"""Tracing and profiling: the port of ``deepseek_tpu/utils/profiling.py``.

1. ``span(name)``: a named range of the program's host code at a layer
   boundary (``serve.step``, ``model.decode_step``, ``layer.attn``,
   ``moe.dispatch``, ``sample``, ...). While a ``torch.profiler`` session
   records (the benchmark's traced run, or an operator's own profiler) it
   opens a function-scope ``record_function`` range, which lies on
   Kineto's clock with the card's kernel events: each idle gap of the
   device trace falls inside the span that was running on the host. A
   span is a host range only: it takes no kernel, so a user range around
   it (``torch.profiler.record_function``, such as a benchmark's) keeps
   every kernel launched inside it. With no profiler recording a span
   costs one flag test; it never synchronizes, allocates or launches
   anything.
2. ``profile_scope(name)``: a span plus a scoped wall-clock profiler keyed
   by the dotted nesting path (``with profile_scope("hydrate.prefill")``),
   aggregated into one map and dumped like the reference's end-of-run
   report (main.cpp:355-360). The aggregate is on with ``DSEEK_PROFILE=1``
   or ``enable_profiling()``; kernels launch asynchronously, so then a
   scope synchronizes the card when it closes and times work that has
   finished. With the aggregate off a scope is a span.
3. The routing record (each MoE layer's routed experts, as program data):
   ``models/deepseek.py::make_decode_loop(with_routes=True)``,
   ``engine.py::hydrate_cache(routes=[...])`` / ``Engine.perplexity`` and
   ``serving.py::BatchScheduler(record_routes=True).routes(request_id)``.
4. The analytical bandwidth model is
   ``deepseek_tpu_torch.models.loader.params_active_bytes``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch.autograd import _profiler_enabled

_enabled = os.environ.get("DSEEK_PROFILE", "0") == "1"
_times: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_stack = threading.local()
_lock = threading.Lock()
_NO_SPAN = contextlib.nullcontext()


def enable_profiling(on: bool = True) -> None:
    global _enabled
    _enabled = on


def profiling_enabled() -> bool:
    return _enabled


def span(name: str):
    """A host range named ``name`` while a profiler records; otherwise a
    shared no-op context."""
    if not _profiler_enabled():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


def _sync() -> None:
    """Wait for the card's queued work (none to wait for on the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_scope(name: str) -> Iterator[None]:
    with span(name):
        if not _enabled:
            yield
            return
        stack = getattr(_stack, "names", None)
        if stack is None:
            stack = _stack.names = []
        stack.append(name)
        key = ".".join(stack)
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            dt = time.perf_counter() - t0
            stack.pop()
            with _lock:
                _times[key] += dt
                _counts[key] += 1


def profile_report() -> Dict[str, float]:
    with _lock:
        return dict(sorted(_times.items()))


def reset_profile() -> None:
    with _lock:
        _times.clear()
        _counts.clear()


def dump_profile() -> str:
    """Formatted like the reference's end-of-run dump (main.cpp:355-360)."""
    lines = ["Profile total times (sec):"]
    with _lock:
        for k in sorted(_times):
            lines.append(f"  {k}: {_times[k]:.4f} ({_counts[k]} calls)")
    return "\n".join(lines)
