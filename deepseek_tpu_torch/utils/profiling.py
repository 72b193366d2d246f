"""Tracing and profiling: the port of ``deepseek_tpu/utils/profiling.py``.

1. A scoped wall-clock profiler keyed by the dotted nesting path
   (``with profile_scope("hydrate.prefill"): ...``), aggregated into one
   map and dumped like the reference's end-of-run report
   (main.cpp:355-360). Enabled by ``DSEEK_PROFILE=1`` or
   ``enable_profiling()``; ``profiling_disabled()`` excludes a region.
   Kernels launch asynchronously, so while profiling is enabled a scope
   synchronizes the card when it closes and times work that has finished;
   with profiling off a scope costs one flag test and never synchronizes.
2. ``device_trace(logdir)``: a ``torch.profiler`` trace of the host and
   the card, written as a Chrome trace.
3. The analytical bandwidth model is
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

_enabled = os.environ.get("DSEEK_PROFILE", "0") == "1"
_disabled_depth = 0
_times: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_stack = threading.local()
_lock = threading.Lock()


def enable_profiling(on: bool = True) -> None:
    global _enabled
    _enabled = on


def profiling_enabled() -> bool:
    return _enabled and _disabled_depth == 0


@contextlib.contextmanager
def profiling_disabled() -> Iterator[None]:
    """Exclude a region (e.g. warmup) from profiling (ProfileDisabledScope)."""
    global _disabled_depth
    _disabled_depth += 1
    try:
        yield
    finally:
        _disabled_depth -= 1


def _sync() -> None:
    """Wait for the card's queued work (none to wait for on the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_scope(name: str) -> Iterator[None]:
    if not profiling_enabled():
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


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """A ``torch.profiler`` trace of the region (host and, where a GPU is
    visible, the card), exported to ``logdir/trace.json`` (Chrome trace
    format: chrome://tracing or Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
