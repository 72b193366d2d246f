"""The traced run: ``torch.profiler`` over a part of the window, reduced to
the device's busy time, the device operations that took the most time and
the idle gaps named by what the host was doing in them; and the taps that
the traced run puts around the program's calls."""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List

import torch

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Profile:
    """``torch.profiler`` over [start(), stop()] (CPU ops and CUDA
    activity), read back through the raw Kineto events."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        self._prof.start()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self._prof.stop()

    def summary(self, log=None) -> dict:
        """busy_s (the union of device intervals inside the window),
        window_s, span_busy_s (for each of the benchmark's spans, the part
        of busy_s inside the span's range on the device timeline),
        device_ops and idle_gaps (each the TOP largest, as [name, seconds])."""
        return summarize(self._prof.profiler.kineto_results.events(), self.t0_ns, self.t1_ns,
                         log)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _kind(ev) -> str:
    """The event's activity type; older and newer torch name it apart."""
    at = getattr(ev, "activity_type", None)
    if at is not None:
        return at()
    ua = getattr(ev, "is_user_annotation", lambda: False)()
    if str(ev.device_type()).endswith("CUDA"):
        return "gpu_user_annotation" if ua else "kernel"
    return "user_annotation" if ua else "cpu_op"


def _end(ev) -> int:
    end = getattr(ev, "end_ns", None)
    return end() if end is not None else ev.start_ns() + ev.duration_ns()


def _overlap(merged, ranges) -> int:
    """ns of the merged intervals that lie inside the union of ``ranges``."""
    total = 0
    for s, e in _merge(ranges):
        total += sum(max(0, min(e, b) - max(s, a)) for a, b in merged)
    return total


def summarize(events, t0: int, t1: int, log=None) -> dict:
    """The reduction of Kineto events (ns on one clock) to the window
    [t0, t1]; see ``Profile.summary``. A device event named as one of the
    host's annotations is that annotation's range on the device timeline,
    no operation."""
    dev, cpu, ann = [], [], []
    kinds = collections.Counter()
    for ev in events:
        kind = _kind(ev)
        s, e = ev.start_ns(), _end(ev)
        if e <= t0 or s >= t1:
            continue
        kinds[kind] += 1
        if kind in _DEVICE_KINDS:
            dev.append((max(s, t0), min(e, t1), ev.name()))
        elif kind == "gpu_user_annotation":
            ann.append((max(s, t0), min(e, t1), ev.name()))
        elif kind in ("cpu_op", "user_annotation"):
            tid = getattr(ev, "start_thread_id", lambda: 0)()
            cpu.append((s, e, ev.name(), kind == "user_annotation", tid))
    spans = {c[2] for c in cpu if c[3]}
    ann += [d for d in dev if d[2] in spans]
    dev = [d for d in dev if d[2] not in spans]
    if log is not None:
        log(f"trace events in the window: {dict(kinds)}; device operations {len(dev)}")
    by_name: Dict[str, float] = collections.defaultdict(float)
    for s, e, name in dev:
        by_name[name[:120]] += (e - s) * 1e-9
    merged = _merge((s, e) for s, e, _ in dev)
    busy = sum(e - s for s, e in merged)
    gaps, prev = [], t0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    span_busy = {name: _overlap(merged, [(s, e) for s, e, n in ann if n == name]) * 1e-9
                 for name in sorted({n for *_, n in ann})}
    return {"busy_s": busy * 1e-9, "window_s": (t1 - t0) * 1e-9, "span_busy_s": span_busy,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": _name_gaps(gaps, cpu)}


def _name_gaps(gaps, cpu) -> List[list]:
    """Idle seconds by what the host's main thread ran at each gap's
    middle: '<innermost span of the benchmark>:<innermost op>' ('python'
    where no op ran), summed by name, the TOP largest."""
    if not gaps:
        return []
    threads = collections.Counter(t for *_, t in cpu)
    main = threads.most_common(1)[0][0] if threads else None
    evs = sorted((c for c in cpu if c[4] == main), key=lambda c: (c[0], -c[1]))
    total: Dict[str, float] = collections.defaultdict(float)
    stack, i = [], 0
    for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
        mid = (s + e) // 2
        while i < len(evs) and evs[i][0] <= mid:
            while stack and stack[-1][1] < evs[i][0]:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        live = [ev for ev in stack if ev[0] <= mid <= ev[1]]
        span = next((ev[2] for ev in reversed(live) if ev[3]), "outside")
        op = live[-1][2] if live and not live[-1][3] else "python"
        total[f"{span}:{op}"] += (e - s) * 1e-9
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


ROUTE_CAPACITY = 1 << 27   # int16 expert ids (256 MiB); a run of either cell fills under a third


class RouteLog:
    """Wraps the port's router call (``models/deepseek.py::moe_gate``) and
    keeps every call's chosen experts (int16, in a device buffer: one copy
    kernel a call, no host read inside the window), with a host tag the
    driver sets for each call (which rows, which positions). Used for the
    distinct experts a step chose (the traced run's work count) and for the
    reference's routing at near-ties (``reference/forward.py``).

    The port exposes no record of its routing, so this swaps a wrapper in
    for the name ``moe_gate`` that the forward calls. Where the program stops
    calling it through that name (a fused router, a decode block replayed as
    a CUDA graph), or the buffer is full, calls go unlogged: their positions
    count as missing in ``check.compare`` and the run is not correct, with
    that reason printed, instead of the reference silently routing alone."""

    def __init__(self, device):
        self.buf = torch.empty(ROUTE_CAPACITY, dtype=torch.int16, device=device)
        self.n = 0
        self.calls: List[tuple] = []     # (offset, rows, k, tag)
        self.tag = None
        self._mod = self._orig = None
        self._host = None

    def install(self):
        from deepseek_tpu_torch.models import deepseek
        self._mod, self._orig = deepseek, deepseek.moe_gate
        deepseek.moe_gate = self
        return self

    def uninstall(self) -> None:
        if self._mod is not None:
            self._mod.moe_gate = self._orig
            self._mod = None

    def __call__(self, logits, bias, cfg):
        weights, idx = self._orig(logits, bias, cfg)
        flat = idx.reshape(-1)
        m, k = flat.numel(), idx.shape[-1]
        if self.n + m <= self.buf.shape[0]:
            self.buf[self.n:self.n + m].copy_(flat)
            self.calls.append((self.n, m // k, k, self.tag))
        self.n += m
        return weights, idx

    def host(self):
        """The buffer on the host (read once, after the window)."""
        if self._host is None or len(self._host) < min(self.n, self.buf.shape[0]):
            self._host = self.buf[:min(self.n, self.buf.shape[0])].cpu().numpy()
        return self._host

    def experts(self, call: int):
        """(rows, k) experts of call ``call``."""
        off, rows, k, _ = self.calls[call]
        return self.host()[off:off + rows * k].reshape(rows, k)

    def distinct(self, call: int, live=None) -> int:
        """Distinct experts the call's (live) rows chose."""
        e = self.experts(call)
        return len(set((e if live is None else e[live]).reshape(-1).tolist()))


@contextlib.contextmanager
def span(name: str, on: bool):
    """A ``record_function`` range of the benchmark's own, in the traced run."""
    if not on:
        yield
        return
    with torch.profiler.record_function(name):
        yield
