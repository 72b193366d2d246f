"""The profiler's reduction (``trace.summarize``) over hand-built events:
the device's busy time as the union of its operations, the part of it
inside a span's device-side range, and idle gaps named by the host's op."""

import pytest

from gpubench import trace


class Ev:
    def __init__(self, kind, name, s, e, tid=1):
        self.kind, self.n, self.s, self.e, self.tid = kind, name, s, e, tid

    def activity_type(self):
        return self.kind

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def start_thread_id(self):
        return self.tid


def test_busy_spans_and_gaps_over_the_window():
    evs = [
        Ev("user_annotation", "admission", 0, 40),
        Ev("gpu_user_annotation", "admission", 10, 50),        # its range on the device
        Ev("kernel", "a", 10, 30),
        Ev("kernel", "b", 20, 45),                             # overlaps a: union 10-45
        Ev("kernel", "c", 60, 70),                             # outside the admission
        Ev("cpu_op", "cudaLaunchKernel", 45, 60),
        Ev("kernel", "late", 120, 130),                        # after the window
    ]
    out = trace.summarize(evs, 0, 100)
    assert out["window_s"] == pytest.approx(100e-9)
    assert out["busy_s"] == pytest.approx(45e-9)                # 10-45 and 60-70
    assert out["span_busy_s"] == {"admission": pytest.approx(35e-9)}
    assert dict((n, s) for n, s in out["device_ops"]) == pytest.approx(
        {"a": 20e-9, "b": 25e-9, "c": 10e-9})
    gaps = dict(out["idle_gaps"])
    assert gaps["outside:cudaLaunchKernel"] == pytest.approx(15e-9)    # 45-60
    assert gaps["outside:python"] == pytest.approx(30e-9)              # 70-100
    assert gaps["admission:python"] == pytest.approx(10e-9)            # 0-10


def test_a_span_without_a_device_range_reads_nothing():
    out = trace.summarize([Ev("kernel", "a", 0, 10)], 0, 20)
    assert out["span_busy_s"] == {}
