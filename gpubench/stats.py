"""The benchmark's arithmetic of rates and percentiles."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0..100) by linear interpolation between the
    closest ranks (rank q/100 * (n - 1) over the sorted values); None for
    no values."""
    xs = sorted(values)
    if not xs:
        return None
    r = q / 100.0 * (len(xs) - 1)
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


def mean(values: Sequence[float]) -> Optional[float]:
    """The arithmetic mean; None for no values."""
    return sum(values) / len(values) if values else None


def rate(count: float, seconds: float) -> Optional[float]:
    """count / seconds, None over an empty window."""
    return count / seconds if seconds > 0 else None


def ttft_ms(records, t0: float, t1: float):
    """Time to first token (ms) of every request whose first token came
    inside [t0, t1]."""
    return [1e3 * (r.t_first - r.t_submit) for r in records
            if r.t_first is not None and t0 <= r.t_first <= t1]


def tpot_ms(records, t0: float, t1: float):
    """Time per output token (ms) after the first, of every request that
    completed inside [t0, t1] with two tokens or more."""
    return [1e3 * (r.t_last - r.t_first) / (r.n_tokens - 1) for r in records
            if r.t_done is not None and t0 <= r.t_done <= t1 and r.n_tokens > 1]
