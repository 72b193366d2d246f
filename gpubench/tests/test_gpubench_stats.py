"""Rates and percentiles over a hand-built timeline."""

import dataclasses
from typing import Optional

import pytest

from gpubench import stats


@dataclasses.dataclass
class R:
    t_submit: float
    t_first: Optional[float]
    t_last: Optional[float]
    t_done: Optional[float]
    n_tokens: int


def test_percentile_interpolates_between_ranks():
    assert stats.percentile([], 90) is None
    assert stats.percentile([5.0], 90) == 5.0
    xs = list(range(1, 11))                       # ranks 0..9
    assert stats.percentile(xs, 90) == pytest.approx(9.1)
    assert stats.percentile(xs, 50) == pytest.approx(5.5)
    assert stats.percentile(list(reversed(xs)), 0) == 1


def test_rates_and_tails_over_the_window():
    recs = [
        R(0.0, 1.0, 3.0, 3.0, 5),     # first token and completion inside [1, 10]
        R(0.5, 0.8, 2.0, 2.0, 3),     # first token before the window: no TTFT
        R(9.0, 9.5, None, None, 1),   # in flight at the close: TTFT only
        R(2.0, 4.0, 12.0, 12.0, 9),   # completes after the window: no TPOT
        R(5.0, 6.0, 6.0, 6.0, 1),     # one token: no TPOT
    ]
    assert stats.ttft_ms(recs, 1.0, 10.0) == pytest.approx([1000.0, 500.0, 2000.0, 1000.0])
    assert stats.tpot_ms(recs, 1.0, 10.0) == pytest.approx([500.0, 600.0])
    assert stats.rate(90, 30.0) == 3.0
    assert stats.rate(5, 0.0) is None
