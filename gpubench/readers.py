"""Arithmetic shared by the per-layer metric readers (``metrics/*.py``).
Each reader takes the run's record and returns a number, or None where the
record has nothing for it: device numbers come only from a run on the card."""

from __future__ import annotations

from typing import Optional


def _trace(record: dict) -> Optional[dict]:
    tr = record.get("trace")
    if record.get("platform") != "cuda" or not tr or tr.get("window_s", 0) <= 0:
        return None
    return tr


def step_share_of_window(record: dict) -> Optional[float]:
    """The least time the traced steps need on the chip (``work.py``) over
    the traced window's wall, in %."""
    tr = _trace(record)
    if tr is None or record.get("least_s") is None:
        return None
    return 100.0 * record["least_s"] / tr["window_s"]


def step_share_of_busy(record: dict) -> Optional[float]:
    """The same least time over the device's busy time, in %."""
    tr = _trace(record)
    if tr is None or not tr.get("busy_s") or record.get("least_s") is None:
        return None
    return 100.0 * record["least_s"] / tr["busy_s"]


def idle_share(record: dict) -> Optional[float]:
    """1 - busy / window of the traced window, in %."""
    tr = _trace(record)
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
