"""The whole step's share of the chip's roofline: the least time the traced
window's steps need (the larger of flops at 989 TFLOP/s and bytes at 3.35
TB/s, a step at a time, ``work.py``) over the traced window's wall."""

from gpubench.readers import step_share_of_window as read  # noqa: F401
