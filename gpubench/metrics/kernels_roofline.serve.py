"""The kernels' share of their roofline: the least time the traced
window's steps need (``work.py``) over the device's busy time (the union of
kernel intervals in the profiler's trace)."""

from gpubench.readers import step_share_of_busy as read  # noqa: F401
