"""The device's idle share of the traced window: 1 - (union of kernel
intervals / the window), from the profiler's kernel events."""

from gpubench.readers import idle_share as read  # noqa: F401
