"""RMS normalization (reference semantics: infer.cpp:601-611)."""

from __future__ import annotations

import torch


# Row reductions and the router product take at least this many rows:
# torch's reduction picks its threads per row from the row count (512 for
# one row, 128 for four, a warp from 16 rows on), and cuBLAS its algorithm
# from it, so fewer rows are padded with zero rows to this many, and a
# decode row's norm and routing scores are the same bits whatever batch
# it is decoded in. From 16 rows on the reduction keeps that configuration
# (a warp a row) at any count, so a verify chunk's rows (B x (k+1) of them)
# also normalize to the bits of their sequence alone.
INVARIANT_ROWS = 16


def pad_rows(x: torch.Tensor, rows: int = INVARIANT_ROWS) -> torch.Tensor:
    """x (n, ...) with zero rows appended up to ``rows`` (x itself if it
    has as many or more)."""
    n = x.shape[0]
    if n >= rows:
        return x
    return torch.cat([x, x.new_zeros((rows - n, *x.shape[1:]))])


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """y = x / sqrt(mean(x^2) + eps) * weight over the last axis; the
    statistics run in float32 whatever the input dtype, over at least
    INVARIANT_ROWS rows."""
    xf = x.float()
    flat = pad_rows(xf.reshape(-1, xf.shape[-1]))
    ms = (flat * flat).mean(dim=-1)[:xf[..., 0].numel()].reshape(*xf.shape[:-1], 1)
    y = xf * torch.rsqrt(ms + eps)
    return (y * weight.float()).to(x.dtype)
