"""RMS normalization (reference semantics: infer.cpp:601-611)."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """y = x / sqrt(mean(x^2) + eps) * weight over the last axis; the
    statistics run in float32 whatever the input dtype."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * weight.float()).to(x.dtype)
