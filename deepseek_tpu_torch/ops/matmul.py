"""Projection dispatch and the MoE pair list.

``qmatmul`` applies a stored projection ``W (out, in)`` to ``x (..., in)``
(reference dispatcher infer.cpp:381-417; ``deepseek_tpu/ops/matmul.py::
qmatmul``): nibble weights go through kernel K1, plain weights through one
matrix product. ``dispatch_pairs`` is the single-device (ep == 1) part of
``deepseek_tpu/parallel/spmd.py::SpmdCtx.dispatch_pairs``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from deepseek_tpu_torch.ops.kernels.qmm import qmm
from deepseek_tpu_torch.quant.qtensor import KNibbleTensor, PlainTensor


def qmatmul(qt, x: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ W.T -> (..., out) in x's dtype, accumulated in f32."""
    if isinstance(qt, KNibbleTensor):
        return qmm(qt, x).to(x.dtype)
    if isinstance(qt, PlainTensor):
        return torch.matmul(x.float(), qt.data.float().t()).to(x.dtype)
    raise TypeError(f"unsupported weight {type(qt).__name__}")


def dispatch_pairs(idx: torch.Tensor, weights: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten the (T, k) token-expert pairs and sort them by expert id
    (stable), so a repeated expert's pairs sit together.

    Returns (expert (N,), weight (N,), token (N,)), N = T*k."""
    T, k = idx.shape
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    tok = torch.arange(T * k, device=idx.device) // k
    return flat[order], weights.reshape(-1)[order], tok[order]
