"""F8E5M2 weight quantization, per-tensor and blockwise (128x128 by default).

The port's copy of ``deepseek_tpu/quant/fp8.py`` on torch tensors, with
``torch.float8_e5m2`` in place of ``ml_dtypes`` (which the port does not
need): scale = max / clamp(absmax, 1e-12) per block, the values scaled,
clipped to the representable range and cast (round to nearest even), and
the reciprocal scale stored in f32. The grid is ceil-sized: an edge block
of a weight whose rows or columns its size does not divide is partial.
"""

from __future__ import annotations

from typing import Tuple

import torch

from deepseek_tpu_torch.quant.qtensor import Fp8Tensor

F8E5M2 = torch.float8_e5m2
F8E5M2_MAX = float(torch.finfo(F8E5M2).max)       # 57344.0


def per_tensor_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (qweight float8_e5m2, inverse scale f32 0-d tensor)."""
    x = x.float()
    amax = float(x.abs().max()) if x.numel() else 16.0
    scale = F8E5M2_MAX / max(amax, 1e-12)
    q = torch.clamp(x * scale, -F8E5M2_MAX, F8E5M2_MAX).to(F8E5M2)
    return q, torch.tensor(1.0 / scale, dtype=torch.float32)


def blockwise_quantize(x: torch.Tensor, block: Tuple[int, int] = (128, 128)
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a 2-D weight with a per-(b0, b1)-block scale grid.

    Returns (qweight float8_e5m2 (d, n), inv_scales f32 (ceil(d/b0),
    ceil(n/b1)))."""
    x = x.float()
    d, n = x.shape
    b0, b1 = block
    g0, g1 = -(-d // b0), -(-n // b1)
    # pad to whole blocks so the reduction is a reshape
    xp = torch.zeros((g0 * b0, g1 * b1), dtype=torch.float32, device=x.device)
    xp[:d, :n] = x
    blocks = xp.reshape(g0, b0, g1, b1)
    amax = blocks.abs().amax(dim=(1, 3))
    # tensor / tensor: a Python scalar over a tensor computes a reciprocal
    # and a product, which rounds differently from numpy's division
    scale = torch.full_like(amax, F8E5M2_MAX) / torch.clamp(amax, min=1e-12)
    q = torch.clamp(blocks * scale[:, None, :, None], -F8E5M2_MAX, F8E5M2_MAX)
    q = q.reshape(g0 * b0, g1 * b1)[:d, :n].to(F8E5M2)
    return q, torch.ones_like(scale) / scale


def blockwise_dequantize(q: torch.Tensor, inv_scales: torch.Tensor,
                         block: Tuple[int, int] = (128, 128)) -> torch.Tensor:
    """f32 weight (d, n) from its fp8 bytes and the (ceil-sized) grid."""
    return Fp8Tensor(data=q, scale=inv_scales.float(),
                     block_size=tuple(block)).dequant(torch.float32)
