"""Rotary position embeddings — DeepSeek V2 and V3 variants.

Rope covers only the ``qk_rope_head_dim`` chunk of each head (reference
infer.cpp:648-724, selected by ``is_v3 = has_moegate_bias``):

- **V2 ("transposed")**: pairs (x[2i], x[2i+1]) rotate by angle(i); the
  outputs land split, real parts in the first half and imaginary parts in
  the second half.
- **V3 ("interleaved")**: the same rotation, outputs stay interleaved.

Plain theta^(-2i/d) frequencies unless YaRN is opted into (cfg.use_yarn).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class YarnParams:
    """YaRN frequency-interpolation parameters (static)."""

    factor: float
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float
    original_max_position: int


def yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn_inv_freq(d: int, theta: float, yp: YarnParams) -> np.ndarray:
    """Interpolated inverse frequencies, one per rotation pair (d//2,)."""
    dim_idx = np.arange(0, d, 2, dtype=np.float64)
    freq_extra = theta ** -(dim_idx / d)
    freq_inter = freq_extra / yp.factor

    def correction_dim(num_rot):
        return (d * math.log(yp.original_max_position / (num_rot * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(correction_dim(yp.beta_fast)), 0)
    high = min(math.ceil(correction_dim(yp.beta_slow)), d - 1)
    ramp = np.clip((np.arange(d // 2, dtype=np.float64) - low)
                   / max(high - low, 0.001), 0.0, 1.0)
    inv_freq_mask = 1.0 - ramp
    return (freq_inter * (1 - inv_freq_mask)
            + freq_extra * inv_freq_mask).astype(np.float32)


def yarn_attention_mscale(yp: YarnParams) -> float:
    """Extra factor on the attention softmax scale under YaRN."""
    m = yarn_get_mscale(yp.factor, yp.mscale_all_dim)
    return m * m


def _angles(pos: torch.Tensor, d: int, theta: float,
            yarn: Optional[YarnParams] = None):
    """pos (...,) -> (cos, sin) of shape pos.shape + (d//2,), float32."""
    # no blocking host-to-device copy: the decode block runs without a
    # host synchronization (models/deepseek.py::make_decode_loop)
    if yarn is not None and yarn.factor > 1.0:
        freq = torch.from_numpy(_yarn_inv_freq(d, theta, yarn)).to(
            pos.device, non_blocking=True)
        m = (yarn_get_mscale(yarn.factor, yarn.mscale)
             / yarn_get_mscale(yarn.factor, yarn.mscale_all_dim))
    else:
        i = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
        base = torch.full((), theta, dtype=torch.float32, device=pos.device)
        freq = torch.pow(base, -(i / d))
        m = 1.0
    val = pos.float()[..., None] * freq
    return torch.cos(val) * m, torch.sin(val) * m


def apply_rope(x: torch.Tensor, pos, theta: float, is_v3: bool,
               yarn: Optional[YarnParams] = None) -> torch.Tensor:
    """Rotate the last axis of ``x`` (length d, even); ``pos`` is an int or
    a tensor broadcastable to ``x.shape[:-1]``."""
    d = x.shape[-1]
    pos = (pos.to(x.device) if isinstance(pos, torch.Tensor)
           else torch.full((), pos, dtype=torch.int64, device=x.device))
    cos, sin = _angles(pos, d, theta, yarn)
    x0 = x[..., 0::2].float()
    x1 = x[..., 1::2].float()
    r = x0 * cos - x1 * sin
    im = x0 * sin + x1 * cos
    if is_v3:
        out = torch.stack([r, im], dim=-1).reshape(r.shape[:-1] + (d,))
    else:
        out = torch.cat([r, im], dim=-1)
    return out.to(x.dtype)
