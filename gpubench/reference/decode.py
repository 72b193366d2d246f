"""Stored weight formats to float32, written from the formats themselves
(plain torch; nothing of the program).

Q3_K, per 256-weight super-block of a row: w = d * s * q, q = low2 + 4*high
- 4 in [-4, 3], s the 6-bit group scale of its 16-weight group minus 32, d
the super-block's scale. In the packed plane layout the quants sit at
stride-16 permuted column positions: position o*(n/16) + g holds natural
column 16*g + o; byte j of ``qs`` holds positions j + k*n/4 in bits 2k..2k+1
(k = 0..3), byte j of ``hm`` positions j + b*n/8 in bit b (b = 0..7).

F8E5M2 with inverse block scales: w = e5m2(byte) * scale[row // b0, col // b1]
on a ceil-sized grid.
"""

from __future__ import annotations

from typing import Tuple

import torch


def q3k_to_f32(qs: torch.Tensor, hm: torch.Tensor, sc: torch.Tensor,
               d: torch.Tensor) -> torch.Tensor:
    """(..., rows, n) float32 from the planes (see the module docstring)."""
    n = qs.shape[-1] * 4
    low = torch.cat([(qs >> (2 * k)) & 3 for k in range(4)], dim=-1).to(torch.int16)
    high = torch.cat([(hm >> b) & 1 for b in range(8)], dim=-1).to(torch.int16)
    q_perm = low + 4 * high - 4                      # at permuted positions
    lead = q_perm.shape[:-1]
    q = q_perm.reshape(*lead, 16, n // 16).transpose(-1, -2).reshape(*lead, n)
    group = d.repeat_interleave(16, dim=-1) * sc.float()         # (..., n/16)
    return group.repeat_interleave(16, dim=-1) * q.float()


def fp8_to_f32(data: torch.Tensor, scale: torch.Tensor,
               block: Tuple[int, int]) -> torch.Tensor:
    """(..., rows, cols) float32 from e5m2 bytes and their block scales."""
    w = data.view(torch.float8_e5m2).float()
    b0, b1 = block
    rows, cols = w.shape[-2:]
    s = scale.repeat_interleave(b0, dim=-2)[..., :rows, :]
    return w * s.repeat_interleave(b1, dim=-1)[..., :cols]


def to_f32(fields, quant: str, block=None) -> torch.Tensor:
    """A draw's stored fields (``gpubench.draw.draw``) as float32."""
    if quant == "q3_k":
        return q3k_to_f32(fields["qs"], fields["hm"], fields["sc"], fields["d"])
    return fp8_to_f32(fields[0], fields[1], tuple(block))


def rows_to_f32(fields, rows: torch.Tensor, quant: str, block=None) -> torch.Tensor:
    """Rows ``rows`` of a 2-D weight (an embedding lookup) as float32."""
    if quant == "q3_k":
        return q3k_to_f32(*(fields[k][rows] for k in ("qs", "hm", "sc", "d")))
    data, scale = fields
    w = data[rows].view(torch.float8_e5m2).float()
    s = scale[rows // block[0]].repeat_interleave(block[1], dim=-1)[..., :w.shape[-1]]
    return w * s
