"""Absorbed-MLA decode attention, plain PyTorch.

``decode_attn_mla`` is the port of ``deepseek_tpu/ops/attention.py``'s
function of the same name and the plain version of kernel K3
(ops.kernels.attention.mla_decode_attn): scores live in the shared latent
space, MQA-style — one (kv_lora_rank + rope) cache row serves every head.
``kv_len`` masks the valid prefix of the static ring buffer.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def decode_attn_mla(q_c: torch.Tensor, q_rope: torch.Tensor,
                    ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
                    kv_len, head_dim: int, softmax_scale=None) -> torch.Tensor:
    """q_c (B,H,R), q_rope (B,H,P), ckv_cache (B,S,R), krope_cache (B,S,P),
    kv_len int or (B,) -> attended latents (B,H,R) float32."""
    B, S = ckv_cache.shape[0], ckv_cache.shape[1]
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(head_dim)
    ckv = ckv_cache.float()
    scores = (torch.einsum("bhr,bsr->bhs", q_c.float(), ckv)
              + torch.einsum("bhp,bsp->bhs", q_rope.float(),
                             krope_cache.float())) * scale
    kv_len = torch.as_tensor(kv_len, device=ckv.device).reshape(-1)
    mask = (torch.arange(S, device=ckv.device)[None, None, :]
            < kv_len.expand(B)[:, None, None])
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    e = torch.where(mask, e, torch.zeros_like(e))
    w = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhs,bsr->bhr", w, ckv)
