"""Attention, plain PyTorch: decode (MHA and absorbed MLA) and the chunked
prefill.

``decode_attn_mha``, ``decode_attn_mla``, ``prefill_attn_mha`` and
``prefill_attn_mla`` port the functions of the same names in
``deepseek_tpu/ops/attention.py``. They are the plain versions of kernels
K8, K3 (ops.kernels.attention), K9 and K10 (ops.kernels.prefill_attn). In
the MLA forms scores live in the shared latent space, MQA-style: one
(kv_lora_rank + rope) cache row serves every head. Decode masks the valid prefix ``kv_len`` of the ring buffer; prefill
masks by the position each slot holds.

Over an int8 cache each takes the f32 scales of the stored rows and
dequantizes the rows before the same einsums (the JAX package's XLA
route, ``deepseek.py:317-318, 452-460, 565-566, 624-631``), in the layouts
of the JAX kernels: (B,S) for the latent rows, head-major (B,H,S) for the
per-head keys and values.

The ``*_partial`` functions (``decode_attn_mla_partial`` etc., the JAX
functions of the same names) attend over one shard of the window and
return the unnormalized accumulator with its flash statistics, (acc, m,
l): m the shard's maximum scaled score of each query row, l = sum exp(s -
m), acc = sum exp(s - m) v. Shards merge exactly (``parallel/spmd.py``).
A row that sees no slot of the shard gives acc 0, l 0 and m = -1e30. They
are the plain versions of the kernels' ``partials=True`` bodies.
"""

from __future__ import annotations

import math

import torch

from deepseek_tpu_torch.models.kvcache import dequant_rows

_NEG_INF = -1e30


def _heads_dequant(cache: torch.Tensor, scale) -> torch.Tensor:
    """(B,S,H,D) int8 rows with head-major (B,H,S) scales -> f32, or a
    float cache as it is."""
    return dequant_rows(cache, None if scale is None else scale.transpose(1, 2))


def _len_mask(kv_len, B: int, S: int, device) -> torch.Tensor:
    """(B, 1, S) mask of the valid cache slots; kv_len int or (B,)."""
    kv_len = torch.as_tensor(kv_len, device=device).reshape(-1)
    return (torch.arange(S, device=device)[None, None, :]
            < kv_len.expand(B)[:, None, None])


def decode_attn_mha(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, kv_len, softmax_scale=None,
                    k_scale=None, v_scale=None) -> torch.Tensor:
    """Decompressed-MHA decode: q (B,H,Dh), k_cache (B,S,H,Dh), v_cache
    (B,S,H,Dv), kv_len int or (B,) -> (B,H,Dv) float32; an int8 cache
    passes k_scale/v_scale (B,H,S)."""
    B, S = k_cache.shape[0], k_cache.shape[1]
    k_cache, v_cache = _heads_dequant(k_cache, k_scale), _heads_dequant(v_cache, v_scale)
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k_cache.float()) * scale
    w = _masked_softmax(scores, _len_mask(kv_len, B, S, scores.device))
    return torch.einsum("bhs,bshv->bhv", w, v_cache.float())


def decode_attn_mla(q_c: torch.Tensor, q_rope: torch.Tensor,
                    ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
                    kv_len, head_dim: int, softmax_scale=None,
                    ckv_scale=None, krope_scale=None) -> torch.Tensor:
    """q_c (B,H,R), q_rope (B,H,P), ckv_cache (B,S,R), krope_cache (B,S,P),
    kv_len int or (B,) -> attended latents (B,H,R) float32; an int8 cache
    passes ckv_scale/krope_scale (B,S)."""
    B, S = ckv_cache.shape[0], ckv_cache.shape[1]
    ckv_cache = dequant_rows(ckv_cache, ckv_scale)
    krope_cache = dequant_rows(krope_cache, krope_scale)
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(head_dim)
    ckv = ckv_cache.float()
    scores = (torch.einsum("bhr,bsr->bhs", q_c.float(), ckv)
              + torch.einsum("bhp,bsp->bhs", q_rope.float(),
                             krope_cache.float())) * scale
    w = _masked_softmax(scores, _len_mask(kv_len, B, S, ckv.device))
    return torch.einsum("bhs,bsr->bhr", w, ckv)


def _masked_partials(scores: torch.Tensor, mask: torch.Tensor):
    """(m, e): the masked rows' maximum (-1e30 where no slot is visible)
    and exp(s - m), 0 at masked slots."""
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1)
    e = torch.where(mask, torch.exp(scores - m[..., None]), torch.zeros_like(scores))
    return m, e


def decode_attn_mha_partial(q, k_cache, v_cache, kv_len_local, softmax_scale=None,
                            k_scale=None, v_scale=None):
    """decode_attn_mha over one shard of the window: kv_len_local (B,) the
    valid prefix within the shard -> (acc (B,H,Dv), m (B,H), l (B,H))."""
    B, S = k_cache.shape[0], k_cache.shape[1]
    k_cache, v_cache = _heads_dequant(k_cache, k_scale), _heads_dequant(v_cache, v_scale)
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k_cache.float()) * scale
    m, e = _masked_partials(scores, _len_mask(kv_len_local, B, S, scores.device))
    return torch.einsum("bhs,bshv->bhv", e, v_cache.float()), m, e.sum(-1)


def decode_attn_mla_partial(q_c, q_rope, ckv_cache, krope_cache, kv_len_local,
                            head_dim: int, softmax_scale=None, ckv_scale=None,
                            krope_scale=None):
    """decode_attn_mla over one shard of the window -> (acc (B,H,R), m
    (B,H), l (B,H))."""
    B, S = ckv_cache.shape[0], ckv_cache.shape[1]
    ckv = dequant_rows(ckv_cache, ckv_scale).float()
    krope = dequant_rows(krope_cache, krope_scale).float()
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(head_dim)
    scores = (torch.einsum("bhr,bsr->bhs", q_c.float(), ckv)
              + torch.einsum("bhp,bsp->bhs", q_rope.float(), krope)) * scale
    m, e = _masked_partials(scores, _len_mask(kv_len_local, B, S, ckv.device))
    return torch.einsum("bhs,bsr->bhr", e, ckv), m, e.sum(-1)


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    e = torch.where(mask, e, torch.zeros_like(e))
    return e / e.sum(dim=-1, keepdim=True)


def _prefill_mask(q_pos: torch.Tensor, cache_pos: torch.Tensor) -> torch.Tensor:
    """(1, 1, T, S), or (B, 1, T, S) for per-row q_pos (B, T) (verify
    mode): query t sees slot s when the position stored there is at most
    its own and the slot is filled (position >= 0)."""
    mask = (cache_pos[None, :] <= q_pos[..., :, None]) & (cache_pos >= 0)
    return mask[None, None] if q_pos.dim() == 1 else mask[:, None]


def prefill_attn_mha(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_pos: torch.Tensor,
                     cache_pos: torch.Tensor, softmax_scale=None,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """Chunked causal attention: q (B,T,H,Dh), k_cache (B,S,H,Dh), v_cache
    (B,S,H,Dv), q_pos (T,) query positions (or (B,T), verify mode: each
    row's own), cache_pos (S,) the position
    each slot holds (-1 = empty) -> (B,T,H,Dv) float32; an int8 cache
    passes k_scale/v_scale (B,H,S)."""
    k_cache, v_cache = _heads_dequant(k_cache, k_scale), _heads_dequant(v_cache, v_scale)
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k_cache.float()) * scale
    w = _masked_softmax(scores, _prefill_mask(q_pos, cache_pos))
    return torch.einsum("bhts,bshv->bthv", w, v_cache.float())


def prefill_attn_mla(q_c: torch.Tensor, q_rope: torch.Tensor,
                     ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
                     q_pos: torch.Tensor, cache_pos: torch.Tensor,
                     head_dim: int, softmax_scale=None, ckv_scale=None,
                     krope_scale=None) -> torch.Tensor:
    """Chunked causal absorbed-MLA attention over the latent cache: q_c
    (B,T,H,R), q_rope (B,T,H,P), ckv_cache (B,S,R), krope_cache (B,S,P) ->
    attended latents (B,T,H,R) float32 (mask as prefill_attn_mha); an int8
    cache passes ckv_scale/krope_scale (B,S)."""
    ckv_cache = dequant_rows(ckv_cache, ckv_scale)
    krope_cache = dequant_rows(krope_cache, krope_scale)
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(head_dim)
    ckv = ckv_cache.float()
    scores = (torch.einsum("bthr,bsr->bhts", q_c.float(), ckv)
              + torch.einsum("bthp,bsp->bhts", q_rope.float(),
                             krope_cache.float())) * scale
    w = _masked_softmax(scores, _prefill_mask(q_pos, cache_pos))
    return torch.einsum("bhts,bsr->bthr", w, ckv)


def prefill_attn_mha_partial(q, k_cache, v_cache, q_pos, cache_pos,
                             softmax_scale=None, k_scale=None, v_scale=None):
    """prefill_attn_mha over one shard of the window, cache_pos (S_local,)
    the global positions of its slots -> (acc (B,T,H,Dv), m (B,T,H), l
    (B,T,H))."""
    k_cache, v_cache = _heads_dequant(k_cache, k_scale), _heads_dequant(v_cache, v_scale)
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k_cache.float()) * scale
    m, e = _masked_partials(scores, _prefill_mask(q_pos, cache_pos))
    acc = torch.einsum("bhts,bshv->bthv", e, v_cache.float())
    return acc, m.transpose(1, 2), e.sum(-1).transpose(1, 2)


def prefill_attn_mla_partial(q_c, q_rope, ckv_cache, krope_cache, q_pos, cache_pos,
                             head_dim: int, softmax_scale=None, ckv_scale=None,
                             krope_scale=None):
    """prefill_attn_mla over one shard of the window -> (acc (B,T,H,R), m
    (B,T,H), l (B,T,H))."""
    ckv = dequant_rows(ckv_cache, ckv_scale).float()
    krope = dequant_rows(krope_cache, krope_scale).float()
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(head_dim)
    scores = (torch.einsum("bthr,bsr->bhts", q_c.float(), ckv)
              + torch.einsum("bthp,bsp->bhts", q_rope.float(), krope)) * scale
    m, e = _masked_partials(scores, _prefill_mask(q_pos, cache_pos))
    acc = torch.einsum("bhts,bsr->bthr", e, ckv)
    return acc, m.transpose(1, 2), e.sum(-1).transpose(1, 2)
