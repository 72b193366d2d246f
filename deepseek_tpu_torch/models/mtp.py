"""DeepSeek-V3's multi-token-prediction (MTP) layer: the port of
``deepseek_tpu/models/mtp.py``.

The checkpoint's extra layer predicts token t+2 from the main model's
pre-final-norm hidden state at position t and the embedding of token t+1:

    h' = eh_proj([RMSNorm_e(embed(tok_{t+1})); RMSNorm_h(h_t)])
    h_mtp = TransformerBlock(h')          (its own one-layer KV cache)
    logits_{t+2} = lm_head(RMSNorm(h_mtp))   (the main model's head)

It drafts for lossless self-speculative decoding (``Engine.generate_mtp``,
``speculative.make_mtp_spec_rounds``): the main model verifies every
draft, so the layer's quality moves speed only. The block is the port's own
attention and FFN (``models/deepseek.py``), so it runs the main path's
kernels: K3 (or K8) in decode and K10 (or K9) in prefill, the projections
through K1/K5/K4 and the experts through K2 (K6/K11 for large chunks).
The MTP cache is keyed by position like the main ring cache, made at its
window and cache dtype (an int8 cache keeps the sinks' float masters).
"""

from __future__ import annotations

import dataclasses

import torch

from deepseek_tpu_torch.config import ModelConfig
from deepseek_tpu_torch.models.deepseek import (
    _attention, _attention_mha, _attention_prefill, _attention_prefill_mha, _ffn,
    compute_dtype, decode_positions, final_logits,
)
from deepseek_tpu_torch.models.kvcache import KVCache, init_cache
from deepseek_tpu_torch.models.params import ModelParams, embed_lookup
from deepseek_tpu_torch.ops.matmul import qmatmul
from deepseek_tpu_torch.ops.norms import rmsnorm


def init_mtp_cache(cfg: ModelConfig, batch: int = 1, device="cpu") -> KVCache:
    """One-layer KV cache for the MTP block (the main cache's window, ring
    and dtype)."""
    return init_cache(dataclasses.replace(cfg, n_layers=1), batch=batch, device=device)


@torch.inference_mode()
def mtp_forward(params: ModelParams, cache: KVCache, tokens: torch.Tensor,
                h: torch.Tensor, pos0, cfg: ModelConfig, prefill: bool):
    """tokens (B,T): the NEXT tokens; h (B,T,dim): the main model's hidden
    states at the base positions pos0.. (a shared int). Returns (logits
    (B,T,V) float32, h_mtp (B,T,dim) in the compute dtype, cache), the cache
    written in place. Decode takes T == 1; prefill keeps pos0 + T inside
    the window (``_mtp_impl``, mtp.py:46-99)."""
    mp = params.mtp
    if mp is None:
        raise ValueError("checkpoint has no MTP module")
    if isinstance(pos0, torch.Tensor) and pos0.dim() > 0:
        raise NotImplementedError(
            "MTP verify mode (per-sequence positions) belongs to batched "
            "serving (ROADMAP.md queue 1, item 12)")
    pos0 = int(pos0)
    B, T = tokens.shape
    dtype = compute_dtype(cfg)
    e = rmsnorm(embed_lookup(params.embed, tokens, torch.float32).to(dtype),
                mp.enorm, cfg.norm_eps)
    hh = rmsnorm(h.to(dtype), mp.hnorm, cfg.norm_eps)
    x = qmatmul(mp.eh_proj, torch.cat([e, hh], dim=-1)).to(dtype)

    lp = mp.block
    xb = rmsnorm(x, lp.attn_norm, cfg.norm_eps)
    if prefill:
        if pos0 + T > cfg.kv_window:
            raise ValueError(f"MTP prefill at {pos0}..{pos0 + T - 1} crosses the "
                             f"{cfg.kv_window}-slot window")
        attend = _attention_prefill if cfg.use_mla else _attention_prefill_mha
        x = x + attend(lp, cfg, xb, cache, 0, pos0)
    else:
        if T != 1:
            raise ValueError("MTP decode processes one token per sequence per call")
        pos, kv_pos, kv_len, kv_sink = decode_positions(cfg, B, pos0, tokens.device)
        attend = _attention if cfg.use_mla else _attention_mha
        x = x + attend(lp, cfg, xb, cache, 0, pos, kv_pos, kv_len, kv_sink)
    xb = rmsnorm(x, lp.ffn_norm, cfg.norm_eps)
    # the block's FFN form follows its own weights (V3's MTP layer is MoE)
    layer_kind = cfg.first_k_dense_replace if lp.moegate is not None else 0
    x = x + _ffn(lp, cfg, xb, layer_kind, prefill=prefill)
    logits = final_logits(mp.final_norm, params.lm_head, x, cfg, "all")
    return logits, x, cache
