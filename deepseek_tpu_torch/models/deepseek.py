"""DeepSeek decode forward: one token per sequence per call.

The port of the decode mode of ``deepseek_tpu/models/deepseek.py::
_forward_impl``: ring/sink position math, the absorbed-MLA attention over
the latent cache (written in place), the dense GLU and the MoE FFN through
an expert-sorted pair list, then the final norm and the lm_head. Nibble
projections go through kernel K1, the per-head ``wv_b`` and the expert
tables through K2, the attention through K3; on CPU tensors each of them
runs its plain version. Prefill is the next slice (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch

from deepseek_tpu_torch.config import KV_SINKS, ModelConfig
from deepseek_tpu_torch.models.kvcache import KVCache, ring_positions
from deepseek_tpu_torch.models.params import LayerParams, ModelParams, embed_lookup
from deepseek_tpu_torch.ops.activations import glu_act
from deepseek_tpu_torch.ops.gating import moe_gate
from deepseek_tpu_torch.ops.kernels.attention import mla_decode_attn
from deepseek_tpu_torch.ops.kernels.qmm import qmm_experts
from deepseek_tpu_torch.ops.matmul import dispatch_pairs, qmatmul
from deepseek_tpu_torch.ops.norms import rmsnorm
from deepseek_tpu_torch.ops.rope import apply_rope
from deepseek_tpu_torch.quant.qtensor import KNibbleTensor

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _COMPUTE_DTYPES[str(cfg.compute_dtype)]


def _rotation_only(yarn):
    """YaRN params with mscale neutralized: the sink re-rotation must be a
    pure rotation (the cached keys carry the magnitude scale once)."""
    return None if yarn is None else dataclasses.replace(
        yarn, mscale=yarn.mscale_all_dim)


def _expert_mm(qt, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Row i of x against expert idx[i] of a stacked table -> f32."""
    if isinstance(qt, KNibbleTensor):
        return qmm_experts(qt, idx, x)
    w = qt.data[idx].float()                                  # (N, d, n)
    return torch.bmm(w, x.float()[..., None])[..., 0]


def _attention(lp: LayerParams, cfg: ModelConfig, xb: torch.Tensor,
               cache: KVCache, layer: int, pos: torch.Tensor,
               kv_pos: torch.Tensor, kv_len: torch.Tensor,
               kv_sink: torch.Tensor) -> torch.Tensor:
    """Absorbed MLA decode (BlockMLA, infer.cpp:1052-1141). xb (B,1,dim)."""
    B = xb.shape[0]
    H, R, P = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    Dv = cfg.v_head_dim
    is_v3, theta = cfg.has_moegate_bias, cfg.rope_theta
    yarn = cfg.yarn_params()

    if lp.wkvq is not None:
        kvq = qmatmul(lp.wkvq, xb)
        kv_a, q_a_raw = kvq[..., :R + P], kvq[..., R + P:]
    else:
        kv_a, q_a_raw = qmatmul(lp.wkv_a, xb), qmatmul(lp.wq_a, xb)
    pos_b1 = pos[:, None]                                     # (B, 1)
    k_rope = apply_rope(kv_a[..., R:].float(), pos_b1, theta, is_v3, yarn)
    ckv = rmsnorm(kv_a[..., :R], lp.kv_a_norm, cfg.norm_eps)
    q_a = rmsnorm(q_a_raw, lp.q_a_norm, cfg.norm_eps)
    if lp.wcr is not None:
        qcr = qmatmul(lp.wcr, q_a)
        q_rope, q_c = qcr[..., :H * P], qcr[..., H * P:]
    else:
        q_rope, q_c = qmatmul(lp.wq_rope_b, q_a), qmatmul(lp.wc, q_a)
    q_rope = apply_rope(q_rope.reshape(B, 1, H, P).float(), pos_b1[..., None],
                        theta, is_v3, yarn)
    q_c = q_c.reshape(B, 1, H, R).float()

    # cache write at the ring slot, then the sink re-rotation by +1
    # (StreamingLLM; infer.cpp:1103-1110) once the ring has wrapped
    bidx = torch.arange(B, device=xb.device)
    ckv_l, kr_l = cache.ckv[layer], cache.krope[layer]
    ckv_l[bidx, kv_pos] = ckv[:, 0].to(ckv_l.dtype)
    kr_l[bidx, kv_pos] = k_rope[:, 0].to(kr_l.dtype)
    sink = kr_l[:, :KV_SINKS].float()
    rot = apply_rope(sink, 1, theta, is_v3, _rotation_only(yarn))
    keep = (kv_sink > 0)[:, None, None]
    kr_l[:, :KV_SINKS] = torch.where(keep, rot.to(kr_l.dtype), kr_l[:, :KV_SINKS])

    lat = mla_decode_attn(q_c[:, 0], q_rope[:, 0], ckv_l, kr_l, kv_len,
                          cfg.attn_softmax_scale())           # (B, H, R)

    # per-head up-projection of the attended latents (infer.cpp:1134-1137):
    # the expert kernel with idx = head id reads each head's block once
    if isinstance(lp.wv_b, KNibbleTensor):
        wv3 = lp.wv_b.map(lambda t: t.reshape(H, t.shape[0] // H, t.shape[1]))
        hidx = torch.arange(H, device=xb.device).expand(B, H)
        v = qmm_experts(wv3, hidx, lat)                       # (B, H, Dv)
    else:
        wv = lp.wv_b.dequant(torch.float32).reshape(H, Dv, R)
        v = torch.einsum("bhr,hvr->bhv", lat, wv)
    return qmatmul(lp.wo, v.reshape(B, 1, H * Dv).to(xb.dtype))


def _dense_glu(w13, w1, w2, w3, xb: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if w13 is not None:
        h2 = qmatmul(w13, xb)
        m = h2.shape[-1] // 2
        h = glu_act(h2[..., :m], h2[..., m:], cfg.act)
    else:
        h = glu_act(qmatmul(w1, xb), qmatmul(w3, xb), cfg.act)
    return qmatmul(w2, h)


def _ffn(lp: LayerParams, cfg: ModelConfig, xb: torch.Tensor, layer: int) -> torch.Tensor:
    if not cfg.is_moe_layer(layer):
        return _dense_glu(lp.w13, lp.w1, lp.w2, lp.w3, xb, cfg)
    B, dtype = xb.shape[0], xb.dtype
    router_logits = torch.matmul(xb.float(), lp.moegate.float().t())
    weights, idx = moe_gate(router_logits, lp.moegate_bias, cfg)   # (B,1,k)
    idx, weights = idx.reshape(B, -1), weights.reshape(B, -1)
    folded = lp.w13s is not None
    if folded:
        # shared experts sit at the tail of the tables as weight-1.0 slots
        ns, E = cfg.n_shared_experts, cfg.n_routed_experts
        sid = torch.arange(E, E + ns, device=idx.device).expand(B, ns)
        idx = torch.cat([idx, sid], dim=-1)
        weights = torch.cat([weights, torch.ones_like(weights[:, :ns])], dim=-1)
        t13, t1, t2, t3 = lp.w13s, None, lp.w2s, None
    else:
        t13, t1, t2, t3 = lp.w13, lp.w1, lp.w2, lp.w3
    eid, wts, tok = dispatch_pairs(idx, weights)                   # (N,)
    xk = xb.reshape(B, -1)[tok]                                    # (N, dim)
    if t13 is not None:
        h2 = _expert_mm(t13, eid, xk).to(dtype)
        m = h2.shape[-1] // 2
        h = glu_act(h2[:, :m], h2[:, m:], cfg.act)
    else:
        h = glu_act(_expert_mm(t1, eid, xk).to(dtype),
                    _expert_mm(t3, eid, xk).to(dtype), cfg.act)
    per = _expert_mm(t2, eid, h)                                   # (N, dim) f32
    out = torch.zeros((B, per.shape[-1]), dtype=torch.float32, device=per.device)
    out.index_add_(0, tok, per * wts[:, None])
    out = out.reshape(B, 1, -1).to(dtype)
    if not folded and (lp.shared_w13 is not None or lp.shared_w1 is not None):
        out = out + _dense_glu(lp.shared_w13, lp.shared_w1, lp.shared_w2,
                               lp.shared_w3, xb, cfg)
    return out


def run_layer_stack(layers, cache: KVCache, x: torch.Tensor, pos, kv_pos,
                    kv_len, kv_sink, cfg: ModelConfig) -> torch.Tensor:
    """The transformer layers, unrolled, over x (B,1,dim)."""
    for layer, lp in enumerate(layers):
        xb = rmsnorm(x, lp.attn_norm, cfg.norm_eps)
        x = x + _attention(lp, cfg, xb, cache, layer, pos, kv_pos, kv_len, kv_sink)
        xb = rmsnorm(x, lp.ffn_norm, cfg.norm_eps)
        x = x + _ffn(lp, cfg, xb, layer)
    return x


def decode_positions(cfg: ModelConfig, B: int, pos0, device):
    """(pos (B,), kv_pos (B,), kv_len (B,) int32, kv_sink (B,)) for decode
    at ``pos0`` (int, or a (B,) per-sequence tensor)."""
    pos = torch.as_tensor(pos0, dtype=torch.int64, device=device).reshape(-1).expand(B)
    kv_sink, kv_pos, kv_len = ring_positions(cfg, pos)
    return pos, kv_pos, kv_len.to(torch.int32), kv_sink


def final_logits(final_norm, lm_head, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm + lm_head of the last row: x (B,T,dim) -> (B,V) float32."""
    x = rmsnorm(x[:, -1:], final_norm, cfg.norm_eps)
    return qmatmul(lm_head, x.float())[:, 0]


def forward_decode(params: ModelParams, cache: KVCache, tokens: torch.Tensor,
                   pos0, cfg: ModelConfig) -> torch.Tensor:
    """One decode step: tokens (B,1) at position ``pos0`` -> logits (B,V)
    float32. Writes this step's latent rows into ``cache`` in place."""
    B, T = tokens.shape
    if T != 1:
        raise ValueError("decode processes one token per sequence per call")
    if not cfg.use_mla:
        raise NotImplementedError(
            "decompressed-MHA decode is not ported yet (ROADMAP.md queue 1, item 5)")
    pos, kv_pos, kv_len, kv_sink = decode_positions(cfg, B, pos0, tokens.device)
    x = embed_lookup(params.embed, tokens, torch.float32).to(compute_dtype(cfg))
    x = run_layer_stack(params.layers, cache, x, pos, kv_pos, kv_len, kv_sink, cfg)
    return final_logits(params.final_norm, params.lm_head, x, cfg)
