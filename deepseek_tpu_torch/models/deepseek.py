"""DeepSeek forward: decode (one token per sequence per call) and chunked
prefill.

The port of ``deepseek_tpu/models/deepseek.py::_forward_impl``:

- ``forward_decode`` (decode mode): ring/sink position math, the
  absorbed-MLA attention over the latent cache (written in place), the
  dense GLU and the MoE FFN through an expert-sorted pair list, then the
  final norm and the lm_head. Nibble projections go through kernel K1, the
  per-head nibble ``wv_b`` and the expert tables (nibble or plain) through
  K2, the attention through K3.
- ``forward_prefill`` (prefill mode, scalar ``pos0``, pos0 + T <= window):
  T rows written at slot pos0, then causal attention over the window. The
  hybrid-MLA policy: a layer that kept ``wq_b``/``wkv_b`` attends in
  decompressed head space (K9), any other through the latent cache (K10).
  The MoE FFN takes the pair path (K2) for at most 128 token-expert pairs,
  the grouped products (K6, K11) where the widths allow, the
  dense-over-experts einsums otherwise. Projections at many rows take
  K1's row-tiled route.
- A ``use_mla=0`` checkpoint (the converter's default) takes the
  decompressed-MHA branch in both modes: queries from ``wq`` (or
  ``wq_a``/``wq_b``), keys and values decompressed through ``wkv_b`` and
  cached per head; decode re-rotates only the rope part of the sink keys
  and attends through K8, prefill through K9. Large plain weights at few
  rows (the lm_head, the dense FFN of DeepSeek-V2-Lite) take K4.
- A packed Q2_K/Q3_K checkpoint (the default K-quant runtime) runs the
  packed bodies: every projection through K5, the expert tables and the
  per-head ``wv_b`` through K2's, the grouped MoE prefill through K6's; its
  shared expert stays a dense projection (the stride-16 planes interleave
  columns, so it is not folded into the routed tables).
- The turbo runtime (``kquant_runtime="turbo"``: int8 planes) runs the
  turbo bodies of K5, K2 and K6 the same way; Q2_K turbo's natural column
  order lets its shared expert fold into the routed tables, Q3_K turbo's
  stays a dense projection as packed does.
- A blockwise F8E5M2 checkpoint runs the fp8 bodies: every projection
  through K5, the expert tables and the per-head ``wv_b`` through K2's,
  the grouped MoE prefill through K6's. A per-tensor one has no expert
  kernel (nor has the JAX package): its decode gathers and dequantizes the
  selected experts, its prefill runs every expert once.

- An int8 KV cache (``kv_cache_dtype="int8"``) stores each row quantized
  with its f32 scale and the sink keys' float masters (models/kvcache.py):
  every write quantizes, the sinks re-rotate from the master and are
  quantized fresh each step (in MHA the whole (slot, head) key row, as its
  scale covers it), and K3, K8, K9 and K10 take the scales. The hybrid
  prefill dequantizes the window before ``wkv_b`` and attends through the
  float K9.

- The row-permuted nibble expert tables of ``DSEEK_FUSED_FFN=1``
  (``KNibbleTensor.rowperm``, set once at load): a single token's MoE FFN
  runs the fused expert FFN (K7, one launch for w13, the GLU, w2 and the
  weighted sum); several tokens' pairs run K2 on w13 and K2's
  prepermuted body on w2, the grouped prefill K6 then K6's prepermuted
  body; the dequantizing paths restore the natural rows.

- ``make_decode_loop`` runs ``n_steps`` decode steps at a time, sampling
  each token on the device (``ops/sampling.py``) with the JAX package's
  threefry keys; the Engine's default decode block.

- On a mesh with a ``seq`` axis (``parallel/``: one process per shard,
  ``torch.distributed``), ``forward_decode``/``forward_prefill`` take the
  ``SpmdCtx`` of ``make_ctx``: the cache is this rank's slice of the
  window, decode writes commit on the shard that owns the slot, the sinks
  re-rotate on shard 0, and every attention launches its kernel's
  ``partials`` body over the local slice and merges the shards exactly
  (``seq_merge``). A prefill chunk whose length divides the axis runs
  context-parallel (the JAX ``_forward_impl``): each rank embeds,
  projects and runs the FFN on its T/sp rows, the chunk's queries and
  cache rows are gathered, and ``cp_merge_scatter`` hands each rank its
  rows back; the logits are reassembled (``final_logits``).

On CPU tensors every kernel runs its plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deepseek_tpu_torch.config import KV_SINKS, ModelConfig
from deepseek_tpu_torch.models.kvcache import (
    KVCache, dequant_rows, ring_positions, write_rows, write_slot, write_step_int8,
)
from deepseek_tpu_torch.models.params import LayerParams, ModelParams, embed_lookup
from deepseek_tpu_torch.ops.activations import glu_act
from deepseek_tpu_torch.ops.gating import moe_gate
from deepseek_tpu_torch.ops.kernels.attention import mha_decode_attn, mla_decode_attn
from deepseek_tpu_torch.ops.kernels.prefill_attn import (
    mha_prefill_attn, mla_prefill_attn,
)
from deepseek_tpu_torch.ops.kernels.qmm import (
    expert_ffn_fusable, qmm_expert_ffn, qmm_experts,
)
from deepseek_tpu_torch.ops.matmul import (
    dispatch_pairs, grouped_expert_ffn, grouped_ffn_supported, per_tensor_fp8,
    qmatmul,
)
from deepseek_tpu_torch.ops.norms import rmsnorm
from deepseek_tpu_torch.ops.rope import apply_rope
from deepseek_tpu_torch.parallel.spmd import NULL_CTX, SpmdCtx, make_ctx
from deepseek_tpu_torch.quant.qtensor import KNibbleTensor, PlainTensor, rows_to_experts

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Prefill chunks with at most this many token-expert pairs run the
# decode-style pair dispatch (K2) instead of the grouped chunk products,
# whose cost floor is about one tile per expert (the JAX package's
# ``_PAIR_PREFILL_MAX_PAIRS``, measured on a TPU; not re-measured here).
PAIR_PREFILL_MAX_PAIRS = 128


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _COMPUTE_DTYPES[str(cfg.compute_dtype)]


def _rotation_only(yarn):
    """YaRN params with mscale neutralized: the sink re-rotation must be a
    pure rotation (the cached keys carry the magnitude scale once)."""
    return None if yarn is None else dataclasses.replace(
        yarn, mscale=yarn.mscale_all_dim)


def _latent_inputs(lp: LayerParams, cfg: ModelConfig, xb: torch.Tensor,
                   pos_bt: torch.Tensor):
    """The projections every attention path and mode shares: xb (B,T,dim)
    at positions pos_bt (B,T) -> (ckv (B,T,R), k_rope (B,T,P) f32, q_a
    (B,T,q_lora), or None for a checkpoint without a query LoRA)."""
    R, P = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    if lp.wkvq is not None:
        kvq = qmatmul(lp.wkvq, xb)
        kv_a, q_a_raw = kvq[..., :R + P], kvq[..., R + P:]
    else:
        kv_a = qmatmul(lp.wkv_a, xb)
        q_a_raw = qmatmul(lp.wq_a, xb) if lp.wq_a is not None else None
    k_rope = apply_rope(kv_a[..., R:].float(), pos_bt, cfg.rope_theta,
                        cfg.has_moegate_bias, cfg.yarn_params())
    ckv = rmsnorm(kv_a[..., :R], lp.kv_a_norm, cfg.norm_eps)
    q_a = None if q_a_raw is None else rmsnorm(q_a_raw, lp.q_a_norm, cfg.norm_eps)
    return ckv, k_rope, q_a


def _attend(kernel, ctx: SpmdCtx, merge, *args, **kw) -> torch.Tensor:
    """``kernel(*args, **kw)`` on one device; under a seq axis its partials
    body over this rank's slice of the window, merged across the shards by
    ``merge`` (``ctx.seq_merge`` or, for a context-parallel chunk,
    ``ctx.cp_merge_scatter``)."""
    if ctx.sp <= 1:
        return kernel(*args, **kw)
    return merge(*kernel(*args, partials=True, **kw))


def _mha_inputs(lp: LayerParams, cfg: ModelConfig, xb: torch.Tensor,
                pos_bt: torch.Tensor):
    """Decompressed-MHA projections (BlockMHA, infer.cpp:935-1049;
    deepseek_tpu/models/deepseek.py:499-514): xb (B,T,dim) at positions
    pos_bt (B,T) -> q (B,T,H,Dh) f32 with rope on its last P dims, k
    (B,T,H,Dh) f32 = [k_nope, the rope key shared by every head], v
    (B,T,H,Dv) in xb's dtype. The queries come from ``wq``, or from
    ``wq_a`` -> ``q_a_norm`` -> ``wq_b`` where the checkpoint has a query
    LoRA."""
    B, T, _ = xb.shape
    H, P = cfg.n_heads, cfg.qk_rope_head_dim
    nope, Dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    ckv, k_rope, q_a = _latent_inputs(lp, cfg, xb, pos_bt)
    q = qmatmul(lp.wq_b, q_a) if q_a is not None else qmatmul(lp.wq, xb)
    q = q.reshape(B, T, H, cfg.head_dim).float()
    q_pe = apply_rope(q[..., nope:], pos_bt[..., None], cfg.rope_theta,
                      cfg.has_moegate_bias, cfg.yarn_params())
    q = torch.cat([q[..., :nope], q_pe], dim=-1)
    kv_b = qmatmul(lp.wkv_b, ckv).reshape(B, T, H, nope + Dv)
    k = torch.cat([kv_b[..., :nope].float(),
                   k_rope[:, :, None, :].expand(B, T, H, P)], dim=-1)
    return q, k, kv_b[..., nope:]


def _attention_mha(lp: LayerParams, cfg: ModelConfig, xb: torch.Tensor,
                   cache: KVCache, layer: int, pos: torch.Tensor,
                   kv_pos: torch.Tensor, kv_len: torch.Tensor,
                   kv_sink: torch.Tensor, ctx: SpmdCtx = NULL_CTX) -> torch.Tensor:
    """Decompressed-MHA decode (deepseek.py:579-635). xb (B,1,dim)."""
    B = xb.shape[0]
    H, nope, Dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    q, k, v = _mha_inputs(lp, cfg, xb, pos[:, None])
    k_l, v_l = cache.k[layer], cache.v[layer]                 # (B,S,H,.)
    rotate = lambda x: apply_rope(x, 1, cfg.rope_theta, cfg.has_moegate_bias,
                                  _rotation_only(cfg.yarn_params()))
    if cache.quantized:
        # the sinks rotate from their float master: only the rope part moves
        write_step_int8(cache, layer, kv_pos, k[:, 0], v[:, 0], kv_sink,
                        lambda m: torch.cat([m[..., :nope], rotate(m[..., nope:])], -1),
                        ctx)
        scales = dict(k_scale=cache.k_s[layer].transpose(1, 2),
                      v_scale=cache.v_s[layer].transpose(1, 2))
    else:
        bidx = torch.arange(B, device=xb.device)
        lpos, own = ctx.local_slots(kv_pos, cfg.kv_window)
        write_slot(k_l, bidx, lpos, k[:, 0], own)
        write_slot(v_l, bidx, lpos, v[:, 0], own)
        if ctx.sidx == 0:       # the sink slots live on seq shard 0
            # the sink re-rotation by +1 touches only the rope part of each key
            sink = k_l[:, :KV_SINKS, :, nope:]
            keep = (kv_sink > 0)[:, None, None, None]
            k_l[:, :KV_SINKS, :, nope:] = torch.where(
                keep, rotate(sink.float()).to(k_l.dtype), sink)
        scales = {}
    out = _attend(mha_decode_attn, ctx, ctx.seq_merge, q[:, 0], k_l, v_l,
                  ctx.local_kv_len(kv_len, cfg.kv_window), cfg.attn_softmax_scale(),
                  **scales)
    return qmatmul(lp.wo, out.reshape(B, 1, H * Dv).to(xb.dtype))


def _chunk_positions(xb: torch.Tensor, pos0: int, ctx: SpmdCtx) -> torch.Tensor:
    """(B,T) positions of the chunk rows in xb: pos0.., or under context
    parallelism this rank's share of the chunk."""
    B, T = xb.shape[:2]
    first = pos0 + (ctx.sidx * T if ctx.cp else 0)
    return (first + torch.arange(T, device=xb.device)).expand(B, T)


def _attention_prefill_mha(lp: LayerParams, cfg: ModelConfig, xb: torch.Tensor,
                           cache: KVCache, layer: int, pos0: int,
                           ctx: SpmdCtx = NULL_CTX) -> torch.Tensor:
    """Decompressed-MHA attention of a prefill chunk xb (B,T,dim) at
    positions pos0.. (deepseek.py:548-578): the chunk's keys and values go
    into the cache at slot pos0, then the chunk attends causally over the
    cached heads (slot == position)."""
    B, T, _ = xb.shape
    H, Dv = cfg.n_heads, cfg.v_head_dim
    q, k, v = _mha_inputs(lp, cfg, xb, _chunk_positions(xb, pos0, ctx))
    write_rows(cache, layer, k, v, pos0, ctx)
    if ctx.cp:
        q = ctx.cp_gather_rows(q)                 # the whole chunk's queries
    scales = {} if not cache.quantized else dict(
        k_scale=cache.k_s[layer].transpose(1, 2),
        v_scale=cache.v_s[layer].transpose(1, 2))
    # On the card the port always launches K9 here. The JAX package's
    # _use_flash_prefill (deepseek.py:195-200) would take its einsum at
    # DeepSeek-V2-Lite's T=256, S=4096, H=16 (64 MB of f32 scores, under its
    # 256 MB threshold); K9 never holds the (B,H,T,S) scores in memory.
    merge = ctx.cp_merge_scatter if ctx.cp else ctx.seq_merge
    out = _attend(mha_prefill_attn, ctx, merge, q, cache.k[layer], cache.v[layer],
                  pos0, ctx.sidx * cache.window, cfg.attn_softmax_scale(), **scales)
    return qmatmul(lp.wo, out.reshape(B, T, H * Dv).to(xb.dtype))


def _absorbed_queries(lp: LayerParams, cfg: ModelConfig, q_a: torch.Tensor,
                      pos_bt: torch.Tensor):
    """Queries in the latent space: q_a (B,T,q_lora) -> (q_c (B,T,H,R),
    q_rope (B,T,H,P)), both f32."""
    B, T = q_a.shape[:2]
    H, R, P = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    if lp.wcr is not None:
        qcr = qmatmul(lp.wcr, q_a)
        q_rope, q_c = qcr[..., :H * P], qcr[..., H * P:]
    else:
        q_rope, q_c = qmatmul(lp.wq_rope_b, q_a), qmatmul(lp.wc, q_a)
    q_rope = apply_rope(q_rope.reshape(B, T, H, P).float(), pos_bt[..., None],
                        cfg.rope_theta, cfg.has_moegate_bias, cfg.yarn_params())
    return q_c.reshape(B, T, H, R).float(), q_rope


def _attention(lp: LayerParams, cfg: ModelConfig, xb: torch.Tensor,
               cache: KVCache, layer: int, pos: torch.Tensor,
               kv_pos: torch.Tensor, kv_len: torch.Tensor,
               kv_sink: torch.Tensor, ctx: SpmdCtx = NULL_CTX) -> torch.Tensor:
    """Absorbed MLA decode (BlockMLA, infer.cpp:1052-1141). xb (B,1,dim)."""
    B = xb.shape[0]
    H, Dv = cfg.n_heads, cfg.v_head_dim
    is_v3, theta = cfg.has_moegate_bias, cfg.rope_theta
    yarn = cfg.yarn_params()

    pos_b1 = pos[:, None]                                     # (B, 1)
    ckv, k_rope, q_a = _latent_inputs(lp, cfg, xb, pos_b1)
    q_c, q_rope = _absorbed_queries(lp, cfg, q_a, pos_b1)

    # cache write at the ring slot, then the sink re-rotation by +1
    # (StreamingLLM; infer.cpp:1103-1110) once the ring has wrapped
    ckv_l, kr_l = cache.ckv[layer], cache.krope[layer]
    rotate = lambda x: apply_rope(x, 1, theta, is_v3, _rotation_only(yarn))
    if cache.quantized:
        write_step_int8(cache, layer, kv_pos, ckv[:, 0], k_rope[:, 0], kv_sink, rotate,
                        ctx)
        scales = dict(ckv_scale=cache.ckv_s[layer], krope_scale=cache.krope_s[layer])
    else:
        bidx = torch.arange(B, device=xb.device)
        lpos, own = ctx.local_slots(kv_pos, cfg.kv_window)
        write_slot(ckv_l, bidx, lpos, ckv[:, 0], own)
        write_slot(kr_l, bidx, lpos, k_rope[:, 0], own)
        if ctx.sidx == 0:       # the sink slots live on seq shard 0
            keep = (kv_sink > 0)[:, None, None]
            rot = rotate(kr_l[:, :KV_SINKS].float())
            kr_l[:, :KV_SINKS] = torch.where(keep, rot.to(kr_l.dtype),
                                             kr_l[:, :KV_SINKS])
        scales = {}

    lat = _attend(mla_decode_attn, ctx, ctx.seq_merge, q_c[:, 0], q_rope[:, 0],
                  ckv_l, kr_l, ctx.local_kv_len(kv_len, cfg.kv_window),
                  cfg.attn_softmax_scale(), **scales)           # (B, H, R)
    v = per_head_up(lp.wv_b, lat)                             # (B, H, Dv)
    return qmatmul(lp.wo, v.reshape(B, 1, H * Dv).to(xb.dtype))


def per_head_up(wv_b, lat: torch.Tensor) -> torch.Tensor:
    """The per-head up-projection of the attended latents (infer.cpp:
    1134-1137; deepseek.py:465-492): lat (B, H, R) f32 through wv_b (H*Dv,
    R) -> (B, H, Dv) f32. A nibble, packed or blockwise fp8 wv_b goes
    through the expert kernel with idx = head id, which reads each head's
    block once; a plain or per-tensor fp8 one has no kernel (nor in the JAX
    package) and is dequantized. A blockwise fp8 wv_b whose row blocks straddle two
    heads has no kernel either (the JAX kernel path asserts, ops/matmul.py:
    407): on the card that raises, on the CPU it is dequantized."""
    B, H, R = lat.shape
    wv3 = None if isinstance(wv_b, PlainTensor) else rows_to_experts(wv_b, H)
    if wv3 is not None:
        return qmm_experts(wv3, torch.arange(H, device=lat.device).expand(B, H), lat)
    if lat.device.type != "cpu" and not isinstance(wv_b, PlainTensor) \
            and not per_tensor_fp8(wv_b):
        raise ValueError(
            f"wv_b {wv_b.shape} with {tuple(wv_b.block_size)} blocks: a row "
            f"block straddles two of the {H} heads, which no kernel takes")
    wv = wv_b.dequant(torch.float32).reshape(H, -1, R)
    return torch.einsum("bhr,hvr->bhv", lat, wv)


def _attention_prefill(lp: LayerParams, cfg: ModelConfig, xb: torch.Tensor,
                       cache: KVCache, layer: int, pos0: int,
                       ctx: SpmdCtx = NULL_CTX) -> torch.Tensor:
    """MLA attention of a prefill chunk xb (B,T,dim) at positions pos0..:
    the chunk's latent rows go into the cache at slot pos0, then the
    chunk attends causally over the window (slot == position). Under a
    seq axis the window is this rank's slice (its slot s holds position
    sidx * S_local + s) and the shards' partials merge; under context
    parallelism xb holds this rank's rows and the queries are gathered."""
    B, T, _ = xb.shape
    H, R, P = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    nope, Dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    scale = cfg.attn_softmax_scale()
    pos_bt = _chunk_positions(xb, pos0, ctx)

    ckv, k_rope, q_a = _latent_inputs(lp, cfg, xb, pos_bt)
    # hybrid MLA (deepseek.py:247-265): every prefill chunk of a layer that
    # kept its factor weights attends in decompressed head space, so the
    # hydrated cache does not depend on the chunk length
    decompress = lp.wkv_b is not None and lp.wq_b is not None
    if not decompress:
        q_c, q_rope = _absorbed_queries(lp, cfg, q_a, pos_bt)
        if ctx.cp:
            q_c, q_rope = ctx.cp_gather_rows(q_c), ctx.cp_gather_rows(q_rope)

    write_rows(cache, layer, ckv, k_rope, pos0, ctx)
    ckv_l, kr_l = cache.ckv[layer], cache.krope[layer]              # (B,S,.)
    cs_l, rs_l = ((cache.ckv_s[layer], cache.krope_s[layer]) if cache.quantized
                  else (None, None))
    base = ctx.sidx * cache.window              # position of local slot 0
    merge = ctx.cp_merge_scatter if ctx.cp else ctx.seq_merge
    # The JAX package launches its flash kernels only above 256 MB of f32
    # scores (_use_flash_prefill, a TPU v5e measurement); on the card the
    # port always launches K9/K10 for prefill, which never hold the
    # (B,H,T,S) scores in device memory.
    if decompress:
        S = ckv_l.shape[1]
        q = qmatmul(lp.wq_b, q_a).reshape(B, T, H, cfg.head_dim).float()
        q_pe = apply_rope(q[..., nope:], pos_bt[..., None], cfg.rope_theta,
                          cfg.has_moegate_bias, cfg.yarn_params())
        q = torch.cat([q[..., :nope], q_pe], dim=-1)
        if ctx.cp:
            q = ctx.cp_gather_rows(q)             # the whole chunk's queries
        # the whole window's keys and values, decompressed through wkv_b
        # (an int8 window dequantized first, as deepseek.py:317-318 does)
        ckv_d, kr_d = dequant_rows(ckv_l, cs_l), dequant_rows(kr_l, rs_l)
        kv_dec = qmatmul(lp.wkv_b, ckv_d.to(xb.dtype)).reshape(B, S, H, nope + Dv)
        k_l = torch.cat([kv_dec[..., :nope].float(),
                         kr_d[:, :, None, :].float().expand(B, S, H, P)], dim=-1)
        v_out = _attend(mha_prefill_attn, ctx, merge, q, k_l.to(xb.dtype),
                        kv_dec[..., nope:].contiguous(), pos0, base, scale)
        return qmatmul(lp.wo, v_out.reshape(B, T, H * Dv).to(xb.dtype))
    lat = _attend(mla_prefill_attn, ctx, merge, q_c, q_rope, ckv_l, kr_l, pos0, base,
                  scale, ckv_scale=cs_l, krope_scale=rs_l)      # (B,T,H,R)
    # per-head up-projection of the attended latents, a plain einsum as in
    # the JAX prefill (deepseek.py:489-492)
    wv = lp.wv_b.dequant(torch.float32).reshape(H, Dv, R)
    v = torch.einsum("bthr,hvr->bthv", lat, wv)
    return qmatmul(lp.wo, v.reshape(B, T, H * Dv).to(xb.dtype))


def _dense_glu(w13, w1, w2, w3, xb: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if w13 is not None:
        h2 = qmatmul(w13, xb)
        m = h2.shape[-1] // 2
        h = glu_act(h2[..., :m], h2[..., m:], cfg.act)
    else:
        h = glu_act(qmatmul(w1, xb), qmatmul(w3, xb), cfg.act)
    return qmatmul(w2, h)


def _ffn(lp: LayerParams, cfg: ModelConfig, xb: torch.Tensor, layer: int,
         prefill: bool = False) -> torch.Tensor:
    """The FFN over xb (B,T,dim). Decode (T == 1) and small prefill chunks
    take the expert-sorted pair list; larger prefill chunks the grouped
    products or, where the widths do not allow them, dense-over-experts."""
    if not cfg.is_moe_layer(layer):
        return _dense_glu(lp.w13, lp.w1, lp.w2, lp.w3, xb, cfg)
    B, T, dtype = xb.shape[0], xb.shape[1], xb.dtype
    router_logits = torch.matmul(xb.float(), lp.moegate.float().t())
    weights, idx = moe_gate(router_logits, lp.moegate_bias, cfg)   # (B,T,k)
    folded = lp.w13s is not None
    if folded:
        # shared experts sit at the tail of the tables as weight-1.0 slots
        ns, E = cfg.n_shared_experts, cfg.n_routed_experts
        sid = torch.arange(E, E + ns, device=idx.device).expand(B, T, ns)
        idx = torch.cat([idx, sid], dim=-1)
        weights = torch.cat([weights, torch.ones_like(weights[..., :ns])], dim=-1)
        t13, t1, t2, t3 = lp.w13s, None, lp.w2s, None
    else:
        t13, t1, t2, t3 = lp.w13, lp.w1, lp.w2, lp.w3
    n_exp = t2.shape[0]
    probe = t13 if t13 is not None else t1
    if per_tensor_fp8(probe):
        # no expert kernel takes a per-tensor scale (deepseek.py:707-713)
        out = (_dense_over_experts(t13, t1, t2, t3, xb, weights, idx, n_exp, cfg)
               if prefill else _gather_ffn(t13, t1, t2, t3, xb, weights, idx, cfg))
    elif not prefill or idx.numel() <= PAIR_PREFILL_MAX_PAIRS:
        out = _pair_ffn(t13, t1, t2, t3, xb, weights, idx, cfg)
    elif grouped_ffn_supported(cfg, probe):
        out = grouped_expert_ffn(t1, t2, t3, xb, weights, idx, cfg.act, w13=t13)
    else:
        out = _dense_over_experts(t13, t1, t2, t3, xb, weights, idx, n_exp, cfg)
    if not folded and (lp.shared_w13 is not None or lp.shared_w1 is not None):
        out = out + _dense_glu(lp.shared_w13, lp.shared_w1, lp.shared_w2,
                               lp.shared_w3, xb, cfg)
    return out


def _pair_ffn(t13, t1, t2, t3, xb, weights, idx, cfg) -> torch.Tensor:
    """Expert-sorted pair list through the gathered-expert products (K2:
    its nibble, packed or fp8 body or, for a plain table, its plain body),
    combined per token with the routing weights. A single token over a
    row-permuted nibble w13 (``DSEEK_FUSED_FFN=1``) takes the fused expert
    FFN (K7) instead; several tokens over one take K2's prepermuted body on
    w2 (``deepseek_tpu/models/deepseek.py:806-850``)."""
    B, T, dtype = xb.shape[0], xb.shape[1], xb.dtype
    Bt = B * T
    eid, wts, tok = dispatch_pairs(idx.reshape(Bt, -1), weights.reshape(Bt, -1))
    if Bt == 1 and expert_ffn_fusable(t13, t2):
        y = qmm_expert_ffn(t13, t2, eid, xb.reshape(1, -1), wts, cfg.act)
        return y.reshape(B, T, -1).to(dtype)
    xk = xb.reshape(Bt, -1)[tok]                                   # (N, dim)
    if t13 is not None:
        h2 = qmm_experts(t13, eid, xk).to(dtype)
        m = h2.shape[-1] // 2
        h = glu_act(h2[:, :m], h2[:, m:], cfg.act)
    else:
        h = glu_act(qmm_experts(t1, eid, xk).to(dtype),
                    qmm_experts(t3, eid, xk).to(dtype), cfg.act)
    # a row-permuted w13 leaves h permuted per half: w2 takes it as it is
    rp = isinstance(t13, KNibbleTensor) and bool(t13.rowperm)
    per = qmm_experts(t2, eid, h, rp)                # x_prepermuted; (N, dim) f32
    out = torch.zeros((Bt, per.shape[-1]), dtype=torch.float32, device=per.device)
    out.index_add_(0, tok, per * wts[:, None])
    return out.reshape(B, T, -1).to(dtype)


def _gather_ffn(t13, t1, t2, t3, xb, weights, idx, cfg) -> torch.Tensor:
    """Decode over expert tables that no kernel takes: the k selected
    experts of each token gathered and dequantized (the JAX decode path,
    deepseek.py:852-868)."""
    dtype = xb.dtype
    take = lambda t: t.map(lambda a: a[idx]).dequant(dtype).float()  # (B,T,k,.,.)
    if t13 is not None:
        d13 = take(t13)
        m = d13.shape[-2] // 2
        w1k, w3k = d13[..., :m, :], d13[..., m:, :]
    else:
        w1k, w3k = take(t1), take(t3)
    x = xb.float()
    h = glu_act(torch.einsum("btn,btkmn->btkm", x, w1k).to(dtype),
                torch.einsum("btn,btkmn->btkm", x, w3k).to(dtype), cfg.act)
    per_k = torch.einsum("btkm,btkdm->btkd", h.float(), take(t2))
    return (per_k * weights[..., None].float()).sum(2).to(dtype)


def _dense_over_experts(t13, t1, t2, t3, xb, weights, idx, n_exp, cfg):
    """Every expert once per chunk, the routing weights combined through a
    (B,T,E) matrix (plain torch, as the JAX package leaves it to XLA)."""
    dtype = xb.dtype
    wmat = (torch.nn.functional.one_hot(idx, n_exp).float()
            * weights[..., None].float()).sum(-2)                  # (B,T,E)
    if t13 is not None:
        d13 = t13.dequant(dtype).float()                           # (E,2m,dim)
        m = d13.shape[-2] // 2
        d1, d3 = d13[..., :m, :], d13[..., m:, :]
    else:
        d1, d3 = t1.dequant(dtype).float(), t3.dequant(dtype).float()
    x = xb.float()
    h = glu_act(torch.einsum("btn,emn->btem", x, d1).to(dtype),
                torch.einsum("btn,emn->btem", x, d3).to(dtype), cfg.act)
    per_e = torch.einsum("btem,edm->bted", h.float(), t2.dequant(dtype).float())
    return torch.einsum("bted,bte->btd", per_e, wmat).to(dtype)


def run_layer_stack(layers, cache: KVCache, x: torch.Tensor, pos, kv_pos,
                    kv_len, kv_sink, cfg: ModelConfig,
                    ctx: SpmdCtx = NULL_CTX) -> torch.Tensor:
    """The transformer layers, unrolled, over x (B,1,dim)."""
    attend = _attention if cfg.use_mla else _attention_mha
    for layer, lp in enumerate(layers):
        xb = rmsnorm(x, lp.attn_norm, cfg.norm_eps)
        x = x + attend(lp, cfg, xb, cache, layer, pos, kv_pos, kv_len, kv_sink, ctx)
        xb = rmsnorm(x, lp.ffn_norm, cfg.norm_eps)
        x = x + _ffn(lp, cfg, xb, layer)
    return x


def decode_positions(cfg: ModelConfig, B: int, pos0, device):
    """(pos (B,), kv_pos (B,), kv_len (B,) int32, kv_sink (B,)) for decode
    at ``pos0`` (int, or a (B,) per-sequence tensor)."""
    pos = (pos0.to(device=device, dtype=torch.int64).reshape(-1).expand(B)
           if isinstance(pos0, torch.Tensor)
           else torch.full((B,), int(pos0), dtype=torch.int64, device=device))
    kv_sink, kv_pos, kv_len = ring_positions(cfg, pos)
    return pos, kv_pos, kv_len.to(torch.int32), kv_sink


def final_logits(final_norm, lm_head, x: torch.Tensor, cfg: ModelConfig,
                 logits_mode: str = "last", ctx: SpmdCtx = NULL_CTX) -> torch.Tensor:
    """Final norm + lm_head: x (B,T,dim) -> (B,V) float32 of the last row
    (``logits_mode="last"``) or (B,T,V) of every row (``"all"``). Under a
    context-parallel chunk x holds this rank's rows: the chunk's last row
    comes from the last shard, "all" gathers every shard's rows
    (``deepseek.py:1086-1095``), so every rank returns the whole result."""
    if logits_mode == "last":
        x = x[:, -1:]
    x = rmsnorm(x, final_norm, cfg.norm_eps)
    logits = qmatmul(lm_head, x.float())
    if ctx.cp:
        logits = ctx.cp_last_row(logits) if logits_mode == "last" \
            else ctx.cp_gather_rows(logits)
    return logits[:, 0] if logits_mode == "last" else logits


def forward_decode(params: ModelParams, cache: KVCache, tokens: torch.Tensor,
                   pos0, cfg: ModelConfig, ctx: SpmdCtx = NULL_CTX,
                   with_hidden: bool = False):
    """One decode step: tokens (B,1) at position ``pos0`` -> logits (B,V)
    float32. Writes this step's cache rows into ``cache`` in place; under a
    seq axis (``ctx`` from ``parallel.spmd.make_ctx``) ``cache`` is this
    rank's slice of the window and every rank returns the same logits.
    ``with_hidden`` returns (logits, hidden): the pre-final-norm hidden
    state (B,1,dim) in the compute dtype, which the MTP layer takes
    (``_forward_impl(with_hidden=True)``, deepseek.py:1076-1080)."""
    B, T = tokens.shape
    if T != 1:
        raise ValueError("decode processes one token per sequence per call")
    pos, kv_pos, kv_len, kv_sink = decode_positions(cfg, B, pos0, tokens.device)
    x = embed_lookup(params.embed, tokens, torch.float32).to(compute_dtype(cfg))
    x = run_layer_stack(params.layers, cache, x, pos, kv_pos, kv_len, kv_sink, cfg, ctx)
    logits = final_logits(params.final_norm, params.lm_head, x, cfg)
    return (logits, x) if with_hidden else logits


def forward_prefill(params: ModelParams, cache: KVCache, tokens: torch.Tensor,
                    pos0, cfg: ModelConfig, logits_mode: str = "last",
                    ctx: SpmdCtx = NULL_CTX, with_hidden: bool = False):
    """One prefill chunk: tokens (B,T) at positions pos0..pos0+T-1 (a
    shared int; pos0 + T <= kv_window) -> logits per ``logits_mode``:
    "last" (B,V), "all" (B,T,V) float32, or "none" (None). Writes the
    chunk's cache rows into ``cache`` in place. Under a seq axis (``ctx``
    from ``parallel.spmd.make_ctx``, ``cache`` this rank's slice of the
    window) a chunk whose length divides the axis runs context-parallel,
    each rank on T/sp rows; any other chunk runs replicated on every rank
    (``deepseek.py:1036-1056``). Every rank returns the same logits.
    ``with_hidden`` returns (logits, hidden), hidden the pre-final-norm
    state (B,T,dim) in the compute dtype (this rank's rows under context
    parallelism)."""
    B, T = tokens.shape
    if isinstance(pos0, torch.Tensor) and pos0.dim() > 0:
        raise NotImplementedError(
            "verify mode (per-sequence chunk positions) belongs to batched "
            "serving (ROADMAP.md queue 1, item 12)")
    pos0 = int(pos0)
    if logits_mode not in ("all", "last", "none"):
        raise ValueError(f"logits_mode must be all, last or none, not {logits_mode!r}")
    if pos0 + T > cfg.kv_window:
        raise ValueError(f"prefill at {pos0}..{pos0 + T - 1} crosses the "
                         f"{cfg.kv_window}-slot window; decode steps go on past it")
    if ctx.sp > 1 and T % ctx.sp == 0 and not ctx.cp:
        ctx = dataclasses.replace(ctx, cp=True)
    if ctx.cp:
        sidx, t_loc = ctx.cp_rows(T)
        tokens = tokens[:, sidx * t_loc:(sidx + 1) * t_loc]
    x = embed_lookup(params.embed, tokens, torch.float32).to(compute_dtype(cfg))
    attend = _attention_prefill if cfg.use_mla else _attention_prefill_mha
    for layer, lp in enumerate(params.layers):
        xb = rmsnorm(x, lp.attn_norm, cfg.norm_eps)
        x = x + attend(lp, cfg, xb, cache, layer, pos0, ctx)
        xb = rmsnorm(x, lp.ffn_norm, cfg.norm_eps)
        x = x + _ffn(lp, cfg, xb, layer, prefill=True)
    logits = None if logits_mode == "none" else final_logits(
        params.final_norm, params.lm_head, x, cfg, logits_mode, ctx)
    return (logits, x) if with_hidden else logits


def make_decode_loop(cfg: ModelConfig, n_steps: int, *, mesh=None,
                     with_logprobs: bool = False, with_hidden: bool = False):
    """Multi-token decode (``deepseek_tpu/models/deepseek.py::
    make_decode_loop``): one call runs ``n_steps`` decode steps, each
    sampling on the device the token the next step feeds.

    Returns ``fn(params, cache, tok (B,1), pos0, key, temperature, top_p,
    active=None, top_k=0, min_p=0.0) -> (tokens (B, n_steps) int64,
    logits_last (B, V) float32, cache)``: ``tok`` is the token fed first,
    ``tokens[:, 0]`` its successor; ``key`` a (2,) uint32 threefry key
    (``ops/prng.py``) split once a step as the JAX loop splits its carry;
    the cache is written in place. Positions are host ints ``pos0 + i``
    and the sampled token stays on the device, so no step synchronizes
    with the host: the tokens cross once, when the caller reads them.

    With ``mesh`` (``parallel.mesh.make_mesh(seq=n)``, called on every
    rank) each rank runs the block over its slice of the window
    (``parallel.sharding.shard_cache``) with the same key: the merged
    logits, and so the sampled tokens, are the same on every rank."""
    from deepseek_tpu_torch.ops import prng
    from deepseek_tpu_torch.ops.sampling import sample_with_noise

    ctx = NULL_CTX if mesh is None else make_ctx(cfg, mesh)
    if with_logprobs:
        raise NotImplementedError("per-token logprobs belong to batched serving "
                                  "(ROADMAP.md queue 1, item 12)")
    if with_hidden:
        raise NotImplementedError("the decode block's hidden state feeds batched "
                                  "MTP serving (ROADMAP.md queue 1, item 12)")

    @torch.inference_mode()
    def loop(params, cache, tok, pos0, key, temperature, top_p, active=None,
             top_k=0, min_p=0.0):
        if active is not None:
            raise NotImplementedError("live-row masks belong to batched serving "
                                      "(ROADMAP.md queue 1, item 12)")
        subs = []
        for _ in range(n_steps):
            key, sub = prng.split(key)
            subs.append(sub)
        noise = []

        def noise_of(i):
            # the block's noise in one draw, made when a step first samples
            if not noise:
                noise.append(prng.gumbel(np.stack(subs), (tok.shape[0], cfg.vocab_size),
                                         tok.device))
            return noise[0][i]

        tokens, logits = [], None
        for i in range(n_steps):
            logits = forward_decode(params, cache, tok, pos0 + i, cfg, ctx)
            nxt = sample_with_noise(logits, lambda i=i: noise_of(i), temperature,
                                    top_p, top_k, min_p)
            tokens.append(nxt)
            tok = nxt[:, None]
        return torch.stack(tokens, 1), logits.float(), cache

    return loop
