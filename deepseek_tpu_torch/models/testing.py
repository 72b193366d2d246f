"""Random-weight models built directly on the device (benchmarks, smoke runs).

Ports ``deepseek_tpu/models/testing.py::deepseek_v3_proportions`` and the
nibble part of ``random_fused_params`` (its row-permuted expert tables
made by a real permutation where the JAX ``_mark_rowperm`` only sets the
flag; with the packed Q2_K/Q3_K planes of
``_direct_qtensor`` beside it, and their turbo conversion as
``_random_qtensor`` makes it), and adds DeepSeek-V2-Lite's
proportions with a plain-weight model (``random_plain_params``) and a
blockwise F8E5M2 one (``random_fp8_params``): weights are synthesized in
their final runtime layout from a seeded ``torch.Generator`` on the target
device,
one random 2-D block per projection, repeated across an expert stack
(throughput does not depend on the values, and every expert still has its
own bytes at its own address).
"""

from __future__ import annotations

import torch

from deepseek_tpu_torch.config import (
    ActivationType, ModelConfig, QuantKind, ScoringFunc, TopKMethod,
)
from deepseek_tpu_torch.models.loader import fuse_layer, rowperm_expert_w13
from deepseek_tpu_torch.models.params import LayerParams, MTPParams, ModelParams
from deepseek_tpu_torch.quant.qtensor import (
    Fp8Tensor, KNibbleTensor, PlainTensor, Q2KTensor, Q3KTensor, q2k_to_turbo,
    q3k_to_turbo,
)


def deepseek_v3_proportions(n_layers: int = 61, **overrides) -> ModelConfig:
    """DeepSeek-V3's architecture hyperparameters (config.json of
    deepseek-ai/DeepSeek-V3): dim 7168, 128 heads, MLA r=512 with q_lora
    1536, 256 routed experts (k=8, sigmoid + noaux_tc routing over 8
    groups, e-score correction bias), 1 shared expert, m=2048, first 3
    layers dense, vocab 129280. Only the depth is cut by callers."""
    base = dict(
        dim=7168, hidden_dim=18432, n_layers=n_layers, n_heads=128,
        vocab_size=129280, max_seq_len=4096, rope_theta=10000.0,
        norm_eps=1e-6, act=ActivationType.SILU, first_k_dense_replace=3,
        n_shared_experts=1, n_routed_experts=256, n_active_routed=8,
        moe_intermediate_size=2048, routed_scaling_factor=2.5, n_group=8,
        norm_topk_prob=True, scoring_func=ScoringFunc.SIGMOID,
        topk_group=4, topk_method=TopKMethod.NOAUX_TC, has_moegate_bias=True,
        use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        weight_quant=QuantKind.F16,
        rs_original_max_position_embeddings=4096,
        arch="DeepseekV3ForCausalLM",
        compute_dtype="bfloat16", kv_cache_dtype="bfloat16",
    )
    base.update(overrides)
    return ModelConfig(**base)


def deepseek_v2_lite_proportions(n_layers: int = 27, **overrides) -> ModelConfig:
    """DeepSeek-V2-Lite's architecture hyperparameters (config.json of
    deepseek-ai/DeepSeek-V2-Lite): dim 2048, 27 layers, 16 heads, no query
    LoRA, kv_lora 512, 64 routed experts + 2 shared, k=6, softmax greedy
    routing, first layer dense (10944), m=1408, vocab 102400. As the
    converter writes it by default: decompressed MHA (use_mla=0) in F16;
    compute and cache in bf16 as bench.py's V2-Lite config. YaRN stays
    off: the window is the original 4096 positions."""
    base = dict(
        dim=2048, hidden_dim=10944, n_layers=n_layers, n_heads=16,
        vocab_size=102400, max_seq_len=4096, rope_theta=10000.0,
        norm_eps=1e-6, act=ActivationType.SILU, first_k_dense_replace=1,
        n_shared_experts=2, n_routed_experts=64, n_active_routed=6,
        moe_intermediate_size=1408, routed_scaling_factor=1.0, n_group=1,
        norm_topk_prob=False, scoring_func=ScoringFunc.SOFTMAX,
        topk_group=1, topk_method=TopKMethod.GREEDY, has_moegate_bias=False,
        use_mla=False, kv_lora_rank=512, q_lora_rank=0,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        weight_quant=QuantKind.F16, rs_factor=40.0, rs_mscale=0.707,
        rs_mscale_all_dim=0.707, rs_original_max_position_embeddings=4096,
        arch="DeepseekV2ForCausalLM",
        compute_dtype="bfloat16", kv_cache_dtype="bfloat16",
    )
    base.update(overrides)
    return ModelConfig(**base)


def random_plain_params(cfg: ModelConfig, dtype=torch.float16, seed: int = 7,
                        device="cuda") -> ModelParams:
    """Random plain-weight (``dtype`` f16/bf16/f32) decompressed-MHA model
    without a query LoRA (DeepSeek-V2-Lite's layout), as
    ``loader.fuse_projections`` leaves a plain checkpoint: ``wq``,
    ``wkv_a``, ``wkv_b`` and ``wo``, the dense FFN as w13/w2, the shared
    experts folded into w13s/w2s. Weights are normal(0, 0.02) blocks from
    a seeded generator on the device; an expert table repeats one block
    across its experts."""
    if cfg.use_mla or cfg.q_lora_rank > 0:
        raise ValueError("random_plain_params builds MHA models without a "
                         "query LoRA (use_mla=False, q_lora_rank=0)")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def w(*shape):
        *lead, rows, cols = shape
        blk = (torch.randn((rows, cols), generator=gen, device=device) * 0.02).to(dtype)
        return PlainTensor(data=blk if not lead else
                           blk.expand(*lead, rows, cols).contiguous())

    def ones(n):
        return torch.ones(n, device=device)

    c = cfg
    H, P, Dv, R = c.n_heads, c.qk_rope_head_dim, c.v_head_dim, c.kv_lora_rank
    E, m, ns = c.n_routed_experts, c.moe_intermediate_size, c.n_shared_experts
    layers = []
    for l in range(c.n_layers):
        moe = c.is_moe_layer(l)
        layers.append(LayerParams(
            attn_norm=ones(c.dim), ffn_norm=ones(c.dim), kv_a_norm=ones(R),
            wq=w(H * c.head_dim, c.dim), wkv_a=w(R + P, c.dim),
            wkv_b=w(H * (c.qk_nope_head_dim + Dv), R), wo=w(c.dim, H * Dv),
            w13=None if moe else w(2 * c.hidden_dim, c.dim),
            w2=None if moe else w(c.dim, c.hidden_dim),
            moegate=(torch.randn((E, c.dim), generator=gen, device=device) * 0.02
                     if moe else None),
            moegate_bias=(torch.zeros(E, device=device)
                          if moe and c.has_moegate_bias else None),
            w13s=w(E + ns, 2 * m, c.dim) if moe else None,
            w2s=w(E + ns, c.dim, m) if moe else None,
        ))
    return ModelParams(embed=w(c.vocab_size, c.dim), layers=layers,
                       final_norm=ones(c.dim), lm_head=w(c.vocab_size, c.dim))


def random_fp8_params(cfg: ModelConfig, seed: int = 7, device="cuda") -> ModelParams:
    """Random blockwise F8E5M2 model with the tensors the converter writes
    for ``cfg`` (``deepseek_tpu/convert.py``: MHA ``wq`` or ``wq_a``/
    ``wq_b``, or absorbed MLA with the factor weights kept; every
    projection, the embedding and the lm_head in fp8 with ceil-sized
    ``cfg.block_size`` grids, partial at a ragged edge such as V2-Lite's
    576-row ``wkv_a`` or 10944-wide dense FFN), each layer fused by
    ``loader.fuse_layer`` as ``Engine`` loads it. Values are normal(0, 1)
    drawn in bf16 and cast to e5m2 (random bytes would hit its inf/NaN
    codes), scales uniform in [0.005, 0.02]; an expert table repeats one
    block and its grid across its experts."""
    if tuple(cfg.block_size) == (0, 0):
        raise ValueError("random_fp8_params builds blockwise models: "
                         "cfg.block_size must be set")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    b0, b1 = cfg.block_size

    def w(*shape):
        *lead, rows, cols = shape
        data = torch.randn((rows, cols), generator=gen, device=device) \
            .to(torch.bfloat16).to(torch.float8_e5m2).view(torch.uint8)
        sc = torch.rand((-(-rows // b0), -(-cols // b1)), generator=gen,
                        device=device) * 0.015 + 0.005
        if lead:
            data = data.expand(*lead, rows, cols).contiguous()
            sc = sc.expand(*lead, *sc.shape).contiguous()
        return Fp8Tensor(data=data.view(torch.float8_e5m2), scale=sc,
                         block_size=(b0, b1))

    def ones(n):
        return torch.ones(n, device=device)

    c = cfg
    H, P, Dv, R = c.n_heads, c.qk_rope_head_dim, c.v_head_dim, c.kv_lora_rank
    E, m, ns, ql = c.n_routed_experts, c.moe_intermediate_size, c.n_shared_experts, c.q_lora_rank
    hd, kvb = H * c.head_dim, H * (c.qk_nope_head_dim + Dv)
    layers = []
    for l in range(c.n_layers):
        moe = c.is_moe_layer(l)
        attn = dict(wkv_a=w(R + P, c.dim), wo=w(c.dim, H * Dv), wkv_b=w(kvb, R))
        if c.use_mla:
            attn.update(wq_a=w(ql, c.dim), wc=w(H * R, ql), wq_rope_b=w(H * P, ql),
                        wv_b=w(H * Dv, R), wq_b=w(hd, ql))
        elif ql > 0:
            attn.update(wq_a=w(ql, c.dim), wq_b=w(hd, ql))
        else:
            attn.update(wq=w(hd, c.dim))
        ffn = (dict(w1=w(E, m, c.dim), w3=w(E, m, c.dim), w2=w(E, c.dim, m),
                    shared_w1=w(ns * m, c.dim), shared_w3=w(ns * m, c.dim),
                    shared_w2=w(c.dim, ns * m),
                    moegate=torch.randn((E, c.dim), generator=gen, device=device) * 0.02,
                    moegate_bias=(torch.zeros(E, device=device)
                                  if c.has_moegate_bias else None))
               if moe else dict(w1=w(c.hidden_dim, c.dim), w3=w(c.hidden_dim, c.dim),
                                w2=w(c.dim, c.hidden_dim)))
        layers.append(fuse_layer(LayerParams(
            attn_norm=ones(c.dim), ffn_norm=ones(c.dim), kv_a_norm=ones(R),
            q_a_norm=ones(ql) if ql > 0 else None, **attn, **ffn), c))
    return ModelParams(embed=w(c.vocab_size, c.dim), layers=layers,
                       final_norm=ones(c.dim), lm_head=w(c.vocab_size, c.dim))


def random_fused_params(cfg: ModelConfig, quant: str, seed: int = 7,
                        device="cuda", factors: bool = False,
                        rowperm: bool = False, mtp: bool = False) -> ModelParams:
    """Random model in the fused decode layout (wkvq, wcr, w13) with
    nibble planes (``quant`` q3_k_nibble | q2_k_nibble: the shared experts
    folded into w13s/w2s), packed planes (q3_k | q2_k: the ranges of the
    JAX ``_direct_qtensor``, random bytes for qs/sm/hm, sc in [-32, 32),
    d and dmin in [0.001, 0.01]; the shared experts stay shared_w13 /
    shared_w2, as ``loader.fuse_projections`` leaves a packed checkpoint)
    or those packed draws converted on the device to the turbo layout
    (q3_k_turbo | q2_k_turbo, as the JAX ``_random_qtensor``; Q2_K turbo
    folds the shared experts into w13s/w2s, as fusing its checkpoint does,
    Q3_K turbo keeps them apart like packed). Each 2-D block is drawn,
    converted, then repeated across its experts.
    The embedding is bf16, the lm_head quantized. ``factors`` also gives
    each layer the factor weights wq_b (H*head_dim, q_lora) and wkv_b
    (H*(nope+v), kv_lora) that every converted MLA checkpoint keeps, so
    prefill attends in decompressed head space (K9); without them it runs
    the absorbed prefill (K10). ``rowperm`` gives the nibble expert
    [w1;w3] tables the row-permuted layout of ``DSEEK_FUSED_FFN=1``
    (``loader.rowperm_expert_w13`` applied to the drawn planes, a real
    permutation: the model computes what the one drawn without it does).
    ``mtp`` adds a random multi-token-prediction layer (``ModelParams.mtp``:
    the norms, an ``eh_proj`` (dim, 2*dim) and one MoE block drawn like the
    others), drawn after the main model so that the main weights do not
    depend on it."""
    kinds = ("q3_k_nibble", "q2_k_nibble", "q3_k", "q2_k", "q3_k_turbo", "q2_k_turbo")
    if quant not in kinds:
        raise ValueError(f"quant must be one of {kinds}, not {quant}")
    turbo = quant.endswith("_turbo")
    quant = quant[:-len("_turbo")] if turbo else quant
    packed = quant in ("q3_k", "q2_k")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def uniform(shape, lo, hi, dtype):
        t = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        return (t * (hi - lo) + lo).to(dtype)

    def tile(blk, lead):
        return blk if not lead else blk.expand(*lead, *blk.shape).contiguous()

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=device,
                             dtype=torch.uint8)

    def qt(*shape):
        *lead, rows, cols = shape
        if cols % 256:
            raise ValueError(f"K-quant planes need cols % 256 == 0, got {cols}")
        if packed:
            qs = u8(rows, cols // 4)
            d = uniform((rows, cols // 256), 0.001, 0.01, torch.float32)
            if quant == "q2_k":
                sm = u8(rows, cols // 16)
                dmin = uniform((rows, cols // 256), 0.001, 0.01, torch.float32)
                blk = Q2KTensor(qs=qs, sm=sm, d=d, dmin=dmin)
                blk = q2k_to_turbo(blk) if turbo else blk
            else:
                hm = u8(rows, cols // 8)
                sc = torch.randint(-32, 32, (rows, cols // 16), generator=gen,
                                   device=device, dtype=torch.int8)
                blk = Q3KTensor(qs=qs, hm=hm, sc=sc, d=d)
                blk = q3k_to_turbo(blk) if turbo else blk
            return blk.map(lambda t: tile(t, lead))
        p = torch.randint(0, 256, (rows, cols // 2), generator=gen,
                          device=device, dtype=torch.uint8)
        a = uniform((rows, cols // 16), 0.001, 0.01, torch.bfloat16)
        if quant == "q2_k_nibble":
            c = uniform((rows, cols // 16), 0.0005, 0.005, torch.bfloat16)
            return KNibbleTensor(p=tile(p, lead), a=tile(a, lead),
                                 c=tile(c, lead), off=0)
        return KNibbleTensor(p=tile(p, lead), a=tile(a, lead), c=None, off=4)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    def ones(n):
        return torch.ones(n, device=device)

    def moe_ffn(E, m, ns):
        if packed and not (turbo and quant == "q2_k"):
            return dict(w13=qt(E, 2 * m, c.dim), w2=qt(E, c.dim, m),
                        shared_w13=qt(2 * ns * m, c.dim), shared_w2=qt(c.dim, ns * m))
        return dict(w13s=qt(E + ns, 2 * m, c.dim), w2s=qt(E + ns, c.dim, m))

    def layer(moe: bool) -> LayerParams:
        return LayerParams(
            attn_norm=ones(c.dim), ffn_norm=ones(c.dim), kv_a_norm=ones(R),
            q_a_norm=ones(c.q_lora_rank),
            wo=qt(c.dim, H * Dv), wv_b=qt(H * Dv, R),
            wcr=qt(H * P + H * R, c.q_lora_rank),
            wkvq=qt(R + P + c.q_lora_rank, c.dim),
            moegate=normal(E, c.dim) if moe else None,
            moegate_bias=(torch.zeros(E, device=device)
                          if moe and c.has_moegate_bias else None),
            **(moe_ffn(E, m, ns) if moe else
               dict(w13=qt(2 * c.hidden_dim, c.dim), w2=qt(c.dim, c.hidden_dim))),
            wq_b=qt(H * c.head_dim, c.q_lora_rank) if factors else None,
            wkv_b=qt(H * (c.qk_nope_head_dim + Dv), R) if factors else None,
        )

    c = cfg
    H, P, Dv, R = c.n_heads, c.qk_rope_head_dim, c.v_head_dim, c.kv_lora_rank
    E, m, ns = c.n_routed_experts, c.moe_intermediate_size, c.n_shared_experts
    layers = [layer(c.is_moe_layer(l)) for l in range(c.n_layers)]
    params = ModelParams(
        embed=PlainTensor(data=normal(c.vocab_size, c.dim).to(torch.bfloat16)),
        layers=layers, final_norm=ones(c.dim),
        lm_head=qt(c.vocab_size, c.dim))
    if mtp:
        params.mtp = MTPParams(enorm=ones(c.dim), hnorm=ones(c.dim),
                               eh_proj=qt(c.dim, 2 * c.dim),
                               block=layer(c.n_routed_experts > 0),
                               final_norm=ones(c.dim))
    return rowperm_expert_w13(params, cfg) if rowperm else params
