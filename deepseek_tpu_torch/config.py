"""Normalized model configuration (the port's own copy of
``deepseek_tpu/config.py``; the field set is identical so a checkpoint's
metadata means the same to both packages).

Mirrors the semantics of the reference's ``Config::from_yalm``
(``src/model.cpp:22-127`` of the C++ system): every value in the ``.dseek`` metadata
is stored as a *string*; defaults and enum mappings below replicate the
reference so both engines interpret the same checkpoint identically.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class ActivationType(str, enum.Enum):
    GELU = "gelu"
    SILU = "silu"


class TopKMethod(str, enum.Enum):
    GREEDY = "greedy"
    GROUP_LIMITED_GREEDY = "group_limited_greedy"
    # Implemented here (the reference downgrades it to group_limited_greedy;
    # convert.py:110-111, infer.cpp:589-591).
    NOAUX_TC = "noaux_tc"


class ScoringFunc(str, enum.Enum):
    SOFTMAX = "softmax"
    SIGMOID = "sigmoid"


class QuantKind(str, enum.Enum):
    """Weight quantization scheme of the checkpoint (metadata key ``quant``)."""

    F32 = "fp32"
    F16 = "fp16"
    F8E5M2 = "f8e5m2"
    Q2_K = "q2_k"
    Q3_K = "q3_k"


# Number of StreamingLLM attention-sink slots kept at the front of the KV ring
# buffer (reference: model.h:14).
KV_SINKS = 2


def _geti(md: dict, key: str, default: Optional[int] = None) -> int:
    if key in md:
        return int(md[key])
    if default is None:
        raise KeyError(f"missing required metadata key: {key}")
    return default


def _getf(md: dict, key: str, default: Optional[float] = None) -> float:
    if key in md:
        return float(md[key])
    if default is None:
        raise KeyError(f"missing required metadata key: {key}")
    return default


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    dim: int                    # transformer input & output dimension
    hidden_dim: int             # FFN hidden dim (dense blocks only)
    n_layers: int
    n_heads: int
    vocab_size: int
    max_seq_len: int
    rope_theta: float
    norm_eps: float
    act: ActivationType
    first_k_dense_replace: int  # how many leading blocks keep the dense FFN

    # mixture of experts
    n_shared_experts: int
    n_routed_experts: int
    n_active_routed: int
    moe_intermediate_size: int
    routed_scaling_factor: float
    n_group: int
    norm_topk_prob: bool
    scoring_func: ScoringFunc
    topk_group: int
    topk_method: TopKMethod
    has_moegate_bias: bool      # V3 e-score correction bias present

    # multi-latent attention
    use_mla: bool               # absorbed latent path (vs decompressed MHA path)
    kv_lora_rank: int
    q_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    # weight quantization
    weight_quant: QuantKind
    # blockwise scale grid for F8E5M2; (0, 0) means per-tensor scale
    block_size: Tuple[int, int] = (0, 0)

    # RoPE / YaRN scaling params (parsed + stored; like the reference, plain
    # theta rope is applied — sinks-not-yarn, README.md:93)
    rs_beta_fast: int = 32
    rs_beta_slow: int = 1
    rs_factor: float = 1.0
    rs_mscale: float = 1.0
    rs_mscale_all_dim: float = 1.0
    rs_original_max_position_embeddings: int = 4096

    arch: str = "DeepseekV2ForCausalLM"

    # --- runtime knobs (not part of checkpoint metadata); kernel_impl is
    # kept for the JAX package's field set and is not read by the port ---
    # dtype activations are computed in ("float32" or "bfloat16")
    compute_dtype: str = "float32"
    # dtype the KV cache is stored in (reference stores f16)
    kv_cache_dtype: str = "float16"
    # compute-kernel selection: "auto" uses the Pallas fused-dequant /
    # expert-gather kernels on TPU and the XLA dequant path elsewhere;
    # "xla" / "pallas" force a path (pallas off-TPU runs interpreted — tests)
    kernel_impl: str = "auto"
    # apply YaRN rope scaling (the reference parses but never applies it —
    # "sinks rather than yarn", README.md:93; opt-in quality improvement)
    use_yarn: bool = False
    # expert-parallel prefill capacity factor: each EP shard computes only
    # its OWNED token-expert pairs, compacted into a buffer of
    # ceil(cf * N / EP) rows (N = B*T*k pairs) — per-shard MoE FLOPs scale
    # ~cf*k/EP instead of k. Routing skew past the capacity raises the
    # overflow count returned by the prefill forward; callers retry that
    # chunk with the exact path (0 disables the capacity, always exact).
    ep_capacity_factor: float = 2.0

    @property
    def head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def kv_window(self) -> int:
        """Size of the ring-buffer KV cache.

        The reference windows at ``rs_original_max_position_embeddings``
        (NOT max_seq_len) — infer.cpp:1271-1277.
        """
        return min(self.max_seq_len, self.rs_original_max_position_embeddings) \
            if self.max_seq_len > 0 else self.rs_original_max_position_embeddings

    def yarn_params(self):
        """YarnParams when use_yarn is set and the checkpoint scales."""
        if not self.use_yarn or self.rs_factor <= 1.0:
            return None
        from deepseek_tpu_torch.ops.rope import YarnParams
        return YarnParams(
            factor=self.rs_factor, beta_fast=self.rs_beta_fast,
            beta_slow=self.rs_beta_slow, mscale=self.rs_mscale,
            mscale_all_dim=self.rs_mscale_all_dim,
            original_max_position=self.rs_original_max_position_embeddings)

    def attn_softmax_scale(self) -> float:
        """1/sqrt(head_dim), with the YaRN mscale^2 correction when active."""
        import math
        from deepseek_tpu_torch.ops.rope import yarn_attention_mscale
        scale = 1.0 / math.sqrt(self.head_dim)
        yp = self.yarn_params()
        if yp is not None:
            scale = scale * yarn_attention_mscale(yp)
        return scale

    def is_moe_layer(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace and self.n_routed_experts > 0

    @classmethod
    def from_metadata(cls, md: dict, context: int = 0, **overrides) -> "ModelConfig":
        """Build a config from `.dseek` string-valued metadata.

        ``context`` (the CLI ``-T`` flag) caps ``max_seq_len`` when nonzero,
        matching model.cpp:69-72.
        """
        scoring = md.get("scoring_func", "softmax")
        try:
            scoring_func = ScoringFunc(scoring)
        except ValueError:
            scoring_func = ScoringFunc.SOFTMAX

        topk = md.get("topk_method", "greedy")
        try:
            topk_method = TopKMethod(topk)
        except ValueError:
            topk_method = TopKMethod.GREEDY

        act_str = md.get("act_type", "gelu")
        try:
            act = ActivationType(act_str)
        except ValueError:
            act = ActivationType.GELU

        max_seq_len = _geti(md, "max_seq_len")
        if context:
            max_seq_len = min(max_seq_len, context)

        quant = QuantKind(md["quant"])
        block_size = (0, 0)
        if "quantization_block_size_0" in md:
            block_size = (
                int(md["quantization_block_size_0"]),
                int(md["quantization_block_size_1"]),
            )

        arch = md.get("arch", "DeepseekV2ForCausalLM")

        cfg = cls(
            dim=_geti(md, "dim"),
            hidden_dim=_geti(md, "hidden_dim"),
            n_layers=_geti(md, "n_layers"),
            n_heads=_geti(md, "n_heads"),
            vocab_size=_geti(md, "vocab_size"),
            max_seq_len=max_seq_len,
            rope_theta=_getf(md, "rope_theta"),
            norm_eps=_getf(md, "norm_eps", 1e-5),
            act=act,
            first_k_dense_replace=_geti(md, "first_k_dense_replace", 0),
            n_shared_experts=_geti(md, "n_shared_experts", 0),
            n_routed_experts=_geti(md, "n_routed_experts", 0),
            n_active_routed=_geti(md, "n_active_routed", 0),
            moe_intermediate_size=_geti(md, "moe_intermediate_size", 0),
            routed_scaling_factor=_getf(md, "routed_scaling_factor", 1.0),
            n_group=_geti(md, "n_group", 1),
            norm_topk_prob=md.get("norm_topk_prob", "False") == "True",
            scoring_func=scoring_func,
            topk_group=_geti(md, "topk_group", 0),
            topk_method=topk_method,
            has_moegate_bias=(arch == "DeepseekV3ForCausalLM"),
            use_mla=bool(_geti(md, "use_mla", 0)),
            kv_lora_rank=_geti(md, "kv_lora_rank", 0),
            q_lora_rank=_geti(md, "q_lora_rank", 0),
            qk_nope_head_dim=_geti(md, "qk_nope_head_dim", 0),
            qk_rope_head_dim=_geti(md, "qk_rope_head_dim", 0),
            v_head_dim=_geti(md, "v_head_dim", 0),
            weight_quant=quant,
            block_size=block_size,
            rs_beta_fast=_geti(md, "rope_scaling_beta_fast", 32),
            rs_beta_slow=_geti(md, "rope_scaling_beta_slow", 1),
            rs_factor=_getf(md, "rope_scaling_factor", 1.0),
            rs_mscale=_getf(md, "rope_scaling_mscale", 1.0),
            rs_mscale_all_dim=_getf(md, "rope_scaling_mscale_all_dim", 1.0),
            rs_original_max_position_embeddings=_geti(
                md, "rope_scaling_original_max_position_embeddings", 4096),
            arch=arch,
        )
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return cfg

    def to_metadata(self) -> dict:
        """Serialize to the string-valued metadata dict written into shard 0."""
        md = {
            "arch": self.arch,
            "use_mla": str(int(self.use_mla)),
            "quant": self.weight_quant.value,
            "dim": str(self.dim),
            "hidden_dim": str(self.hidden_dim),
            "n_layers": str(self.n_layers),
            "n_heads": str(self.n_heads),
            "vocab_size": str(self.vocab_size),
            "max_seq_len": str(self.max_seq_len),
            "rope_theta": str(self.rope_theta),
            "norm_eps": str(self.norm_eps),
            "norm_type": "rmsnorm",
            "act_type": self.act.value,
            "first_k_dense_replace": str(self.first_k_dense_replace),
            "kv_lora_rank": str(self.kv_lora_rank),
            "q_lora_rank": str(self.q_lora_rank),
            "qk_nope_head_dim": str(self.qk_nope_head_dim),
            "qk_rope_head_dim": str(self.qk_rope_head_dim),
            "v_head_dim": str(self.v_head_dim),
            "n_shared_experts": str(self.n_shared_experts),
            "n_routed_experts": str(self.n_routed_experts),
            "n_active_routed": str(self.n_active_routed),
            "moe_intermediate_size": str(self.moe_intermediate_size),
            "routed_scaling_factor": str(self.routed_scaling_factor),
            "n_group": str(self.n_group),
            "norm_topk_prob": "True" if self.norm_topk_prob else "False",
            "scoring_func": self.scoring_func.value,
            "topk_group": str(self.topk_group),
            "topk_method": self.topk_method.value,
            "rope_scaling_beta_fast": str(self.rs_beta_fast),
            "rope_scaling_beta_slow": str(self.rs_beta_slow),
            "rope_scaling_factor": str(self.rs_factor),
            "rope_scaling_mscale": str(self.rs_mscale),
            "rope_scaling_mscale_all_dim": str(self.rs_mscale_all_dim),
            "rope_scaling_original_max_position_embeddings":
                str(self.rs_original_max_position_embeddings),
        }
        if self.block_size != (0, 0):
            md["quantization_block_size_0"] = str(self.block_size[0])
            md["quantization_block_size_1"] = str(self.block_size[1])
        return md
