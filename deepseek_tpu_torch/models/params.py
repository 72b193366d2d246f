"""Model parameters: plain dataclasses of tensors and weight tensors.

The counterparts of ``deepseek_tpu/models/params.py`` with the same field
names, so ``loader.params_from_reference`` maps the JAX package's params
field by field. Which attention and FFN branch a layer takes follows from
which fields are set (the fused pairs are built by loader.fuse_projections).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from deepseek_tpu_torch.quant.qtensor import (
    PACKED, TURBO, Fp8Tensor, KNibbleTensor, PlainTensor,
)

QT = Any  # PlainTensor, Fp8Tensor, Q2KTensor, Q3KTensor, their turbo
          # forms (Q2KTurboTensor, Q3KTurboTensor) or KNibbleTensor


@dataclasses.dataclass
class LayerParams:
    # norms (float32)
    attn_norm: torch.Tensor          # (dim,)
    ffn_norm: torch.Tensor           # (dim,)
    kv_a_norm: torch.Tensor          # (kv_lora_rank,)
    q_a_norm: Optional[torch.Tensor] = None   # (q_lora_rank,)

    # attention projections (checkpoint layout: (out, in))
    wkv_a: QT = None                 # (kv_lora_rank + qk_rope_head_dim, dim)
    wo: QT = None                    # (dim, n_heads * v_head_dim)
    wq: QT = None                    # (n_heads * head_dim, dim) — MHA, no q LoRA
    wq_a: QT = None                  # (q_lora_rank, dim)
    wq_b: QT = None                  # (n_heads * head_dim, q_lora_rank) — MHA, MLA prefill
    wkv_b: QT = None                 # (n_heads * (nope + v), kv_lora_rank) — MHA, MLA prefill
    wc: QT = None                    # (n_heads * kv_lora_rank, q_lora_rank)
    wq_rope_b: QT = None             # (n_heads * qk_rope_head_dim, q_lora_rank)
    wv_b: QT = None                  # (n_heads * v_head_dim, kv_lora_rank)

    # FFN: dense (hidden, dim) or routed experts (E, moe_inter, dim)
    w1: QT = None
    w2: QT = None
    w3: QT = None
    shared_w1: QT = None             # (n_shared * moe_inter, dim)
    shared_w2: QT = None
    shared_w3: QT = None
    moegate: Optional[torch.Tensor] = None        # (E, dim) f32
    moegate_bias: Optional[torch.Tensor] = None   # (E,) f32

    # fused pairs (loader.fuse_projections); the parts are None when set
    w13: QT = None                   # [w1; w3] rows
    shared_w13: QT = None            # [shared_w1; shared_w3]
    wcr: QT = None                   # [wq_rope_b; wc]
    wkvq: QT = None                  # [wkv_a; wq_a]
    # shared experts folded into the routed tables as always-on slots
    w13s: QT = None                  # (E + n_shared, 2m, dim)
    w2s: QT = None                   # (E + n_shared, dim, m)


@dataclasses.dataclass
class MTPParams:
    """DeepSeek-V3's multi-token-prediction layer (the checkpoint's extra
    layer): predicts token t+2 from the main model's final hidden state at
    t and the embedding of token t+1 (models/mtp.py). The output head is
    the main model's lm_head."""

    enorm: torch.Tensor              # (dim,) norm on the next token's embedding
    hnorm: torch.Tensor              # (dim,) norm on the main hidden state
    eh_proj: QT                      # (dim, 2*dim) over [embedding; hidden]
    block: LayerParams               # one transformer block, its own KV cache
    final_norm: torch.Tensor         # (dim,) shared_head.norm


@dataclasses.dataclass
class ModelParams:
    embed: QT                        # (vocab_size, dim)
    layers: List[LayerParams]
    final_norm: torch.Tensor         # (dim,)
    lm_head: QT                      # (vocab_size, dim); tied checkpoints reuse embed
    mtp: Optional[MTPParams] = None


def embed_lookup(qt, tokens: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Gather + dequantize embedding rows (reference _copy_embedding,
    infer.cpp:1217-1263). tokens (...,) int -> (..., dim)."""
    if isinstance(qt, PlainTensor):
        return qt.data[tokens].to(dtype)
    if isinstance(qt, Fp8Tensor):
        return qt.gather_rows(tokens).dequant(dtype)
    if isinstance(qt, (*PACKED, *TURBO, KNibbleTensor)):
        return qt.map(lambda t: t[tokens]).dequant(dtype)
    raise TypeError(f"unsupported embedding tensor {type(qt).__name__}")
