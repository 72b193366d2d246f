"""The work a step needs, counted from the configuration's shapes and the
tokens it processed, whatever kernels the program runs: the benchmark's
frozen copy of what ``models/loader.py::params_active_bytes`` counts, per
step, with the routed experts the step's tokens actually chose.

Bytes: every weight a step reads once (attention, dense FFN, shared
experts, router, lm_head where the step computes logits), each distinct
routed expert's tables once, the embedding rows, and the cached KV rows at
the lengths attended. Stored sizes: Q3_K 110 bytes per 256 weights, F8E5M2 one
byte a weight plus an f32 scale per block, the router f32, the cache float16.

Flops: 2 per multiply-add of every product the tokens need (each token's
k routed experts and the shared ones), and attention's scores and weighted
sums at the attended lengths (causal within a chunk).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from gpubench import draw

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

_CACHE_BYTES = {"float16": 2, "bfloat16": 2, "float32": 4, "int8": 1}


def bytes_per_weight(run: dict) -> float:
    if run["quant"] == "q3_k":
        return 110.0 / 256.0
    if run["quant"] == "f8e5m2":
        b0, b1 = run["block_size"]
        return 1.0 + 4.0 / (b0 * b1)
    raise ValueError(f"unsupported weight format {run['quant']!r}")


def _count(specs) -> int:
    n = 0
    for w in specs:
        lead = 1
        for e in w.lead:
            lead *= e
        n += lead * w.rows * w.cols
    return n


@dataclasses.dataclass(frozen=True)
class Shapes:
    """Per-layer weight counts of a configuration."""
    n_layers: int
    moe_layers: tuple
    bpw: float
    attn: Sequence[int]          # attention weights, by layer
    dense: Sequence[int]         # dense-FFN (or shared-expert) weights, by layer
    expert: int                  # one routed expert's weights
    router: int                  # router weights of a MoE layer (f32)
    k: int                       # routed experts a token
    dim: int
    vocab: int
    kv_row_bytes: int            # one cached position of one layer
    attn_flops_per_kv: int       # flops a query spends on one attended row
    cache_bytes: int

    @classmethod
    def of(cls, spec: dict) -> "Shapes":
        run, hf = spec["run"], spec
        L = hf["num_hidden_layers"]
        moe = tuple(l for l in range(L) if draw.is_moe(hf, l))
        attn = [_count(draw.attention_weights(hf, run, l)) for l in range(L)]
        dense, expert = [], 0
        for l in range(L):
            f = draw.ffn_weights(hf, l)
            if l in moe:
                dense.append(_count([w for w in f if w.name.split(".")[1].startswith("shared")]))
                expert = _count([w for w in f if not w.lead == ()]) // hf["n_routed_experts"]
            else:
                dense.append(_count(f))
        H, R, P = hf["num_attention_heads"], hf["kv_lora_rank"], hf["qk_rope_head_dim"]
        nope, Dv = hf["qk_nope_head_dim"], hf["v_head_dim"]
        cb = _CACHE_BYTES[run["kv_cache_dtype"]]
        if run["use_mla"]:
            row, per_kv = (R + P) * cb, 2 * H * ((R + P) + R)
        else:
            row, per_kv = H * (nope + P + Dv) * cb, 2 * H * ((nope + P) + Dv)
        return cls(n_layers=L, moe_layers=moe, bpw=bytes_per_weight(run), attn=attn,
                   dense=dense, expert=expert,
                   router=hf.get("n_routed_experts", 0) * hf["hidden_size"],
                   k=hf.get("num_experts_per_tok", 0), dim=hf["hidden_size"],
                   vocab=hf["vocab_size"], kv_row_bytes=row, attn_flops_per_kv=per_kv,
                   cache_bytes=cb)


def step_work(sh: Shapes, tokens: int, kv_read: int, kv_pairs: int,
              distinct: Sequence[int], logit_rows: int):
    """(flops, bytes) of one forward step: ``tokens`` rows processed,
    ``kv_read`` cached positions read a layer (each read once), ``kv_pairs``
    (query, attended position) pairs a layer, ``distinct`` routed experts
    chosen in each MoE layer, ``logit_rows`` rows through the lm_head."""
    if tokens <= 0:
        return 0.0, 0.0
    w_all = sum(sh.attn) + sum(sh.dense)
    w_tok = w_all + len(sh.moe_layers) * sh.k * sh.expert
    flops = 2.0 * tokens * w_tok + 2.0 * tokens * sh.router * len(sh.moe_layers)
    flops += sh.n_layers * kv_pairs * sh.attn_flops_per_kv
    flops += 2.0 * logit_rows * sh.vocab * sh.dim
    byts = sh.bpw * (w_all + sh.expert * sum(distinct))
    byts += 4.0 * sh.router * len(sh.moe_layers)
    byts += sh.n_layers * kv_read * sh.kv_row_bytes
    byts += tokens * sh.dim * sh.bpw
    if logit_rows:
        byts += sh.bpw * sh.vocab * sh.dim
    return flops, byts


def least_seconds(flops: float, byts: float) -> float:
    """The least time the chip can take for a step: its flops at the peak
    rate or its bytes at the peak bandwidth, whichever is longer."""
    return max(flops / PEAK_FLOPS, byts / PEAK_BYTES)
