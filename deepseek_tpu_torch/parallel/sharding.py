"""Placement of the parameters and the KV cache on a mesh
(``deepseek_tpu/parallel/sharding.py``): each rank keeps only its slice.

Parameters (``shard_params``, the JAX rules of ``_layer_shardings``, on the
unfused layout: ``models/loader.py::unfuse_projections``):

- COL (out rows over ``tensor``): wq, wq_b, wkv_b, wc, wq_rope_b, wv_b,
  the dense and shared w1/w3, the lm_head (where the vocab divides the
  axis);
- ROW (in columns over ``tensor``): wo, the dense and shared w2;
- EXP (the expert axis over ``expert``): the routed w1/w2/w3;
- replicated: the norms, wq_a, wkv_a, the router and the embedding.

The MTP block follows the layer rules. A projection group shards as one:
the head projections with wo, w1/w3 with their w2. Every field of a
weight is cut at one boundary (``quant/qtensor.py::slice_qt``), which must
fall on the weight's block (128 for blockwise fp8, the 256-column
superblock for K-quant); where one member of a group cannot be cut there,
the whole group stays whole on every rank and the forward skips its
all-reduce (it reads the split from the weights' shapes). So DeepSeek-
V2-Lite's blockwise-fp8 dense FFN (10944 hidden: 5472 a rank at
tensor=2, no multiple of 128) runs whole on both ranks. The head groups
split in every layer or in none, as the MHA cache's heads follow them.

Cache (``shard_cache``): every field's batch (axis 1) is cut to this
rank's rows over ``data`` where the batch divides the axis (the JAX
``_fit``: a one-row admission cache stays whole on every data rank); the
fields that carry the window (rows and their
int8 scales) are sliced to this rank's ``window / seq`` slots; the MHA
fields (k, v, k_s, v_s and the sink masters sink_k) to this rank's heads
where the heads split; the latent MLA cache stays whole on every tensor
rank, and the int8 sink masters whole along the window.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deepseek_tpu_torch.config import ModelConfig
from deepseek_tpu_torch.models.kvcache import KVCache
from deepseek_tpu_torch.models.params import LayerParams, ModelParams
from deepseek_tpu_torch.quant.qtensor import slice_qt

# KVCache fields whose axis 2 is the window (L, B, S, ...)
WINDOW_FIELDS = ("k", "v", "ckv", "krope", "k_s", "v_s", "ckv_s", "krope_s")
# MHA cache fields whose axis 3 is the heads
HEAD_FIELDS = ("k", "v", "k_s", "v_s", "sink_k")

COL, ROW, EXP = "rows", "cols", "experts"
HEAD_GROUP = {"wq": COL, "wq_b": COL, "wkv_b": COL, "wc": COL, "wq_rope_b": COL,
              "wv_b": COL, "wo": ROW}


def _part(qt, dim: str, n: int, i: int):
    """Part i of n of ``qt`` along ``dim``, or None where it does not cut."""
    if qt is None:
        return None
    size = qt.shape[{COL: -2, ROW: -1, EXP: 0}[dim]]
    if size % n:
        return None
    return slice_qt(qt, dim, i * (size // n), (i + 1) * (size // n))


def _group(lp: LayerParams, rules: dict, n: int, i: int) -> Optional[dict]:
    """The rank's parts of a projection group, or None (keep it whole)."""
    out = {}
    for name, dim in rules.items():
        qt = getattr(lp, name)
        if qt is not None:
            out[name] = _part(qt, dim, n, i)
            if out[name] is None:
                return None
    return out


def _shard_layer(lp: LayerParams, moe: bool, mesh, heads: Optional[dict]) -> LayerParams:
    """``heads``: this rank's head group, or None where the heads stay whole."""
    tp, ti = mesh.tensor, mesh.tensor_index
    rep = dict(heads or {})
    if tp > 1:
        rep.update(_group(lp, {"shared_w1": COL, "shared_w3": COL, "shared_w2": ROW},
                          tp, ti) or {})
        if not moe:
            rep.update(_group(lp, {"w1": COL, "w3": COL, "w2": ROW}, tp, ti) or {})
    if moe and mesh.expert > 1:
        rep.update(_group(lp, {"w1": EXP, "w2": EXP, "w3": EXP}, mesh.expert,
                          mesh.expert_index))
    return dataclasses.replace(lp, **rep)


def shard_params(params: ModelParams, cfg: ModelConfig, mesh) -> ModelParams:
    """This rank's parameters (new tensors on their device; drop the
    whole model afterwards to free it). At a seq-only mesh they are the
    parameters as given, replicated; over a tensor or expert axis the
    unfused layout (``unfuse_projections``) cut by the rules above."""
    if mesh.tensor == 1 and mesh.expert == 1:
        return params
    from deepseek_tpu_torch.models.loader import unfuse_projections

    params = unfuse_projections(params, cfg)
    mtp = params.mtp
    blocks = params.layers + ([mtp.block] if mtp is not None else [])
    # a cut that misses a block misses it on every rank (rank 0's cut ends
    # where rank 1's starts), so all ranks agree on what stays whole
    heads = [_group(lp, HEAD_GROUP, mesh.tensor, mesh.tensor_index)
             if mesh.tensor > 1 else None for lp in blocks]
    if any(h is None for h in heads):
        heads = [None] * len(blocks)
    moe = [cfg.is_moe_layer(l) for l in range(len(params.layers))]
    if mtp is not None:
        moe.append(mtp.block.moegate is not None)
    blocks = [_shard_layer(lp, m, mesh, h) for lp, m, h in zip(blocks, moe, heads)]
    layers = blocks[:len(params.layers)]
    if mtp is not None:
        mtp = dataclasses.replace(mtp, block=blocks[-1])
    lm_head = params.lm_head
    if mesh.tensor > 1 and cfg.vocab_size % mesh.tensor == 0:
        lm_head = _part(lm_head, COL, mesh.tensor, mesh.tensor_index) or lm_head
    return dataclasses.replace(params, layers=layers, mtp=mtp, lm_head=lm_head)


def shard_cache(cache: KVCache, cfg: ModelConfig, mesh,
                params: Optional[ModelParams] = None) -> KVCache:
    """This rank's slice of ``cache`` (as ``init_cache`` builds it): rows
    [data_index * B/data, (data_index + 1) * B/data) of every field where
    the data axis divides the batch B (else every row), slots
    [seq_index * S/seq, (seq_index + 1) * S/seq) of every window field, the
    sink masters whole along the window; an MHA cache that holds every
    head cut to this rank's heads as the head projections are (``params``:
    this rank's ``shard_params``; None takes them as cut), one made at the
    local head count (``init_cache(heads=)``) left as it is; new tensors
    on the cache's device."""
    s = cfg.kv_window // mesh.seq
    lo = mesh.seq_index * s
    heads = (mesh.tensor > 1 and cache.k is not None and cache.k.shape[3] == cfg.n_heads
             and (params is None
                  or params.layers[0].wo.shape[-1] < cfg.n_heads * cfg.v_head_dim))
    h = cfg.n_heads // mesh.tensor
    rows = mesh.data > 1 and cache.batch % mesh.data == 0
    b = cache.batch // mesh.data
    if mesh.seq <= 1 and not heads and not rows:
        return cache
    out = {}
    for f in dataclasses.fields(cache):
        t = getattr(cache, f.name)
        if t is not None:
            if rows:
                t = t[:, mesh.data_index * b:(mesh.data_index + 1) * b]
            if mesh.seq > 1 and f.name in WINDOW_FIELDS:
                t = t[:, :, lo:lo + s]
            if heads and f.name in HEAD_FIELDS:
                t = t[:, :, :, mesh.tensor_index * h:(mesh.tensor_index + 1) * h]
            t = t.clone(memory_format=torch.contiguous_format)
        out[f.name] = t
    return KVCache(**out)
