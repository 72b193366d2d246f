"""Placement of the parameters and the KV cache on a mesh
(``deepseek_tpu/parallel/sharding.py``, the ``seq`` entries of
``cache_shardings`` and ``shard_params``).

At a ``seq``-only mesh every rank holds the whole model and one slice of
the window: the cache fields that carry the window (rows and their int8
scales) are sliced to this rank's ``window / seq`` slots, the int8 sink
masters (``sink_krope``, ``sink_k``) stay whole on every rank, as JAX
replicates them.
"""

from __future__ import annotations

import dataclasses

import torch

from deepseek_tpu_torch.config import ModelConfig
from deepseek_tpu_torch.models.kvcache import KVCache
from deepseek_tpu_torch.models.params import ModelParams

# KVCache fields whose axis 2 is the window (L, B, S, ...)
WINDOW_FIELDS = ("k", "v", "ckv", "krope", "k_s", "v_s", "ckv_s", "krope_s")


def shard_cache(cache: KVCache, cfg: ModelConfig, mesh) -> KVCache:
    """This rank's slice of ``cache`` (as ``init_cache`` builds it): slots
    [seq_index * S/seq, (seq_index + 1) * S/seq) of every window field, the
    sink masters whole; new tensors on the cache's device."""
    if mesh.seq <= 1:
        return cache
    s = cfg.kv_window // mesh.seq
    lo = mesh.seq_index * s
    out = {}
    for f in dataclasses.fields(cache):
        t = getattr(cache, f.name)
        if t is not None:
            t = t[:, :, lo:lo + s] if f.name in WINDOW_FIELDS else t
            t = t.clone(memory_format=torch.contiguous_format)
        out[f.name] = t
    return KVCache(**out)


def shard_params(params: ModelParams, cfg: ModelConfig, mesh) -> ModelParams:
    """At a ``seq``-only mesh the parameters are replicated: every rank
    holds them whole, as it built or loaded them on its device."""
    return params
