"""Pipeline parallelism: contiguous layer stages (``deepseek_tpu/parallel/
pipeline.py``).

Each stage owns a contiguous layer range: its slice of the weights and a
KV cache of its layers live on the stage's device, and the stage body runs
the range through ``models.deepseek.run_layer_stack`` under a stage-local
config (the dense/MoE boundary ``first_k_dense_replace`` shifted by the
range's first layer), stage 0 embedding the tokens and the last stage
applying the final norm and the lm_head (``final_logits``).

- Without ``mesh_shape`` one process runs every stage, each on its
  ``torch.device`` (stages may share one card); the activations hop with
  ``.to(device)`` where the JAX package uses ``jax.device_put``. The host
  enqueues the stages' work in order, so microbatches overlap across
  stages only where the stages sit on different cards with streams of
  their own: on one card the stages share one stream.
- With ``mesh_shape`` (``{"tensor": t}``, ``{"expert": e}`` or both) the
  pipeline runs SPMD over ``n_stages * t * e`` ranks (``make_mesh(...,
  stages=n)``), stage s on ranks [s * t * e, (s + 1) * t * e), each stage a
  tensor/expert mesh whose layers ``shard_params`` unfuses
  (``unfuse_projections``) and cuts (``pipeline.py:178-179, 203``), each
  rank keeping only its stage's; the collectives
  stay inside the stage. The activations leave a stage replicated, and
  rank i of stage s hands them to rank i of stage s + 1 over a two-rank
  subgroup of their own (a gloo all-reduce into the receiver's zeroed
  buffer, the route every collective of the port takes); the last stage's
  logits reach every rank over the line of stages, so every rank returns
  them, as the JAX single controller does.

``decode_microbatched`` splits the batch into microbatches whose caches
persist: the whole-batch cache of every stage is split once when the
microbatch count is first used and merged back only when a whole-batch
call follows (``_whole_batch``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from deepseek_tpu_torch.config import ModelConfig
from deepseek_tpu_torch.models.deepseek import (
    compute_dtype, decode_positions, final_logits, run_layer_stack,
)
from deepseek_tpu_torch.models.kvcache import KVCache, init_cache
from deepseek_tpu_torch.models.params import ModelParams, embed_lookup
from deepseek_tpu_torch.ops.matmul import decode_rows
from deepseek_tpu_torch.parallel.spmd import NULL_CTX, SpmdCtx, make_ctx


def stage_bounds(n_layers: int, n_stages: int) -> List[tuple]:
    """Contiguous [lo, hi) layer ranges, earlier stages one layer larger
    when n_layers % n_stages != 0 (stage 0 also runs the embedding)."""
    if not 1 <= n_stages <= n_layers:
        raise ValueError(f"{n_stages} stages over {n_layers} layers")
    base, rem = divmod(n_layers, n_stages)
    bounds, lo = [], 0
    for s in range(n_stages):
        hi = lo + base + (1 if s < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def stage_config(cfg: ModelConfig, lo: int, hi: int) -> ModelConfig:
    """The config of layers [lo, hi) indexed from 0: the dense/MoE boundary
    shifts with the range."""
    return dataclasses.replace(cfg, n_layers=hi - lo,
                               first_k_dense_replace=max(0, cfg.first_k_dense_replace - lo))


def to_device(obj, device):
    """A params tree (dataclasses, lists, tensors) on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, list):
        return [to_device(o, device) for o in obj]
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: to_device(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj)})
    return obj


@dataclasses.dataclass
class _Stage:
    device: torch.device
    lo: int
    hi: int
    cfg: ModelConfig                    # stage-local
    params: ModelParams
    cache: Optional[KVCache]            # whole-batch cache (None while microbatched)
    ctx: SpmdCtx = NULL_CTX
    mesh: Any = None
    mb_caches: Optional[List[KVCache]] = None   # persistent per-microbatch caches


class Pipeline:
    """Stage-sharded inference: ``prefill`` and ``decode_step`` run the
    whole batch straight through, ``decode_microbatched`` microbatch after
    microbatch through every stage."""

    def __init__(self, cfg: ModelConfig, params: ModelParams, n_stages: int,
                 batch: int = 1, devices: Optional[Sequence] = None,
                 mesh_shape: Optional[dict] = None):
        """``devices``: a stage's device each (default: the cards in turn),
        or with ``mesh_shape`` a rank's device each (default: the current
        card). ``mesh_shape`` (``{"tensor": 2}``, ``{"expert": 2,
        "tensor": 2}``): every stage a mesh of that shape, the pipeline made
        on every one of the ``n_stages * prod(mesh_shape)`` ranks of the
        process group (``parallel.mesh.init_distributed``), each keeping
        its stage's weights cut to its slice."""
        self.cfg, self.n_stages, self.batch = cfg, n_stages, batch
        bounds = stage_bounds(cfg.n_layers, n_stages)
        self.per_stage = 1
        if mesh_shape:
            if not set(mesh_shape) <= {"expert", "tensor"}:
                raise ValueError("per-stage meshes shard model axes; batch/seq stay "
                                 f"whole, not {sorted(mesh_shape)}")
            self.per_stage = int(np.prod(list(mesh_shape.values())))
        self.stages: List[Optional[_Stage]] = [None] * n_stages
        self.spmd = bool(mesh_shape)
        if not self.spmd:
            if devices is None:
                n = max(1, torch.cuda.device_count())
                devices = [f"cuda:{s % n}" for s in range(n_stages)]
            if len(devices) < n_stages:
                raise ValueError(f"{n_stages} stages need {n_stages} devices, "
                                 f"{len(devices)} given")
            for s, (lo, hi) in enumerate(bounds):
                dev = _device(devices[s])
                scfg = stage_config(cfg, lo, hi)
                sub = to_device(self._sub(params, s, lo, hi), dev)
                self.stages[s] = _Stage(dev, lo, hi, scfg, sub,
                                        init_cache(scfg, batch=batch, device=dev))
            self.stage = None
            return
        self._spmd_init(params, bounds, mesh_shape, devices)

    def _sub(self, params: ModelParams, s: int, lo: int, hi: int) -> ModelParams:
        last = s == self.n_stages - 1
        return ModelParams(embed=params.embed if s == 0 else None,
                           layers=list(params.layers[lo:hi]),
                           final_norm=params.final_norm if last else None,
                           lm_head=params.lm_head if last else None, mtp=None)

    def _spmd_init(self, params, bounds, mesh_shape, devices) -> None:
        from deepseek_tpu_torch.parallel.mesh import _TIMEOUT, make_mesh, settle_groups
        from deepseek_tpu_torch.parallel.sharding import shard_cache, shard_params

        n, per = self.n_stages, self.per_stage
        mesh = make_mesh(**mesh_shape, stages=n)
        rank = dist.get_rank()
        self.stage, self.pos = rank // per, rank % per
        # the hop subgroups (rank i of stage s, rank i of stage s + 1) and the
        # lines of stages, made on every rank in one order
        self._hops, self._line = {}, None
        for s in range(n - 1):
            for i in range(per):
                g = dist.new_group([s * per + i, (s + 1) * per + i], timeout=_TIMEOUT)
                if i == self.pos and self.stage in (s, s + 1):
                    self._hops[s] = g
        for i in range(per):
            g = (dist.new_group([s * per + i for s in range(n)], timeout=_TIMEOUT)
                 if n > 2 else None)
            if i == self.pos:
                self._line = g if n > 2 else self._hops.get(0)
        settle_groups()
        dev = _device(devices[rank] if devices is not None else "cuda")
        lo, hi = bounds[self.stage]
        scfg = stage_config(self.cfg, lo, hi)
        # fused projections are a one-device layout: shard_params cuts the
        # stage's layers unfused (unfuse_projections)
        sub = shard_params(to_device(self._sub(params, self.stage, lo, hi), dev), scfg,
                           mesh)
        cache = shard_cache(init_cache(scfg, batch=self.batch, device=dev), scfg, mesh, sub)
        self.stages[self.stage] = _Stage(dev, lo, hi, scfg, sub, cache,
                                         ctx=make_ctx(scfg, mesh), mesh=mesh)

    # ------------------------------------------------------------------
    def _body(self, st: _Stage, cache: KVCache, xin: torch.Tensor, pos0,
              prefill: bool, logits_mode: str, last: bool):
        """One stage over its layers: tokens (stage 0) or activations in,
        activations or (last stage) logits out."""
        scfg = st.cfg
        if st.params.embed is not None:
            B, T = xin.shape
            x = embed_lookup(st.params.embed, xin, torch.float32)
        else:
            B, T = xin.shape[:2]
            x = xin
        x = x.to(compute_dtype(scfg))
        # a decode step's rows compute the bits of the unstaged forward_decode
        with contextlib.nullcontext() if prefill else decode_rows(B):
            if prefill:
                x = run_layer_stack(st.params.layers, cache, x, pos0, None, None, None,
                                    scfg, st.ctx, prefill=True)
            else:
                pos, kv_pos, kv_len, kv_sink = decode_positions(scfg, B, pos0, x.device)
                x = run_layer_stack(st.params.layers, cache, x, pos, kv_pos, kv_len,
                                    kv_sink, scfg, st.ctx)
            if not last:
                return x
            if logits_mode == "none":
                return None
            return final_logits(st.params.final_norm, st.params.lm_head, x, scfg,
                                logits_mode, st.ctx)

    def _hop(self, s: int, x: Optional[torch.Tensor], shape, dtype) -> Optional[torch.Tensor]:
        """Stage s's activations to rank i of stage s + 1 (SPMD)."""
        if self.stage not in (s, s + 1):
            return None
        if self.stage == s + 1:
            x = torch.zeros(shape, dtype=dtype, device=self.stages[s + 1].device)
        x = x.contiguous()
        dist.all_reduce(x, group=self._hops[s])
        return x

    def _run(self, xin, pos0, prefill: bool, logits_mode: str,
             micro: Optional[int] = None):
        """One pass through every stage; ``micro`` picks a persistent
        microbatch cache instead of the whole-batch one."""
        x = torch.as_tensor(xin, dtype=torch.int64)
        B, T = x.shape[:2]
        dtype = compute_dtype(self.cfg)
        out = None
        for s in range(self.n_stages):
            st = self.stages[s]
            last = s == self.n_stages - 1
            if self.spmd and s > 0:
                x = self._hop(s - 1, x, (B, T, self.cfg.dim), dtype)
            if st is None:
                continue
            cache = st.cache if micro is None else st.mb_caches[micro]
            x = self._body(st, cache, x.to(st.device), pos0, prefill, logits_mode, last)
            out = x
        if self.spmd and logits_mode != "none":
            out = self._logits_to_all(out, B, T, logits_mode)
        return out

    def _logits_to_all(self, logits, B: int, T: int, logits_mode: str):
        """The last stage's logits to every rank (SPMD), over the line of
        stages."""
        if self.stage != self.n_stages - 1:
            shape = (B, self.cfg.vocab_size) if logits_mode == "last" else \
                (B, T, self.cfg.vocab_size)
            logits = torch.zeros(shape, dtype=torch.float32,
                                 device=self.stages[self.stage].device)
        logits = logits.float().contiguous()
        dist.all_reduce(logits, group=self._line)
        return logits

    def _local(self) -> List[_Stage]:
        return [st for st in self.stages if st is not None]

    def _whole_batch(self) -> None:
        """Merge persistent microbatch caches back into the whole-batch
        layout (one concatenation, only when the call's shape changes)."""
        for st in self._local():
            if st.mb_caches is not None:
                st.cache = KVCache(**{
                    f.name: (None if getattr(st.mb_caches[0], f.name) is None else
                             torch.cat([getattr(c, f.name) for c in st.mb_caches], 1))
                    for f in dataclasses.fields(KVCache)})
                st.mb_caches = None

    @torch.inference_mode()
    def prefill(self, tokens, pos0: int = 0, logits_mode: str = "last"):
        """Tokens (B,T) at positions pos0.. (a shared int, inside the
        window) -> logits per ``logits_mode`` ("last" (B,V), "all" (B,T,V),
        "none": None), as ``forward_prefill``."""
        if logits_mode not in ("all", "last", "none"):
            raise ValueError(f"logits_mode must be all, last or none, not {logits_mode!r}")
        if np.ndim(pos0) > 0:
            raise ValueError("pipeline prefill takes a shared scalar position")
        T = np.shape(tokens)[1]
        if pos0 < 0 or pos0 + T > self.cfg.kv_window:
            raise ValueError(f"prefill at {pos0}..{pos0 + T - 1} crosses the "
                             f"{self.cfg.kv_window}-slot window; decode steps go on past it")
        self._whole_batch()
        return self._run(tokens, int(pos0), True, logits_mode)

    @torch.inference_mode()
    def decode_step(self, tok, pos0):
        """One decode step of the whole batch: tok (B,1) at ``pos0`` (an
        int or (B,) positions) -> logits (B,V) float32."""
        self._whole_batch()
        return self._run(tok, pos0, False, "last")

    @torch.inference_mode()
    def decode_microbatched(self, tok, pos0, n_micro: int):
        """The batch split into ``n_micro`` groups, each run through every
        stage in turn over its own persistent cache -> logits (B,V)."""
        tok = torch.as_tensor(tok, dtype=torch.int64)
        B = tok.shape[0]
        if B % n_micro:
            raise ValueError(f"a batch of {B} does not split into {n_micro} microbatches")
        mb = B // n_micro
        pos_b = np.broadcast_to(np.asarray(pos0.cpu() if isinstance(pos0, torch.Tensor)
                                           else pos0, np.int64).reshape(-1), (B,))
        if any(st.mb_caches is None or len(st.mb_caches) != n_micro
               for st in self._local()):
            self._whole_batch()       # normalize, then split every stage once
            for st in self._local():
                st.mb_caches = [KVCache(**{
                    f.name: (None if getattr(st.cache, f.name) is None else
                             getattr(st.cache, f.name)[:, m * mb:(m + 1) * mb].clone())
                    for f in dataclasses.fields(KVCache)}) for m in range(n_micro)]
                st.cache = None
        outs = [self._run(tok[m * mb:(m + 1) * mb], pos_b[m * mb:(m + 1) * mb].copy(),
                          False, "last", micro=m) for m in range(n_micro)]
        return torch.cat(outs, 0)


def _device(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA GPU is visible; pass the "
                           "stages' devices as 'cpu' to run the plain versions")
    return dev
