"""The context a forward body runs under on a mesh (``deepseek_tpu/
parallel/spmd.py::SpmdCtx``, its ``seq`` parts).

Every rank holds one slice of the KV window (``parallel/sharding.py``)
and runs the whole model on it; attention over the window is split
into per-shard partials (acc, m, l) that merge exactly:

- ``seq_merge``: sequence-parallel decode (and prefill chunks whose rows
  are replicated): out = sum(acc e^(m - m*)) / sum(l e^(m - m*)), m* the
  maximum over the shards.
- context-parallel (CP) prefill, when the chunk's length divides the seq
  axis: each rank projects its T/sp rows, ``cp_gather_rows`` gathers the
  chunk's queries and cache rows, and ``cp_merge_scatter`` merges the
  partials and keeps this rank's rows.

Each collective is an ``all_reduce``, which every backend takes for CPU
and CUDA tensors: MAX of m, SUM of the weighted acc and l, and for the row
gathers a SUM of a zero-filled (B, T, ...) buffer into which each rank
copied its rows (exact: x + 0 = x, integers included). This computes the
JAX functions exactly; the gathers and the merge-scatter move sp times the
bytes of JAX's ``all_gather`` / ``psum_scatter``. ``NULL_CTX`` (one
device) runs no collective and costs the single-device path nothing.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from deepseek_tpu_torch.config import ModelConfig

# host counters the tests read: "cp_rows" counts context-parallel chunks
COUNTS: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class SpmdCtx:
    tp: int = 1              # tensor axis (not ported: 1)
    ep: int = 1              # expert axis (not ported: 1)
    dp: int = 1              # data axis (not ported: 1)
    sp: int = 1              # seq axis: shards of the KV window
    sidx: int = 0            # this rank's index along seq
    # context-parallel prefill: the current chunk's rows are sharded over
    # seq (set per chunk by forward_prefill when T % sp == 0)
    cp: bool = False

    def seq_shard(self, window: int) -> Tuple[int, int]:
        """(shard index, local window length) of the window-sharded cache."""
        return self.sidx, window // self.sp

    def local_slots(self, kv_pos: torch.Tensor, window: int):
        """Global ring slots kv_pos (B,) -> (local slots, owned (B,) bool or
        None): a slot outside this shard's slice is clipped into it and not
        owned, so only the owning shard commits a decode write."""
        if self.sp <= 1:
            return kv_pos, None
        sidx, s_local = self.seq_shard(window)
        lpos = kv_pos - sidx * s_local
        return lpos.clamp(0, s_local - 1), (lpos >= 0) & (lpos < s_local)

    def local_kv_len(self, kv_len: torch.Tensor, window: int) -> torch.Tensor:
        """The valid prefix kv_len (B,) of the ring within this shard:
        clip(kv_len - sidx * S/sp, 0, S/sp)."""
        if self.sp <= 1:
            return kv_len
        sidx, s_local = self.seq_shard(window)
        return (kv_len - sidx * s_local).clamp(0, s_local)

    def _all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        x = x.contiguous()
        dist.all_reduce(x, op=op)
        return x

    def _weights(self, m: torch.Tensor) -> torch.Tensor:
        """e^(m - m*), m* the maximum of m over the shards."""
        return torch.exp(m - self._all_reduce(m.clone(), dist.ReduceOp.MAX))

    def seq_merge(self, acc, m, l):
        """Exact merge of per-shard partials: acc (..., D) unnormalized,
        m/l (...) -> normalized (..., D) on every rank."""
        if self.sp <= 1:
            return acc / torch.clamp(l, min=1e-30)[..., None]
        w = self._weights(m)
        num = self._all_reduce(acc * w[..., None])
        den = self._all_reduce(l * w)
        return num / torch.clamp(den, min=1e-30)[..., None]

    def cp_rows(self, T: int) -> Tuple[int, int]:
        """(row-shard index, local row count) for a CP-sharded chunk."""
        COUNTS["cp_rows"] += 1
        return self.sidx, T // self.sp

    def cp_gather_rows(self, x: Optional[torch.Tensor]):
        """This rank's chunk rows (B, t, ...) -> the whole chunk (B, t*sp,
        ...) in shard order, in x's dtype; None passes through."""
        if x is None or self.sp <= 1:
            return x
        t = x.shape[1]
        full = torch.zeros((x.shape[0], t * self.sp) + tuple(x.shape[2:]),
                           dtype=x.dtype, device=x.device)
        full[:, self.sidx * t:(self.sidx + 1) * t] = x
        return self._all_reduce(full)

    def cp_merge_scatter(self, acc, m, l):
        """Merge the partials over the whole (gathered) chunk and keep this
        rank's rows: acc (B,T,H,D), m/l (B,T,H) -> (B,T/sp,H,D)."""
        if self.sp <= 1:
            return acc / torch.clamp(l, min=1e-30)[..., None]
        t = acc.shape[1] // self.sp
        rows = slice(self.sidx * t, (self.sidx + 1) * t)
        w = self._weights(m)
        num = self._all_reduce(acc * w[..., None])[:, rows]
        den = self._all_reduce(l * w)[:, rows]
        return num / torch.clamp(den, min=1e-30)[..., None]

    def cp_last_row(self, logits: torch.Tensor) -> torch.Tensor:
        """The chunk's last row lives on the last shard: a masked all-reduce
        hands it to every rank."""
        if self.sidx != self.sp - 1:
            logits = torch.zeros_like(logits)
        return self._all_reduce(logits)


NULL_CTX = SpmdCtx()


def make_ctx(cfg: ModelConfig, mesh) -> SpmdCtx:
    """Validate the mesh against the config and build the body's context.
    Only the seq axis is ported: a mesh with another axis above 1 raises."""
    if (mesh.data, mesh.expert, mesh.tensor) != (1, 1, 1):
        raise NotImplementedError(
            f"mesh (data {mesh.data}, expert {mesh.expert}, tensor {mesh.tensor}): "
            "only the seq axis is ported; the others belong to multi-device "
            "(ROADMAP.md queue 1, item 14 (tensor, expert, data axes))")
    sp = mesh.seq
    if sp > 1 and cfg.kv_window % sp:
        raise ValueError(
            f"shard_map path requires kv_window {cfg.kv_window} % seq {sp} == 0; "
            "pick a different mesh shape")
    return SpmdCtx(sp=sp, sidx=mesh.seq_index)
