"""The context a forward body runs under on a mesh (``deepseek_tpu/
parallel/spmd.py::SpmdCtx``): the body runs on this rank's local shards,
with the collectives placed explicitly (the JAX ``shard_map`` path).

Tensor axis (``tp``): the head projections and the FFN's w1/w3 are
column-parallel (this rank's heads, its share of the hidden width), wo and
w2 row-parallel: ``psum_t`` sums their partial products over the tensor
line. The lm_head is vocab-sharded where the vocabulary divides the axis:
``gather_logits`` reassembles the row.

Expert axis (``ep``): the activations are replicated over the expert line,
so dispatch is local: each rank keeps the token-expert pairs it owns
(``ep_ownership``; non-owned pairs keep their place with weight 0) and
``psum_e`` sums the shards' mixtures.

Data axis (``dp``): the weights are replicated and each rank runs its
rows of the batch (``data_rows``) over its rows of the cache; nothing in a
forward crosses the data line but the EP prefill overflow count
(``psum_d``), and the decode block and the batched speculation gather
their rows' results into the whole batch on every rank (``gather_d``).

Seq axis (``sp``): every rank holds one slice of the KV window
(``parallel/sharding.py``) and attention over the window is split into
per-shard partials (acc, m, l) that merge exactly:

- ``seq_merge``: sequence-parallel decode (and prefill chunks whose rows
  are replicated): out = sum(acc e^(m - m*)) / sum(l e^(m - m*)), m* the
  maximum over the shards.
- context-parallel (CP) prefill, when the chunk's length divides the seq
  axis: each rank projects its T/sp rows, ``cp_gather_rows`` gathers the
  chunk's queries and cache rows, and ``cp_merge_scatter`` merges the
  partials and keeps this rank's rows.

Each collective is an ``all_reduce`` over the axis's subgroup
(``parallel/mesh.py``), which every backend takes for CPU and CUDA
tensors: SUM for the partial products and mixtures, MAX of m, and for the
gathers (rows, vocab slices) a SUM of a zero-filled buffer into which each
rank copied its part (exact: x + 0 = x). Every rank of a line gets the
same bits, so every rank samples the same token. This computes the JAX
functions exactly; the gathers and the merge-scatter move n times the
bytes of JAX's ``all_gather`` / ``psum_scatter``. ``NULL_CTX`` (one
device) runs no collective and costs the single-device path nothing.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from deepseek_tpu_torch.config import ModelConfig

# host counters the tests read: "cp_rows" counts context-parallel chunks
COUNTS: collections.Counter = collections.Counter()


def ep_ownership(flat_idx: torch.Tensor, flat_w: torch.Tensor, ctx: "SpmdCtx",
                 e_local: int):
    """This rank's share of a flat pair list (``spmd.py::ep_ownership``):
    global expert ids -> (local ids, 0 where not owned; the owned mask, or
    None at ep == 1; the weights, 0 where not owned)."""
    if ctx.ep <= 1:
        return flat_idx, None, flat_w
    keep = torch.div(flat_idx, e_local, rounding_mode="floor") == ctx.eidx
    lidx = torch.where(keep, flat_idx % e_local, torch.zeros_like(flat_idx))
    return lidx, keep, torch.where(keep, flat_w, torch.zeros_like(flat_w))


@dataclasses.dataclass(frozen=True)
class SpmdCtx:
    tp: int = 1              # tensor axis: shards of the heads and hidden width
    ep: int = 1              # expert axis: shards of the routed-expert tables
    dp: int = 1              # data axis: shards of the batch
    sp: int = 1              # seq axis: shards of the KV window
    sidx: int = 0            # this rank's index along seq
    tidx: int = 0            # ... along tensor
    eidx: int = 0            # ... along expert
    didx: int = 0            # ... along data
    lm_head_tp: bool = False  # the lm_head's vocab may shard (vocab % tp == 0)
    # EP prefill capacity factor (ops/matmul.py::ep_prefill_capacity); 0 =
    # exact. Only read when ep > 1.
    ep_capacity_factor: float = 0.0
    # context-parallel prefill: the current chunk's rows are sharded over
    # seq (set per chunk by forward_prefill when T % sp == 0)
    cp: bool = False
    # the subgroups of this rank's lines (None: the default group)
    tgroup: Any = None
    egroup: Any = None
    sgroup: Any = None
    dgroup: Any = None

    def _all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM,
                    group=None) -> torch.Tensor:
        x = x.contiguous()
        dist.all_reduce(x, op=op, group=group)
        return x

    def _gather(self, x: torch.Tensor, dim: int, n: int, idx: int, group) -> torch.Tensor:
        """The n ranks' parts of ``dim`` in rank order: a zero-filled buffer
        holding this rank's part, summed over the line."""
        dim = dim % x.dim()
        t = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = t * n
        full = torch.zeros(shape, dtype=x.dtype, device=x.device)
        full.narrow(dim, idx * t, t).copy_(x)
        return self._all_reduce(full, group=group)

    # -- data axis -----------------------------------------------------------

    def psum_d(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the data line (global scalar statistics: the EP prefill
        overflow count)."""
        return self._all_reduce(x, group=self.dgroup) if self.dp > 1 else x

    def data_rows(self, B: int) -> slice:
        """This rank's rows of a B-row batch cut over the data line."""
        if self.dp <= 1:
            return slice(0, B)
        if B % self.dp:
            raise ValueError(f"a batch of {B} rows does not divide the data axis "
                             f"({self.dp})")
        b = B // self.dp
        return slice(self.didx * b, (self.didx + 1) * b)

    def gather_d(self, x: Optional[torch.Tensor], dim: int = 0):
        """This rank's rows of ``dim`` -> the whole batch's on every rank of
        the data line, in rank order; None passes through."""
        if x is None or self.dp <= 1:
            return x
        return self._gather(x, dim, self.dp, self.didx, self.dgroup)

    # -- tensor and expert axes ------------------------------------------

    def psum_t(self, x: torch.Tensor) -> torch.Tensor:
        """Sum a row-parallel product's partial sums over the tensor line."""
        return self._all_reduce(x, group=self.tgroup) if self.tp > 1 else x

    def psum_e(self, x: torch.Tensor) -> torch.Tensor:
        """Sum the routed-expert partial outputs over the expert line."""
        return self._all_reduce(x, group=self.egroup) if self.ep > 1 else x

    def local_heads(self, n_heads: int) -> int:
        return n_heads // self.tp

    def gather_logits(self, logits: torch.Tensor, vocab: int) -> torch.Tensor:
        """Vocab-sharded logits (..., vocab/tp) -> the whole row on every
        rank; a replicated lm_head's logits pass through."""
        if self.tp <= 1 or logits.shape[-1] == vocab:
            return logits
        return self._gather(logits, -1, self.tp, self.tidx, self.tgroup)

    def expert_slots(self, idx: torch.Tensor, weights: torch.Tensor, n_experts: int):
        """Global top-k expert ids -> this rank's local table: slots routed
        to experts it does not own point at local expert 0 with weight 0
        (the compute is wasted, the result exact after ``psum_e``)."""
        if self.ep <= 1:
            return idx, weights
        lidx, _, w = ep_ownership(idx, weights, self, n_experts // self.ep)
        return lidx, w

    def local_expert_slice(self, wmat: torch.Tensor, n_experts: int) -> torch.Tensor:
        """A (..., E) routing-weight matrix -> this rank's (..., E/ep)."""
        if self.ep <= 1:
            return wmat
        e_local = n_experts // self.ep
        return wmat[..., self.eidx * e_local:(self.eidx + 1) * e_local]

    # -- seq axis ----------------------------------------------------------

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

    def _weights(self, m: torch.Tensor) -> torch.Tensor:
        """e^(m - m*), m* the maximum of m over the seq shards."""
        return torch.exp(m - self._all_reduce(m.clone(), dist.ReduceOp.MAX, self.sgroup))

    def seq_merge(self, acc, m, l):
        """Exact merge of per-shard partials: acc (..., D) unnormalized,
        m/l (...) -> normalized (..., D) on every rank."""
        if self.sp <= 1:
            return acc / torch.clamp(l, min=1e-30)[..., None]
        w = self._weights(m)
        num = self._all_reduce(acc * w[..., None], group=self.sgroup)
        den = self._all_reduce(l * w, group=self.sgroup)
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
        return self._gather(x, 1, self.sp, self.sidx, self.sgroup)

    def cp_merge_scatter(self, acc, m, l):
        """Merge the partials over the whole (gathered) chunk and keep this
        rank's rows: acc (B,T,H,D), m/l (B,T,H) -> (B,T/sp,H,D)."""
        if self.sp <= 1:
            return acc / torch.clamp(l, min=1e-30)[..., None]
        t = acc.shape[1] // self.sp
        rows = slice(self.sidx * t, (self.sidx + 1) * t)
        w = self._weights(m)
        num = self._all_reduce(acc * w[..., None], group=self.sgroup)[:, rows]
        den = self._all_reduce(l * w, group=self.sgroup)[:, rows]
        return num / torch.clamp(den, min=1e-30)[..., None]

    def cp_last_row(self, logits: torch.Tensor) -> torch.Tensor:
        """The chunk's last row lives on the last seq shard: a masked
        all-reduce hands it to every rank."""
        if self.sidx != self.sp - 1:
            logits = torch.zeros_like(logits)
        return self._all_reduce(logits, group=self.sgroup)

    def psum_s(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the seq line (a CP chunk's per-shard counts)."""
        return self._all_reduce(x, group=self.sgroup) if self.sp > 1 else x


NULL_CTX = SpmdCtx()


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(
            f"shard_map path requires {what}; pick a different mesh shape "
            "(see deepseek_tpu_torch.parallel.mesh.default_mesh_shape)")


def make_ctx(cfg: ModelConfig, mesh) -> SpmdCtx:
    """Validate the mesh against the config (``spmd.py::make_ctx``'s
    divisibility checks and messages) and build the body's context."""
    tp, ep, sp, dp = mesh.tensor, mesh.expert, mesh.seq, mesh.data
    if sp > 1:
        _check(cfg.kv_window % sp == 0, f"kv_window {cfg.kv_window} % seq {sp} == 0")
    if tp > 1:
        _check(cfg.n_heads % tp == 0, f"n_heads {cfg.n_heads} % tensor {tp} == 0")
        _check(cfg.hidden_dim % tp == 0, f"hidden_dim {cfg.hidden_dim} % tensor {tp} == 0")
        if cfg.n_shared_experts > 0:
            _check((cfg.n_shared_experts * cfg.moe_intermediate_size) % tp == 0,
                   "shared-expert hidden dim divisible by tensor axis")
    if ep > 1:
        _check(cfg.n_routed_experts % ep == 0,
               f"n_routed_experts {cfg.n_routed_experts} % expert {ep} == 0")
    return SpmdCtx(tp=tp, ep=ep, dp=dp, sp=sp, sidx=mesh.seq_index,
                   tidx=mesh.tensor_index, eidx=mesh.expert_index, didx=mesh.data_index,
                   lm_head_tp=tp > 1 and cfg.vocab_size % tp == 0,
                   ep_capacity_factor=cfg.ep_capacity_factor,
                   tgroup=mesh.tensor_group, egroup=mesh.expert_group,
                   sgroup=mesh.seq_group, dgroup=mesh.data_group)
