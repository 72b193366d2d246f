"""Projection dispatch and the MoE pair list.

``qmatmul`` applies a stored projection ``W (out, in)`` to ``x (..., in)``
(reference dispatcher infer.cpp:381-417; ``deepseek_tpu/ops/matmul.py::
qmatmul``): nibble weights go through kernel K1, packed Q2_K/Q3_K, their
int8 turbo forms and blockwise fp8 weights through K5's bodies, large
plain weights at few rows
through K4 (the lm_head and the large dense FFN weights in decode), other
plain weights and per-tensor fp8 (dequantized first, as the JAX qmm does)
through one matrix product. ``dispatch_pairs`` ports
``deepseek_tpu/parallel/spmd.py::SpmdCtx.dispatch_pairs``, with its
ownership fold under an expert axis and its ``active`` mask of live batch
rows (``LiveRows``: the serving scheduler's host mask and its device copy).

The MoE prefill FFN (``grouped_expert_ffn``) ports the function of the same
name in ``deepseek_tpu/ops/matmul.py``: a counting sort of the token-expert
pairs by expert (under an expert axis, of the pairs this rank owns, into
the static EP capacity: ``ep_prefill_capacity``, with the count of pairs
that did not fit), then the expert projections as grouped products, K11
(``gmm``) for plain tables and K6 (``qmm_grouped``) over 128-row tiles for
nibble, packed, turbo and blockwise fp8 tables. Every
K-quant kernel takes its activations in the natural column order: the
permuted copy (packed, Q3_K turbo, nibble) and the per-16 group sums
(Q2_K turbo, nibble), which the JAX package makes before its kernels
(``ops/matmul.py:254-259``, ``ops/pallas/qmm.py:600-615``), are made
inside the port's kernels (or, for the tiles, not needed: they dequantize
the weights in natural order); behind a row-permuted w13 the w2 tiles read
h in its permuted order.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from deepseek_tpu_torch.ops.activations import glu_act
from deepseek_tpu_torch.parallel.spmd import NULL_CTX, SpmdCtx, ep_ownership
from deepseek_tpu_torch.ops.kernels.qmm import (
    PLAIN_KERNEL_MAX_ROWS, PLAIN_KERNEL_MIN_BYTES, VERIFY_ROWS, gmm, qmm, qmm_grouped,
    qmm_tiled,
)
from deepseek_tpu_torch.ops.norms import pad_rows
from deepseek_tpu_torch.quant.qtensor import (
    PACKED, TURBO, Fp8Tensor, KNibbleTensor, PlainTensor,
)


def plain_kernel_route(qt: PlainTensor, rows: int) -> bool:
    """The JAX condition (``deepseek_tpu/ops/pallas/qmm.py:326-327``) for a
    plain weight (d, n) to take qmm's kernel (K4) rather than one matrix
    product: at most 8 rows, both widths % 128, at least 32 MiB."""
    d, n = qt.data.shape[-2:]
    return (qt.data.dim() == 2 and 1 <= rows <= PLAIN_KERNEL_MAX_ROWS
            and n % 128 == 0 and d % 128 == 0
            and qt.data.numel() * qt.data.element_size() >= PLAIN_KERNEL_MIN_BYTES)


def per_tensor_fp8(t) -> bool:
    """True for an fp8 weight with a per-tensor scale: the JAX package has
    no kernel for it (qmm.py:407-411 dequantizes; qmm_experts and
    qmm_grouped assert), so its callers take the dequantizing
    formulations."""
    return isinstance(t, Fp8Tensor) and t.per_tensor


_VERIFY = contextvars.ContextVar("verify_chunk", default=False)


@contextlib.contextmanager
def verify_chunk():
    """Verify mode (``forward_prefill`` with per-row starts: the batched
    speculation's chunks of B x (k+1) rows). Inside it every product whose
    formulation would follow the row count takes one formulation whatever
    B is, so that a sequence's rows compute the bits they have when the
    sequence is verified alone: ``qmatmul`` and ``row_slices`` run slices
    of exactly ``VERIFY_ROWS`` rows, zero-padded (a kernel-backed weight on
    its row-tiled route, ``qmm_tiled``: one narrow tile of MMA width 16 a
    slice, even where the matvec would take the rows; a plain weight or a
    library product one GEMM shape), and the MoE FFN picks the pair list
    or the grouped products from one sequence's pairs
    (``models/deepseek.py::_ffn``). K9/K10 plan their splits for per-row
    starts without it (``prefill_splits(per_row=True)``) and rmsnorm needs
    nothing (``ops/norms.py``)."""
    token = _VERIFY.set(True)
    try:
        yield
    finally:
        _VERIFY.reset(token)


def in_verify_chunk() -> bool:
    return _VERIFY.get()


def row_slices(fn, x: torch.Tensor) -> torch.Tensor:
    """fn over the rows of x (rows, ...) in slices of ``VERIFY_ROWS``, each
    padded with zero rows to exactly that many, the results cut back and
    joined: every row goes through the same shape of product."""
    outs = []
    for i in range(0, x.shape[0], VERIFY_ROWS):
        xs = x[i:i + VERIFY_ROWS]
        outs.append(fn(pad_rows(xs, VERIFY_ROWS))[:xs.shape[0]])
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def qmatmul(qt, x: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ W.T -> (..., out) in x's dtype, accumulated in f32;
    inside ``verify_chunk`` in slices of ``VERIFY_ROWS`` rows."""
    if _VERIFY.get() and x.numel():
        x2 = x.reshape(-1, x.shape[-1])
        if isinstance(qt, (*PACKED, *TURBO, KNibbleTensor)) or (
                isinstance(qt, Fp8Tensor) and not qt.per_tensor):
            y = row_slices(lambda xs: qmm_tiled(qt, xs), x2)
        else:
            w = qt.dequant(torch.float32) if isinstance(qt, Fp8Tensor) else qt.data.float()
            y = row_slices(lambda xs: torch.matmul(xs.float(), w.t()), x2)
        return y.reshape(*x.shape[:-1], -1).to(x.dtype)
    if isinstance(qt, (*PACKED, *TURBO, KNibbleTensor)):
        return qmm(qt, x).to(x.dtype)
    if isinstance(qt, Fp8Tensor):
        if qt.per_tensor:
            return torch.matmul(x.float(), qt.dequant(torch.float32).t()).to(x.dtype)
        return qmm(qt, x).to(x.dtype)
    if isinstance(qt, PlainTensor):
        if plain_kernel_route(qt, x.numel() // x.shape[-1]):
            return qmm(qt, x).to(x.dtype)
        return torch.matmul(x.float(), qt.data.float().t()).to(x.dtype)
    raise TypeError(f"unsupported weight {type(qt).__name__}")


@dataclasses.dataclass(frozen=True)
class LiveRows:
    """The live rows of a decode batch (continuous batching: empty and
    finished slots are dead): ``mask`` (B,) bool on the device and
    ``count``, the live rows, taken from the host mask it was made from, so
    that cutting the pair list reads nothing back."""
    mask: torch.Tensor
    count: int

    @classmethod
    def of(cls, active, device) -> Optional["LiveRows"]:
        """From a host mask (numpy or a list; a tensor is read back once),
        with one non-blocking copy to ``device``; None stays None."""
        if active is None or isinstance(active, LiveRows):
            return active
        if isinstance(active, torch.Tensor):
            active = active.cpu().numpy()
        host = np.array(active, dtype=bool).reshape(-1)
        return cls(torch.from_numpy(host).to(device, non_blocking=True), int(host.sum()))


def dispatch_pairs(idx: torch.Tensor, weights: torch.Tensor,
                   live: Optional[LiveRows] = None, ctx: SpmdCtx = NULL_CTX,
                   n_experts: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten the (T, k) token-expert pairs and sort them by expert id
    (stable), so a repeated expert's pairs sit together. With ``live`` the
    dead rows' pairs sort last and are cut off: the list keeps exactly the
    live rows' ``live.count * k`` pairs (the JAX ``n_keep`` cut at an
    occupancy bucket; eager torch has no bucketed compile, so the cut is
    the live count itself), and the dead rows do no expert work.

    Under an expert axis (``ctx.ep > 1``, ``n_experts`` global experts) the
    ids become this rank's local ids; the pairs it does not own keep their
    place in the list (its length stays T*k, or the live pairs: nothing is
    read back to size it) with weight 0, sorted after the owned ones and
    aliased to the last owned expert, so the expert kernel reads no other
    table (``spmd.py:154-214``).

    Returns (expert (N,), weight (N,), token (N,), pair (N,): the index
    of each pair in the flat (T*k) list, for ``combine_pairs``), N = T*k
    or the live pairs."""
    T, k = idx.shape
    flat = idx.reshape(-1)
    w = weights.reshape(-1)
    tok = torch.arange(T * k, device=idx.device) // k
    e_local = n_experts // ctx.ep if ctx.ep > 1 else n_experts
    flat, keep, w = ep_ownership(flat, w, ctx, e_local)
    key = flat if keep is None else torch.where(keep, flat, e_local)
    if live is not None:
        key = torch.where(live.mask[tok], key, 1 << 30)
    order = torch.sort(key, stable=True).indices
    if live is not None:
        order = order[:live.count * k]
    eid = flat[order]
    if keep is not None:
        kept = keep[order]
        alias = torch.where(kept, eid, -1).max().clamp(min=0)
        eid = torch.where(kept, eid, alias)
    return eid, w[order], tok[order], order


def combine_pairs(per: torch.Tensor, weights: torch.Tensor, pair: torch.Tensor,
                  n_tokens: int, k: int) -> torch.Tensor:
    """Each token's routed output from the sorted pairs' outputs per (N,
    dim): the weighted pairs scattered back to their (n_tokens, k) places
    and summed over k there, in the token's own slot order and without
    atomics, so that a token's sum is the same bits whatever else the pair
    list holds (a served row equals the sequence decoded alone). Cut pairs
    (dead rows) add 0. Returns (n_tokens, dim) in per's dtype."""
    dense = per.new_zeros((n_tokens * k, per.shape[-1]))
    dense[pair] = per * weights[:, None]
    return dense.view(n_tokens, k, -1).sum(1)


def counting_rank(cls: torch.Tensor, n_cls: int):
    """One-hot-cumsum counting sort (``deepseek_tpu/parallel/spmd.py::
    counting_rank``): (within, counts, starts) = each element's rank among
    its class, the per-class counts and the exclusive class starts."""
    oh = torch.nn.functional.one_hot(cls.long(), n_cls).to(torch.int32)
    within = (torch.cumsum(oh, 0) - 1).gather(1, cls.long()[:, None])[:, 0]
    counts = oh.sum(0)
    return within, counts, torch.cumsum(counts, 0) - counts


def grouped_ffn_supported(cfg, w1=None) -> bool:
    """Divisibility for the grouped prefill paths: the K-quant tiles
    (packed, turbo and nibble) need the superblock (256) to divide both
    contraction dims, the plain and fp8 grouped products 128. Per-tensor
    fp8 has no grouped kernel."""
    if per_tensor_fp8(w1):
        return False
    if isinstance(w1, (*PACKED, *TURBO, KNibbleTensor)):
        return cfg.dim % 256 == 0 and cfg.moe_intermediate_size % 256 == 0
    return cfg.dim % 128 == 0 and cfg.moe_intermediate_size % 128 == 0


def ep_prefill_capacity(n_pairs: int, ep: int, cf: float, tile: int = 128) -> int:
    """Static per-rank pair capacity of the EP prefill dispatch
    (``deepseek_tpu/ops/matmul.py::ep_prefill_capacity``): every pair,
    tile-rounded, at ep == 1 or cf <= 0; else about cf * n_pairs / ep.
    Pairs past it are counted (the overflow), their contributions lost."""
    if ep <= 1 or cf <= 0:
        return -(-n_pairs // tile) * tile
    c = min(n_pairs, int(cf * n_pairs / ep) + 1)
    return min(-(-c // tile) * tile, -(-n_pairs // tile) * tile)


def ep_owned(flat_idx: torch.Tensor, flat_w: torch.Tensor, ctx: SpmdCtx, e_local: int):
    """Ownership and per-expert counting-sort ranks of this rank's pairs
    (``ops/matmul.py::_ep_owned``): (local ids, owned (N,) bool, rank among
    the owned pairs of the same expert, owned counts per local expert,
    weights with the others' pairs at 0)."""
    lidx, owned, w = ep_ownership(flat_idx, flat_w, ctx, e_local)
    if owned is None:
        owned = torch.ones(flat_idx.shape, dtype=torch.bool, device=flat_idx.device)
    within, counts, _ = counting_rank(torch.where(owned, lidx, e_local), e_local + 1)
    return lidx, owned, within, counts[:e_local], w


def owned_tiles(lidx: torch.Tensor, owned: torch.Tensor, within: torch.Tensor,
                counts: torch.Tensor, capacity: int, tile: int = 128):
    """Counting dispatch of the owned pairs (``ep_owned``) into
    ``tile``-row tiles, each tile of one expert, under the static budget
    G = E_local + capacity/tile: each expert wastes less than one tile to
    ragged fragmentation; surplus tiles point at the last expert; owned
    pairs past the budget (EP capacity overflow) are dropped.

    Returns (tile_expert (G,), tile_rows (G,) rows per tile, dest (N,) each
    pair's slot in the (G*tile) rows, keep (N,) whether it has one, G)."""
    e_local = counts.shape[0]
    G = e_local + capacity // tile
    tiles_e = (counts + tile - 1) // tile
    tile_start = torch.cumsum(tiles_e, 0) - tiles_e              # (E,)
    t_idx = torch.arange(G, device=lidx.device)
    tile_expert = ((t_idx[:, None] >= tile_start[None, :]).sum(1) - 1) \
        .clamp(0, e_local - 1)
    tile_rows = (counts[tile_expert] - (t_idx - tile_start[tile_expert]) * tile) \
        .clamp(0, tile)
    dest = torch.where(owned, tile_start[lidx.long()] * tile + within, G * tile)
    return tile_expert, tile_rows, dest, dest < G * tile, G


def tile_dispatch(flat_idx: torch.Tensor, e_local: int, tile: int = 128):
    """``owned_tiles`` of every pair (one rank), the capacity all pairs:
    (tile_expert (G,), tile_rows (G,), dest (N,), G)."""
    lidx, owned, within, counts, _ = ep_owned(flat_idx, flat_idx, NULL_CTX, e_local)
    N = flat_idx.shape[0]
    te, tr, dest, _, G = owned_tiles(lidx, owned, within, counts,
                                     -(-N // tile) * tile, tile)
    return te, tr, dest, G


def _scatter_src(dest: torch.Tensor, keep: torch.Tensor, rows: int) -> torch.Tensor:
    """src (rows,): the pair each kept pair's slot takes (0 where none), by
    one scatter into a buffer with a spare slot for the dropped pairs (no
    data-dependent shape, so nothing is read back)."""
    N = dest.shape[0]
    src = torch.zeros(rows + 1, dtype=torch.int64, device=dest.device)
    src[torch.where(keep, dest, rows)] = torch.arange(N, device=dest.device)
    return src[:rows]


def _combine(y: torch.Tensor, dest, keep, w, shape, dtype):
    """The kept pairs' rows of y (rows, dim) back in pair order, weighted
    and summed over each token's k: (B, T, dim) in ``dtype``."""
    B, T, k = shape
    y = y[dest.clamp(max=y.shape[0] - 1)] * w.reshape(-1, 1).float()
    y = torch.where(keep[:, None], y, torch.zeros((), dtype=y.dtype, device=y.device))
    return y.reshape(B, T, k, -1).sum(2).to(dtype)


def _quantized_grouped_ffn(w1, w2, w3, xb, weights, idx, act, w13=None,
                           ctx: SpmdCtx = NULL_CTX, ovf: Optional[list] = None):
    """K-quant- or fp8-expert prefill FFN: ``owned_tiles`` into 128-row
    tiles and K6 over them. Unfilled slots gather row 0 and are never read
    back; the live row count of each tile goes to the kernel, which skips
    the rest. Returns out (B, T, dim); the overflow count goes to ``ovf``."""
    TB = 128
    B, T, k = idx.shape
    dim, dtype = xb.shape[-1], xb.dtype
    N = B * T * k
    e_local = (w13 if w13 is not None else w1).shape[0]
    lidx, owned, within, counts, w = ep_owned(idx.reshape(N), weights.reshape(N), ctx,
                                              e_local)
    C = ep_prefill_capacity(N, ctx.ep, ctx.ep_capacity_factor, TB)
    tile_expert, tile_rows, dest, keep, G = owned_tiles(lidx, owned, within, counts,
                                                        C, TB)
    src = _scatter_src(dest, keep, G * TB)
    x_tiles = xb.reshape(B * T, dim)[src // k].float().reshape(G, TB, dim)

    if w13 is not None:
        h2 = qmm_grouped(w13, tile_expert, x_tiles, tile_rows)
        mh = h2.shape[-1] // 2
        h = glu_act(h2[..., :mh], h2[..., mh:], act)
    else:
        h = glu_act(qmm_grouped(w1, tile_expert, x_tiles, tile_rows),
                    qmm_grouped(w3, tile_expert, x_tiles, tile_rows), act)
    # a row-permuted w13 (KNibbleTensor.rowperm, DSEEK_FUSED_FFN=1) leaves
    # h in the stride-16 permuted order per half: K6's prepermuted body
    # takes it as it is (deepseek_tpu/ops/matmul.py:268-285)
    rp = isinstance(w13, KNibbleTensor) and bool(w13.rowperm)
    y = qmm_grouped(w2, tile_expert, h, tile_rows, x_prepermuted=rp)  # (G, TB, dim)
    if ovf is not None:
        ovf.append((owned & ~keep).sum().float())
    return _combine(y.reshape(G * TB, dim), dest, keep, w, (B, T, k), dtype)


def grouped_expert_ffn(w1, w2, w3, xb: torch.Tensor, weights: torch.Tensor,
                       idx: torch.Tensor, act, w13=None, ctx: SpmdCtx = NULL_CTX,
                       ovf: Optional[list] = None) -> torch.Tensor:
    """Prefill MoE FFN as a ragged grouped product: the (B*T*k) pairs are
    counting-sorted by expert and each expert's rows multiply its table
    once, so the work scales with the k routed experts per token, not all
    E. Plain tables (E, m, dim)/(E, dim, m) run K11; nibble, packed and
    blockwise fp8 tables K6. Under an expert axis (the tables this rank's
    experts) only the pairs it owns run, compacted into the static
    capacity ``ep_prefill_capacity(N, ep, ctx.ep_capacity_factor)``.
    xb (B, T, dim), weights/idx (B, T, k) -> this rank's share of the
    mixture (B, T, dim) in xb's dtype; the count of owned pairs past the
    capacity (an f32 scalar tensor on the device) is appended to ``ovf``."""
    if not isinstance(w13 if w13 is not None else w1, PlainTensor):
        return _quantized_grouped_ffn(w1, w2, w3, xb, weights, idx, act, w13=w13,
                                      ctx=ctx, ovf=ovf)
    B, T, k = idx.shape
    dim, dtype = xb.shape[-1], xb.dtype
    N = B * T * k
    e_local = w2.shape[0]
    C = ep_prefill_capacity(N, ctx.ep, ctx.ep_capacity_factor, 128)

    lidx, owned, within, counts, w = ep_owned(idx.reshape(N), weights.reshape(N), ctx,
                                              e_local)
    starts = torch.cumsum(counts, 0) - counts
    dest = torch.where(owned, starts[lidx.long()] + within, C)
    keep = dest < C
    src = _scatter_src(dest, keep, C)
    # groups clipped to the capacity; slack rows (unfilled, src = 0) attach
    # to the last expert, their outputs never gathered back
    sizes = (torch.minimum(starts + counts, torch.full_like(starts, C))
             - torch.minimum(starts, torch.full_like(starts, C)))
    sizes[-1] += C - sizes.sum()
    x_rows = xb.reshape(B * T, dim)[src // k]                    # (C, dim)

    if w13 is not None:
        h2 = gmm(x_rows, w13.data, sizes)
        mh = h2.shape[-1] // 2
        h = glu_act(h2[:, :mh], h2[:, mh:], act).to(dtype)
    else:
        h = glu_act(gmm(x_rows, w1.data, sizes), gmm(x_rows, w3.data, sizes),
                    act).to(dtype)
    y = gmm(h, w2.data, sizes)                                   # (C, dim) f32
    if ovf is not None:
        ovf.append((owned & ~keep).sum().float())
    return _combine(y, dest, keep, w, (B, T, k), dtype)
