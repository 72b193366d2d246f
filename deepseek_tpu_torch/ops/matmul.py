"""Projection dispatch and the MoE pair list.

``qmatmul`` applies a stored projection ``W (out, in)`` to ``x (..., in)``
(reference dispatcher infer.cpp:381-417; ``deepseek_tpu/ops/matmul.py::
qmatmul``): nibble weights go through kernel K1, packed Q2_K/Q3_K, their
int8 turbo forms and blockwise fp8 weights through K5's bodies, large
plain weights at few rows
through K4 (the lm_head and the large dense FFN weights in decode), other
plain weights and per-tensor fp8 (dequantized first, as the JAX qmm does)
through one matrix product. ``dispatch_pairs`` is the single-device
(ep == 1) part of ``deepseek_tpu/parallel/spmd.py::SpmdCtx.dispatch_pairs``.

The MoE prefill FFN (``grouped_expert_ffn``) ports the function of the same
name in ``deepseek_tpu/ops/matmul.py`` for ``ep == 1``: a counting sort of
the token-expert pairs by expert, then the expert projections as grouped
products, K11 (``gmm``) for plain tables and K6 (``qmm_grouped``) over
128-row tiles for nibble, packed, turbo and blockwise fp8 tables. Every
K-quant kernel takes its activations in the natural column order: the
permuted copy (packed, Q3_K turbo, nibble) and the per-16 group sums
(Q2_K turbo, nibble), which the JAX package makes before its kernels
(``ops/matmul.py:254-259``, ``ops/pallas/qmm.py:600-615``), are made
inside the port's kernels (or, for the tiles, not needed: they dequantize
the weights in natural order); behind a row-permuted w13 the w2 tiles read
h in its permuted order. The pair
capacity is every pair, rounded up to the 128-row tile (the JAX
``ep_prefill_capacity`` at ``ep == 1``); expert parallelism (the EP
capacity and its overflow count) is ROADMAP.md queue 1, item 14 (tensor,
expert, data axes).
"""

from __future__ import annotations

from typing import Tuple

import torch

from deepseek_tpu_torch.ops.activations import glu_act
from deepseek_tpu_torch.ops.kernels.qmm import (
    PLAIN_KERNEL_MAX_ROWS, PLAIN_KERNEL_MIN_BYTES, gmm, qmm, qmm_grouped,
)
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


def qmatmul(qt, x: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ W.T -> (..., out) in x's dtype, accumulated in f32."""
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


def dispatch_pairs(idx: torch.Tensor, weights: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten the (T, k) token-expert pairs and sort them by expert id
    (stable), so a repeated expert's pairs sit together.

    Returns (expert (N,), weight (N,), token (N,)), N = T*k."""
    T, k = idx.shape
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    tok = torch.arange(T * k, device=idx.device) // k
    return flat[order], weights.reshape(-1)[order], tok[order]


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


def tile_dispatch(flat_idx: torch.Tensor, e_local: int, tile: int = 128):
    """Counting dispatch of N pairs' expert ids into ``tile``-row tiles,
    each tile of one expert, under the static budget G = E + C/tile (C =
    all pairs, tile-rounded): each expert wastes less than one tile to
    ragged fragmentation; surplus tiles point at the last expert.

    Returns (tile_expert (G,), tile_rows (G,) live rows per tile, dest (N,)
    each pair's slot in the (G*tile) rows, G)."""
    N = flat_idx.shape[0]
    G = e_local + -(-N // tile)
    within, counts, _ = counting_rank(flat_idx, e_local)
    tiles_e = (counts + tile - 1) // tile
    tile_start = torch.cumsum(tiles_e, 0) - tiles_e              # (E,)
    t_idx = torch.arange(G, device=flat_idx.device)
    tile_expert = ((t_idx[:, None] >= tile_start[None, :]).sum(1) - 1) \
        .clamp(0, e_local - 1)
    tile_rows = (counts[tile_expert] - (t_idx - tile_start[tile_expert]) * tile) \
        .clamp(0, tile)
    dest = tile_start[flat_idx.long()] * tile + within
    return tile_expert, tile_rows, dest, G


def _quantized_grouped_ffn(w1, w2, w3, xb, weights, idx, act, w13=None):
    """K-quant- or fp8-expert prefill FFN: ``tile_dispatch`` into 128-row
    tiles and K6 over them. Unfilled slots gather row 0 and are never read
    back; the live row count of each tile goes to the kernel, which skips
    the rest. Returns out (B, T, dim)."""
    TB = 128
    B, T, k = idx.shape
    dim, dtype = xb.shape[-1], xb.dtype
    N = B * T * k
    e_local = (w13 if w13 is not None else w1).shape[0]
    tile_expert, tile_rows, dest, G = tile_dispatch(idx.reshape(N), e_local, TB)
    src = torch.zeros(G * TB, dtype=torch.int64, device=xb.device)
    src[dest] = torch.arange(N, device=xb.device)
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
    y = y.reshape(G * TB, dim)[dest] * weights.reshape(N, 1).float()
    return y.reshape(B, T, k, dim).sum(2).to(dtype)


def grouped_expert_ffn(w1, w2, w3, xb: torch.Tensor, weights: torch.Tensor,
                       idx: torch.Tensor, act, w13=None) -> torch.Tensor:
    """Prefill MoE FFN as a ragged grouped product: the (B*T*k) pairs are
    counting-sorted by expert and each expert's rows multiply its table
    once, so the work scales with the k routed experts per token, not all
    E. Plain tables (E, m, dim)/(E, dim, m) run K11; nibble, packed and
    blockwise fp8 tables K6.
    xb (B, T, dim), weights/idx (B, T, k) -> (B, T, dim) in xb's dtype."""
    if not isinstance(w13 if w13 is not None else w1, PlainTensor):
        return _quantized_grouped_ffn(w1, w2, w3, xb, weights, idx, act, w13=w13)
    B, T, k = idx.shape
    dim, dtype = xb.shape[-1], xb.dtype
    N = B * T * k
    e_local = w2.shape[0]
    C = -(-N // 128) * 128           # all pairs, tile-rounded (ep == 1)

    flat = idx.reshape(N)
    within, counts, starts = counting_rank(flat, e_local)
    dest = starts[flat] + within                                 # (N,) < C
    src = torch.zeros(C, dtype=torch.int64, device=xb.device)
    src[dest] = torch.arange(N, device=xb.device)
    # slack rows (unfilled, src = 0) attach to the last expert; their
    # outputs are never gathered back
    sizes = counts.clone()
    sizes[-1] += C - N
    x_rows = xb.reshape(B * T, dim)[src // k]                    # (C, dim)

    if w13 is not None:
        h2 = gmm(x_rows, w13.data, sizes)
        mh = h2.shape[-1] // 2
        h = glu_act(h2[:, :mh], h2[:, mh:], act).to(dtype)
    else:
        h = glu_act(gmm(x_rows, w1.data, sizes), gmm(x_rows, w3.data, sizes),
                    act).to(dtype)
    y = gmm(h, w2.data, sizes)                                   # (C, dim) f32
    y = y[dest] * weights.reshape(N, 1).float()
    return y.reshape(B, T, k, dim).sum(2).to(dtype)
