"""Kernels K1, K2, K4, K5, K6, K7 and K11: quantized, plain and grouped
matrix products, and the fused expert FFN.

- ``qmm`` replaces ``deepseek_tpu/ops/pallas/qmm.py::qmm`` with
  ``_knib_body`` (K1). Up to ``ROW_TILE_MIN`` rows it launches the nibble
  matvec of ``csrc/nibble_mv.cu`` (all rows against each weight byte once:
  x split into two int8 terms by a pre-pass, exact ``__dp4a`` products;
  ``packed_lanes`` and ``nibble_warps`` size its grid); above, its
  row-tiled route ``qmm_rows`` launches the tile GEMM of
  ``csrc/qmm_tiles.cu``. A plain weight goes to ``qmm_fp``, ``::qmm`` with
  ``_plain_body`` (K4: at most 8 rows; ``csrc/qmm.cu``).
- ``qmm_experts`` replaces ``::qmm_experts`` with ``_knib_body`` (K2, one
  expert id per activation row, read as given; ``csrc/nibble_mv.cu``, the
  same kernel). A plain f32/f16/bf16 table goes to ``qmm_experts_fp``,
  K2's plain body (``qmm.py:651``; ``csrc/qmm.cu``).
- ``qmm_grouped`` replaces ``::qmm_grouped`` with ``_knib_body`` (K6:
  128-row tiles, one expert each; ``csrc/qmm_tiles.cu``, the tile GEMM
  on the tensor cores over split bf16 operands, which every row-tiled
  route and every K6 body launches; ``tile_width`` is its MMA width).
- A blockwise F8E5M2 weight (``Fp8Tensor``) takes the fp8 bodies
  (``_fp8_body``, qmm.py:260): ``qmm_fp8`` is K5's (qmm.py:418; the fp8
  matvec of ``csrc/fp8_mv.cu``, f32 products over coalesced weight words,
  up to ``ROW_TILE_MIN`` rows, x read in its own dtype; ``qmm_fp8_rows`` on
  the tile GEMM above),
  ``qmm_experts_fp8`` K2's (qmm.py:664; ``csrc/qmm.cu``)
  and ``qmm_grouped_fp8`` K6's (qmm.py:502-508; ``csrc/qmm_tiles.cu``).
  Ragged grids (a block size that does not divide the weight) are taken,
  which the TPU kernels assert against. A per-tensor scale has no kernel
  here, as in the JAX package: on the card these wrappers raise on it.
- A packed Q2_K/Q3_K weight (``Q2KTensor``/``Q3KTensor``, the default
  K-quant runtime) takes the packed bodies (``_q2k_body`` qmm.py:361,
  ``_q3k_body`` :368): ``qmm_packed`` is K5's (the integer matvec of
  ``csrc/packed_mv.cu`` up to ``ROW_TILE_MIN`` rows, each weight byte read
  once for all of them, the x pre-pass shared with the nibble matvec
  (``csrc/xsplit.cuh``); ``qmm_packed_rows`` on the tile GEMM above),
  ``qmm_experts_packed`` K2's (qmm.py:622-629; the same kernel, the expert
  ids read as given) and ``qmm_grouped_packed`` K6's (qmm.py:471-478;
  ``csrc/qmm_tiles.cu``). ``packed_lanes`` and ``packed_warps`` size the
  matvec's persistent grid.
- A turbo Q2_K/Q3_K weight (``Q2KTurboTensor``/``Q3KTurboTensor``, the
  int8 planes of ``kquant_runtime="turbo"``) takes the turbo bodies
  (``_q2kt_body`` qmm.py:169, launched :378; ``_q3kt_body`` :195, launched
  :385): ``qmm_turbo`` is K5's (the matvec of ``csrc/qmm.cu`` up to
  ``ROW_TILE_MIN`` rows, ``qmm_turbo_rows`` on the tile GEMM above),
  ``qmm_experts_turbo`` K2's (qmm.py:630-637; ``csrc/qmm.cu``) and
  ``qmm_grouped_turbo`` K6's (qmm.py:479-487; ``csrc/qmm_tiles.cu``).
- ``gmm`` replaces ``megablox.gmm`` as ``deepseek_tpu/ops/matmul.py::
  grouped_expert_ffn`` calls it (K11: rows grouped by expert against a
  plain table; ``csrc/gmm.cu``, on the tensor cores).
- Row-permuted nibble expert tables (``KNibbleTensor.rowperm``, the
  layout of ``DSEEK_FUSED_FFN=1``): ``qmm_expert_ffn`` replaces
  ``::qmm_expert_ffn`` (K7: w13, GLU, w2 and the weighted sum over one
  token's pairs in one launch; ``csrc/expert_ffn.cu``), and
  ``qmm_experts`` / ``qmm_grouped`` take ``x_prepermuted=True``, K2's and
  K6's prepermuted nibble bodies (``::qmm_experts`` :602-609, whose
  pre-pass reads each natural column from its permuted position, and the
  ``rp`` branch of ``deepseek_tpu/ops/matmul.py:268-285``): the
  activations arrive in the stride-16 permuted order in which a permuted
  w13 leaves h. They count their launches apart, in
  ``qmm_experts.prepermuted`` and ``qmm_grouped.prepermuted``.

The sources' headers give each design and its bound. Each wrapper keeps
its own launch count in ``.launches``. The kernels compute against a
table's rows as they are stored, and so do the plain versions
(``KNibbleTensor.stored_rows``).

A wrapper given CPU tensors computes the plain version (``*_plain``: the
f32 dequant of quant/qtensor.py and a product, for every layout); given
CUDA tensors it launches the kernel or raises. It never falls back. The
nibble, packed and fp8 matvecs read x in its own dtype (f32, f16 or bf16)
and ``check_mv_x`` raises on any other, so none runs a cast launch.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch

from deepseek_tpu_torch.config import ActivationType
from deepseek_tpu_torch.ops.activations import glu_act
from deepseek_tpu_torch.ops.kernels.build import check, library
from deepseek_tpu_torch.quant.qtensor import (
    PACKED, TURBO, Fp8Tensor, KNibbleTensor, PlainTensor, Q2KTensor,
    Q2KTurboTensor, unperm_x,
)


def _stored(qt):
    """A nibble table with its rows in their stored order (a row-permuted
    table's products land permuted, as the kernels' do)."""
    return qt.stored_rows() if isinstance(qt, KNibbleTensor) else qt


def _natural_x(qt, x: torch.Tensor, x_prepermuted: bool, what: str) -> torch.Tensor:
    """x in the natural column order; ``x_prepermuted`` (nibble tables
    only, as the JAX qmm_experts asserts) undoes the stride-16 order."""
    if not x_prepermuted:
        return x
    if not isinstance(qt, KNibbleTensor):
        raise ValueError(f"{what}: x_prepermuted needs a nibble table, not "
                         f"{type(qt).__name__}")
    return unperm_x(x)


def qmm_plain(qt, x: torch.Tensor) -> torch.Tensor:
    """x (..., n) @ dequant(W (d, n)).T -> (..., d) float32 (a nibble,
    packed or fp8 weight)."""
    return torch.matmul(x.float(), _stored(qt).dequant(torch.float32).t())


def qmm_experts_plain(qt, idx: torch.Tensor, x: torch.Tensor,
                      x_prepermuted: bool = False) -> torch.Tensor:
    """Row i of x (..., n) times expert idx[i] of W (E, d, n), a nibble,
    packed, fp8 or plain table, -> (..., d) float32. Only the selected experts are
    dequantized (a plain table: widened to f32). ``x_prepermuted``: x in
    the stride-16 permuted order (a nibble table)."""
    x = _natural_x(qt, x, x_prepermuted, "qmm_experts")
    lead, n = x.shape[:-1], x.shape[-1]
    sel = idx.reshape(-1).long()
    if isinstance(qt, PlainTensor):
        w = qt.data[sel].float()
    else:
        w = _stored(qt).map(lambda t: t[sel]).dequant(torch.float32)   # (N, d, n)
    out = torch.bmm(w, x.reshape(-1, n, 1).float())[..., 0]
    return out.reshape(*lead, -1)


# K1 takes the row-tiled route above this many rows (the nibble and fp8
# matvecs take at most this many rows a pass, kNbMaxX in csrc/nibble_mv.cu
# and kMvRowsX in csrc/fp8_mv.cu).
# The figures below placed it when the nibble and fp8 matvecs still
# streamed the weight once per row; reading it once for all of a pass's
# rows moved the crossover to 8-16 rows (chip_smoke.py logs it on every
# run); the value is left at 4 until a change of its own measures a new one.
# The tile GEMM (on the tensor cores) streams it once per 128 rows and
# runs a tile of at most 16 live rows at MMA width 16, so its time hardly
# moves below 16 rows. Measured by chip_smoke.py on
# an H100 80GB HBM3 at 700 W, both routes in one call (matvec / row-tiled
# ms): w13 36864x7168 at 2 rows 0.156 / 0.257, at 4 rows 0.287 / 0.258, at
# 8 0.545 / 0.259; wo 7168x16384 at 4 rows 0.141 / 0.217, at 8 0.262 /
# 0.222. K5's fp8 matvec (8 x rows a pass) against its row-tiled route,
# the same call: lm_head 102400x2048 at 4 rows 0.228 / 0.137, at 8 0.379 /
# 0.137; wq 3072x2048 at 8 rows 0.021 / 0.029, at 16 0.037 / 0.030; dense
# w2 2048x10944 at 8 rows 0.066 / 0.117, at 16 0.125 / 0.118. The
# crossover is 4 rows on w13 and the lm_head, 8 on wo, 16 on wq and w2;
# 4 keeps every one within 0.09 ms of its faster route at every count
# measured from 1 to 32 rows (the worst: the lm_head at 4 rows, w2 at 8),
# where 8 would cost w13 0.29 ms and the lm_head 0.24 ms at 8 rows, so
# both weight kinds share the value. A decode step (1 row) and the pair path's
# gathered rows stay on the matvec.
ROW_TILE_MIN = 4
_TILE = 128           # activation rows per tile (kBM in csrc/qmm_tiles.cu)
# the tile GEMM's MMA widths (kW0..kW3 there; the tests read both back)
_TILE_WIDTHS = (16, 32, 64, _TILE)
# verify mode's row slices (``qmm_tiled``): at most the narrow tiles' rows
# (Slot::NARROW, 16 for the nibble and packed kinds), so that every slice
# runs the narrow kernel at MMA width 16 whatever its live rows
VERIFY_ROWS = _TILE_WIDTHS[0]
_PLAIN_KIND = {torch.float32: 2, torch.float16: 3, torch.bfloat16: 4}   # csrc/qmm.cu
_FP8_KIND = 5
# K11 (csrc/gmm.cu): rows of x a tile (kBN there; the tests read it) and
# its dtype codes (x: f32 or bf16, the compute dtype; the table: any)
_GMM_ROWS = 64
_GMM_DTYPE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def tile_width(live_rows: int) -> int:
    """The MMA width N (wgmma m64nNk16) that csrc/qmm_tiles.cu runs a tile
    of ``live_rows`` rows at: the least of ``_TILE_WIDTHS`` that covers
    them, chosen block-uniformly on the card, so a routed tile of a few
    live rows does not pay for 128."""
    if not 1 <= live_rows <= _TILE:
        raise ValueError(f"a tile holds 1 to {_TILE} live rows, not {live_rows}")
    return next(w for w in _TILE_WIDTHS if w >= live_rows)


def qmm_grouped_plain(qt, tile_expert: torch.Tensor,
                      x_tiles: torch.Tensor,
                      tile_rows: Optional[torch.Tensor] = None,
                      x_prepermuted: bool = False) -> torch.Tensor:
    """x_tiles (G, TB, n) in natural column order (``x_prepermuted``: in
    the stride-16 permuted order, a nibble table), tile g against expert
    tile_expert[g] of W (E, d, n), a nibble, packed or fp8 table -> (G, TB, d)
    float32. Rows at or past tile_rows[g] (when given) are zero."""
    x_tiles = _natural_x(qt, x_tiles, x_prepermuted, "qmm_grouped")
    G, TB, _ = x_tiles.shape
    d = qt.shape[-2]
    out = torch.zeros((G, TB, d), dtype=torch.float32, device=x_tiles.device)
    te = tile_expert.long()
    qt = _stored(qt)
    for e in te.unique().tolist():
        sel = (te == e).nonzero()[:, 0]
        w = qt.map(lambda t: t[e]).dequant(torch.float32)
        out[sel] = torch.matmul(x_tiles[sel].float(), w.t())
    if tile_rows is not None:
        live = torch.arange(TB, device=out.device)[None, :] < tile_rows[:, None]
        out = torch.where(live[..., None], out, torch.zeros_like(out))
    return out


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor,
              group_sizes: torch.Tensor) -> torch.Tensor:
    """Row group e of lhs (M, k) times rhs[e].T, rhs (E, n, k) cast to
    lhs's dtype (the compute dtype) -> (M, n) float32. Groups are
    consecutive from row 0; rows past the last group are zero."""
    M, E = lhs.shape[0], rhs.shape[0]
    out = torch.zeros((M, rhs.shape[1]), dtype=torch.float32, device=lhs.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()[:E]):
        end = min(start + int(size), M)
        if end > start:
            w = rhs[e].to(lhs.dtype).float()
            out[start:end] = torch.matmul(lhs[start:end].float(), w.t())
        start = end
    return out


def _check_planes(qt: KNibbleTensor, x: torch.Tensor, experts: bool) -> None:
    dims = 3 if experts else 2
    if qt.p.dim() != dims:
        raise ValueError(f"expected {dims}-D nibble planes, got {tuple(qt.p.shape)}")
    planes = [("p", qt.p, torch.uint8), ("a", qt.a, torch.bfloat16)]
    if qt.c is not None:
        planes.append(("c", qt.c, torch.bfloat16))
    for name, t, dt in planes:
        if t.device != x.device or t.dtype != dt or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(
                f"plane {name}: need a contiguous, 16-byte aligned {dt} "
                f"tensor on {x.device}, got {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()}, address % 16 = {t.data_ptr() % 16}")
    n = qt.shape[-1]
    if n % 256:
        raise ValueError(f"nibble kernels need in-features % 256 == 0, got {n}")


# K5's fp8 matvec (csrc/fp8_mv.cu; the tests read it back): x rows a pass
# (kMvRowsX, = ROW_TILE_MIN); it sizes its own grid from the card's
# occupancy
_MV_ROWS_X = 4
_X_DTYPE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# K1's and K2's nibble matvec (csrc/nibble_mv.cu; the tests read these
# back): x rows a K1 launch takes at most (kNbMaxX, = ROW_TILE_MIN; more
# rows go in passes of it), warps a block (kNbThreads / 32), |off| at most
# (kNbMaxOff) and, by the x rows an item takes (K2's: 1), the warps an SM
# holds at the launch bounds (2 x kNbBlocksFew at 1-2, 2 x kNbBlocksMany at
# 3-4)
_NB_MAX_X = 4
_NB_BLOCK_WARPS = 2
_NB_MAX_OFF = 8
_NB_WARPS_PER_SM = {1: 16, 2: 16, 3: 12, 4: 12}


def check_mv_x(x2: torch.Tensor, n: int, what: str) -> None:
    """Raise ValueError unless the nibble or fp8 matvec takes x2 (rows, n)
    as it is: f32, f16 or bf16 (read in its own dtype, no cast launch),
    contiguous, 16-byte aligned, as wide as the weight."""
    if x2.dim() != 2 or x2.shape[1] != n:
        raise ValueError(f"{what}: x {tuple(x2.shape)} against in-features {n}")
    if x2.dtype not in _X_DTYPE or not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError(f"{what}: x must be a contiguous, 16-byte aligned f32, f16 or "
                         f"bf16 tensor, got {x2.dtype}, contiguous={x2.is_contiguous()}, "
                         f"address % 16 = {x2.data_ptr() % 16}")


def nibble_warps(rows: int, d: int, n: int, sms: int, experts: bool = False) -> int:
    """The nibble matvec's persistent warps for ``rows`` x rows (K1: 1 to
    ``_NB_MAX_X``, all in each item) or pairs (``experts``, K2: one item
    per pair and row group) of a (d, n) weight on ``sms`` SMs: an item is
    one row for each lane subgroup of a warp (``packed_lanes`` lanes a row:
    the same superblock a lane a step); as many warps as the card
    holds at the kernel's launch bounds, fewer where that spreads the items
    more evenly (every warp walks ``per`` or ``per - 1`` items), so that no
    partial last wave is left."""
    items = (rows if experts else 1) * -(-d // (32 // packed_lanes(n)))
    most = sms * _NB_WARPS_PER_SM[1 if experts else rows]
    per = -(-items // most)
    return -(-items // per)


def _nibble_mv(qt: KNibbleTensor, x2: torch.Tensor, idx, d: int,
               x_perm: bool = False) -> torch.Tensor:
    """Launch csrc/nibble_mv.cu: its x pre-pass, then the matvec. idx: K2's
    expert ids (int32 or int64, one a row, as given), or None (K1: the rows
    in passes of up to ``_NB_MAX_X``, each reading the weight once)."""
    rows, n = x2.shape
    check_mv_x(x2, n, "nibble_mv")
    if idx is not None:
        check_ids(idx, rows, x2.device, "nibble_mv")
    if abs(int(qt.off)) > _NB_MAX_OFF:
        raise ValueError(f"nibble_mv takes |off| <= {_NB_MAX_OFF}, not {qt.off}")
    y = torch.empty((rows, d), dtype=torch.float32, device=x2.device)
    step = rows if idx is not None else _NB_MAX_X
    sms = _sm_count(x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    for r0 in range(0, rows, step):
        xr, yr = x2[r0:r0 + step], y[r0:r0 + step]
        nr = xr.shape[0]
        # the pre-pass's two int8 terms and group scalars: 40 bytes a group
        scratch = torch.empty(nr * (n // 16) * 40, dtype=torch.uint8, device=x2.device)
        err = library("nibble_mv").nibble_mv(
            xr.data_ptr(), _X_DTYPE[x2.dtype], int(x_perm), qt.p.data_ptr(), qt.a.data_ptr(),
            qt.c.data_ptr() if qt.c is not None else None, int(qt.off),
            idx.data_ptr() if idx is not None else None,
            idx.element_size() if idx is not None else 0, scratch.data_ptr(), yr.data_ptr(),
            nr, d, n, packed_lanes(n), nibble_warps(nr, d, n, sms, idx is not None), stream)
        check(err, "nibble_mv")
    return y


def _nibble_args(qt: KNibbleTensor):
    return (1 if qt.c is not None else 0, qt.p.data_ptr(), qt.a.data_ptr(),
            qt.c.data_ptr() if qt.c is not None else None, int(qt.off))


_NIB_XPERM_KIND = 10    # kNibP in csrc/qmm_tiles.cu (kNibCP = 11): x permuted


def _tile_gemm(x2, kind, w, a, c, off, tiles, y, G, d, scales=(None, 0, 0),
               s2=None):
    """Launch csrc/qmm_tiles.cu over x2 (rows, n) f32; ``tiles`` =
    (tile_expert, tile_rows), each an int32 device tensor or None;
    ``scales`` = (scale pointer, b0, b1): an fp8 table's grid, or a packed
    table's super scales (b0 = b1 = 0) with Q2_K's super mins in ``s2``."""
    ptr = [t.data_ptr() if t is not None else None for t in tiles]
    err = library("qmm_tiles").tile_gemm(
        x2.data_ptr(), kind, w, a, c, off, *scales, s2, *ptr,
        y.data_ptr(), x2.shape[0], G, d, x2.shape[1],
        torch.cuda.current_stream(x2.device).cuda_stream)
    check(err, "tile_gemm")


def qmm(qt, x: torch.Tensor) -> torch.Tensor:
    """K1: x (..., n) @ W (d, n).T -> (..., d) float32. More than
    ``ROW_TILE_MIN`` rows take the row-tiled route (``qmm_rows``). A plain
    weight takes ``qmm_fp`` (K4), an fp8 one ``qmm_fp8`` (K5), a packed one
    ``qmm_packed`` (K5), a turbo one ``qmm_turbo`` (K5)."""
    if isinstance(qt, PlainTensor):
        return qmm_fp(qt, x)
    if isinstance(qt, Fp8Tensor):
        return qmm_fp8(qt, x)
    if isinstance(qt, PACKED):
        return qmm_packed(qt, x)
    if isinstance(qt, TURBO):
        return qmm_turbo(qt, x)
    if x.device.type == "cpu":
        return qmm_plain(qt, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm runs on cuda or cpu tensors, not {x.device}")
    _check_planes(qt, x, experts=False)
    lead, n = x.shape[:-1], x.shape[-1]
    d = qt.shape[-2]
    x2 = x.reshape(-1, n)
    if x2.shape[0] == 0:
        return x.new_zeros((*lead, d), dtype=torch.float32)
    if x2.shape[0] > ROW_TILE_MIN:
        return qmm_rows(qt, x2).reshape(*lead, d)
    y = _nibble_mv(qt, x2.contiguous(), None, d)
    qmm.launches += 1
    return y.reshape(*lead, d)


# The JAX package sends a plain weight through its Pallas body only from
# this size on, at <= PLAIN_KERNEL_MAX_ROWS rows, with both widths % 128
# (qmm.py:302, :326-327); ops.matmul.qmatmul keeps that condition for K4.
PLAIN_KERNEL_MIN_BYTES = 32 * 1024 * 1024
PLAIN_KERNEL_MAX_ROWS = 8


def qmm_fp_plain(qt: PlainTensor, x: torch.Tensor) -> torch.Tensor:
    """x (..., n) @ W (d, n).T, W widened to f32 -> (..., d) float32."""
    return torch.matmul(x.float(), qt.data.float().t())


def qmm_fp(qt: PlainTensor, x: torch.Tensor) -> torch.Tensor:
    """K4, qmm's plain body: x (..., n) with at most 8 rows @ a plain
    f32/f16/bf16 weight W (d, n).T, widened to f32 in registers ->
    (..., d) float32. Each weight row is read once for all rows."""
    if x.device.type == "cpu":
        return qmm_fp_plain(qt, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_fp runs on cuda or cpu tensors, not {x.device}")
    w = qt.data
    lead, n = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, n).float().contiguous()
    rows = x2.shape[0]
    if w.dim() != 2 or w.shape[1] != n or not 1 <= rows <= PLAIN_KERNEL_MAX_ROWS:
        raise ValueError(f"qmm_fp: W {tuple(w.shape)}, x {tuple(x.shape)} "
                         f"(1 to {PLAIN_KERNEL_MAX_ROWS} rows)")
    if w.device != x.device or w.dtype not in _PLAIN_KIND \
            or not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"qmm_fp: need a contiguous, 16-byte aligned "
                         f"f32/f16/bf16 weight on {x.device}, got {w.dtype} on "
                         f"{w.device}, contiguous={w.is_contiguous()}")
    if n % 64:
        raise ValueError(f"qmm_fp needs in-features % 64 == 0, got {n}")
    d = w.shape[0]
    y = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    err = library("qmm").plain_mv(
        x2.data_ptr(), w.data_ptr(), _PLAIN_KIND[w.dtype], y.data_ptr(), rows,
        d, n, torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "plain_mv")
    qmm_fp.launches += 1
    return y.reshape(*lead, d)


def qmm_rows(qt: KNibbleTensor, x: torch.Tensor) -> torch.Tensor:
    """K1's row-tiled route: x (rows, n) @ W (d, n).T -> (rows, d) float32,
    128 rows a tile. ``qmm`` calls it above ``ROW_TILE_MIN`` rows."""
    if x.device.type == "cpu":
        return qmm_plain(qt, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_rows runs on cuda or cpu tensors, not {x.device}")
    _check_planes(qt, x, experts=False)
    rows, d = x.shape[0], qt.shape[-2]
    x2 = x.float().contiguous()
    y = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    kind, p, a, c, off = _nibble_args(qt)
    _tile_gemm(x2, kind, p, a, c, off, (None, None), y, -(-rows // _TILE), d)
    qmm_rows.launches += 1
    return y


def qmm_tiled(qt, x: torch.Tensor) -> torch.Tensor:
    """The row-tiled route of a nibble, packed, turbo or blockwise fp8
    weight at any row count, even at most ``ROW_TILE_MIN``: x (rows, n) ->
    (rows, d) float32. Verify mode (``ops/matmul.py::qmatmul``) calls it
    on slices of at most ``VERIFY_ROWS`` rows, each one narrow tile of MMA
    width 16, so a row's bits do not follow the slice's other rows. An fp8
    weight whose column blocks are no multiple of 64 has no tile route: it
    takes its matvec, whose rows are likewise independent."""
    if isinstance(qt, Fp8Tensor):
        return qmm_fp8_rows(qt, x) if qt.block_size[1] % 64 == 0 else qmm_fp8(qt, x)
    if isinstance(qt, PACKED):
        return qmm_packed_rows(qt, x)
    if isinstance(qt, TURBO):
        return qmm_turbo_rows(qt, x)
    return qmm_rows(qt, x)


def qmm_experts(qt, idx: torch.Tensor, x: torch.Tensor,
                x_prepermuted: bool = False) -> torch.Tensor:
    """K2: row i of x (..., n) against expert idx[i] of W (E, d, n) ->
    (..., d) float32. ``idx`` (...) must hold ids in [0, E): the kernel
    reads the expert's planes at that offset unchecked. A plain table
    takes ``qmm_experts_fp``, an fp8 one ``qmm_experts_fp8``, a packed one
    ``qmm_experts_packed``, a turbo one ``qmm_experts_turbo``.
    ``x_prepermuted`` (a nibble table only; any other raises): x is in the
    stride-16 permuted order, as a row-permuted w13 leaves h, and the
    kernel's pre-pass reads each natural column from its permuted position
    (K2's prepermuted body). A nibble table's ids are read as given, int32
    or int64."""
    if x_prepermuted and not isinstance(qt, KNibbleTensor):
        raise ValueError(f"qmm_experts: x_prepermuted needs a nibble table, "
                         f"not {type(qt).__name__}")
    if isinstance(qt, PlainTensor):
        return qmm_experts_fp(qt, idx, x)
    if isinstance(qt, Fp8Tensor):
        return qmm_experts_fp8(qt, idx, x)
    if isinstance(qt, PACKED):
        return qmm_experts_packed(qt, idx, x)
    if isinstance(qt, TURBO):
        return qmm_experts_turbo(qt, idx, x)
    if x.device.type == "cpu":
        return qmm_experts_plain(qt, idx, x, x_prepermuted)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_experts runs on cuda or cpu tensors, not {x.device}")
    _check_planes(qt, x, experts=True)
    lead, n = x.shape[:-1], x.shape[-1]
    d = qt.shape[-2]
    if idx.shape != lead:
        raise ValueError(f"idx shape {tuple(idx.shape)} != rows {tuple(lead)}")
    x2 = x.reshape(-1, n)
    if x2.shape[0] == 0:
        return x.new_zeros((*lead, d), dtype=torch.float32)
    y = _nibble_mv(qt, x2.contiguous(), idx.reshape(-1).contiguous(), d, x_prepermuted)
    (qmm_experts.prepermuted if x_prepermuted else qmm_experts).launches += 1
    return y.reshape(*lead, d)


def qmm_experts_fp(qt: PlainTensor, idx: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """K2's plain body: row i of x (..., n) against expert idx[i] (ids in
    [0, E), read unchecked) of a plain f32/f16/bf16 table W (E, d, n),
    widened to f32 -> (..., d) float32."""
    if x.device.type == "cpu":
        return qmm_experts_plain(qt, idx, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_experts_fp runs on cuda or cpu tensors, not {x.device}")
    w = qt.data
    lead, n = x.shape[:-1], x.shape[-1]
    if w.dim() != 3 or w.shape[2] != n or idx.shape != lead:
        raise ValueError(f"qmm_experts_fp: W {tuple(w.shape)}, x {tuple(x.shape)}, "
                         f"idx {tuple(idx.shape)}")
    if w.device != x.device or w.dtype not in _PLAIN_KIND \
            or not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"qmm_experts_fp: need a contiguous, 16-byte aligned "
                         f"f32/f16/bf16 table on {x.device}, got {w.dtype} on "
                         f"{w.device}, contiguous={w.is_contiguous()}")
    if n % 8:
        raise ValueError(f"qmm_experts_fp needs in-features % 8 == 0, got {n}")
    d = w.shape[1]
    x2 = x.reshape(-1, n).float().contiguous()
    if x2.shape[0] == 0:
        return x.new_zeros((*lead, d), dtype=torch.float32)
    idx32 = idx.reshape(-1).to(device=x.device, dtype=torch.int32).contiguous()
    y = torch.empty((x2.shape[0], d), dtype=torch.float32, device=x.device)
    err = library("qmm").plain_matvec(
        x2.data_ptr(), w.data_ptr(), _PLAIN_KIND[w.dtype], idx32.data_ptr(),
        y.data_ptr(), x2.shape[0], d, n,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "plain_matvec")
    qmm_experts_fp.launches += 1
    return y.reshape(*lead, d)


def qmm_grouped(qt: KNibbleTensor, tile_expert: torch.Tensor,
                x_tiles: torch.Tensor,
                tile_rows: Optional[torch.Tensor] = None,
                x_prepermuted: bool = False) -> torch.Tensor:
    """K6: x_tiles (G, 128, n) f32 in natural column order, tile g against
    expert tile_expert[g] (ids in [0, E), read unchecked) of the nibble
    table W (E, d, n) -> (G, 128, d) float32. With ``tile_rows`` (G,) only
    the first tile_rows[g] rows of tile g are computed; the kernel leaves
    the others unwritten (the plain version zeroes them). An fp8 table
    takes ``qmm_grouped_fp8``, a packed one ``qmm_grouped_packed``, a turbo
    one ``qmm_grouped_turbo``. ``x_prepermuted`` (a nibble table only; any
    other raises): x_tiles are in the stride-16 permuted order, and the
    kernel reads each natural column from its permuted position as it
    stages a tile (K6's prepermuted body)."""
    if x_prepermuted and not isinstance(qt, KNibbleTensor):
        raise ValueError(f"qmm_grouped: x_prepermuted needs a nibble table, "
                         f"not {type(qt).__name__}")
    if isinstance(qt, Fp8Tensor):
        return qmm_grouped_fp8(qt, tile_expert, x_tiles, tile_rows)
    if isinstance(qt, PACKED):
        return qmm_grouped_packed(qt, tile_expert, x_tiles, tile_rows)
    if isinstance(qt, TURBO):
        return qmm_grouped_turbo(qt, tile_expert, x_tiles, tile_rows)
    if x_tiles.device.type == "cpu":
        return qmm_grouped_plain(qt, tile_expert, x_tiles, tile_rows, x_prepermuted)
    if x_tiles.device.type != "cuda":
        raise ValueError(f"qmm_grouped runs on cuda or cpu tensors, not {x_tiles.device}")
    _check_planes(qt, x_tiles, experts=True)
    x2, te, tr, y = _grouped_operands(qt, tile_expert, x_tiles, tile_rows,
                                      "qmm_grouped")
    kind, p, a, c, off = _nibble_args(qt)
    if x_prepermuted:
        kind += _NIB_XPERM_KIND
    _tile_gemm(x2, kind, p, a, c, off, (te, tr), y, te.shape[0], qt.shape[-2])
    (qmm_grouped.prepermuted if x_prepermuted else qmm_grouped).launches += 1
    return y


def _grouped_operands(qt, tile_expert, x_tiles, tile_rows, what):
    """Checked K6 operands: (x (G*128, n) f32, tile_expert and tile_rows
    as int32, the output (G, 128, d))."""
    G, TB, n = x_tiles.shape
    if TB != _TILE or tile_expert.shape != (G,) or n != qt.shape[-1]:
        raise ValueError(f"{what}: x_tiles {tuple(x_tiles.shape)}, "
                         f"tile_expert {tuple(tile_expert.shape)}, W {qt.shape}")
    dev = x_tiles.device
    for t in (tile_expert, tile_rows):
        if t is not None and t.device != dev:
            raise ValueError(f"{what}: tile maps on another device")
    x2 = x_tiles.reshape(G * TB, n).float().contiguous()
    y = torch.empty((G, TB, qt.shape[-2]), dtype=torch.float32, device=dev)
    te = tile_expert.to(torch.int32).contiguous()
    tr = None if tile_rows is None else tile_rows.to(torch.int32).contiguous()
    return x2, te, tr, y


# ---------------------------------------------------------------------------
# the fp8 bodies (K5, and K2's and K6's): blockwise F8E5M2 weights
# ---------------------------------------------------------------------------

def _check_fp8(qt: Fp8Tensor, x: torch.Tensor, experts: bool, col_align: int,
               what: str) -> None:
    """Raise unless the kernels can take ``qt`` against x's device: a
    blockwise grid of the ceil size, contiguous 16-byte aligned bytes, f32
    scales, in-features and column blocks multiples of ``col_align``."""
    dims = 3 if experts else 2
    if qt.per_tensor:
        raise ValueError(f"{what}: a per-tensor fp8 scale has no kernel (the "
                         "callers dequantize it, as the JAX package does)")
    b0, b1 = qt.block_size
    d, n = qt.shape[-2:]
    grid = (*qt.shape[:-2], -(-d // b0), -(-n // b1))
    if qt.data.dim() != dims or tuple(qt.scale.shape) != grid:
        raise ValueError(f"{what}: expected a {dims}-D fp8 weight with a "
                         f"{grid} scale grid, got {qt.shape} and "
                         f"{tuple(qt.scale.shape)}")
    for name, t, dt in (("data", qt.data, torch.float8_e5m2),
                        ("scale", qt.scale, torch.float32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{what}: {name} must be a contiguous, 16-byte aligned {dt} "
                f"tensor on {x.device}, got {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()}, address % 16 = {t.data_ptr() % 16}")
    if n % col_align or b1 % col_align:
        raise ValueError(f"{what} needs in-features and the column block % "
                         f"{col_align} == 0, got {n} and {b1}")


def _fp8_matvec(qt: Fp8Tensor, x2: torch.Tensor, idx, d: int) -> torch.Tensor:
    """K2's fp8 body (csrc/qmm.cu ``fp8_matvec``), idx (rows,) int32."""
    x2 = x2.float().contiguous()
    y = torch.empty((x2.shape[0], d), dtype=torch.float32, device=x2.device)
    err = library("qmm").fp8_matvec(
        x2.data_ptr(), qt.data.data_ptr(), qt.scale.data_ptr(), idx.data_ptr(),
        y.data_ptr(), x2.shape[0], d, x2.shape[1], *qt.block_size,
        torch.cuda.current_stream(x2.device).cuda_stream)
    check(err, "fp8_matvec")
    return y


def _fp8_mv(qt: Fp8Tensor, x2: torch.Tensor, d: int) -> torch.Tensor:
    """Launch csrc/fp8_mv.cu: x2 (rows, n) in its own dtype, four rows a
    pass."""
    rows, n = x2.shape
    check_mv_x(x2, n, "fp8_mv")
    y = torch.empty((rows, d), dtype=torch.float32, device=x2.device)
    err = library("fp8_mv").fp8_mv(
        x2.data_ptr(), _X_DTYPE[x2.dtype], qt.data.data_ptr(), qt.scale.data_ptr(),
        y.data_ptr(), rows, d, n, *qt.block_size,
        torch.cuda.current_stream(x2.device).cuda_stream)
    check(err, "fp8_mv")
    return y


def qmm_fp8(qt: Fp8Tensor, x: torch.Tensor) -> torch.Tensor:
    """K5's fp8 body: x (..., n) @ W (d, n).T for a blockwise F8E5M2 weight
    -> (..., d) float32; more than ``ROW_TILE_MIN`` rows take
    ``qmm_fp8_rows`` where its 64-column k-steps fit the column blocks (b1
    % 64 == 0: the converter's 128), the matvec (four rows a pass, each
    reading the weight once) where they do not. x is read in its own dtype
    (f32, f16 or bf16)."""
    if x.device.type == "cpu":
        return qmm_plain(qt, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_fp8 runs on cuda or cpu tensors, not {x.device}")
    _check_fp8(qt, x, False, 16, "qmm_fp8")
    lead, n = x.shape[:-1], x.shape[-1]
    d = qt.shape[-2]
    x2 = x.reshape(-1, n)
    if x2.shape[0] == 0:
        return x.new_zeros((*lead, d), dtype=torch.float32)
    if x2.shape[0] > ROW_TILE_MIN and qt.block_size[1] % 64 == 0:
        return qmm_fp8_rows(qt, x2).reshape(*lead, d)
    y = _fp8_mv(qt, x2.contiguous(), d)
    qmm_fp8.launches += 1
    return y.reshape(*lead, d)


def qmm_fp8_rows(qt: Fp8Tensor, x: torch.Tensor) -> torch.Tensor:
    """K5's row-tiled route: x (rows, n) @ W (d, n).T for a blockwise fp8
    weight -> (rows, d) float32, 128 rows a tile."""
    if x.device.type == "cpu":
        return qmm_plain(qt, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_fp8_rows runs on cuda or cpu tensors, not {x.device}")
    _check_fp8(qt, x, False, 64, "qmm_fp8_rows")
    rows, d = x.shape[0], qt.shape[-2]
    x2 = x.float().contiguous()
    y = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    _tile_gemm(x2, _FP8_KIND, qt.data.data_ptr(), None, None, 0,
               (None, None), y, -(-rows // _TILE), d,
               scales=(qt.scale.data_ptr(), *qt.block_size))
    qmm_fp8_rows.launches += 1
    return y


def qmm_experts_fp8(qt: Fp8Tensor, idx: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """K2's fp8 body: row i of x (..., n) against expert idx[i] (ids in
    [0, E), read unchecked) of a blockwise F8E5M2 table W (E, d, n) ->
    (..., d) float32."""
    if x.device.type == "cpu":
        return qmm_experts_plain(qt, idx, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_experts_fp8 runs on cuda or cpu tensors, not {x.device}")
    _check_fp8(qt, x, True, 16, "qmm_experts_fp8")
    lead, n = x.shape[:-1], x.shape[-1]
    d = qt.shape[-2]
    if idx.shape != lead or n != qt.shape[-1]:
        raise ValueError(f"qmm_experts_fp8: W {qt.shape}, x {tuple(x.shape)}, "
                         f"idx {tuple(idx.shape)}")
    x2 = x.reshape(-1, n)
    if x2.shape[0] == 0:
        return x.new_zeros((*lead, d), dtype=torch.float32)
    idx32 = idx.reshape(-1).to(device=x.device, dtype=torch.int32).contiguous()
    y = _fp8_matvec(qt, x2, idx32, d)
    qmm_experts_fp8.launches += 1
    return y.reshape(*lead, d)


def qmm_grouped_fp8(qt: Fp8Tensor, tile_expert: torch.Tensor,
                    x_tiles: torch.Tensor,
                    tile_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6's fp8 body: ``qmm_grouped`` over a blockwise F8E5M2 table W (E,
    d, n) -> (G, 128, d) float32 (rows past tile_rows[g] unwritten on the
    card, zero in the plain version)."""
    if x_tiles.device.type == "cpu":
        return qmm_grouped_plain(qt, tile_expert, x_tiles, tile_rows)
    if x_tiles.device.type != "cuda":
        raise ValueError(f"qmm_grouped_fp8 runs on cuda or cpu tensors, not "
                         f"{x_tiles.device}")
    _check_fp8(qt, x_tiles, True, 64, "qmm_grouped_fp8")
    x2, te, tr, y = _grouped_operands(qt, tile_expert, x_tiles, tile_rows,
                                      "qmm_grouped_fp8")
    _tile_gemm(x2, _FP8_KIND, qt.data.data_ptr(), None, None, 0,
               (te, tr), y, te.shape[0], qt.shape[-2],
               scales=(qt.scale.data_ptr(), *qt.block_size))
    qmm_grouped_fp8.launches += 1
    return y


# ---------------------------------------------------------------------------
# the packed bodies (K5, and K2's and K6's): Q2_K / Q3_K plane layouts
# ---------------------------------------------------------------------------

_Q2K_TILE_KIND = 6      # kQ2 in csrc/qmm_tiles.cu; kQ3 = 7


def _check_packed(qt, x: torch.Tensor, experts: bool, what: str) -> None:
    """Raise unless the kernels can take the packed planes against x's
    device."""
    if isinstance(qt, Q2KTensor):
        planes = (("qs", qt.qs, torch.uint8, 4), ("sm", qt.sm, torch.uint8, 16),
                  ("d", qt.d, torch.float32, 256), ("dmin", qt.dmin, torch.float32, 256))
    else:
        planes = (("qs", qt.qs, torch.uint8, 4), ("hm", qt.hm, torch.uint8, 8),
                  ("sc", qt.sc, torch.int8, 16), ("d", qt.d, torch.float32, 256))
    _check_kquant_planes(qt, planes, x, experts, what)


def _check_kquant_planes(qt, planes, x: torch.Tensor, experts: bool,
                         what: str) -> None:
    """Raise unless each of ``planes`` ((name, tensor, dtype, in-features
    per element)) is contiguous, 16-byte aligned, of its dtype and of the
    shape the in-features give, on x's device, and in-features % 256 ==
    0."""
    dims = 3 if experts else 2
    n = qt.shape[-1]
    if n % 256:
        raise ValueError(f"{what}: K-quant kernels need in-features % 256 "
                         f"== 0 (the converter writes no other), got {n}")
    lead = tuple(planes[0][1].shape[:-1])
    for name, t, dt, per in planes:
        if t.dim() != dims or tuple(t.shape) != lead + (n // per,):
            raise ValueError(f"{what}: plane {name} {tuple(t.shape)}, expected "
                             f"{lead + (n // per,)} ({dims}-D planes)")
        if t.device != x.device or t.dtype != dt or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{what}: plane {name} must be a contiguous, 16-byte aligned {dt} "
                f"tensor on {x.device}, got {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()}, address % 16 = {t.data_ptr() % 16}")


def _packed_ptrs(qt):
    """(kind: 0 = Q2_K, 1 = Q3_K; then the pointers of qs, hm, the scale
    bytes, d and dmin, hm or dmin None)."""
    if isinstance(qt, Q2KTensor):
        return (0, qt.qs.data_ptr(), None, qt.sm.data_ptr(), qt.d.data_ptr(),
                qt.dmin.data_ptr())
    return (1, qt.qs.data_ptr(), qt.hm.data_ptr(), qt.sc.data_ptr(),
            qt.d.data_ptr(), None)


# K5's and K2's packed matvec (csrc/packed_mv.cu; the tests read these
# back): weight rows a lane subgroup holds (kPkRows), x rows a K5 launch
# takes at most (kPkMaxX, = ROW_TILE_MIN), warps a block (kPkThreads / 32)
# and, by the x rows an item takes (K2's: 1), the warps an SM holds at the
# launch bounds (2 x kPkBlocksFew at 1-2, 2 x kPkBlocksMany at 3-4)
_PK_ROWS = 2
_PK_MAX_X = 4
_PK_BLOCK_WARPS = 2
_PK_WARPS_PER_SM = {1: 16, 2: 16, 3: 12, 4: 12}
_SMS = {}


def packed_lanes(n: int) -> int:
    """Lanes that share one weight row in the packed matvec, from the
    256-column superblocks a row has (a lane takes one a step): 32 from 24
    superblocks on (V3's n = 7168, 16384, 18432), 8 from 6 (n = 1536,
    2048), else 2 (n = 512), so that short rows still fill the warp."""
    units = n // 256
    return 32 if units >= 24 else 8 if units >= 6 else 2


def packed_warps(rows: int, d: int, n: int, sms: int, experts: bool = False) -> int:
    """The packed matvec's persistent warps for ``rows`` x rows (K5: 1 to
    ``_PK_MAX_X``, all in each item) or pairs (``experts``, K2: one item
    per pair and row group) of a (d, n) weight on ``sms`` SMs: an item is
    ``_PK_ROWS`` rows for each lane subgroup of a warp; as many warps as
    the card holds at the kernel's launch bounds, fewer where that spreads
    the items more evenly (every warp walks ``per`` or ``per - 1``
    items), so that no partial last wave is left."""
    warp_rows = 32 // packed_lanes(n) * _PK_ROWS
    items = (rows if experts else 1) * -(-d // warp_rows)
    most = sms * _PK_WARPS_PER_SM[1 if experts else rows]
    per = -(-items // most)
    return -(-items // per)


def _sm_count(device: torch.device) -> int:
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def check_ids(idx: torch.Tensor, rows: int, device, what: str) -> None:
    """Raise ValueError unless ``idx`` holds one int32 or int64 expert id
    a row on ``device``, contiguous: what the kernels that read ids as
    given (no cast launch) take."""
    if idx.dtype not in (torch.int32, torch.int64) or idx.device != device \
            or tuple(idx.shape) != (rows,) or not idx.is_contiguous():
        raise ValueError(f"{what}: expert ids must be {rows} contiguous int32 or int64 "
                         f"values on {device}, got {idx.dtype} {tuple(idx.shape)} "
                         f"on {idx.device}")


def check_packed_mv(qt, x2: torch.Tensor, idx, what: str) -> None:
    """Raise ValueError unless csrc/packed_mv.cu takes x (rows, n) and the
    ids beside planes that ``_check_packed`` has passed: x as wide as the
    weight, at most ``_PK_MAX_X`` rows without ids, and ids of int32 or
    int64 on x's device, one a row, contiguous."""
    rows, n = x2.shape
    if n != qt.shape[-1]:
        raise ValueError(f"{what}: x {tuple(x2.shape)} against W {qt.shape}")
    if idx is None:
        if not 1 <= rows <= _PK_MAX_X:
            raise ValueError(f"{what}: the matvec takes 1 to {_PK_MAX_X} rows, not {rows}")
        return
    check_ids(idx, rows, x2.device, what)


def _packed_matvec(qt, x2: torch.Tensor, idx, d: int, what: str) -> torch.Tensor:
    """Launch csrc/packed_mv.cu: its x pre-pass (x in its own dtype), then
    the matvec."""
    x2 = x2.contiguous()
    check_packed_mv(qt, x2, idx, what)
    rows, n = x2.shape
    check_mv_x(x2, n, what)
    y = torch.empty((rows, d), dtype=torch.float32, device=x2.device)
    # the pre-pass's two int8 terms and group scalars: 40 bytes a group
    scratch = torch.empty(rows * (n // 16) * 40, dtype=torch.uint8, device=x2.device)
    warps = packed_warps(rows, d, n, _sm_count(x2.device), experts=idx is not None)
    err = library("packed_mv").packed_mv(
        x2.data_ptr(), _X_DTYPE[x2.dtype], *_packed_ptrs(qt),
        idx.data_ptr() if idx is not None else None,
        idx.element_size() if idx is not None else 0, scratch.data_ptr(),
        y.data_ptr(), rows, d, n, packed_lanes(n), warps,
        torch.cuda.current_stream(x2.device).cuda_stream)
    check(err, "packed_mv")
    return y


def _packed_tiles(qt, x2, tiles, y, G):
    kind, qs, hm, s8, dsup, dmin = _packed_ptrs(qt)
    _tile_gemm(x2, _Q2K_TILE_KIND + kind, qs, s8, hm, 0, tiles, y, G,
               qt.shape[-2], scales=(dsup, 0, 0), s2=dmin)


def qmm_packed(qt, x: torch.Tensor) -> torch.Tensor:
    """K5's packed bodies: x (..., n) @ W (d, n).T for a packed Q2_K/Q3_K
    weight -> (..., d) float32; more than ``ROW_TILE_MIN`` rows take
    ``qmm_packed_rows``."""
    if x.device.type == "cpu":
        return qmm_plain(qt, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_packed runs on cuda or cpu tensors, not {x.device}")
    _check_packed(qt, x, False, "qmm_packed")
    lead, n = x.shape[:-1], x.shape[-1]
    d = qt.shape[-2]
    x2 = x.reshape(-1, n)
    if x2.shape[0] == 0:
        return x.new_zeros((*lead, d), dtype=torch.float32)
    if x2.shape[0] > ROW_TILE_MIN:
        return qmm_packed_rows(qt, x2).reshape(*lead, d)
    y = _packed_matvec(qt, x2, None, d, "qmm_packed")
    qmm_packed.launches += 1
    return y.reshape(*lead, d)


def qmm_packed_rows(qt, x: torch.Tensor) -> torch.Tensor:
    """K5's packed row-tiled route: x (rows, n) @ W (d, n).T -> (rows, d)
    float32, 128 rows a tile."""
    if x.device.type == "cpu":
        return qmm_plain(qt, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_packed_rows runs on cuda or cpu tensors, not {x.device}")
    _check_packed(qt, x, False, "qmm_packed_rows")
    rows, d = x.shape[0], qt.shape[-2]
    x2 = x.float().contiguous()
    y = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    _packed_tiles(qt, x2, (None, None), y, -(-rows // _TILE))
    qmm_packed_rows.launches += 1
    return y


def qmm_experts_packed(qt, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K2's packed bodies: row i of x (..., n) against expert idx[i] (int32
    or int64 ids in [0, E) on x's device, read as given and unchecked) of a
    packed Q2_K/Q3_K table W (E, d, n) -> (..., d) float32."""
    if x.device.type == "cpu":
        return qmm_experts_plain(qt, idx, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_experts_packed runs on cuda or cpu tensors, not {x.device}")
    _check_packed(qt, x, True, "qmm_experts_packed")
    lead, n = x.shape[:-1], x.shape[-1]
    d = qt.shape[-2]
    if idx.shape != lead or n != qt.shape[-1]:
        raise ValueError(f"qmm_experts_packed: W {qt.shape}, x {tuple(x.shape)}, "
                         f"idx {tuple(idx.shape)}")
    x2 = x.reshape(-1, n)
    if x2.shape[0] == 0:
        return x.new_zeros((*lead, d), dtype=torch.float32)
    y = _packed_matvec(qt, x2, idx.reshape(-1).contiguous(), d, "qmm_experts_packed")
    qmm_experts_packed.launches += 1
    return y.reshape(*lead, d)


def qmm_grouped_packed(qt, tile_expert: torch.Tensor, x_tiles: torch.Tensor,
                       tile_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6's packed bodies: ``qmm_grouped`` over a packed Q2_K/Q3_K table W
    (E, d, n), x_tiles in natural column order -> (G, 128, d) float32
    (rows past tile_rows[g] unwritten on the card, zero in the plain
    version)."""
    if x_tiles.device.type == "cpu":
        return qmm_grouped_plain(qt, tile_expert, x_tiles, tile_rows)
    if x_tiles.device.type != "cuda":
        raise ValueError(f"qmm_grouped_packed runs on cuda or cpu tensors, not "
                         f"{x_tiles.device}")
    _check_packed(qt, x_tiles, True, "qmm_grouped_packed")
    x2, te, tr, y = _grouped_operands(qt, tile_expert, x_tiles, tile_rows,
                                      "qmm_grouped_packed")
    _packed_tiles(qt, x2, (te, tr), y, te.shape[0])
    qmm_grouped_packed.launches += 1
    return y


# ---------------------------------------------------------------------------
# the turbo bodies (K5, and K2's and K6's): Q2_K / Q3_K int8 planes
# ---------------------------------------------------------------------------

_Q2KT_TILE_KIND = 8     # kQ2T in csrc/qmm_tiles.cu; kQ3T = 9


def _check_turbo(qt, x: torch.Tensor, experts: bool, what: str) -> None:
    """Raise unless the kernels can take the turbo planes against x's
    device."""
    planes = [("p", qt.p, torch.int8, 1)]
    if isinstance(qt, Q2KTurboTensor):
        planes += [("d", qt.d, torch.float32, 256), ("bm", qt.bm, torch.bfloat16, 16)]
    else:
        planes += [("a", qt.a, torch.bfloat16, 16)]
    _check_kquant_planes(qt, planes, x, experts, what)


def _turbo_ptrs(qt):
    """(kind: 0 = Q2_K turbo, 1 = Q3_K turbo; the pointers of p, d (None for
    Q3_K) and the bf16 plane, bm or a)."""
    if isinstance(qt, Q2KTurboTensor):
        return 0, qt.p.data_ptr(), qt.d.data_ptr(), qt.bm.data_ptr()
    return 1, qt.p.data_ptr(), None, qt.a.data_ptr()


def _turbo_matvec(qt, x2: torch.Tensor, idx, d: int) -> torch.Tensor:
    x2 = x2.float().contiguous()
    y = torch.empty((x2.shape[0], d), dtype=torch.float32, device=x2.device)
    err = library("qmm").turbo_matvec(
        x2.data_ptr(), *_turbo_ptrs(qt), idx.data_ptr() if idx is not None else None,
        y.data_ptr(), x2.shape[0], d, x2.shape[1],
        torch.cuda.current_stream(x2.device).cuda_stream)
    check(err, "turbo_matvec")
    return y


def _turbo_tiles(qt, x2, tiles, y, G):
    kind, p, dsup, a = _turbo_ptrs(qt)
    _tile_gemm(x2, _Q2KT_TILE_KIND + kind, p, a, None, 0, tiles, y, G,
               qt.shape[-2], scales=(dsup, 0, 0))


def qmm_turbo(qt, x: torch.Tensor) -> torch.Tensor:
    """K5's turbo bodies: x (..., n) in natural order @ W (d, n).T for a
    Q2_K/Q3_K turbo weight -> (..., d) float32; more than ``ROW_TILE_MIN``
    rows take ``qmm_turbo_rows``."""
    if x.device.type == "cpu":
        return qmm_plain(qt, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_turbo runs on cuda or cpu tensors, not {x.device}")
    _check_turbo(qt, x, False, "qmm_turbo")
    lead, n = x.shape[:-1], x.shape[-1]
    d = qt.shape[-2]
    x2 = x.reshape(-1, n)
    if x2.shape[0] == 0:
        return x.new_zeros((*lead, d), dtype=torch.float32)
    if x2.shape[0] > ROW_TILE_MIN:
        return qmm_turbo_rows(qt, x2).reshape(*lead, d)
    y = _turbo_matvec(qt, x2, None, d)
    qmm_turbo.launches += 1
    return y.reshape(*lead, d)


def qmm_turbo_rows(qt, x: torch.Tensor) -> torch.Tensor:
    """K5's turbo row-tiled route: x (rows, n) @ W (d, n).T -> (rows, d)
    float32, 128 rows a tile."""
    if x.device.type == "cpu":
        return qmm_plain(qt, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_turbo_rows runs on cuda or cpu tensors, not {x.device}")
    _check_turbo(qt, x, False, "qmm_turbo_rows")
    rows, d = x.shape[0], qt.shape[-2]
    x2 = x.float().contiguous()
    y = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    _turbo_tiles(qt, x2, (None, None), y, -(-rows // _TILE))
    qmm_turbo_rows.launches += 1
    return y


def qmm_experts_turbo(qt, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K2's turbo bodies: row i of x (..., n) against expert idx[i] (ids in
    [0, E), read unchecked) of a Q2_K/Q3_K turbo table W (E, d, n) ->
    (..., d) float32."""
    if x.device.type == "cpu":
        return qmm_experts_plain(qt, idx, x)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_experts_turbo runs on cuda or cpu tensors, not {x.device}")
    _check_turbo(qt, x, True, "qmm_experts_turbo")
    lead, n = x.shape[:-1], x.shape[-1]
    d = qt.shape[-2]
    if idx.shape != lead or n != qt.shape[-1]:
        raise ValueError(f"qmm_experts_turbo: W {qt.shape}, x {tuple(x.shape)}, "
                         f"idx {tuple(idx.shape)}")
    x2 = x.reshape(-1, n)
    if x2.shape[0] == 0:
        return x.new_zeros((*lead, d), dtype=torch.float32)
    idx32 = idx.reshape(-1).to(device=x.device, dtype=torch.int32).contiguous()
    y = _turbo_matvec(qt, x2, idx32, d)
    qmm_experts_turbo.launches += 1
    return y.reshape(*lead, d)


def qmm_grouped_turbo(qt, tile_expert: torch.Tensor, x_tiles: torch.Tensor,
                      tile_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6's turbo bodies: ``qmm_grouped`` over a Q2_K/Q3_K turbo table W
    (E, d, n), x_tiles in natural column order -> (G, 128, d) float32
    (rows past tile_rows[g] unwritten on the card, zero in the plain
    version)."""
    if x_tiles.device.type == "cpu":
        return qmm_grouped_plain(qt, tile_expert, x_tiles, tile_rows)
    if x_tiles.device.type != "cuda":
        raise ValueError(f"qmm_grouped_turbo runs on cuda or cpu tensors, not "
                         f"{x_tiles.device}")
    _check_turbo(qt, x_tiles, True, "qmm_grouped_turbo")
    x2, te, tr, y = _grouped_operands(qt, tile_expert, x_tiles, tile_rows,
                                      "qmm_grouped_turbo")
    _turbo_tiles(qt, x2, (te, tr), y, te.shape[0])
    qmm_grouped_turbo.launches += 1
    return y


# ---------------------------------------------------------------------------
# K7: the fused expert FFN over a row-permuted nibble [w1;w3] table
# ---------------------------------------------------------------------------

_ACT_CODE = {ActivationType.SILU: 0, ActivationType.GELU: 1}


def expert_ffn_fusable(qt13, qt2) -> bool:
    """True where K7 takes the tables (``deepseek_tpu/ops/pallas/qmm.py::
    expert_ffn_fusable`` without its environment read and its TPU VMEM
    budget): both nibble, w13 (E, 2m, n) row-permuted in two parts, w2
    (E, d, m), m and n multiples of 256."""
    if not (isinstance(qt13, KNibbleTensor) and isinstance(qt2, KNibbleTensor)):
        return False
    if qt13.rowperm != 2:
        return False
    m2, n = qt13.shape[-2], qt13.shape[-1]
    mh = qt2.shape[-1]
    return m2 == 2 * mh and mh % 256 == 0 and n % 256 == 0


def qmm_expert_ffn_plain(qt13: KNibbleTensor, qt2: KNibbleTensor,
                         idx: torch.Tensor, x: torch.Tensor, wts: torch.Tensor,
                         act: ActivationType) -> torch.Tensor:
    """y = sum_p wts[p] * (glu(x @ w1_e.T, x @ w3_e.T) @ w2_e.T), e =
    idx[p], for one token x (1, n) over N pairs -> (1, d) float32, as K7
    computes it: h2 against the stored (permuted) w13 rows in f32, the GLU
    in f32 times wts[p], the w2 product of that permuted h per pair (its
    natural order restored, which is what the kernel's natural-group sums
    of the permuted h amount to), the pairs summed in their order."""
    sel = idx.reshape(-1).long()
    N = sel.numel()
    w13 = qt13.stored_rows().map(lambda t: t[sel]).dequant(torch.float32)  # (N, 2m, n)
    xf = x.reshape(1, -1, 1).float().expand(N, -1, 1)
    h2 = torch.bmm(w13, xf)[..., 0]                                       # (N, 2m)
    del w13
    mh = h2.shape[-1] // 2
    g = glu_act(h2[:, :mh], h2[:, mh:], act) * wts.reshape(N, 1).float()
    w2 = qt2.stored_rows().map(lambda t: t[sel]).dequant(torch.float32)   # (N, d, m)
    per = torch.bmm(w2, unperm_x(g)[..., None])[..., 0]                   # (N, d)
    y = per[0]
    for p in range(1, N):
        y = y + per[p]
    return y[None]


def qmm_expert_ffn(qt13: KNibbleTensor, qt2: KNibbleTensor, idx: torch.Tensor,
                   x: torch.Tensor, wts: torch.Tensor,
                   act: ActivationType) -> torch.Tensor:
    """K7: one token's whole MoE expert chain in one launch,

        y = sum_p wts[p] * (glu(x @ w1_e.T, x @ w3_e.T) @ w2_e.T),  e = idx[p],

    for x (1, n) in natural order, idx (N,) expert ids in [0, E) (read
    unchecked), wts (N,) routing weights (dead pairs carry 0), w13 (E, 2m,
    n) a nibble table row-permuted in two parts (``expert_ffn_fusable``)
    and w2 (E, d, m) -> (1, d) float32. h never leaves the kernel's
    scratch; no host synchronization."""
    if x.device.type == "cpu":
        return qmm_expert_ffn_plain(qt13, qt2, idx, x, wts, act)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_expert_ffn runs on cuda or cpu tensors, not {x.device}")
    if not expert_ffn_fusable(qt13, qt2):
        raise ValueError(f"qmm_expert_ffn: tables {type(qt13).__name__} "
                         f"{qt13.shape} (rowperm "
                         f"{getattr(qt13, 'rowperm', None)}) and "
                         f"{type(qt2).__name__} {qt2.shape} are not fusable")
    _check_planes(qt13, x, experts=True)
    _check_planes(qt2, x, experts=True)
    if (qt13.c is None) != (qt2.c is None):
        raise ValueError("qmm_expert_ffn: w13 and w2 must both have or both "
                         "lack the min plane c")
    E, m2, n = qt13.shape
    d, mh = qt2.shape[-2], m2 // 2
    N = idx.numel()
    if qt2.shape[0] != E or x.numel() != n or wts.numel() != N or not 1 <= N <= 65535:
        raise ValueError(f"qmm_expert_ffn: w13 {qt13.shape}, w2 {qt2.shape}, "
                         f"x {tuple(x.shape)}, idx {tuple(idx.shape)}, "
                         f"wts {tuple(wts.shape)}")
    if idx.device != x.device or wts.device != x.device:
        raise ValueError("qmm_expert_ffn: idx and wts must be on x's device")
    x1 = x.reshape(1, n).float().contiguous()
    if x1.data_ptr() % 16:                     # the kernel reads float4s
        x1 = x1.clone()
    idx32 = idx.reshape(N).to(torch.int32).contiguous()
    w = wts.reshape(N).to(torch.float32).contiguous()
    g = torch.empty((N, mh), dtype=torch.float32, device=x.device)   # h scratch
    y = torch.empty((1, d), dtype=torch.float32, device=x.device)
    has_c = qt13.c is not None
    err = library("expert_ffn").expert_ffn(
        x1.data_ptr(), qt13.p.data_ptr(), qt13.a.data_ptr(),
        qt13.c.data_ptr() if has_c else None, int(qt13.off),
        qt2.p.data_ptr(), qt2.a.data_ptr(), qt2.c.data_ptr() if has_c else None,
        int(qt2.off), idx32.data_ptr(), w.data_ptr(), g.data_ptr(), y.data_ptr(),
        N, n, mh, d, _ACT_CODE[act], torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "expert_ffn")
    qmm_expert_ffn.launches += 1
    return y


def gmm_tiles(group_sizes: torch.Tensor):
    """(group_off, tile_off), (E+1,) int32 each: the groups' first rows
    and first tiles of ``_GMM_ROWS`` rows. Tile g of csrc/gmm.cu takes
    group e (the last with tile_off[e] <= g), rows group_off[e] + (g -
    tile_off[e]) * _GMM_ROWS onwards, within the group."""
    sizes = group_sizes.to(torch.int32)
    zero = sizes.new_zeros(1)
    tiles = (sizes + _GMM_ROWS - 1) // _GMM_ROWS
    return (torch.cat([zero, torch.cumsum(sizes, 0, dtype=torch.int32)]),
            torch.cat([zero, torch.cumsum(tiles, 0, dtype=torch.int32)]))


def gmm(lhs: torch.Tensor, rhs: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    """K11: row group e of lhs (M, k) (f32 or bf16, the compute dtype)
    times rhs[e].T for a plain table rhs (E, n, k) in f32/f16/bf16, cast to
    lhs's dtype -> (M, n) float32. Groups are consecutive from row 0
    (group_sizes (E,), summing to at most M); rows past them are left
    unwritten on the card (zero in the plain version)."""
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, group_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"gmm runs on cuda or cpu tensors, not {lhs.device}")
    M, k = lhs.shape
    E, n = rhs.shape[0], rhs.shape[1]
    if rhs.dim() != 3 or rhs.shape[2] != k or group_sizes.shape != (E,):
        raise ValueError(f"gmm: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}")
    if rhs.device != lhs.device or group_sizes.device != lhs.device:
        raise ValueError("gmm: operands on different devices")
    if lhs.dtype not in (torch.float32, torch.bfloat16) or rhs.dtype not in _GMM_DTYPE:
        raise ValueError(f"gmm: unsupported dtypes {lhs.dtype} x {rhs.dtype}")
    if not rhs.is_contiguous() or rhs.data_ptr() % 16:
        raise ValueError("gmm: the table must be contiguous and 16-byte aligned")
    if k % 64:
        raise ValueError(f"gmm needs k % 64 == 0, got {k}")
    if M == 0:
        return lhs.new_zeros((0, n), dtype=torch.float32)
    x = lhs.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    group_off, tile_off = gmm_tiles(group_sizes)
    y = torch.empty((M, n), dtype=torch.float32, device=lhs.device)
    err = library("gmm").gmm(
        x.data_ptr(), _GMM_DTYPE[x.dtype], rhs.data_ptr(), _GMM_DTYPE[rhs.dtype],
        group_off.data_ptr(), tile_off.data_ptr(), y.data_ptr(), M,
        E + -(-M // _GMM_ROWS), E, n, k, torch.cuda.current_stream(lhs.device).cuda_stream)
    check(err, "gmm")
    gmm.launches += 1
    return y


qmm.launches = 0
qmm_fp.launches = 0
qmm_rows.launches = 0
qmm_experts.launches = 0
qmm_experts.prepermuted = SimpleNamespace(launches=0)
qmm_grouped.prepermuted = SimpleNamespace(launches=0)
qmm_expert_ffn.launches = 0
qmm_experts_fp.launches = 0
qmm_grouped.launches = 0
gmm.launches = 0
qmm_fp8.launches = 0
qmm_fp8_rows.launches = 0
qmm_experts_fp8.launches = 0
qmm_grouped_fp8.launches = 0
qmm_packed.launches = 0
qmm_packed_rows.launches = 0
qmm_experts_packed.launches = 0
qmm_grouped_packed.launches = 0
qmm_turbo.launches = 0
qmm_turbo_rows.launches = 0
qmm_experts_turbo.launches = 0
qmm_grouped_turbo.launches = 0
