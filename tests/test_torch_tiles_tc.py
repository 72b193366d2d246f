"""The numerics of the tile GEMM on the tensor cores (``csrc/qmm_tiles.cu``:
K1's and K5's row-tiled routes, every body of K6) against the JAX
package, on the CPU.

The kernel computes the plain versions' function (each tile's rows against
the f32 dequantization of its expert's table) with bf16 operands and f32
accumulators: each dequantized weight split into bf16 hi + lo, each
activation too, three passes a 16-column k-step (W_hi.x_hi + W_hi.x_lo +
W_lo.x_hi), the 64 columns of a k-step taken in each reader's order (the
MMA's k order is free as long as x is staged in it), the MMA width chosen
from a tile's live rows. ``_emulate`` repeats that arithmetic in float32
torch (a product of two bf16 values is exact in f32, as on the tensor
cores), over the port's plain dequantization, walking the tiles as the
kernel does, and must agree with the Pallas ``qmm_grouped`` and ``qmm`` in
interpret mode at 1e-4 of max|ref|, the tolerance of every check of the
kernel on the card. A negative control pins why both operands are split:
one bf16 pass misses 1e-4 on the same inputs. The emulation is
test-local; the plain versions stay f32.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu.ops.pallas.qmm import _group_sums, _perm_x
from deepseek_tpu.ops.pallas.qmm import qmm as jax_qmm
from deepseek_tpu.ops.pallas.qmm import qmm_grouped as jax_qmm_grouped
import deepseek_tpu_torch.ops.kernels.qmm as wrapper
from deepseek_tpu_torch.ops.kernels.qmm import (
    _TILE, _TILE_WIDTHS, qmm_grouped, qmm_rows, tile_width,
)
from deepseek_tpu_torch.quant.qtensor import perm_x
from tests.test_torch_fp8 import _quantize
from tests.test_torch_qmm import _raw, jax_nibble, rnd, torch_nibble
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_turbo import turbo_pair
from tests.test_torch_packed import packed_pair

KINDS = ["nibble-q2", "nibble-q3", "nibble-q2-xperm", "nibble-q3-xperm",
         "packed-q2", "packed-q3", "turbo-q2", "turbo-q3", "fp8", "fp8-ragged"]
# tiles of 128, 7, 0, 64, 1 and 30 live rows: MMA widths 128, 16, none (the
# tile exits), 64, 16 and 32
TILE_ROWS = [128, 7, 0, 64, 1, 30]
TILE_EXPERT = [2, 0, 1, 1, 2, 0]
E, D = 3, 160            # 160 weight rows: a ragged second column block


def _mma_cols(kind):
    """The natural column (within a 64-column k-step) at each MMA position
    kk*16 + p of the kernel: lane c = (p % 8) / 2 holds fragment values i
    = p % 2 + 2 (p / 8) of every kk (the csrc/qmm_tiles.cu header)."""
    cols = []
    for kk in range(4):
        for p in range(16):
            c, i = (p & 7) >> 1, (p & 1) + 2 * (p >> 3)
            if kind.startswith("nibble"):
                cols.append(16 * kk + p)
            elif kind.startswith("packed"):
                cols.append(16 * kk + 4 * i + c)
            elif kind == "turbo-q3":
                cols.append(16 * kk + 4 * c + i)
            else:                                    # fp8, turbo-q2: natural bytes
                cols.append(16 * c + 4 * kk + i)
    return cols


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """The kernel's rounding to bf16: half an ulp of the 16 dropped bits
    added to the f32 pattern, then truncated (nearest, ties away from
    zero; no conversion instruction)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x8000) & -65536).view(torch.float32)


def _split(x: torch.Tensor):
    """split_rn: x = hi + lo, each a bf16 value."""
    hi = _round_bf16(x)
    return hi, _round_bf16(x - hi)


def _unperm_loader(xp: torch.Tensor, n: int) -> torch.Tensor:
    """The prepermuted kinds' x loader: natural column 16(g0 + q) + o read
    from permuted position o*n16 + g0 + q, one float4 (q = 0..3) at each
    of the 16 offsets o*n16 + g0 of a k-step."""
    n16 = n // 16
    out = torch.empty_like(xp)
    for k0 in range(0, n, 64):
        g0 = k0 // 16
        for o in range(16):
            f4 = xp[..., o * n16 + g0:o * n16 + g0 + 4]
            for q in range(4):
                out[..., k0 + 16 * q + o] = f4[..., q]
    return out


def _int_view(kind, tt):
    """The narrow tiles' operands of a table: A (E, d, n), the values each
    reader gives the MMA exactly (the nibble u, the 2-bit q, Q3_K's q + 4h
    - 4, the int8 turbo value, the e5m2 value), and the fold terms mul and
    add (E, d, n/16) a row and natural 16-column group: W = mul * A - add.
    Each is the plain dequantization with the scales set to 1 and the
    min terms to 0, and the scales themselves."""
    ones = torch.ones_like

    def rep(t, k):
        return t.float().repeat_interleave(k, dim=-1)
    if kind.startswith("nibble"):
        a = ones(tt.a)
        A = dataclasses.replace(tt, a=a, c=None, off=0).dequant(torch.float32)
        add = tt.a.float() * float(tt.off)
        if tt.c is not None:
            add = add + tt.c.float()
        return A, tt.a.float(), add
    if kind == "packed-q2":
        A = dataclasses.replace(tt, sm=ones(tt.sm), d=ones(tt.d),
                                dmin=torch.zeros_like(tt.dmin)).dequant(torch.float32)
        return (A, rep(tt.d, 16) * (tt.sm & 0xF).float(),
                rep(tt.dmin, 16) * (tt.sm >> 4).float())
    if kind == "packed-q3":
        A = dataclasses.replace(tt, sc=ones(tt.sc), d=ones(tt.d)).dequant(torch.float32)
        mul = rep(tt.d, 16) * tt.sc.float()
        return A, mul, torch.zeros_like(mul)
    if kind == "turbo-q3":
        A = dataclasses.replace(tt, a=ones(tt.a)).dequant(torch.float32)
        return A, tt.a.float(), torch.zeros_like(tt.a, dtype=torch.float32)
    if kind == "turbo-q2":
        A = dataclasses.replace(tt, d=ones(tt.d), bm=torch.zeros_like(tt.bm)) \
            .dequant(torch.float32)
        return A, rep(tt.d, 16), tt.bm.float()
    A = dataclasses.replace(tt, scale=ones(tt.scale)).dequant(torch.float32)
    d, n = tt.shape[-2:]
    mul = tt.scale.repeat_interleave(128, dim=-2)[..., :d, :]
    mul = mul.repeat_interleave(8, dim=-1)[..., :n // 16]
    return A, mul, torch.zeros_like(mul)


def _emulate(kind, tt, te, x_tiles: torch.Tensor, tile_rows, passes="split"):
    """The tile GEMM's arithmetic over tiles (G, 128, n) of x against the
    table tt (E, d, n); rows no tile writes stay NaN. Wide tiles: the f32
    dequantization split in hi + lo, three passes a k16 step. Narrow tiles
    (at most 16 live rows, 32 for the byte kinds): A exact, two passes (x
    hi, x lo) into a
    product a k16 step (the byte kinds: a step), folded in with the
    group's scale and, against the x rows' group sums, its min term.
    passes="single": every tile one bf16 pass of the rounded W and x (the
    negative control)."""
    G, _, n = x_tiles.shape
    if kind.endswith("xperm"):
        x_tiles = _unperm_loader(x_tiles, n)
    cols = torch.tensor(_mma_cols(kind))
    w = tt.dequant(torch.float32)
    A, mul, add = _int_view(kind, tt)
    bytes_kind = kind.startswith("fp8") or kind == "turbo-q2"
    y = torch.full((G, _TILE, w.shape[-2]), float("nan"))
    for g in range(G):
        nr = min(_TILE, int(tile_rows[g]))
        if nr == 0:                                   # an empty tile exits
            continue
        N, e = tile_width(nr), int(te[g])
        x = torch.zeros((N, n))
        x[:nr] = x_tiles[g, :nr]                      # rows past nr staged as 0
        acc = torch.zeros((N, w.shape[-2]))
        for k0 in range(0, n, 64):
            xs = x[:, k0 + cols]
            # the narrow kernel's tiles: n16, and n32 for the byte kinds
            # (Slot::NARROW in the .cu)
            if passes == "single" or N > (32 if bytes_kind else 16):
                ws = w[e][:, k0 + cols]
                if passes == "single":
                    terms = [(_bf16(ws), _bf16(xs))]
                else:
                    (wh, wl), (xh, xl) = _split(ws), _split(xs)
                    terms = [(wh, xh), (wh, xl), (wl, xh)]
                for kk in range(4):
                    sl = slice(16 * kk, 16 * kk + 16)
                    for wt, xt in terms:
                        acc += xt[:, sl] @ wt[:, sl].t()
                continue
            xh, xl = _split(xs)
            a = A[e][:, k0 + cols]
            g0 = k0 // 16
            sums = torch.stack([x[:, k0 + 16 * q:k0 + 16 * q + 16].sum(-1)
                                for q in range(4)], -1)          # (N, 4) natural groups
            prods = [xh[:, sl] @ a[:, sl].t() + xl[:, sl] @ a[:, sl].t()
                     for sl in (slice(16 * kk, 16 * kk + 16) for kk in range(4))]
            if bytes_kind:
                acc += mul[e][:, g0] * sum(prods)
            else:
                for kk in range(4):
                    acc += mul[e][:, g0 + kk] * prods[kk]
            acc -= sums @ add[e][:, g0:g0 + 4].t()
        y[g, :nr] = acc[:nr]
    return y


def _pair(kind, shape, seed):
    """(JAX tensor, port tensor) of one kind over the same numpy draw."""
    d, n = shape[-2:]
    quant = "q2_k" if "q2" in kind else "q3_k"
    if kind.startswith("fp8"):
        return _quantize(rnd(shape, seed=seed), (128, 128))
    raw = _raw(rnd(shape, seed=seed), quant)
    if kind.startswith("nibble"):
        return jax_nibble(raw, quant, d, n), torch_nibble(raw, quant, d, n)
    if kind.startswith("packed"):
        return packed_pair(raw, quant, d, n)
    return turbo_pair(raw, quant, d, n)


def _pallas_grouped(kind, jt, te, x):
    """The Pallas qmm_grouped (interpret) on natural tiles x, with each
    body's operands: nibble and Q2_K turbo the group sums, nibble, packed
    and Q3_K turbo the stride-16 permuted tiles. A ragged fp8 grid, which
    the TPU kernel asserts against, takes the JAX package's XLA path (the
    dequantized table, then the product) instead."""
    n = x.shape[-1]
    xj = jnp.asarray(x)
    if kind == "fp8-ragged":
        w = jt.dequant(jnp.float32)
        return np.stack([np.asarray(xj[g] @ w[int(e)].T) for g, e in enumerate(te)])
    kw = {}
    if kind.startswith("nibble") or kind == "turbo-q2":
        kw["s16_tiles"] = _group_sums(xj, n)
    if kind.startswith(("nibble", "packed")) or kind == "turbo-q3":
        xj = _perm_x(xj, n)
    return np.asarray(jax_qmm_grouped(jt, jnp.asarray(te), xj, interpret=True, **kw))


_CASES = {}


def _grouped_case(kind):
    """(Pallas output, port tensor, natural tiles, tile experts) of a kind,
    once per kind (the nibble xperm kinds share their natural draw)."""
    base = kind.replace("-xperm", "")
    if base not in _CASES:
        # a ragged fp8 grid: 160 rows and 576 columns of 128x128 blocks
        d, n = (256, 512) if base == "fp8" else (D, 576) if base == "fp8-ragged" else (D, 512)
        jt, tt = _pair(base, (E, d, n), seed=len(base))
        x = rnd((len(TILE_ROWS), _TILE, n), seed=3)
        te = np.asarray(TILE_EXPERT, np.int32)
        _CASES[base] = (_pallas_grouped(base, jt, te, x), tt, x, te)
    return _CASES[base]


def _live(rows):
    return torch.arange(_TILE)[None, :] < torch.tensor(rows)[:, None]


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_arithmetic_matches_pallas_grouped(kind):
    """K6, every body: the emulated kernel over full, narrow (7 rows),
    one-row, 30-row and empty tiles (tile_rows < 128) within 1e-4 of
    max|ref| of the Pallas qmm_grouped in interpret mode on the live rows;
    every live row written once, every other row left."""
    want, tt, x, te = _grouped_case(kind)
    xin = torch.from_numpy(x)
    if kind.endswith("xperm"):
        xin = perm_x(xin).contiguous()
    got = _emulate(kind, tt, te, xin, TILE_ROWS).numpy()
    live = _live(TILE_ROWS).numpy()
    assert not np.isnan(got[live]).any() and np.isnan(got[~live]).all()
    assert _rel_err(got[live], want[live]) <= 1e-4
    # the plain version (the card's oracle) agrees on the live rows
    plain = qmm_grouped(tt, torch.from_numpy(te), xin, torch.tensor(TILE_ROWS),
                        x_prepermuted=kind.endswith("xperm")).numpy()
    assert _rel_err(plain[live], want[live]) <= 1e-4


@pytest.mark.parametrize("kind", ["nibble-q2", "nibble-q3", "packed-q3", "turbo-q2",
                                  "fp8"])
def test_row_tiled_arithmetic_matches_pallas_qmm(kind):
    """The row-tiled routes at 200 rows (a full tile and one of 72 rows,
    width 128) against the Pallas qmm in interpret mode, which tiles the
    rows by 128. Tolerance 1e-4 of max|ref|."""
    rows, n = 200, 512
    d = 256 if kind == "fp8" else D
    jt, tt = _pair(kind, (d, n), seed=5)
    x = rnd((rows, n), seed=6)
    want = np.asarray(jax_qmm(jt, jnp.asarray(x), interpret=True))
    xt = torch.zeros((2, _TILE, n))
    xt.view(-1, n)[:rows] = torch.from_numpy(x)
    got = _emulate(kind, tt.map(lambda t: t[None]), [0, 0], xt, [128, 72])
    got = got.reshape(-1, d)[:rows].numpy()
    assert _rel_err(got, want) <= 1e-4
    if kind.startswith("nibble"):
        assert _rel_err(qmm_rows(tt, torch.from_numpy(x)).numpy(), want) <= 1e-4


@pytest.mark.parametrize("kind", ["nibble-q3", "packed-q3", "fp8-ragged"])
def test_single_bf16_pass_misses_the_tolerance(kind):
    """Negative control: the weights and the activations each rounded to
    bf16 once (one pass) miss 1e-4 of max|ref| on the same tiles, so the
    kernel keeps both lo terms."""
    want, tt, x, te = _grouped_case(kind)
    got = _emulate(kind, tt, te, torch.from_numpy(x), TILE_ROWS, passes="single").numpy()
    live = _live(TILE_ROWS).numpy()
    assert _rel_err(got[live], want[live]) > 1e-4


@pytest.mark.parametrize("kind", ["nibble-q2", "nibble-q3", "packed-q2", "packed-q3",
                                  "turbo-q2", "turbo-q3", "fp8-ragged"])
def test_two_bf16_terms_hold_each_weight(kind):
    """W - hi - lo within 2^-17 |W| for every dequantized weight (packed
    Q3_K's (d*sc)*(q - 4) takes up to ~20 bits); Q3_K turbo's a*p (a bf16
    scale times an int8) exactly."""
    _, tt, _, _ = _grouped_case(kind)
    w = tt.dequant(torch.float32)
    hi, lo = _split(w)
    res = (w - hi - lo).abs()
    assert bool((res <= 2.0 ** -17 * w.abs()).all())
    if kind == "turbo-q3":
        assert not res.any()


@pytest.mark.parametrize("kind", KINDS)
def test_mma_column_order_is_a_permutation(kind):
    """Each reader's MMA column order covers the 64 columns of a k-step
    once, and lane c's 16 values of a row sit in its reader's chunks: the
    nibble slabs 2c, 2c+1; qs slab c; Q3_K turbo's slabs 4c..4c+3; bytes
    16c..16c+15."""
    cols = _mma_cols(kind)
    assert sorted(cols) == list(range(64))
    for c in range(4):
        mine = [cols[16 * kk + p] for kk in range(4) for p in range(16)
                if (p & 7) >> 1 == c]
        offs = {col % 16 for col in mine}
        if kind.startswith("nibble"):
            assert {o % 8 for o in offs} == {2 * c, 2 * c + 1}
        elif kind.startswith("packed"):
            assert {o % 4 for o in offs} == {c}
        elif kind == "turbo-q3":
            assert offs == {4 * c + i for i in range(4)}
        else:
            assert sorted(mine) == list(range(16 * c, 16 * c + 16))


def test_tile_width_is_the_least_width_that_covers_the_rows():
    """tile_width (the kernel's block-uniform choice of N) for every live
    row count: the least of 16, 32, 64, 128 at or above it."""
    for r in range(1, _TILE + 1):
        w = tile_width(r)
        assert w in _TILE_WIDTHS and w >= r
        assert all(v < r for v in _TILE_WIDTHS if v < w)
    for bad in (0, _TILE + 1):
        with pytest.raises(ValueError):
            tile_width(bad)


def test_wrapper_constants_match_the_kernel():
    """The wrapper's tile rows (_TILE) and MMA widths (_TILE_WIDTHS) are
    the .cu's kBM and kW0..kW3."""
    src = (Path(wrapper.__file__).resolve().parents[2] / "csrc" / "qmm_tiles.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kBM"]) == _TILE == 128
    m = re.search(r"constexpr int kW0 = (\d+), kW1 = (\d+), kW2 = (\d+), kW3 = kBM;", src)
    assert m is not None
    assert tuple(int(v) for v in m.groups()) + (int(consts["kBM"]),) == _TILE_WIDTHS


@pytest.mark.parametrize("kind", ["nibble-q2", "nibble-q3", "packed-q2", "packed-q3",
                                  "turbo-q2", "turbo-q3", "fp8-ragged"])
def test_fold_terms_rebuild_each_weight(kind):
    """The narrow tiles' operands hold the table: A exact in one bf16 term,
    and mul * A - add, a row and group at a time, the plain dequantization
    to f32 rounding."""
    _, tt, _, _ = _grouped_case(kind)
    A, mul, add = _int_view(kind, tt)
    assert torch.equal(_bf16(A), A)
    w = tt.dequant(torch.float32)
    rebuilt = mul.repeat_interleave(16, -1) * A - add.repeat_interleave(16, -1)
    assert float((rebuilt - w).abs().max()) <= 2.0 ** -22 * float(w.abs().max())
