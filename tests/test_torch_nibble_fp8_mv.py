"""The numerics of the nibble matvec (K1, K2's nibble bodies;
``csrc/nibble_mv.cu``) and K5's fp8 matvec (``csrc/fp8_mv.cu``) on Hopper
against the JAX package, on the CPU, and the wrappers' grids, constants
and checks.

- The nibble matvec takes exact integer products, as the packed one
  (tests/test_torch_packed_mv.py): a pre-pass splits each 16-column group
  of x (natural, or read from the stride-16 permuted order) into two int8
  terms, x ~ s2 (254 a + b); the kernel unpacks each group's quants from
  its plane words with two 4 x 4 byte transposes and masks (``_nib_quants``
  repeats them in numpy), and folds each group's exact integer sums with
  its bf16 scale in f32, off as the integer start -off (254 sum a + sum b)
  or, with a min plane c, (off a + c) against the group's f32 sum of x.
- The fp8 matvec takes f32 products: ``_e5m2x4`` widens each 4-byte
  weight word as fp8.cuh does (bytes under a half's high byte, exact), x
  is widened from its own dtype (exact for bf16 and f16), each lane's
  word a 4-term dot scaled by its block into the lane's sum, and the 32
  lanes of a row meet in a butterfly of shuffles.

Both must agree with the Pallas ``qmm`` / ``qmm_experts`` in interpret mode
(fp8: on dividing grids; on ragged ones with the JAX XLA path, dequantize
then one product) and with the f32 dequantization at 1e-4 of max|ref|, the
tolerance every check of the kernels on the card uses. The cheaper
arithmetic misses it: one int8 term; x rounded to bf16 for the products.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepseek_tpu_torch.ops.kernels.qmm as wrapper
from deepseek_tpu.ops.matmul import qmatmul as jax_qmatmul
from deepseek_tpu.ops.pallas.qmm import qmm as jax_qmm
from deepseek_tpu.ops.pallas.qmm import qmm_experts as jax_qmm_experts
from deepseek_tpu_torch.ops.kernels.qmm import (
    ROW_TILE_MIN, check_mv_x, nibble_warps, packed_lanes,
)
from deepseek_tpu_torch.quant.qtensor import Fp8Tensor, KNibbleTensor, perm_x
from tests.test_torch_fp8 import _quantize
from tests.test_torch_packed_mv import _split, _transpose4
from tests.test_torch_qmm import _raw, jax_nibble, rnd, torch_nibble
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(wrapper.__file__).resolve().parents[2] / "csrc"
NIB_SRC, FP8_SRC = CSRC / "nibble_mv.cu", CSRC / "fp8_mv.cu"
TOL = 1e-4
H100_SMS = 132
U32 = np.uint32


# ---------------------------------------------------------------------------
# the nibble matvec
# ---------------------------------------------------------------------------

def _nib_quants(qt):
    """What csrc/nibble_mv.cu reads from one 2-D weight's plane: the quants
    u (d, n) int64 in natural column order, from each lane's eight 16-byte
    slabs (offsets o*n16 + 16 sb) taken as 4 little-endian words a slab: a
    byte transpose of the words at offsets 0-3 and one of those at 4-7, the
    low nibbles giving columns 0-3 and 4-7 of each group, the high ones 8-11
    and 12-15."""
    p = qt.p.numpy()
    d, n = p.shape[0], 2 * p.shape[1]
    n16, nsb = n // 16, n // 256

    def words(o):               # (d, superblock, quad) words: byte k = group 16 sb + 4 qd + k
        return np.ascontiguousarray(p[:, o * n16:(o + 1) * n16]).view("<u4").reshape(d, nsb, 4)
    tl = _transpose4([words(o) for o in range(4)])
    th = _transpose4([words(o) for o in range(4, 8)])
    u = np.zeros((d, nsb, 4, 4, 16), np.int64)             # (sb, qd, k, column)
    m = np.uint32(0x0F0F0F0F)
    for k in range(4):
        for q, w in enumerate((tl[k] & m, th[k] & m, (tl[k] >> np.uint32(4)) & m,
                               (th[k] >> np.uint32(4)) & m)):
            for b in range(4):
                u[:, :, :, k, 4 * q + b] = (w >> np.uint32(8 * b)) & np.uint32(0xFF)
    return torch.from_numpy(u.reshape(d, n))


def _nib_emulate(qt, x, idx=None, xperm=False, terms=2):
    """Row i of x (rows, n) (natural, or ``xperm``: stride-16 permuted, as
    the pre-pass reads it) against the 2-D weight (idx None) or expert
    idx[i] of a table, as csrc/nibble_mv.cu computes it -> (rows, d) f32:
    exact integer group sums, each folded with its bf16 scale in f32 (here
    in f64 over f32 products); without c, off as the integer start; with c,
    (off a + c) against the group's f32 sum of x."""
    x = torch.as_tensor(x).float()
    if xperm:
        rows, n = x.shape
        x = x.reshape(rows, 16, n // 16).transpose(1, 2).reshape(rows, n)
    rows, n = x.shape
    a, b, s2, sx = _split(x, terms)
    out, cache = [], {}
    for i in range(rows):
        e = 0 if idx is None else int(idx[i])
        if e not in cache:
            w = qt if idx is None else qt.map(lambda t: t[e])
            cache[e] = (_nib_quants(w), w)
        u, w = cache[e]
        d = u.shape[0]
        ug = u.reshape(d, n // 16, 16)
        A = (a[i][None] * ug).sum(-1)
        B = (b[i][None] * ug).sum(-1)
        fa = w.a.float().double()
        if w.c is None:
            B = B - w.off * (254 * a[i].sum(-1) + b[i].sum(-1))[None]
        c = 254 * A + B                                        # (d, n16), exact
        y = (fa * (s2[i][None].double() * c.float().double())).sum(-1)
        if w.c is not None:
            fm = w.off * fa + w.c.float().double()
            y = y - (fm * sx[i][None].double()).sum(-1)
        out.append(y.float())
    return torch.stack(out).numpy()


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _nib_case(quant, d, n, seed, lead=()):
    raw = _raw(rnd((*lead, d, n), seed=seed), quant)
    return jax_nibble(raw, quant, d, n), torch_nibble(raw, quant, d, n)


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("n", [512, 1536, 2048, 7168, 16384])
@pytest.mark.parametrize("rows", [1, 2, 3, 4])
def test_nibble_emulation_matches_jax_qmm(quant, n, rows):
    """K1's matvec at 1-4 x rows (each weight row against every x row)
    against the Pallas qmm in interpret mode and the f32 dequantization, at
    1e-4 of max|ref|: Q2_K with its min plane c (off 0), Q3_K with off 4."""
    jt, tt = _nib_case(quant, 16, n, seed=n + rows)
    x = rnd((rows, n), seed=n + rows + 1)
    want = np.asarray(jax_qmm(jt, jnp.asarray(x), interpret=True))
    got = _nib_emulate(tt, x)
    assert _rel_err(got, want) <= TOL
    assert _rel_err(got, x @ tt.dequant(torch.float32).numpy().T) <= TOL


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("n", [512, 2048, 7168])
@pytest.mark.parametrize("xperm", [False, True], ids=["natural", "prepermuted"])
def test_nibble_emulation_matches_jax_qmm_experts(quant, n, xperm):
    """K2's nibble bodies over 6 pairs of 4 experts, expert 2 three times,
    x natural or already in the stride-16 permuted order (the pre-pass reads
    each natural column from its permuted position), against the Pallas
    qmm_experts in interpret mode and the gathered f32 dequantization, at
    1e-4 of max|ref|."""
    E, m = 4, 16
    jt, tt = _nib_case(quant, m, n, seed=n, lead=(E,))
    idx = np.asarray([2, 0, 2, 3, 1, 2], np.int32)
    x = rnd((6, n), seed=n + 1)
    xin = perm_x(torch.from_numpy(x)).numpy() if xperm else x
    want = np.asarray(jax_qmm_experts(jt, jnp.asarray(idx[None]), jnp.asarray(xin[None]),
                                      interpret=True, x_prepermuted=xperm))[0]
    got = _nib_emulate(tt, xin, torch.from_numpy(idx), xperm=xperm)
    assert _rel_err(got, want) <= TOL
    w = tt.dequant(torch.float32).numpy()[idx]
    assert _rel_err(got, np.einsum("bdn,bn->bd", w, x)) <= TOL


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_nibble_one_int8_term_misses_the_tolerance(quant):
    """At V3's width (n = 7168) and 4 x rows the two int8 terms hold 1e-4 of
    max|ref| with a margin of at least 2x; one term (x ~ s1 a) misses it by
    more than 10x: the case for the two."""
    jt, tt = _nib_case(quant, 64, 7168, seed=11)
    x = rnd((4, 7168), seed=12)
    want = np.asarray(jax_qmm(jt, jnp.asarray(x), interpret=True))
    assert _rel_err(_nib_emulate(tt, x), want) <= TOL / 2
    assert _rel_err(_nib_emulate(tt, x, terms=1), want) > 10 * TOL


@pytest.mark.parametrize("shape", [(64, 512), (3, 16, 1536)], ids=["2d", "experts"])
def test_nibble_unpacking_matches_the_plane(shape):
    """The byte transposes and masks of csrc/nibble_mv.cu give every quant
    at its natural column, on random plane bytes (the dequantization with
    a = 1 and off = 0 is the quants themselves)."""
    g = torch.Generator().manual_seed(sum(shape))
    n = shape[-1]
    p = torch.randint(0, 256, (*shape[:-1], n // 2), generator=g, dtype=torch.uint8)
    qt = KNibbleTensor(p=p, a=torch.ones((*shape[:-1], n // 16), dtype=torch.bfloat16), off=0)
    want = qt.dequant(torch.float32).long()
    for e in range(shape[0] if len(shape) == 3 else 1):
        w = qt.map(lambda t: t[e]) if len(shape) == 3 else qt
        assert torch.equal(_nib_quants(w), want[e] if len(shape) == 3 else want)


# ---------------------------------------------------------------------------
# the fp8 matvec
# ---------------------------------------------------------------------------

def _e5m2x4(words):
    """fp8.cuh's e5m2x4 over little-endian weight words (..., W) uint32:
    bytes 0 and 1 (then 2 and 3) permuted under zero low bytes
    (``__byte_perm(u, 0, 0x1404)``, ``0x3424``) read as a half2, widened to
    f32 -> (..., 4 W) float32 in column order."""
    words = np.asarray(words, U32)
    halves = []
    for sel in (0x1404, 0x3424):
        v = np.zeros(words.shape, U32)
        for k in range(4):                       # result byte k from selector nibble k
            s = (sel >> (4 * k)) & 0xF
            if s < 4:
                v |= ((words >> U32(8 * s)) & U32(0xFF)) << U32(8 * k)
        halves.append(v)
    h = np.stack([halves[0] & U32(0xFFFF), halves[0] >> U32(16),
                  halves[1] & U32(0xFFFF), halves[1] >> U32(16)], -1)
    vals = h.astype(np.uint16).view(np.float16).astype(np.float32)
    return vals.reshape(words.shape[:-1] + (4 * words.shape[-1],))


def _f32(v):
    return np.asarray(v, np.float64).astype(np.float32)


def _fp8_emulate(qt, x, x_dtype=torch.float32):
    """x (rows, n), rounded to x_dtype and widened exactly to f32 (the
    kernel reads it in its own dtype), against the 2-D fp8 weight as
    fp8_mv_kernel computes it -> (rows, d) float32: each lane's word j = 32 k
    + lane (columns 4j..4j+3) a 4-term f32 dot, times its block's scale
    into the lane's sum in k order; the 32 lanes then meet in a butterfly
    (xor 16, 8, 4, 2, 1). FMAs in f64 rounded to f32 (one rounding more
    than the card's, far below the tolerance)."""
    xq = torch.as_tensor(np.asarray(x, np.float32)).to(x_dtype).float().numpy()
    rows, n = xq.shape
    d = qt.shape[0]
    b0, b1 = qt.block_size
    wb = np.ascontiguousarray(qt.data.view(torch.uint8).numpy())
    w = _e5m2x4(wb.view("<u4")).reshape(d, n // 4, 4)           # (d, words, 4)
    xw = xq.reshape(rows, n // 4, 4)
    t = _f32(xw[:, None, :, 0] * w[None, :, :, 0].astype(np.float64))
    for c in range(1, 4):
        t = _f32(xw[:, None, :, c].astype(np.float64) * w[None, :, :, c] + t)
    sc = qt.scale.numpy()[np.arange(d)[:, None] // b0, (4 * np.arange(n // 4))[None] // b1]
    nw = n // 4
    acc = np.zeros((rows, d, 32), np.float32)
    for k in range(-(-nw // 32)):
        j = 32 * k + np.arange(32)
        live = j < nw
        jj = np.minimum(j, nw - 1)
        step = _f32(t[:, :, jj].astype(np.float64) * sc[:, jj][None] + acc)
        acc = np.where(live, step, acc)
    lane = np.arange(32)
    for m in (16, 8, 4, 2, 1):
        acc = _f32(acc.astype(np.float64) + acc[..., lane ^ m])
    return acc[..., 0]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,block", [((256, 384), (128, 128)), ((128, 1024), (128, 128)),
                                         ((64, 512), (32, 64))],
                         ids=["divisible", "wide", "blocks-of-64"])
@pytest.mark.parametrize("rows", [1, 2, 3, 4])
def test_fp8_emulation_matches_jax_qmm(shape, block, rows, x_dtype):
    """K5's fp8 matvec at 1-4 x rows against the Pallas qmm in interpret
    mode (a dividing grid) and the f32 dequantization, at 1e-4 of max|ref|;
    a bf16 x against both over the same x widened to f32 (the kernel reads
    it as it is: the widening is exact)."""
    jt, tt = _quantize(rnd(shape, seed=rows), block)
    x = rnd((rows, shape[1]), seed=rows + 1)
    x = torch.from_numpy(x).to(x_dtype).float().numpy()
    want = np.asarray(jax_qmm(jt, jnp.asarray(x), interpret=True))
    got = _fp8_emulate(tt, x, x_dtype)
    assert _rel_err(got, want) <= TOL
    assert _rel_err(got, x @ tt.dequant(torch.float32).numpy().T) <= TOL


@pytest.mark.parametrize("shape,block", [((576, 256), (128, 128)), ((64, 10944), (128, 128)),
                                         ((40, 448), (32, 16))],
                         ids=["wkv_a-rows", "w2-columns", "small-blocks"])
@pytest.mark.parametrize("rows", [1, 4, 5])
def test_fp8_emulation_matches_jax_xla_on_ragged_grids(shape, block, rows):
    """Ragged grids (576 rows and 10944 columns of 128x128 blocks, a word
    loop that ends inside a step; 32x16 blocks, a scale a word, and at 5
    rows two passes) against the JAX XLA path (dequantize, then one f32
    product), at 1e-4 of max|ref|."""
    jt, tt = _quantize(rnd(shape, seed=shape[1] + rows), block)
    x = rnd((rows, shape[1]), seed=rows + 2)
    want = np.asarray(jax_qmatmul(jt, jnp.asarray(x), impl=None))
    assert _rel_err(_fp8_emulate(tt, x), want) <= TOL


def test_fp8_bf16_products_miss_the_tolerance():
    """At V2-Lite's width (n = 2048) and 4 x rows the f32 products hold 1e-4
    of max|ref| with a wide margin; an f32 x rounded to bf16 for the
    products (what one bf16 tensor-core term computes) misses it more than
    10 times over: the case for f32 products, or for x split in two bf16
    terms on the tensor cores."""
    jt, tt = _quantize(rnd((128, 2048), seed=21), (128, 128))
    x = rnd((4, 2048), seed=22)
    want = np.asarray(jax_qmm(jt, jnp.asarray(x), interpret=True))
    assert _rel_err(_fp8_emulate(tt, x), want) <= TOL / 10
    assert _rel_err(_fp8_emulate(tt, x, torch.bfloat16), want) > 10 * TOL


def test_e5m2_moves_are_exact():
    """Every e5m2 byte (subnormals, zeros of both signs, the largest
    normals, infinities) moved under a half's high byte reads as its value,
    in column order."""
    b = np.arange(256, dtype=np.uint8)
    vals = torch.from_numpy(b).view(torch.float8_e5m2).float().numpy()
    got = _e5m2x4(b.view("<u4"))
    keep = ~np.isnan(vals)
    np.testing.assert_array_equal(got[keep], vals[keep])
    assert np.isnan(got[~keep]).all()


# ---------------------------------------------------------------------------
# the grid, the constants, the checks
# ---------------------------------------------------------------------------

def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src.read_text()).group(1))


def test_wrapper_constants_match_the_kernels():
    """The wrappers' constants are the sources': the nibble matvec's x rows
    a launch, warps a block, |off| at most and warps an SM at its launch
    bounds (two warps a block times kNbBlocksFew at 1-2 x rows,
    kNbBlocksMany at 3-4); the fp8 matvec's x rows a pass and the 4-byte
    words a lane reads, as the emulator takes them (its grid is its own);
    both take every row count below the row-tiled routes'."""
    assert wrapper._NB_MAX_X == _const(NIB_SRC, "kNbMaxX") == ROW_TILE_MIN
    assert wrapper._NB_BLOCK_WARPS == _const(NIB_SRC, "kNbThreads") // 32
    assert wrapper._NB_MAX_OFF == _const(NIB_SRC, "kNbMaxOff")
    few, many = _const(NIB_SRC, "kNbBlocksFew"), _const(NIB_SRC, "kNbBlocksMany")
    assert wrapper._NB_WARPS_PER_SM == {r: wrapper._NB_BLOCK_WARPS * (few if r <= 2 else many)
                                        for r in range(1, wrapper._NB_MAX_X + 1)}
    nib = NIB_SRC.read_text()
    assert "__launch_bounds__(kNbThreads, NB <= 2 ? kNbBlocksFew : kNbBlocksMany)" in nib
    assert 'extern "C" int nibble_mv(' in nib and '#include "xsplit.cuh"' in nib
    fp8 = FP8_SRC.read_text()
    assert wrapper._MV_ROWS_X == _const(FP8_SRC, "kMvRowsX") == ROW_TILE_MIN
    assert "ld.global.nc.L1::no_allocate.u32" in fp8          # one word a lane a load
    assert "ld_stream(wl + 128 * k)" in fp8 and "e5m2x4(u[k], wv);" in fp8   # word 32 k + lane
    assert "x_word<XK>(xb[b] + 128 * k * kX)" in fp8
    assert "__launch_bounds__(kThreads, NB <= 2 ? kBlocksFew : kBlocksMany)" in fp8
    assert 'extern "C" int fp8_mv(' in fp8


# V3's shapes: (name, rows or pairs, d, n, experts)
V3_SHAPES = [("wkvq", 1, 2112, 7168, False), ("wcr", 1, 73728, 1536, False),
             ("wo", 1, 7168, 16384, False), ("w13", 1, 36864, 7168, False),
             ("w2", 1, 7168, 18432, False), ("lm_head", 1, 129280, 7168, False),
             ("w13 4 rows", 4, 36864, 7168, False), ("w13 3 rows", 3, 36864, 7168, False),
             ("wkvq 2 rows", 2, 2112, 7168, False),
             ("w13s", 9, 4096, 7168, True), ("w2s", 9, 7168, 2048, True),
             ("wv_b", 128, 128, 512, True)]


@pytest.mark.parametrize("name,rows,d,n,experts", V3_SHAPES, ids=[s[0] for s in V3_SHAPES])
def test_nibble_warps_leave_no_partial_wave(name, rows, d, n, experts):
    """The nibble matvec's persistent warps on an H100's 132 SMs: never more
    than the card holds at the launch bounds (no second wave), every warp
    walking the same number of items but for one fewer, and never fewer
    warps than that spread needs; wkvq (2112 rows) reaches every SM."""
    warps = nibble_warps(rows, d, n, H100_SMS, experts)
    items = (rows if experts else 1) * -(-d // (32 // packed_lanes(n)))
    most = H100_SMS * wrapper._NB_WARPS_PER_SM[1 if experts else rows]
    assert 1 <= warps <= min(items, most)
    per = -(-items // warps)
    assert per == -(-items // most)
    assert (per - 1) * warps < items <= per * warps
    if name == "wkvq":
        assert -(-warps // wrapper._NB_BLOCK_WARPS) >= H100_SMS


def test_mv_x_checks_raise():
    """What the matvecs do not take raises before a launch: another width,
    another dtype (f64, int), a non-contiguous or misaligned x, ids of
    another dtype; f32, f16 and bf16 x and int32/int64 ids pass as they
    are."""
    for dt in (torch.float32, torch.float16, torch.bfloat16):
        check_mv_x(torch.ones((2, 256), dtype=dt), 256, "t")
    with pytest.raises(ValueError, match="x"):
        check_mv_x(torch.ones((2, 512)), 256, "t")
    for bad in (torch.ones((2, 256), dtype=torch.float64), torch.ones((2, 256), dtype=torch.int32),
                torch.ones((256, 2)).t(), torch.ones(2 * 256 + 1)[1:].view(2, 256)):
        with pytest.raises(ValueError, match="x"):
            check_mv_x(bad, 256, "t")
    with pytest.raises(ValueError, match="ids"):
        wrapper.check_ids(torch.zeros(3, dtype=torch.int16), 3, torch.device("cpu"), "t")
    wrapper.check_ids(torch.zeros(3, dtype=torch.int64), 3, torch.device("cpu"), "t")


def test_fp8_tensor_layout_is_what_the_emulator_reads():
    """The emulators read an Fp8Tensor's bytes as the kernel does: row-major
    (d, n) uint8 with an f32 (ceil(d/b0), ceil(n/b1)) scale grid."""
    _, tt = _quantize(rnd((40, 448), seed=1), (32, 16))
    assert isinstance(tt, Fp8Tensor) and tt.data.is_contiguous()
    assert tuple(tt.scale.shape) == (2, 28) and tt.scale.dtype == torch.float32
