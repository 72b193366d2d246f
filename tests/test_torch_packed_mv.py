"""The numerics of K5's and K2's packed matvec on Hopper
(``csrc/packed_mv.cu``) against the JAX package, on the CPU, and the
wrapper's grid, constants and checks.

The kernel splits each 16-column group of an activation row into two int8
terms, x ~ s2 (254 a + b) (s1 = max|x_g| / 127, a = rint(x / s1), s2 =
s1 / 254, b = rint((x - s1 a) / s2), the divisions as multiplies by
rounded reciprocals of max|x_g|), takes exact integer dot products of
the terms with the weights' unpacked quants (__dp4a), and folds each
group's sum with its scales in f32: Q3_K's -4 as the integer start
-4 (254 sum a + sum b), Q2_K's min term over the group's f32 sum of x.
``_emulate`` repeats that arithmetic in torch, with the quants and scales
read from the planes word by word as the kernel reads them
(``_kernel_quants``: its byte transpose, high-bit moves and masks, in
numpy), and must agree with the Pallas ``qmm`` / ``qmm_experts`` in
interpret mode and with the f32 dequantization at 1e-4 of max|ref|, the
tolerance every check of the kernel on the card uses, at DeepSeek-V3's
widths (n = 1536, 7168, 16384: wcr, w13/wkvq, wo). One int8 term (x ~ s1 a)
misses that tolerance: the case for two.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepseek_tpu_torch.ops.kernels.qmm as wrapper
from deepseek_tpu.ops.pallas.qmm import qmm as jax_qmm
from deepseek_tpu.ops.pallas.qmm import qmm_experts as jax_qmm_experts
from deepseek_tpu_torch.ops.kernels.qmm import (
    ROW_TILE_MIN, check_packed_mv, packed_lanes, packed_warps,
)
from deepseek_tpu_torch.quant.qtensor import Q2KTensor, Q3KTensor, _unpack_planes
from tests.test_torch_packed import packed_pair
from tests.test_torch_qmm import _raw, rnd
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SRC = Path(wrapper.__file__).resolve().parents[2] / "csrc" / "packed_mv.cu"
TOL = 1e-4
H100_SMS = 132


# ---------------------------------------------------------------------------
# the kernel's unpacking, word by word
# ---------------------------------------------------------------------------

def _byte_perm(x, y, sel):
    """CUDA __byte_perm on uint32 arrays: result byte i is byte
    (sel >> 4i) & 7 of {x: bytes 0-3, y: bytes 4-7}."""
    src = [(x >> np.uint32(8 * k)) & np.uint32(0xFF) for k in range(4)] + \
          [(y >> np.uint32(8 * k)) & np.uint32(0xFF) for k in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7].astype(np.uint32) << np.uint32(8 * i)
    return out


def _transpose4(w):
    lo01, hi01 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1], 0x7362)
    lo23, hi23 = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
            _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]


def _high_bits(m0, m1):
    lo, hi = _byte_perm(m0, m1, 0x5140), _byte_perm(m0, m1, 0x7362)
    lo1, hi1 = lo >> np.uint32(1), hi >> np.uint32(1)
    return [_byte_perm(lo, lo1, 0x5410), _byte_perm(lo, lo1, 0x7632),
            _byte_perm(hi, hi1, 0x5410), _byte_perm(hi, hi1, 0x7632)]


def _unpack(t, h, q3):
    c = lambda v: np.uint32(v)
    if q3:
        e = (t & c(0x33333333)) | ((h << c(2)) & c(0x44444444))
        o = ((t >> c(2)) & c(0x33333333)) | (h & c(0x44444444))
        return [e & c(0x07070707), o & c(0x07070707), (e >> c(4)) & c(0x07070707),
                (o >> c(4)) & c(0x07070707)]
    return [(t >> c(2 * s)) & c(0x03030303) for s in range(4)]


def _kernel_quants(qt):
    """What csrc/packed_mv.cu reads from one 2-D weight's planes: the quants
    u (d, n) int64 in natural column order (Q3_K: qlow + 4 hbit) and the
    group scales (d, n/16) int64 (Q3_K: sc; Q2_K: sm & 15, with sm >> 4),
    each lane's 16-byte slabs taken as 4 little-endian words a slab."""
    q3 = isinstance(qt, Q3KTensor)
    qs = qt.qs.numpy()
    d, n = qs.shape[0], 4 * qs.shape[1]
    n16, nsb = n // 16, n // 256

    def words(plane, j):        # (d, superblock, quad) words: byte k = group 16 sb + 4 qd + k
        return np.ascontiguousarray(plane[:, j * n16:(j + 1) * n16]).view("<u4") \
            .reshape(d, nsb, 4)
    t = _transpose4([words(qs, jq) for jq in range(4)])
    hb = _high_bits(words(qt.hm.numpy(), 0), words(qt.hm.numpy(), 1)) if q3 \
        else [np.zeros_like(t[0])] * 4
    u = np.zeros((d, nsb, 4, 4, 4, 4), np.int64)      # (sb, qd, k, s, jq)
    for k in range(4):
        for s, w in enumerate(_unpack(t[k], hb[k], q3)):
            for jq in range(4):
                u[:, :, :, k, s, jq] = (w >> np.uint32(8 * jq)) & np.uint32(0xFF)
    sw = words(qt.sc.numpy().view(np.uint8) if q3 else qt.sm.numpy(), 0)
    if q3:
        sc = np.stack([((sw >> np.uint32(8 * k)) & np.uint32(0xFF)).astype(np.uint8)
                       .view(np.int8) for k in range(4)], -1).astype(np.int64)
        mn = None
    else:
        sc = np.stack([(sw >> np.uint32(8 * k)) & np.uint32(0xF) for k in range(4)], -1)
        mn = np.stack([(sw >> np.uint32(8 * k + 4)) & np.uint32(0xF) for k in range(4)], -1)
        sc, mn = sc.astype(np.int64).reshape(d, n16), mn.astype(np.int64).reshape(d, n16)
    return torch.from_numpy(u.reshape(d, n)), torch.from_numpy(sc.reshape(d, n16)), \
        None if mn is None else torch.from_numpy(mn)


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------

def _split(x, terms=2):
    """The pre-pass (xsplit_kernel): x (rows, n) f32 -> the int terms a, b
    (rows, n/16, 16), s2 (rows, n/16) f32 and the f32 group sums; one term
    (terms=1) keeps a alone, x ~ s1 a = s2 (254 a)."""
    rows, n = x.shape
    g = x.reshape(rows, n // 16, 16)
    m = g.abs().amax(-1, keepdim=True)
    inv = torch.where(m > 0, 1.0 / torch.where(m > 0, m, 1.0), 0.0)    # rounded 1 / m
    s1, r1 = m * (1.0 / 127), 127.0 * inv
    s2, r2 = s1 * (1.0 / 254), 32258.0 * inv
    a = torch.round(g * r1)
    b = torch.round((g - s1 * a) * r2).clamp(-127, 127)
    if terms == 1:
        b = torch.zeros_like(b)
    return a.long(), b.long(), s2[..., 0], g.sum(-1)


def _emulate(qt, x, idx=None, terms=2):
    """Row i of x (rows, n) against the 2-D weight (idx None) or expert
    idx[i] of a table, as csrc/packed_mv.cu computes it -> (rows, d) f32:
    exact integer group sums, each folded with its scales in f32 (here in
    f64 over f32 products), then the super scales."""
    q3 = isinstance(qt, Q3KTensor)
    rows, n = x.shape
    a, b, s2, sx = _split(x.float(), terms)
    experts = {}
    out = []
    for i in range(rows):
        e = 0 if idx is None else int(idx[i])
        if e not in experts:
            w = qt if idx is None else qt.map(lambda t: t[e])
            experts[e] = (_kernel_quants(w), w)
        (u, sc, mn), w = experts[e]
        d = u.shape[0]
        ug = u.reshape(d, n // 16, 16)
        A = (a[i][None] * ug).sum(-1)
        B = (b[i][None] * ug).sum(-1)
        if q3:
            B = B - 4 * (254 * a[i].sum(-1) + b[i].sum(-1))[None]
        c = 254 * A + B                                       # (d, n16), exact
        part = (s2[i][None].double() * (sc * c).float().double())
        sup = lambda v: v.reshape(d, n // 256, 16).sum(-1)
        y = (w.d.double() * sup(part)).sum(-1)
        if not q3:
            y = y - (w.dmin.double() * sup(mn.float().double() * sx[i][None].double())).sum(-1)
        out.append(y.float())
    return torch.stack(out)


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _case(quant, d, n, rows, seed):
    jt, tt = packed_pair(_raw(rnd((d, n), seed=seed), quant), quant, d, n)
    x = rnd((rows, n), seed=seed + 1)
    return jt, tt, x


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("shape", [(64, 512), (3, 16, 1536)], ids=["2d", "experts"])
def test_kernel_unpacking_matches_the_planes(quant, shape):
    """The byte transpose, high-bit moves and masks of csrc/packed_mv.cu
    give every quant at its natural column, and its scale reads give every
    group's scale (and Q2_K's min), on random plane bytes."""
    g = torch.Generator().manual_seed(sum(shape))
    u8 = lambda c: torch.randint(0, 256, (*shape[:-1], c), generator=g, dtype=torch.uint8)
    n = shape[-1]
    sup = torch.rand((*shape[:-1], n // 256), generator=g)
    if quant == "q2_k":
        qt = Q2KTensor(qs=u8(n // 4), sm=u8(n // 16), d=sup, dmin=sup)
        want_u, want_sc = _unpack_planes(qt.qs, 2), (qt.sm & 15).long()
    else:
        qt = Q3KTensor(qs=u8(n // 4), hm=u8(n // 8), d=sup,
                       sc=torch.randint(-32, 32, (*shape[:-1], n // 16), generator=g,
                                        dtype=torch.int8))
        want_u, want_sc = _unpack_planes(qt.qs, 2) + 4 * _unpack_planes(qt.hm, 1), qt.sc.long()
    for e in range(shape[0] if len(shape) == 3 else 1):
        w = qt.map(lambda t: t[e]) if len(shape) == 3 else qt
        u, sc, mn = _kernel_quants(w)
        sel = (lambda t: t[e]) if len(shape) == 3 else (lambda t: t)
        assert torch.equal(u, sel(want_u).long())
        assert torch.equal(sc, sel(want_sc))
        if quant == "q2_k":
            assert torch.equal(mn, (sel(qt.sm) >> 4).long())


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("n", [1536, 7168, 16384], ids=["wcr", "w13-wkvq", "wo"])
@pytest.mark.parametrize("rows", [1, 2, 3, 4])
def test_emulation_matches_jax_qmm(quant, n, rows):
    """K5's packed matvec at 1-4 x rows (every row against each weight row)
    against the Pallas qmm in interpret mode and the f32 dequantization, at
    1e-4 of max|ref|."""
    jt, tt, x = _case(quant, 16, n, rows, seed=n + rows)
    want = np.asarray(jax_qmm(jt, jnp.asarray(x), interpret=True))
    got = _emulate(tt, torch.from_numpy(x)).numpy()
    assert _rel_err(got, want) <= TOL
    dq = x @ tt.dequant(torch.float32).numpy().T
    assert _rel_err(got, dq) <= TOL


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("n", [512, 7168], ids=["wv_b", "w13s"])
def test_emulation_matches_jax_qmm_experts(quant, n):
    """K2's packed matvec over 8 pairs of 5 experts, expert 3 three times
    and 0 twice, against the Pallas qmm_experts in interpret mode and the
    gathered f32 dequantization, at 1e-4 of max|ref|."""
    E, m = 5, 16
    jt, tt = packed_pair(_raw(rnd((E, m, n), seed=n), quant), quant, m, n)
    idx = np.asarray([3, 0, 3, 1, 4, 0, 3, 2], np.int32)
    x = rnd((8, n), seed=n + 1)
    want = np.asarray(jax_qmm_experts(jt, jnp.asarray(idx[None]), jnp.asarray(x[None]),
                                      interpret=True))[0]
    got = _emulate(tt, torch.from_numpy(x), torch.from_numpy(idx).long()).numpy()
    assert _rel_err(got, want) <= TOL
    w = tt.dequant(torch.float32).numpy()[idx]
    assert _rel_err(got, np.einsum("bdn,bn->bd", w, x)) <= TOL


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_one_int8_term_misses_the_tolerance(quant):
    """At V3's width (n = 7168) and 4 x rows, two int8 terms hold 1e-4 of
    max|ref| with a margin of at least 2x (at 64 rows, seed 11: Q2_K
    4.0e-5, Q3_K 1.6e-5; 1.9e-5 to 3.8e-5 at n = 1536 and 16384); one term
    (x ~ s1 a) misses it 45-90 times over (4.6e-3 to 8.9e-3): the case for
    the two terms the kernel takes."""
    jt, tt, x = _case(quant, 64, 7168, 4, seed=11)
    want = np.asarray(jax_qmm(jt, jnp.asarray(x), interpret=True))
    assert _rel_err(_emulate(tt, torch.from_numpy(x)).numpy(), want) <= TOL / 2
    assert _rel_err(_emulate(tt, torch.from_numpy(x), terms=1).numpy(), want) > 10 * TOL


# ---------------------------------------------------------------------------
# the grid, the constants, the checks
# ---------------------------------------------------------------------------

def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC.read_text()).group(1))


def test_wrapper_constants_match_the_kernel():
    """The wrapper's rows an item, x rows at most, warps a block and warps
    an SM are csrc/packed_mv.cu's (kPkRows, kPkMaxX, kPkThreads / 32, two
    warps a block times kPkBlocksFew at 1-2 x rows, kPkBlocksMany at 3-4),
    and the matvec takes every row count below the row-tiled route's."""
    assert wrapper._PK_ROWS == _const("kPkRows")
    assert wrapper._PK_MAX_X == _const("kPkMaxX") == ROW_TILE_MIN
    assert wrapper._PK_BLOCK_WARPS == _const("kPkThreads") // 32
    few, many = _const("kPkBlocksFew"), _const("kPkBlocksMany")
    assert wrapper._PK_WARPS_PER_SM == {r: wrapper._PK_BLOCK_WARPS * (few if r <= 2 else many)
                                        for r in range(1, wrapper._PK_MAX_X + 1)}
    src = SRC.read_text()
    assert "__launch_bounds__(kPkThreads, NB <= 2 ? kPkBlocksFew : kPkBlocksMany)" in src
    assert 'extern "C" int packed_mv(' in src


@pytest.mark.parametrize("n,lanes", [(256, 2), (512, 2), (1536, 8), (2048, 8),
                                     (4096, 8), (6144, 32), (7168, 32), (16384, 32),
                                     (18432, 32)])
def test_packed_lanes(n, lanes):
    """Lanes a row from the superblocks a row has: wv_b's 2 share a warp
    16 rows at a time, wcr's 6 and w2s's 8 4 rows at a time."""
    assert packed_lanes(n) == lanes


# V3's shapes: (name, rows or pairs, d, n, experts)
V3_SHAPES = [("wkvq", 1, 2112, 7168, False), ("wcr", 1, 73728, 1536, False),
             ("wo", 1, 7168, 16384, False), ("w13", 1, 36864, 7168, False),
             ("w2", 1, 7168, 18432, False), ("lm_head", 1, 129280, 7168, False),
             ("w13 4 rows", 4, 36864, 7168, False), ("w13 3 rows", 3, 36864, 7168, False),
             ("wkvq 2 rows", 2, 2112, 7168, False),
             ("w13s", 8, 4096, 7168, True), ("w2s", 8, 7168, 2048, True),
             ("wv_b", 128, 128, 512, True)]


@pytest.mark.parametrize("name,rows,d,n,experts", V3_SHAPES, ids=[s[0] for s in V3_SHAPES])
def test_packed_warps_leave_no_partial_wave(name, rows, d, n, experts):
    """The persistent warps on an H100's 132 SMs: never more than the card
    holds at the launch bounds (no second wave), every warp walking the same
    number of items but for one fewer, and never fewer warps than that
    spread needs; wkvq (2112 rows) reaches every SM."""
    warps = packed_warps(rows, d, n, H100_SMS, experts)
    lanes = packed_lanes(n)
    items = (rows if experts else 1) * -(-d // (32 // lanes * wrapper._PK_ROWS))
    most = H100_SMS * wrapper._PK_WARPS_PER_SM[1 if experts else rows]
    assert 1 <= warps <= min(items, most)
    per = -(-items // warps)
    assert per == -(-items // most)                  # the fewest items a warp can take
    assert (per - 1) * warps < items <= per * warps
    if name == "wkvq":
        assert -(-warps // wrapper._PK_BLOCK_WARPS) >= H100_SMS


def _planes(quant, lead, d, n):
    g = torch.Generator().manual_seed(d + n)
    u8 = lambda c: torch.randint(0, 256, (*lead, d, c), generator=g, dtype=torch.uint8)
    sup = torch.rand((*lead, d, max(n // 256, 1)), generator=g)
    if quant == "q2_k":
        return Q2KTensor(qs=u8(n // 4), sm=u8(n // 16), d=sup, dmin=sup.clone())
    return Q3KTensor(qs=u8(n // 4), hm=u8(n // 8), d=sup,
                     sc=torch.zeros((*lead, d, n // 16), dtype=torch.int8))


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_packed_mv_checks_raise(quant):
    """What the kernel does not take raises ValueError before a launch:
    in-features that are no multiple of 256 and a misaligned or
    non-contiguous plane (``_check_packed``), an x of another width, more
    than 4 rows without ids, and ids of another dtype, count or layout
    (``check_packed_mv``)."""
    qt = _planes(quant, (), 32, 512)
    check = lambda w, x, ids=None: (wrapper._check_packed(w, x, ids is not None, "t"),
                                    check_packed_mv(w, x, ids, "t"))
    check(qt, torch.ones((4, 512)))                             # what it takes
    with pytest.raises(ValueError, match="256"):
        check(_planes(quant, (), 32, 128), torch.ones((1, 128)))
    with pytest.raises(ValueError, match="x"):
        check(qt, torch.ones((1, 768)))
    with pytest.raises(ValueError, match="rows"):
        check(qt, torch.ones((5, 512)))
    tab = _planes(quant, (3,), 32, 512)
    x = torch.ones((2, 512))
    for ids in (torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.int32)):
        check(tab, x, ids)
    for ids in (torch.zeros(2), torch.zeros(3, dtype=torch.int64),
                torch.zeros((2, 2), dtype=torch.int64)[:, 0],
                torch.zeros(2, dtype=torch.int16)):
        with pytest.raises(ValueError, match="ids"):
            check(tab, x, ids)
    bad = qt.map(lambda t: t.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        check(bad, torch.ones((1, 512)))
    shifted = torch.zeros(32 * 128 + 1, dtype=torch.uint8)[1:].view(32, 128)
    with pytest.raises(ValueError, match="aligned"):
        check(dataclasses.replace(qt, qs=shifted), torch.ones((1, 512)))
