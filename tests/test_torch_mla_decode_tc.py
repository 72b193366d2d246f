"""The numerics of K3 on the tensor cores (the decode mode of
``csrc/prefill_attn.cu``) against the JAX package, on the CPU, and the
wrapper's split choice, constants and shape checks.

K3 runs K10's kernel with one query: the block's 64 rows are heads, each
f32 operand (q, and the probabilities p) is split into bf16 hi + lo, the
cache is one bf16 term (bf16, int8) or two (f16, f32), the int8 row
scales fold in after the products, the softmax runs online over tiles of
32 slots with exp2, and the window is walked in the spans of
``mla_decode_splits`` (a pure function of B, H and S), whose partials an
exact merge combines over the spans that saw a slot (l > 0). Slot s of
sequence b counts while s < kv_len[b], read on the card. ``_emulate``
below repeats that arithmetic in float32 torch and must agree with the
Pallas ``mla_decode_attn`` in interpret mode at 1e-4 of max|ref| (each
of acc, m, l for the partials), the tolerance of every check of the
kernel on the card, with scores reaching about +-30. The emulation is
test-local; the plain version stays f32.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu.ops.pallas.attention import mla_decode_attn as jax_mla_decode_attn
import deepseek_tpu_torch.ops.kernels.attention as wrapper
import deepseek_tpu_torch.ops.kernels.qmm as qmm_wrapper
from deepseek_tpu_torch.ops.kernels.attention import (
    check_mla_decode_shapes, mla_decode_splits,
)
from deepseek_tpu_torch.quant.qtensor import Fp8Tensor
from tests.test_torch_prefill_tc import (
    DTYPES, NEG_INF, TILE, _cache, _cache_terms, _product, _rel_errs, _rnd, _split,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

R, P = 512, 64


def _emulate(qc, qr, ckv, kr, cs, rs, kv_len, scale, partials, split=True):
    """The kernel's arithmetic: q_c (B,H,R), q_rope (B,H,P) f32, the cache
    planes (B,S,R), (B,S,P) with (B,S) scales or None, kv_len (B,) ->
    (B,H,R), or (acc, m (B,H), l (B,H))."""
    B, H, _ = qc.shape
    S = ckv.shape[1]
    sc = _product("bhd,bsd->bhs", _split(qc, split), _cache_terms(ckv))
    sr = _product("bhd,bsd->bhs", _split(qr, split), _cache_terms(kr))
    if cs is not None:
        sc, sr = sc * cs[:, None, :], sr * rs[:, None, :]
    scores = (sc + sr) * scale                                   # (B,H,S)
    live = torch.arange(S)[None, :] < kv_len[:, None]            # (B,S)
    vt = _cache_terms(ckv)
    n_split, span = mla_decode_splits(B, H, S)
    trip = []
    for z in range(n_split):
        acc = torch.zeros((B, H, R))
        m = torch.full((B, H), NEG_INF)
        l = torch.zeros((B, H))
        for s0 in range(z * span, min(S, (z + 1) * span), TILE):
            sl = slice(s0, min(S, s0 + TILE, (z + 1) * span))
            x = torch.where(live[:, None, sl], scores[..., sl], torch.tensor(NEG_INF))
            mn = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2((m - mn) * math.log2(math.e))
            p = torch.where(x > NEG_INF, torch.exp2((x - mn[..., None])
                                                    * math.log2(math.e)), 0.0)
            l = l * alpha + p.sum(-1)
            pv = p if cs is None else p * cs[:, None, sl]
            acc = acc * alpha[..., None] + _product(
                "bhs,bsd->bhd", _split(pv, split), tuple(t[:, sl] for t in vt))
            m = mn
        trip.append((acc, m, l))
    # the merge: only the spans that saw a slot
    ok = torch.stack([t[2] > 0 for t in trip])
    M = torch.where(ok, torch.stack([t[1] for t in trip]), torch.tensor(NEG_INF)).amax(0)
    w = [torch.where(k, torch.exp(t[1] - M), 0.0) for k, t in zip(ok, trip)]
    L = sum(wi * t[2] for wi, t in zip(w, trip))
    acc = sum(wi[..., None] * t[0] for wi, t in zip(w, trip))
    if partials:
        return acc, M, L
    return acc / torch.clamp(L, min=1e-30)[..., None]


def _case(dtype, kv_len, partials, B=2, H=3, S=150, q_scale=16.0, seed=2):
    """K3 at V3's latent widths (R 512, P 64), a few heads, B sequences
    with their own kv_len; q scaled so the scores reach about +-30.
    Returns (JAX ref, emulation kwargs)."""
    rng = np.random.default_rng(seed)
    qc, qr = _rnd((B, H, R), rng, q_scale), _rnd((B, H, P), rng, q_scale)
    (ckv, cs), (jckv, jcs) = _cache(_rnd((B, S, R), rng), dtype, False)
    (kr, rs), (jkr, jrs) = _cache(_rnd((B, S, P), rng), dtype, False)
    kl = np.asarray(kv_len, np.int32)
    scale = 1.0 / math.sqrt(192)
    want = jax_mla_decode_attn(jnp.asarray(qc), jnp.asarray(qr), jckv, jkr,
                               jnp.asarray(kl), scale, ckv_scale=jcs, krope_scale=jrs,
                               interpret=True, partials=partials)
    emu = dict(qc=torch.from_numpy(qc), qr=torch.from_numpy(qr), ckv=ckv, kr=kr,
               cs=cs, rs=rs, kv_len=torch.from_numpy(kl), scale=scale,
               partials=partials)
    return want, emu


def _max_score(emu) -> float:
    kf = emu["ckv"].float()
    if emu["cs"] is not None:
        kf = kf * emu["cs"][..., None]
    return float(torch.einsum("bhd,bsd->bhs", emu["qc"], kf).abs().max()) * emu["scale"]


@pytest.mark.parametrize("partials", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv_len", [[150, 37], [96, 1]], ids=["kv150-37", "kv96-1"])
def test_decode_split_bf16_matches_jax(kv_len, dtype, partials):
    """The split-bf16 arithmetic at V3's latent widths over every cache
    dtype, normalized and partials, two sequences with ragged kv_len (a
    single live slot included) against the Pallas kernel in interpret
    mode: 1e-4 of max|ref|. The two kv_len pairs share the spans: the
    split is the shapes'."""
    want, emu = _case(dtype, kv_len, partials)
    assert 20.0 < _max_score(emu) < 45.0
    errs = _rel_errs(_emulate(**emu), want)
    assert max(errs) <= 1e-4, errs


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_decode_split_bf16_empty_shard(dtype):
    """A shard past the live prefix (kv_len 0 in both sequences: every span
    returns at once): the merge gives acc 0, l 0, m -1e30 exactly, as the
    Pallas kernel does, and no 0/0."""
    want, emu = _case(dtype, [0, 0], True)
    got = _emulate(**emu)
    assert float(got[0].abs().max()) == 0.0 and float(got[2].abs().max()) == 0.0
    assert bool((got[1] == NEG_INF).all())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.float32))


def test_decode_single_pass_bf16_misses_the_tolerance():
    """Negative control: single-pass bf16 q and p miss 1e-4 of max|ref| on
    the same inputs, so the decode mode keeps the lo terms too."""
    want, emu = _case("bf16", [150, 37], False)
    assert max(_rel_errs(_emulate(**emu), want)) <= 1e-4
    assert max(_rel_errs(_emulate(**emu, split=False), want)) > 1e-4


@pytest.mark.parametrize("args,want", [
    # V3 at B = 1: two 64-head row blocks, 64 spans of 64 slots (128 blocks)
    ((1, 128, 4096), (64, 64)),
    # one seq=2 shard: 2048 slots
    ((1, 128, 2048), (32, 64)),
    # H not a multiple of 64, a ragged window
    ((2, 20, 301), (5, 64)),
    # eight sequences: 16 row blocks, 8 spans of 512
    ((8, 128, 4096), (8, 512)),
    # one row block: up to the merge's 128 spans
    ((1, 16, 16384), (128, 128)),
    ((1, 4, 16), (1, 64)),
])
def test_mla_decode_splits(args, want):
    """K3's split count and span: about one block an SM over the row
    blocks and spans, spans in whole multiples of 64 slots (every tile
    size divides them) covering the window, at most the merge's limit."""
    n, span = mla_decode_splits(*args)
    assert (n, span) == want
    B, H, S = args
    assert 1 <= n <= wrapper._MAX_DECODE_SPLITS and span % wrapper._DECODE_SPAN_ALIGN == 0
    assert (n - 1) * span < S <= n * span


def test_mla_decode_splits_are_the_shapes_alone():
    """The split is a pure function of (B, H, S): the wrapper passes no
    kv_len to it (kv_len stays on the card, so a captured graph may replay
    any window), and the same shapes give the same spans every time."""
    import inspect
    assert list(inspect.signature(mla_decode_splits).parameters) == ["B", "H", "S"]
    src = inspect.getsource(wrapper.mla_decode_attn)
    assert "mla_decode_splits(B, H, S)" in src
    assert {mla_decode_splits(1, 128, 4096) for _ in range(3)} == {(64, 64)}


def test_wrapper_constants_match_the_kernel():
    """The decode wrapper's heads a block, latent widths and split limit
    are csrc/prefill_attn.cu's (Cfg::BM = 16 * WM, the DV instances of
    by_dv, kMaxDecodeSplits), and every tile size divides its span
    alignment."""
    src = (Path(wrapper.__file__).resolve().parents[2] / "csrc" / "prefill_attn.cu") \
        .read_text()
    assert wrapper._MAX_DECODE_SPLITS == int(
        re.search(r"constexpr int kMaxDecodeSplits = (\d+);", src).group(1))
    assert wrapper._DECODE_ROWS == 16 * int(
        re.search(r"static constexpr int WM = (\d+);", src).group(1))
    by_dv = src[src.index("cudaError_t by_dv("):]
    by_dv = by_dv[:by_dv.index("}\n}")]
    assert tuple(int(v) for v in re.findall(r"case (\d+): return launch", by_dv)) == \
        wrapper._DECODE_R
    m = re.search(r"static constexpr int TS = \(NG == 2 && kSplit\) \? (\d+) : (\d+);",
                  src)
    assert all(wrapper._DECODE_SPAN_ALIGN % int(ts) == 0 for ts in m.groups())
    assert 'extern "C" int mla_decode(' in src


@pytest.mark.parametrize("B,H,S,R_,P_,dtype", [
    (1, 4, 16, 256, 64, torch.bfloat16),     # a latent width with no instance
    (1, 4, 16, 512, 2, torch.bfloat16),      # (R + P) % 4 != 0
    (1, 4, 16, 512, 64, torch.float64),      # no cache dtype code
    (0, 4, 16, 512, 64, torch.bfloat16),     # empty
    (1, 4, 0, 512, 64, torch.bfloat16),
    (65536, 4, 16, 512, 64, torch.int8),     # past the grid's y limit
])
def test_mla_decode_rejects_unsupported_shapes(B, H, S, R_, P_, dtype):
    """What the decode kernel does not take raises ValueError in the
    wrapper, before a launch."""
    with pytest.raises(ValueError):
        check_mla_decode_shapes(B, H, S, R_, P_, dtype)


@pytest.mark.parametrize("R_", [128, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32,
                                   torch.int8])
def test_mla_decode_takes_supported_shapes(R_, dtype):
    check_mla_decode_shapes(2, 20, 301, R_, 64, dtype)


def _fp8_table(E=3, d=40, n=64, block=(16, 32)):
    data = torch.randn((E, d, n)).to(torch.float8_e5m2)
    scale = torch.rand((E, -(-d // block[0]), -(-n // block[1])))
    return Fp8Tensor(data=data, scale=scale, block_size=block)


@pytest.mark.parametrize("misuse", ["per_tensor", "grid", "non_contiguous", "dtype",
                                    "columns", "device"])
def test_k2_fp8_checks_raise(misuse):
    """K2's fp8 body refuses, before a launch, what its kernel cannot take:
    a per-tensor scale, a scale grid that is not the ceil grid, a
    non-contiguous or mistyped plane, in-features or a column block off
    16, planes on another device than x."""
    qt = _fp8_table()
    x = torch.ones((2, 64))
    if misuse == "per_tensor":
        qt = Fp8Tensor(data=qt.data, scale=torch.ones(()), block_size=(0, 0))
    elif misuse == "grid":
        qt = Fp8Tensor(data=qt.data, scale=qt.scale[:, :1], block_size=qt.block_size)
    elif misuse == "non_contiguous":
        qt = qt.map(lambda t: t.transpose(1, 2).contiguous().transpose(1, 2))
    elif misuse == "dtype":
        qt = Fp8Tensor(data=qt.data, scale=qt.scale.double(), block_size=qt.block_size)
    elif misuse == "columns":
        qt = _fp8_table(n=72, block=(16, 24))
        x = torch.ones((2, 72))
    else:
        x = torch.ones((2, 64), device="meta")
    with pytest.raises(ValueError):
        qmm_wrapper._check_fp8(qt, x, True, 16, "qmm_experts_fp8")


def test_k2_fp8_checks_pass_the_converter_layout():
    qmm_wrapper._check_fp8(_fp8_table(E=2, d=300, n=448, block=(128, 128)),
                           torch.ones((1, 448)), True, 16, "qmm_experts_fp8")
