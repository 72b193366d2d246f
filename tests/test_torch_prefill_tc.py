"""The numerics of K9 and K10 on the tensor cores (``csrc/prefill_attn.cu``)
against the JAX package, on the CPU.

The kernel computes the f32 function with bf16 operands: each f32 operand
(q, and the probabilities p) is split into bf16 hi + lo, the cache
operand is one bf16 term (bf16, int8) or two (f16, f32), the int8 row
scales fold in after the products, the softmax runs online over tiles of
32 slots with exp2, and where the row blocks are too few the window is
split over blocks (``prefill_splits``) and the spans' (m, l, acc) partials
merged. ``_emulate`` below repeats that arithmetic in float32 torch (a
product of two bf16 values is exact in f32, as on the tensor cores) and
must agree with the Pallas ``mha_prefill_attn``/``mla_prefill_attn`` in
interpret mode at 1e-4 of max|ref|, the tolerance of every check of the
kernel on the card, with scores reaching about +-30. A negative control
pins why the split is there: single-pass bf16 q and p miss 1e-4 on the
same inputs. The emulation is test-local: nothing on the main path calls
it; the plain versions stay f32.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu.ops.pallas.attention import mha_prefill_attn as jax_mha_prefill
from deepseek_tpu.ops.pallas.attention import mla_prefill_attn as jax_mla_prefill
from deepseek_tpu_torch.models.kvcache import quantize_rows
import deepseek_tpu_torch.ops.kernels.prefill_attn as wrapper
from deepseek_tpu_torch.ops.kernels.prefill_attn import prefill_splits
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TILE = 32             # slots a tile (the kernel's TS at bf16/int8)
NEG_INF = -1e30
DTYPES = ("bf16", "f16", "f32", "int8")
TORCH_DTYPE = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _split(x: torch.Tensor, two: bool = True):
    """bf16 terms of an f32 operand: (hi, lo), or (hi,) single-pass."""
    hi = _bf16(x)
    return (hi, _bf16(x - hi)) if two else (hi,)


def _cache_terms(c: torch.Tensor):
    """The cache operand's bf16 terms: one for bf16/int8 (exact), two for
    f16/f32."""
    f = c.float()
    if c.dtype in (torch.bfloat16, torch.int8):
        assert torch.equal(_bf16(f), f)
        return (f,)
    return _split(f)


def _product(eq: str, x_terms, c_terms):
    """sum of x_i . c_j over the kernel's term pairs: hi.c + lo.c, plus
    hi.c_lo for a two-term cache (lo.c_lo is below f32's resolution)."""
    out = sum(torch.einsum(eq, x, c_terms[0]) for x in x_terms)
    if len(c_terms) > 1:
        out = out + torch.einsum(eq, x_terms[0], c_terms[1])
    return out


def _emulate(parts, v, v_scale, q_pos0, cache_pos0, scale, partials, mqa,
             split_q=True, split_p=True):
    """The kernel's arithmetic. parts: [(q (B,T,H,d) f32, k cache (B,S,H,d)
    or (B,S,d) for MQA, row scale (B,H,S)/(B,S) or None)]; v (B,S,H,Dv) or
    (B,S,R); v_scale likewise. Returns (B,T,H,Dv), or (acc, m, l)."""
    q0 = parts[0][0]
    B, T, H = q0.shape[:3]
    S = v.shape[1]
    ke = "bthd,bsd->bhts" if mqa else "bthd,bshd->bhts"
    ve = "bhts,bsd->bthd" if mqa else "bhts,bshd->bthd"
    sc_view = (lambda s: s[:, None, None, :]) if mqa else (lambda s: s[:, :, None, :])
    scores = 0.0
    for q, k, ks in parts:
        s = _product(ke, _split(q.float(), split_q), _cache_terms(k))
        scores = scores + (s if ks is None else s * sc_view(ks))
    scores = scores * scale                                   # (B,H,T,S)
    vt = _cache_terms(v)
    mask = (cache_pos0 + torch.arange(S))[None, :] <= (q_pos0 + torch.arange(T))[:, None]
    n_split, span = prefill_splits(B, T, H, S, q_pos0, cache_pos0, mqa)
    trip = []
    for z in range(n_split):
        acc = torch.zeros((B, T, H, v.shape[-1]))
        m = torch.full((B, H, T), NEG_INF)
        l = torch.zeros((B, H, T))
        for s0 in range(z * span, min(S, (z + 1) * span), TILE):
            sl = slice(s0, min(S, s0 + TILE, (z + 1) * span))
            x = torch.where(mask[None, None, :, sl], scores[..., sl],
                            torch.tensor(NEG_INF))
            mn = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2((m - mn) * math.log2(math.e))
            p = torch.where(x > NEG_INF, torch.exp2((x - mn[..., None])
                                                    * math.log2(math.e)), 0.0)
            l = l * alpha + p.sum(-1)
            pv = p if v_scale is None else p * sc_view(v_scale)[..., sl]
            acc = acc * alpha.permute(0, 2, 1)[..., None] + _product(
                ve, _split(pv, split_p), tuple(t[:, sl] for t in vt))
            m = mn
        trip.append((acc, m.permute(0, 2, 1), l.permute(0, 2, 1)))
    M = torch.stack([t[1] for t in trip]).amax(0)
    w = [torch.exp(t[1] - M) for t in trip]
    L = sum(wi * t[2] for wi, t in zip(w, trip))
    acc = sum(wi[..., None] * t[0] for wi, t in zip(w, trip))
    if partials:
        return acc, M, L
    return acc / torch.clamp(L, min=1e-30)[..., None]


def _rnd(shape, rng, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cache(x: np.ndarray, dtype: str, head_major: bool):
    """A cache plane in `dtype` as (torch tensor, f32 scales or None) and
    its JAX counterpart (array, scales)."""
    if dtype == "int8":
        qt, s = quantize_rows(torch.from_numpy(x))
        st = s.transpose(1, 2).contiguous() if head_major else s
        return (qt, st), (jnp.asarray(qt.numpy()), jnp.asarray(st.numpy()))
    t = torch.from_numpy(x).to(TORCH_DTYPE[dtype])
    j = jnp.asarray(t.float().numpy()).astype(
        {"bf16": jnp.bfloat16, "f16": jnp.float16, "f32": jnp.float32}[dtype])
    return (t, None), (j, None)


def _mha_case(dtype, partials, Dh=192, Dv=128, q_scale=25.0, q_pos0=90,
              cache_pos0=4, T=24, H=3, S=150, seed=0):
    """K9 at V3/V2-Lite head dims (Dh 192, Dv 128), a few heads; q scaled
    so the scores reach about +-30. Returns (JAX ref, emulation kwargs)."""
    rng = np.random.default_rng(seed)
    q = _rnd((1, T, H, Dh), rng, q_scale)
    (k, ks), (jk, jks) = _cache(_rnd((1, S, H, Dh), rng), dtype, True)
    (v, vs), (jv, jvs) = _cache(_rnd((1, S, H, Dv), rng), dtype, True)
    scale = 1.0 / math.sqrt(Dh)
    want = jax_mha_prefill(jnp.asarray(q), jk, jv, q_pos0, cache_pos0, scale,
                           k_scale=jks, v_scale=jvs, partials=partials,
                           interpret=True)
    emu = dict(parts=[(torch.from_numpy(q), k, ks)], v=v, v_scale=vs,
               q_pos0=q_pos0, cache_pos0=cache_pos0, scale=scale,
               partials=partials, mqa=False)
    return want, emu


def _mla_case(dtype, partials, R=512, P=64, q_scale=16.0, q_pos0=90,
              cache_pos0=4, T=12, H=3, S=150, seed=1):
    """K10 at V3/V2-Lite latent dims (R 512, P 64); scores about +-30."""
    rng = np.random.default_rng(seed)
    qc, qr = _rnd((1, T, H, R), rng, q_scale), _rnd((1, T, H, P), rng, q_scale)
    (ckv, cs), (jckv, jcs) = _cache(_rnd((1, S, R), rng), dtype, False)
    (kr, rs), (jkr, jrs) = _cache(_rnd((1, S, P), rng), dtype, False)
    scale = 1.0 / math.sqrt(192)
    want = jax_mla_prefill(jnp.asarray(qc), jnp.asarray(qr), jckv, jkr, q_pos0,
                           cache_pos0, scale, ckv_scale=jcs, krope_scale=jrs,
                           partials=partials, interpret=True)
    emu = dict(parts=[(torch.from_numpy(qc), ckv, cs), (torch.from_numpy(qr), kr, rs)],
               v=ckv, v_scale=cs, q_pos0=q_pos0, cache_pos0=cache_pos0,
               scale=scale, partials=partials, mqa=True)
    return want, emu


def _rel_errs(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    out = []
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w, np.float32))
        out.append(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
    return out


def _max_score(emu) -> float:
    """max |scaled score| of the first (latent / only) key part, over the
    dequantized rows of an int8 cache."""
    q, k, ks = emu["parts"][0]
    kf = k.float()
    if ks is not None:
        kf = kf * (ks[..., None] if emu["mqa"] else ks.transpose(1, 2)[..., None])
    s = torch.einsum("bthd,bsd->bhts" if emu["mqa"] else "bthd,bshd->bhts", q, kf)
    return float(s.abs().max()) * emu["scale"]


CASES = {"K9": _mha_case, "K10": _mla_case}


@pytest.mark.parametrize("partials", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["K9", "K10"])
def test_split_bf16_matches_jax(kernel, dtype, partials):
    """The split-bf16 arithmetic at V3's (and V2-Lite's) head dims, every
    cache dtype, normalized and partials, against the Pallas kernel in
    interpret mode: 1e-4 of max|ref| (of each of acc, m, l)."""
    want, emu = CASES[kernel](dtype, partials)
    assert 20.0 < _max_score(emu) < 45.0
    errs = _rel_errs(_emulate(**emu), want)
    assert max(errs) <= 1e-4, errs


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("kernel,dims", [("K9", dict(Dh=52)), ("K10", dict(P=20))])
def test_split_bf16_dk_not_multiple_of_16(kernel, dims, dtype):
    """A key width that is not a multiple of 16 (the kernel pads it with
    zeros to a multiple of 64): K9 at Dh 52, K10 at P 20."""
    want, emu = CASES[kernel](dtype, False, **dims)
    errs = _rel_errs(_emulate(**emu), want)
    assert max(errs) <= 1e-4, errs


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("kernel", ["K9", "K10"])
def test_split_bf16_empty_shard(kernel, dtype):
    """A shard whose first slot comes after every query (context-parallel
    prefill's second shard under the window's first chunk): acc 0, l 0,
    m -1e30 from both."""
    want, emu = CASES[kernel](dtype, True, q_pos0=0, cache_pos0=200)
    got = _emulate(**emu)
    assert float(got[0].abs().max()) == 0.0 and float(got[2].abs().max()) == 0.0
    assert bool((got[1] == NEG_INF).all())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("kernel", ["K9", "K10"])
def test_single_pass_bf16_misses_the_tolerance(kernel):
    """Negative control: rounding q and p to bf16 once (the TPU kernel's
    DEFAULT precision, single-pass bf16 on the tensor cores) misses 1e-4
    of max|ref| on the same inputs, so the kernel keeps the lo terms."""
    want, emu = CASES[kernel]("bf16", False)
    assert max(_rel_errs(_emulate(**emu), want)) <= 1e-4
    single = _emulate(**emu, split_q=False, split_p=False)
    assert max(_rel_errs(single, want)) > 1e-4


@pytest.mark.parametrize("args,want", [
    # V2-Lite's K9 at the window's end: 16 heads x 4 row blocks = 64 blocks
    ((1, 256, 16, 4096, 3840, 0, False), (5, 832)),
    # V3's K9 (128 heads) and K10 (256 x 128 rows): 512 blocks, no split
    ((1, 256, 128, 4096, 3840, 0, False), (1, 4096)),
    ((1, 256, 128, 4096, 3840, 0, True), (1, 4096)),
    # V2-Lite's K9 on the second of two shards: 2048 slots
    ((1, 256, 16, 2048, 3840, 2048, False), (5, 448)),
    # an empty shard: no slot is seen, one (empty) span
    ((1, 256, 16, 2048, 0, 2048, False), (1, 2048)),
    # the window's first chunk sees 256 slots: 4 spans of 64
    ((1, 256, 16, 4096, 0, 0, False), (4, 64)),
    # tiny shapes split as far as the seen slots allow
    ((1, 8, 2, 200, 150, 0, True), (3, 64)),
])
def test_prefill_splits(args, want):
    """The wrapper's split count: a pure function of the shapes that fills
    about 2 blocks on each of 132 SMs, with spans that cover exactly the
    seen slots in whole multiples of 64 (every tile size divides them)."""
    n, span = prefill_splits(*args)
    assert (n, span) == want
    B, T, H, S, q_pos0, cache_pos0, _ = args
    used = max(0, min(S, q_pos0 + T - cache_pos0))
    assert 1 <= n <= 16 and span % 64 == 0 or n == 1
    assert n == 1 or (n - 1) * span < used <= n * span


def test_wrapper_constants_match_the_kernel():
    """The wrapper's block rows and split limit are the kernel's (Cfg::BM =
    16 * WM, kMaxSplits in csrc/prefill_attn.cu), and every tile size of
    the kernel divides the split spans' alignment."""
    src = (Path(wrapper.__file__).resolve().parents[2] / "csrc" / "prefill_attn.cu") \
        .read_text()

    def const(pattern):
        return int(re.search(pattern, src).group(1))

    assert wrapper._MAX_SPLITS == const(r"constexpr int kMaxSplits = (\d+);")
    assert re.search(r"static constexpr int BM = 16 \* WM;", src)
    assert wrapper._BLOCK_ROWS == 16 * const(r"static constexpr int WM = (\d+);")
    m = re.search(r"static constexpr int TS = \(NG == 2 && kSplit\) \? (\d+) : (\d+);",
                  src)
    assert all(wrapper._SPAN_ALIGN % int(ts) == 0 for ts in m.groups())
