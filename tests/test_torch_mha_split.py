"""K8's split and merge (``csrc/mha_decode.cu``) against the JAX package,
on the CPU.

The kernel cuts the window into ``decode_splits`` spans (a pure function
of the shapes), walks each span in tiles of TS slots (8 over int8 rows, 4
over bf16/f16/f32) with an online softmax a head, the int8 row scales
folded into the scores and the weights, writes each span's unnormalized
(acc, m, l), and a merge kernel combines the spans exactly (empty spans,
l = 0, weigh nothing). ``_emulate`` repeats that schedule in float32 torch
and must agree with the Pallas ``mha_decode_attn`` in interpret mode at
1e-4 of max|ref|, the tolerance of every check of the kernel on the card,
for bf16 and int8 caches, normalized and partials outputs, and an empty
shard, at kv_len 1, 31, 33 (inside and just past a span) and 4000.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu.ops.pallas.attention import mha_decode_attn as jax_mha_decode
import deepseek_tpu_torch.ops.kernels.attention as wrapper
from deepseek_tpu_torch.ops.kernels.attention import decode_splits
from tests.test_torch_threads import one_torch_thread  # noqa: F401

NEG_INF = -1e30
TILE = {"bf16": 4, "int8": 8}      # slots a tile (Cfg::TS; checked below)


def _emulate(q, k, v, kv_len, scale, ks=None, vs=None, partials=False, tile=4):
    """The kernel's schedule: q (B,H,Dh), k (B,S,H,Dh), v (B,S,H,Dv) f32
    (int8 rows as their integer values), ks/vs (B,H,S) or None."""
    B, S, H, _ = k.shape
    n, span = decode_splits(B, H, S)
    assert n * span >= S and span % tile == 0
    s = torch.einsum("bhd,bshd->bhs", q, k)                  # (B,H,S)
    if ks is not None:
        s = s * ks
    s = s * scale
    pos = torch.arange(n * span)
    live = pos[None, :] < torch.as_tensor(kv_len).reshape(B, 1).clamp(max=S)  # (B, n*span)
    pad = n * span - S
    s = torch.nn.functional.pad(s, (0, pad))
    vw = v if vs is None else v * vs.transpose(1, 2)[..., None]
    vw = torch.nn.functional.pad(vw, (0, 0, 0, 0, 0, pad))      # (B, n*span, H, Dv)
    acc = torch.zeros((B, H, n, v.shape[-1]))
    m = torch.full((B, H, n), NEG_INF)
    l = torch.zeros((B, H, n))
    for t0 in range(0, span, tile):                             # all spans at once
        idx = torch.arange(n)[:, None] * span + t0 + torch.arange(tile)[None, :]   # (n, tile)
        ok = live[:, idx][:, None]                              # (B,1,n,tile)
        st = torch.where(ok, s[:, :, idx], torch.tensor(NEG_INF))
        walked = ok.any(-1)                                     # the span reaches the tile
        mn = torch.maximum(m, st.amax(-1))
        alpha = torch.exp(m - mn)
        p = torch.where(ok, torch.exp(st - mn[..., None]), torch.tensor(0.0))
        vt = vw[:, idx].permute(0, 3, 1, 2, 4)                  # (B,H,n,tile,Dv)
        acc = torch.where(walked[..., None], acc * alpha[..., None] +
                          torch.einsum("bhnt,bhntd->bhnd", p, vt), acc)
        l = torch.where(walked, l * alpha + p.sum(-1), l)
        m = torch.where(walked, mn, m)
    # the merge: the spans' weights e^(m_s - m*), 0 for an empty span
    has = l > 0
    mx = torch.where(has, m, torch.tensor(NEG_INF)).amax(-1)
    w = torch.where(has, torch.exp(m - mx[..., None]), torch.tensor(0.0))
    den = (l * w).sum(-1)
    out = (acc * w[..., None]).sum(2)
    if partials:
        return out, mx, den
    return out / torch.where(den > 0, den, torch.tensor(1.0))[..., None]


def _inputs(kind, B, S, H, Dh, Dv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    if kind == "int8":
        k = rng.integers(-127, 128, (B, S, H, Dh)).astype(np.int8)
        v = rng.integers(-127, 128, (B, S, H, Dv)).astype(np.int8)
        ks = (rng.random((B, H, S)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((B, H, S)) * 0.02 + 0.001).astype(np.float32)
        kj, vj = jnp.asarray(k), jnp.asarray(v)
        kt, vt = torch.from_numpy(k).float(), torch.from_numpy(v).float()
        return q, kj, vj, kt, vt, ks, vs
    kj = jnp.asarray(rng.standard_normal((B, S, H, Dh)) * 0.3, jnp.bfloat16)
    vj = jnp.asarray(rng.standard_normal((B, S, H, Dv)), jnp.bfloat16)
    kt = torch.from_numpy(np.array(kj.astype(jnp.float32)))
    vt = torch.from_numpy(np.array(vj.astype(jnp.float32)))
    return q, kj, vj, kt, vt, None, None


def _pallas(q, kj, vj, kl, scale, ks, vs, partials):
    sc = {} if ks is None else dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    out = jax_mha_decode(jnp.asarray(q), kj, vj, jnp.asarray(kl), scale,
                         interpret=True, partials=partials, **sc)
    if partials:                     # (acc (B,H,Dv), m, l (B,H))
        acc, m, l = (np.asarray(o) for o in out)
        return acc, m.reshape(acc.shape[:2]), l.reshape(acc.shape[:2])
    return np.asarray(out)


def _check(got, want, tol=1e-4):
    assert float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("kv_len,S,H", [(1, 64, 16), (31, 64, 16), (33, 64, 16),
                                        (4000, 4096, 16)])
def test_split_merge_matches_pallas(kind, kv_len, S, H):
    """The normalized output over V2-Lite's 16 heads (Dh 192, Dv 128):
    kv_len 1 (one live slot), 31 and 33 (inside and just past a 32-slot
    span), 4000 (the long window), against the Pallas kernel."""
    Dh, Dv = 192, 128
    q, kj, vj, kt, vt, ks, vs = _inputs(kind, 1, S, H, Dh, Dv, seed=kv_len)
    scale = 1.0 / math.sqrt(Dh)
    kl = np.asarray([kv_len], np.int32)
    want = _pallas(q, kj, vj, kl, scale, ks, vs, False)
    tt = (lambda a: None if a is None else torch.from_numpy(a))
    got = _emulate(torch.from_numpy(q), kt, vt, kl, scale, tt(ks), tt(vs),
                   tile=TILE[kind]).numpy()
    _check(got, want)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_partials_and_empty_shard_match_pallas(kind):
    """The partials triple over two shards of a 64-slot window (B = 2: one
    sequence's live prefix, 33 slots, ends in shard 0 and leaves its shard 1
    empty), against the Pallas kernel's partials: m exact to 1e-4 of its
    scale, acc and l once rescaled to its m; the empty shard gives acc 0,
    l 0 and m -1e30."""
    B, S, H, Dh, Dv = 2, 64, 16, 192, 128
    q, kj, vj, kt, vt, ks, vs = _inputs(kind, B, S, H, Dh, Dv, seed=7)
    scale = 1.0 / math.sqrt(Dh)
    kl = np.asarray([64, 33], np.int32)
    half = S // 2
    for s in range(2):
        sl = slice(s * half, (s + 1) * half)
        kl_s = np.clip(kl - s * half, 0, half).astype(np.int32)
        ks_s = None if ks is None else np.ascontiguousarray(ks[..., sl])
        vs_s = None if vs is None else np.ascontiguousarray(vs[..., sl])
        want = _pallas(q, kj[:, sl], vj[:, sl], kl_s, scale, ks_s, vs_s, True)
        tt = (lambda a: None if a is None else torch.from_numpy(a))
        acc, m, l = (x.numpy() for x in _emulate(
            torch.from_numpy(q), kt[:, sl], vt[:, sl], kl_s, scale, tt(ks_s), tt(vs_s),
            partials=True, tile=TILE[kind]))
        wa, wm, wl = want
        live = kl_s > 0
        _check(m[live], wm[live])
        r = np.exp(m[live] - wm[live])
        _check(acc[live] * r[..., None], wa[live])
        _check(l[live] * r, wl[live])
        if not live.all():                       # sequence 1's empty shard
            assert not acc[~live].any() and not l[~live].any()
            assert (m[~live] == NEG_INF).all()


@pytest.mark.parametrize("args,want", [
    ((1, 16, 4096), (128, 32)),       # V2-Lite: 2 head groups x 128 spans
    ((1, 128, 4096), (17, 248)),      # V3's 128 heads: 16 head groups x 17
    ((1, 16, 2048), (128, 16)),       # a seq=2 shard of V2-Lite's window
    ((2, 3, 40), (5, 8)),             # tiny: one span a tile of 8 slots
    ((64, 16, 4096), (3, 1368)),      # many sequences: few spans
])
def test_decode_splits(args, want):
    """The wrapper's split count: a pure function of the shapes that fills
    about 2 blocks on each of 132 SMs, with spans in whole multiples of 8
    slots (both tile sizes divide them) that cover the window."""
    n, span = decode_splits(*args)
    assert (n, span) == want
    S = args[2]
    assert 1 <= n <= 256 and span % 8 == 0 and (n - 1) * span < S <= n * span


def test_wrapper_constants_match_the_kernel():
    """The wrapper's heads a block, split limit and head-width limit are
    csrc/mha_decode.cu's (kHG, kMaxSplits, kMaxD), and the kernel's tile
    sizes (TS) divide the spans' alignment and are the emulation's."""
    src = (Path(wrapper.__file__).resolve().parents[2] / "csrc" / "mha_decode.cu") \
        .read_text()

    def const(pattern):
        return int(re.search(pattern, src).group(1))

    assert wrapper._MHA_HEADS == const(r"constexpr int kHG = (\d+);")
    assert wrapper._MHA_MAX_SPLITS == const(r"constexpr int kMaxSplits = (\d+);")
    assert wrapper._MHA_MAX_D == const(r"constexpr int kMaxD = (\d+);")
    m = re.search(r"static constexpr int TS = sizeof\(T\) == 1 \? (\d+) : (\d+);", src)
    q8, other = (int(x) for x in m.groups())
    assert (q8, other) == (TILE["int8"], TILE["bf16"])
    assert wrapper._MHA_SPAN_ALIGN % q8 == 0 and wrapper._MHA_SPAN_ALIGN % other == 0
