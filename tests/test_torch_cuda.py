"""The port's CUDA kernels against their plain versions on the card.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed; there tests/conftest.py (which imports JAX) is
skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each test skips where no CUDA GPU is visible.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from deepseek_tpu_torch.ops.kernels.attention import (
    mha_decode_attn, mha_decode_attn_plain, mla_decode_attn,
    mla_decode_attn_plain,
)
from deepseek_tpu_torch.ops.kernels.prefill_attn import (
    mha_prefill_attn, mha_prefill_attn_plain, mla_prefill_attn,
    mla_prefill_attn_plain,
)
from deepseek_tpu_torch.ops.kernels.qmm import (
    ROW_TILE_MIN, gmm, gmm_plain, qmm, qmm_expert_ffn, qmm_expert_ffn_plain, qmm_experts,
    qmm_experts_fp, qmm_experts_fp8,
    qmm_experts_packed, qmm_experts_plain, qmm_fp, qmm_fp8, qmm_fp8_rows,
    qmm_fp_plain, qmm_grouped, qmm_grouped_fp8, qmm_grouped_packed,
    qmm_grouped_plain, qmm_grouped_turbo, qmm_experts_turbo, qmm_packed,
    qmm_packed_rows, qmm_plain, qmm_rows, qmm_turbo, qmm_turbo_rows,
)
from deepseek_tpu_torch.quant.qtensor import (
    Fp8Tensor, KNibbleTensor, PlainTensor, Q2KTensor, Q3KTensor, perm_x,
    q2k_to_turbo, q3k_to_turbo,
)


@pytest.fixture
def dev():
    """The first CUDA device; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the H100: see README.md)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _nibble(E, d, n, quant, seed, dev):
    g = torch.Generator().manual_seed(seed)
    p = torch.randint(0, 256, (E, d, n // 2), generator=g, dtype=torch.uint8)
    a = (torch.rand((E, d, n // 16), generator=g) * 0.009 + 0.001).to(torch.bfloat16)
    c = None
    if quant == "q2_k":
        c = (torch.rand((E, d, n // 16), generator=g) * 0.0045 + 0.0005).to(torch.bfloat16)
    return KNibbleTensor(p=p, a=a, c=c, off=0 if quant == "q2_k" else 4).map(
        lambda t: t.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("n", [256, 512, 1536, 2048, 7168])
@pytest.mark.parametrize("B", [1, 3])
def test_qmm_kernels_match_plain(quant, n, B, dev):
    """K1 and K2 against their plain versions. Tolerance 1e-4 of the output
    scale: x split into two int8 terms a 16-column group (~15 bits) against
    the exact nibbles in __dp4a, f32 folds in other orders."""
    qt = _nibble(4, 100, n, quant, seed=n, dev=dev)      # 100 rows: ragged tiles
    x = torch.randn((B, n), generator=torch.Generator().manual_seed(B)).to(dev)
    dense = qt.map(lambda t: t[1].contiguous())
    want = qmm_plain(dense, x)
    torch.testing.assert_close(qmm(dense, x), want, rtol=0,
                               atol=1e-4 * want.abs().max().item())
    idx = torch.tensor([3, 0, 3][:B], device=dev)
    want = qmm_experts_plain(qt, idx, x)
    torch.testing.assert_close(qmm_experts(qt, idx, x), want, rtol=0,
                               atol=1e-4 * want.abs().max().item())


@pytest.mark.cuda
def test_qmm_rejects_misaligned_planes(dev):
    qt = _nibble(1, 16, 256, "q3_k", seed=0, dev=dev).map(lambda t: t[0])
    bad = KNibbleTensor(p=qt.p[:, 1:], a=qt.a, off=4)
    with pytest.raises(ValueError):
        qmm(bad, torch.ones((1, 256), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("d,n,rows", [(100, 256, 3), (4096, 7168, 9), (7168, 2048, 9)])
def test_k2_plain_body_matches_plain(dtype, d, n, rows, dev):
    """K2's plain body (a plain expert table) against its plain version,
    with a repeated expert and a ragged row block. Tolerance 1e-4 of the
    output scale: f32 sums of the same f32-widened products, in other
    orders."""
    g = torch.Generator().manual_seed(d)
    qt = PlainTensor(data=(torch.randn((4, d, n), generator=g) * 0.05).to(dev, dtype))
    x = torch.randn((rows, n), generator=g).to(dev)
    idx = torch.tensor(([3, 0, 3] * 3)[:rows], device=dev)
    before = qmm_experts_fp.launches
    _close(qmm_experts(qt, idx, x), qmm_experts_plain(qt, idx, x), 1e-4)
    assert qmm_experts_fp.launches == before + 1


def _attn_inputs(B, H, S, R, P, seed, dtype, dev):
    g = torch.Generator().manual_seed(seed)
    qc = torch.randn((B, H, R), generator=g)
    qr = torch.randn((B, H, P), generator=g)
    ckv = torch.randn((B, S, R), generator=g) * 0.5
    kr = torch.randn((B, S, P), generator=g) * 0.5
    return [qc.to(dev), qr.to(dev), ckv.to(dev, dtype), kr.to(dev, dtype)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("B,H,S,R,P,kv_len", [
    (1, 128, 4096, 512, 64, [4000]),
    (2, 2, 40, 512, 64, [37, 1]),
    (1, 20, 301, 512, 64, [301]),
    (2, 80, 700, 512, 64, [613, 1]),
    (1, 70, 300, 128, 64, [290]),
])
def test_mla_kernel_matches_plain(dtype, B, H, S, R, P, kv_len, dev):
    """K3 against its plain version: a ragged kv_len a sequence (1 slot
    included), head counts that leave the last 64-head row block part
    empty, R 512 and 128. Tolerance 1e-4: split bf16 operands, f32 sums
    over up to 4096 slots in other orders, exp2."""
    args = _attn_inputs(B, H, S, R, P, H, dtype, dev)
    kl = torch.tensor(kv_len, device=dev)
    scale = 1.0 / math.sqrt(192)
    before = (mla_decode_attn.launches, mla_decode_attn.f16.launches,
              mla_decode_attn.f32.launches)
    torch.testing.assert_close(mla_decode_attn(*args, kl, scale),
                               mla_decode_attn_plain(*args, kl, scale),
                               rtol=1e-4, atol=1e-4)
    assert (mla_decode_attn.launches, mla_decode_attn.f16.launches,
            mla_decode_attn.f32.launches) == (
        before[0] + 1, before[1] + (dtype == torch.float16),
        before[2] + (dtype == torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_mla_kernel_ignores_slots_past_kv_len(dtype, dev):
    """NaN in the slots past kv_len (inside the last tile and in whole
    tiles past it) changes no bit of the output."""
    args = _attn_inputs(1, 4, 200, 512, 64, 0, dtype, dev)
    kl = torch.tensor([40], device=dev)
    want = mla_decode_attn(*args, kl, 0.1)
    args[2][:, 40:] = float("nan")
    args[3][:, 40:] = float("nan")
    got = mla_decode_attn(*args, kl, 0.1)
    assert torch.equal(got, want)
    assert not np.isnan(got.cpu().numpy()).any()


@pytest.mark.cuda
def test_k3_rejects_what_it_cannot_take(dev):
    """K3's decode kernel is built for R 128 and 512: another latent width,
    (R + P) % 4 != 0 or two cache dtypes raise ValueError before a launch."""
    kl = torch.tensor([5], device=dev)
    for R, P in ((256, 64), (512, 2)):
        args = _attn_inputs(1, 4, 16, R, P, 0, torch.bfloat16, dev)
        with pytest.raises(ValueError):
            mla_decode_attn(*args, kl, 0.1)
    args = _attn_inputs(1, 4, 16, 512, 64, 0, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        mla_decode_attn(args[0], args[1], args[2], args[3].half(), kl, 0.1)


def _close(got, want, rel):
    """Max abs error within ``rel`` of the output scale."""
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rel * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("rows,n", [(17, 256), (200, 512), (300, 1536)])
def test_k1_row_tiled_matches_plain(quant, rows, n, dev):
    """K1's row-tiled route (qmm above ROW_TILE_MIN rows) against the plain
    version; 100 output columns leave a ragged column block. Tolerance
    1e-4 of the output scale: f32 sums in other orders."""
    qt = _nibble(1, 100, n, quant, seed=rows, dev=dev).map(lambda t: t[0].contiguous())
    x = torch.randn((rows, n), generator=torch.Generator().manual_seed(1)).to(dev)
    before = qmm_rows.launches
    _close(qmm(qt, x), qmm_plain(qt, x), 1e-4)
    assert qmm_rows.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_k6_matches_plain(quant, dev):
    """K6 over 5 tiles of 3 experts, with and without live-row counts; the
    rows past a tile's count are not compared (the kernel leaves them)."""
    E, d, n, G = 3, 200, 512, 5
    qt = _nibble(E, d, n, quant, seed=6, dev=dev)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((G, 128, n), generator=g).to(dev)
    te = torch.tensor([0, 0, 2, 1, 2], device=dev, dtype=torch.int32)
    _close(qmm_grouped(qt, te, x), qmm_grouped_plain(qt, te, x), 1e-4)
    rows = torch.tensor([128, 7, 0, 64, 1], device=dev, dtype=torch.int32)
    got = qmm_grouped(qt, te, x, rows)
    want = qmm_grouped_plain(qt, te, x, rows)
    live = torch.arange(128, device=dev)[None, :] < rows[:, None]
    _close(got[live], want[live], 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("E,d,n,rows", [(4, 100, 256, 3), (16, 7168, 2048, 9),
                                        (3, 300, 1536, 1)])
def test_k2_prepermuted_matches_plain(quant, E, d, n, rows, dev):
    """K2's prepermuted body (x in the stride-16 order, each natural column
    read from its permuted position by the pre-pass) against its plain
    version and against the natural body on the natural x; counted apart.
    Tolerance 1e-4 of the output scale, as K2's."""
    qt = _nibble(E, d, n, quant, seed=d + n, dev=dev)
    g = torch.Generator().manual_seed(rows)
    x = torch.randn((rows, n), generator=g).to(dev)
    xp = perm_x(x).contiguous()
    idx = torch.tensor(([E - 1, 0, E - 1] * 3)[:rows], device=dev)
    nat, pre = qmm_experts.launches, qmm_experts.prepermuted.launches
    got = qmm_experts(qt, idx, xp, x_prepermuted=True)
    _close(got, qmm_experts_plain(qt, idx, xp, x_prepermuted=True), 1e-4)
    _close(got, qmm_experts(qt, idx, x), 1e-4)
    assert qmm_experts.prepermuted.launches == pre + 1
    assert qmm_experts.launches == nat + 1


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("d,n", [(200, 512), (7168, 2048)])
def test_k6_prepermuted_matches_plain(quant, d, n, dev):
    """K6's prepermuted body (each natural column read from its permuted
    position as a tile is staged) against its plain version, with live-row
    counts, and against the natural body on the natural tiles."""
    E, G = 3, 5
    qt = _nibble(E, d, n, quant, seed=7, dev=dev)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((G, 128, n), generator=g).to(dev)
    xp = perm_x(x).contiguous()
    te = torch.tensor([0, 0, 2, 1, 2], device=dev, dtype=torch.int32)
    rows = torch.tensor([128, 7, 0, 64, 1], device=dev, dtype=torch.int32)
    live = torch.arange(128, device=dev)[None, :] < rows[:, None]
    before = qmm_grouped.prepermuted.launches
    got = qmm_grouped(qt, te, xp, rows, x_prepermuted=True)
    assert qmm_grouped.prepermuted.launches == before + 1
    _close(got[live], qmm_grouped_plain(qt, te, xp, rows, x_prepermuted=True)[live], 1e-4)
    _close(got[live], qmm_grouped(qt, te, x, rows)[live], 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("E,mh,n,d,N", [(3, 1024, 256, 512, 4), (12, 2048, 7168, 7168, 9),
                                        (6, 256, 512, 300, 40)])
def test_k7_matches_plain(quant, act, E, mh, n, d, N, dev):
    """K7 (one cooperative launch) against its plain version: DeepSeek-V3's
    widths with 9 pairs, the JAX test's shapes, and 40 pairs over a short
    m, more than one shared-memory chunk of pairs; a repeated expert and a
    zero-weight pair each time. Tolerance 1e-4 of the output scale: f32
    sums in other orders, the GLU's exp/tanh, and the nibble floats'
    offset cancelled against f32 group sums in both products."""
    from deepseek_tpu_torch.config import ActivationType
    from deepseek_tpu_torch.models.loader import _rowperm_qt
    w13 = _rowperm_qt(_nibble(E, 2 * mh, n, quant, seed=mh + n, dev=dev), 2, undo=False)
    w2 = _nibble(E, d, mh, quant, seed=d, dev=dev)
    g = torch.Generator().manual_seed(N)
    idx = torch.randint(0, E, (N,), generator=g)
    idx[1] = idx[0]
    idx = idx.sort().values.to(dev)
    wts = torch.rand((N,), generator=g).to(dev)
    wts[N // 2] = 0.0
    x = torch.randn((1, n), generator=g).to(dev, torch.bfloat16)
    a = ActivationType(act)
    before = qmm_expert_ffn.launches
    got = qmm_expert_ffn(w13, w2, idx, x, wts, a)
    assert qmm_expert_ffn.launches == before + 1
    assert got.shape == (1, d) and got.dtype == torch.float32
    _close(got, qmm_expert_ffn_plain(w13, w2, idx, x, wts, a), 1e-4)
    assert torch.equal(qmm_expert_ffn(w13, w2, idx, x, wts, a), got)   # no atomics


@pytest.mark.cuda
def test_k7_rejects_what_it_cannot_take(dev):
    from deepseek_tpu_torch.config import ActivationType
    w13 = _nibble(2, 512, 256, "q3_k", seed=1, dev=dev)
    w2 = _nibble(2, 256, 256, "q3_k", seed=2, dev=dev)
    idx = torch.zeros(2, dtype=torch.int64, device=dev)
    wts = torch.ones(2, device=dev)
    x = torch.ones((1, 256), device=dev)
    with pytest.raises(ValueError, match="not fusable"):       # natural rows
        qmm_expert_ffn(w13, w2, idx, x, wts, ActivationType.SILU)
    from deepseek_tpu_torch.models.loader import _rowperm_qt
    rp = _rowperm_qt(w13, 2, undo=False)
    with pytest.raises(ValueError):                             # x width
        qmm_expert_ffn(rp, w2, idx, torch.ones((1, 512), device=dev), wts,
                       ActivationType.SILU)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_k11_matches_plain(x_dtype, w_dtype, dev):
    """K11 against its plain version with an empty group and one of more
    than a tile. Tolerance 1e-4 of the output scale: f32 sums of the same
    products (the table cast to the activations' dtype on both sides)."""
    E, n, k = 4, 136, 256
    g = torch.Generator().manual_seed(3)
    sizes = torch.tensor([5, 0, 150, 37], device=dev)
    lhs = torch.randn((200, k), generator=g).to(dev, x_dtype)
    rhs = (torch.randn((E, n, k), generator=g) * 0.1).to(dev, w_dtype)
    got = gmm(lhs, rhs, sizes)
    want = gmm_plain(lhs, rhs, sizes)
    _close(got[:192], want[:192], 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("E,n,k,sizes,M", [
    # a one-row group inside a tile, two empty groups, a group over three
    # 64-row tiles, rows past the last group (left unwritten)
    (6, 256, 1408, [1, 0, 70, 0, 150, 37], 320),
    # DeepSeek-V2-Lite's w2 widths (k = 1408), 128 rows in one group
    (3, 2048, 1408, [0, 128, 5], 133),
    # a table narrower than a 128-row block, a ragged last block
    (2, 200, 64, [64, 3], 67),
])
def test_k11_tensor_core_cases(x_dtype, w_dtype, E, n, k, sizes, M, dev):
    """K11 on the tensor cores (csrc/gmm.cu) against its plain version for
    every (rows, table) dtype pair: bf16 rows in one pass over the table
    rounded to bf16, f32 rows as bf16 hi + lo (and f16/f32 tables in two
    terms). Tolerance 1e-4 of the output scale, as chip_smoke.py holds it.
    Rows past the last group are left as they were; one launch each."""
    g = torch.Generator().manual_seed(E + n + k)
    lhs = torch.randn((M, k), generator=g).to(dev, x_dtype)
    rhs = (torch.randn((E, n, k), generator=g) * 0.1).to(dev, w_dtype)
    sz = torch.tensor(sizes, device=dev)
    before = gmm.launches
    got = gmm(lhs, rhs, sz)
    assert gmm.launches == before + 1
    live = sum(sizes)
    _close(got[:live], gmm_plain(lhs, rhs, sz)[:live], 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("H", [16, 128])
@pytest.mark.parametrize("kv_len", [1, 31, 33, 3997])
def test_k8_streaming_cases(kv_len, H, q8, dev):
    """K8's streaming kernel over the 4096-slot window at DeepSeek-V2-Lite's
    16 heads and V3's 128: one live slot, windows that end inside a tile
    (31, 33: tiles of 4 bf16 / 8 int8 slots; 3997: the last tile of a long
    window), normalized against the plain version, then the partials body
    over the two halves of the window (shard 1 empty for kv_len <= 2048:
    the empty triple) against its plain version. Tolerance 1e-4 of the
    scale. Launch counters: .launches / .int8 and .partials(.int8)."""
    g = torch.Generator().manual_seed(kv_len + H)
    S, Dh, Dv = 4096, 192, 128
    q = torch.randn((1, H, Dh), generator=g).to(dev)
    if q8:
        k, ks = _int8_rows((1, S, H, Dh), g, dev)
        v, vs = _int8_rows((1, S, H, Dv), g, dev)
        sc = (ks, vs)
    else:
        k = (torch.randn((1, S, H, Dh), generator=g) * 0.3).to(dev, torch.bfloat16)
        v = torch.randn((1, S, H, Dv), generator=g).to(dev, torch.bfloat16)
        sc = None
    kl = torch.tensor([kv_len], device=dev, dtype=torch.int32)
    scale = 1.0 / math.sqrt(Dh)
    sc_all = _shard_scales("mha", sc, slice(None))
    counter = mha_decode_attn.int8 if q8 else mha_decode_attn
    before = counter.launches
    _close(mha_decode_attn(q, k, v, kl, scale, **sc_all),
           mha_decode_attn_plain(q, k, v, kl, scale, **sc_all), 1e-4)
    assert counter.launches == before + 1
    pc = mha_decode_attn.partials.int8 if q8 else mha_decode_attn.partials
    before = pc.launches
    half = S // 2
    for s in range(2):
        sl = slice(s * half, (s + 1) * half)
        kl_s = (kl - s * half).clamp(0, half)
        k_s, v_s = k[:, sl].contiguous(), v[:, sl].contiguous()
        sc_s = _shard_scales("mha", sc, sl)
        got = mha_decode_attn(q, k_s, v_s, kl_s, scale, partials=True, **sc_s)
        _close_triples(got, mha_decode_attn_plain(q, k_s, v_s, kl_s, scale,
                                                  partials=True, **sc_s), 1e-4)
        if int(kl_s) == 0:
            assert bool((got[1] == -1e30).all()) and not got[0].any() and not got[2].any()
    assert pc.launches == before + 2


def _prefill_inputs(B, T, H, S, DK, DV, seed, dtype, dev):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, T, H, DK), generator=g) * 0.3
    k = (torch.randn((B, S, H, DK), generator=g) * 0.3).to(dtype)
    v = (torch.randn((B, S, H, DV), generator=g) * 0.3).to(dtype)
    return q.to(dev), k.to(dev), v.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("B,T,H,S,DK,DV,q_pos0,cache_pos0", [
    (2, 12, 3, 64, 48, 128, 7, 0),
    (1, 70, 2, 101, 192, 128, 30, 5),
    (1, 256, 128, 512, 192, 128, 256, 0),
])
def test_k9_matches_plain(dtype, B, T, H, S, DK, DV, q_pos0, cache_pos0, dev):
    """K9 against its plain version: ragged S and T, q_pos0 > 0, a
    cache_pos0 offset. Tolerance 1e-4: f32 sums in other orders, fast exp."""
    q, k, v = _prefill_inputs(B, T, H, S, DK, DV, T, dtype, dev)
    scale = 1.0 / math.sqrt(DK)
    _close(mha_prefill_attn(q, k, v, q_pos0, cache_pos0, scale),
           mha_prefill_attn_plain(q, k, v, q_pos0, cache_pos0, scale), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("B,T,H,S,R,P,q_pos0,cache_pos0", [
    (2, 10, 4, 40, 128, 16, 3, 0),
    (1, 33, 5, 77, 512, 64, 40, 2),
    (1, 256, 128, 512, 512, 64, 256, 0),
])
def test_k10_matches_plain(dtype, B, T, H, S, R, P, q_pos0, cache_pos0, dev):
    """K10 against its plain version; tolerance as K9."""
    g = torch.Generator().manual_seed(S)
    qc = (torch.randn((B, T, H, R), generator=g) * 0.3).to(dev)
    qr = (torch.randn((B, T, H, P), generator=g) * 0.3).to(dev)
    ckv = (torch.randn((B, S, R), generator=g) * 0.3).to(dev, dtype)
    kr = (torch.randn((B, S, P), generator=g) * 0.3).to(dev, dtype)
    scale = 1.0 / math.sqrt(192)
    _close(mla_prefill_attn(qc, qr, ckv, kr, q_pos0, cache_pos0, scale),
           mla_prefill_attn_plain(qc, qr, ckv, kr, q_pos0, cache_pos0, scale), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("d,n", [(300, 256), (2048, 10944), (4096, 2048)])
def test_k4_matches_plain(dtype, rows, d, n, dev):
    """K4 (qmm on a plain weight) against its plain version: a ragged
    row block (300 rows), the V2-Lite w2 width (10944 columns: several x
    chunks at 8 rows). Tolerance 1e-5 of the output scale: f32 sums of the
    same f32-widened products in other orders."""
    g = torch.Generator().manual_seed(d + rows)
    qt = PlainTensor(data=(torch.randn((d, n), generator=g) * 0.05).to(dev, dtype))
    x = torch.randn((rows, n), generator=g).to(dev)
    before = qmm_fp.launches
    _close(qmm(qt, x), qmm_fp_plain(qt, x), 1e-5)
    assert qmm_fp.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("B,H,S,Dh,Dv,kv_len", [
    (1, 16, 4096, 192, 128, [4000]),
    (1, 16, 4096, 192, 128, [68]),
    (1, 128, 4096, 192, 128, [4000]),
    (2, 3, 40, 24, 16, [37, 1]),
    (1, 20, 301, 64, 256, [301]),
])
def test_k8_matches_plain(dtype, B, H, S, Dh, Dv, kv_len, dev):
    """K8 against its plain version: the V2-Lite and V3 widths, a ragged
    head group (20 heads), B = 2 with ragged lengths. Tolerance 1e-4 of the
    output scale: f32 sums over up to 4096 slots in other orders, fast
    exp."""
    g = torch.Generator().manual_seed(S + H)
    q = torch.randn((B, H, Dh), generator=g).to(dev)
    k = (torch.randn((B, S, H, Dh), generator=g) * 0.3).to(dev, dtype)
    v = torch.randn((B, S, H, Dv), generator=g).to(dev, dtype)
    kl = torch.tensor(kv_len, device=dev)
    scale = 1.0 / math.sqrt(Dh)
    before = mha_decode_attn.launches
    _close(mha_decode_attn(q, k, v, kl, scale),
           mha_decode_attn_plain(q, k, v, kl, scale), 1e-4)
    assert mha_decode_attn.launches == before + 1


@pytest.mark.cuda
def test_k8_ignores_slots_past_kv_len(dev):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 16, 192), generator=g).to(dev)
    k = torch.randn((1, 64, 16, 192), generator=g).to(dev, torch.bfloat16)
    v = torch.randn((1, 64, 16, 128), generator=g).to(dev, torch.bfloat16)
    kl = torch.tensor([40], device=dev)
    want = mha_decode_attn(q, k, v, kl, 0.1)
    k[:, 40:] = float("nan")
    v[:, 40:] = float("nan")
    got = mha_decode_attn(q, k, v, kl, 0.1)
    assert torch.equal(got, want)


def _int8_rows(shape, g, dev):
    """Random int8 rows and their f32 scales (one a row), on ``dev``."""
    q = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    s = torch.rand(shape[:-1], generator=g) * 0.02 + 0.001
    return q.to(dev), s.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,R,P,kv_len", [
    (1, 128, 4096, 512, 64, [4000]),
    (2, 2, 40, 512, 64, [37, 1]),
    (1, 20, 301, 512, 64, [301]),
    (2, 80, 700, 512, 64, [613, 1]),
    (1, 128, 4096, 512, 64, [32]),
])
def test_k3_int8_matches_plain(B, H, S, R, P, kv_len, dev):
    """K3 over an int8 cache with (B,S) row scales against its plain
    version (kv_len 37 ends inside a 32-slot tile). Tolerance 1e-4 of the
    output scale: f32 sums in other orders, fast exp."""
    g = torch.Generator().manual_seed(S + H)
    qc, qr = torch.randn((B, H, R), generator=g).to(dev), \
        torch.randn((B, H, P), generator=g).to(dev)
    ckv, cs = _int8_rows((B, S, R), g, dev)
    kr, rs = _int8_rows((B, S, P), g, dev)
    kl = torch.tensor(kv_len, device=dev)
    scale = 1.0 / math.sqrt(192)
    before = (mla_decode_attn.launches, mla_decode_attn.int8.launches)
    _close(mla_decode_attn(qc, qr, ckv, kr, kl, scale, ckv_scale=cs, krope_scale=rs),
           mla_decode_attn_plain(qc, qr, ckv, kr, kl, scale, cs, rs), 1e-4)
    assert (mla_decode_attn.launches, mla_decode_attn.int8.launches) == \
        (before[0], before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,Dh,Dv,kv_len", [
    (1, 16, 4096, 192, 128, [4000]),
    (1, 16, 4096, 192, 128, [68]),
    (2, 3, 40, 32, 16, [37, 1]),
    (1, 20, 301, 64, 256, [301]),
])
def test_k8_int8_matches_plain(B, H, S, Dh, Dv, kv_len, dev):
    """K8 over an int8 cache, its (slot, head) scales passed as the
    head-major (B,H,S) view of the cache's (B,S,H) layout, against its
    plain version (kv_len 68 and 37 end inside a tile, 20 heads leave a
    ragged head group). Tolerance 1e-4 of the output scale."""
    g = torch.Generator().manual_seed(S + H + 1)
    q = torch.randn((B, H, Dh), generator=g).to(dev)
    k, ks = _int8_rows((B, S, H, Dh), g, dev)
    v, vs = _int8_rows((B, S, H, Dv), g, dev)
    ks, vs = ks.transpose(1, 2), vs.transpose(1, 2)
    kl = torch.tensor(kv_len, device=dev)
    scale = 1.0 / math.sqrt(Dh)
    before = (mha_decode_attn.launches, mha_decode_attn.int8.launches)
    _close(mha_decode_attn(q, k, v, kl, scale, k_scale=ks, v_scale=vs),
           mha_decode_attn_plain(q, k, v, kl, scale, ks, vs), 1e-4)
    assert (mha_decode_attn.launches, mha_decode_attn.int8.launches) == \
        (before[0], before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,S,DK,DV,q_pos0,cache_pos0", [
    (2, 12, 3, 64, 48, 128, 7, 0),
    (1, 70, 2, 101, 192, 128, 30, 5),
    (1, 256, 16, 4096, 192, 128, 3840, 0),
])
def test_k9_int8_matches_plain(B, T, H, S, DK, DV, q_pos0, cache_pos0, dev):
    """K9 over an int8 cache with head-major scales (views of the (B,S,H)
    layout) against its plain version: ragged S and T, q_pos0 > 0, a
    cache_pos0 offset, and V2-Lite's window end. Tolerance 1e-4 of the
    output scale."""
    g = torch.Generator().manual_seed(T + S)
    q = (torch.randn((B, T, H, DK), generator=g) * 0.3).to(dev)
    k, ks = _int8_rows((B, S, H, DK), g, dev)
    v, vs = _int8_rows((B, S, H, DV), g, dev)
    ks, vs = ks.transpose(1, 2), vs.transpose(1, 2)
    scale = 1.0 / math.sqrt(DK)
    before = (mha_prefill_attn.launches, mha_prefill_attn.int8.launches)
    _close(mha_prefill_attn(q, k, v, q_pos0, cache_pos0, scale, k_scale=ks, v_scale=vs),
           mha_prefill_attn_plain(q, k, v, q_pos0, cache_pos0, scale, ks, vs), 1e-4)
    assert (mha_prefill_attn.launches, mha_prefill_attn.int8.launches) == \
        (before[0], before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,S,R,P,q_pos0,cache_pos0", [
    (2, 10, 4, 40, 128, 16, 3, 0),
    (1, 33, 5, 77, 512, 64, 40, 2),
])
def test_k10_int8_matches_plain(B, T, H, S, R, P, q_pos0, cache_pos0, dev):
    """K10 over an int8 latent cache with (B,S) scales against its plain
    version; tolerance as K9."""
    g = torch.Generator().manual_seed(T + S + 1)
    qc = (torch.randn((B, T, H, R), generator=g) * 0.3).to(dev)
    qr = (torch.randn((B, T, H, P), generator=g) * 0.3).to(dev)
    ckv, cs = _int8_rows((B, S, R), g, dev)
    kr, rs = _int8_rows((B, S, P), g, dev)
    scale = 1.0 / math.sqrt(192)
    before = (mla_prefill_attn.launches, mla_prefill_attn.int8.launches)
    _close(mla_prefill_attn(qc, qr, ckv, kr, q_pos0, cache_pos0, scale,
                            ckv_scale=cs, krope_scale=rs),
           mla_prefill_attn_plain(qc, qr, ckv, kr, q_pos0, cache_pos0, scale, cs, rs),
           1e-4)
    assert (mla_prefill_attn.launches, mla_prefill_attn.int8.launches) == \
        (before[0], before[1] + 1)


@pytest.mark.cuda
def test_new_wrappers_reject_bad_operands(dev):
    """A CPU/CUDA mix, a non-contiguous plane and scales that do not fit the
    cache's dtype raise instead of launching; ``partials=True`` (ported
    with the seq mesh axis) returns the triple of the plain version."""
    qt = _nibble(2, 16, 256, "q3_k", seed=0, dev=dev)
    x = torch.ones((2, 128, 256), device=dev)
    te = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        qmm_grouped(qt, te.cpu(), x)
    with pytest.raises(ValueError):
        qmm_grouped(qt.map(lambda t: t.cpu()), te, x)
    with pytest.raises(ValueError):
        qmm_grouped(qt.map(lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)), te, x)
    with pytest.raises(ValueError):
        qmm_rows(qt.map(lambda t: t[0].cpu()), x[0])
    w = torch.ones((2, 16, 256), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        qmm_experts_fp(PlainTensor(data=w.cpu()), te[:1], x[0, :1])
    with pytest.raises(ValueError):
        qmm_experts_fp(PlainTensor(data=w.transpose(1, 2).contiguous().transpose(1, 2)),
                       te[:1], x[0, :1])
    rhs = torch.ones((2, 128, 256), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        gmm(x[0], rhs.cpu(), torch.tensor([64, 64], device=dev))
    with pytest.raises(ValueError):
        gmm(x[0], rhs.transpose(1, 2).contiguous().transpose(1, 2),
            torch.tensor([64, 64], device=dev))
    q, k, v = _prefill_inputs(1, 4, 2, 8, 64, 128, 0, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        mha_prefill_attn(q, k.cpu(), v, 0, 0, 0.1)
    with pytest.raises(ValueError):
        mha_prefill_attn(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, 0, 0, 0.1)
    # the int8 scales are ported: a float cache with scales, or an int8
    # cache without them, raises; an int8 cache with them gives the plain
    # version's result
    ks = torch.rand((1, 2, 8), device=dev) * 0.01
    with pytest.raises(ValueError):
        mha_prefill_attn(q, k, v, 0, 0, 0.1, k_scale=ks, v_scale=ks)
    k8 = torch.randint(-127, 128, (1, 8, 2, 64), device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (1, 8, 2, 128), device=dev, dtype=torch.int8)
    with pytest.raises(ValueError):
        mha_prefill_attn(q, k8, v8, 0, 0, 0.1)
    _close(mha_prefill_attn(q, k8, v8, 0, 0, 0.1, k_scale=ks, v_scale=ks),
           mha_prefill_attn_plain(q, k8, v8, 0, 0, 0.1, k_scale=ks, v_scale=ks), 1e-4)
    _close_triples(mha_prefill_attn(q, k, v, 0, 0, 0.1, partials=True),
                   mha_prefill_attn_plain(q, k, v, 0, 0, 0.1, partials=True), 1e-4)
    qc = torch.ones((1, 4, 2, 128), device=dev)
    qr = torch.ones((1, 4, 2, 64), device=dev)
    ckv = torch.ones((1, 8, 128), device=dev, dtype=torch.bfloat16)
    kr = torch.ones((1, 8, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        mla_prefill_attn(qc, qr, ckv.cpu(), kr, 0, 0, 0.1)
    with pytest.raises(ValueError):
        kr_t = torch.ones((1, 64, 8), device=dev, dtype=torch.bfloat16).transpose(1, 2)
        mla_prefill_attn(qc, qr, ckv, kr_t, 0, 0, 0.1)
    cs = torch.rand((1, 8), device=dev) * 0.01
    with pytest.raises(ValueError):
        mla_prefill_attn(qc, qr, ckv, kr, 0, 0, 0.1, ckv_scale=cs, krope_scale=cs)
    ckv8 = torch.randint(-127, 128, (1, 8, 128), device=dev, dtype=torch.int8)
    kr8 = torch.randint(-127, 128, (1, 8, 64), device=dev, dtype=torch.int8)
    _close(mla_prefill_attn(qc, qr, ckv8, kr8, 0, 0, 0.1, ckv_scale=cs, krope_scale=cs),
           mla_prefill_attn_plain(qc, qr, ckv8, kr8, 0, 0, 0.1, ckv_scale=cs,
                                  krope_scale=cs), 1e-4)
    _close_triples(mla_prefill_attn(qc, qr, ckv, kr, 0, 0, 0.1, partials=True),
                   mla_prefill_attn_plain(qc, qr, ckv, kr, 0, 0, 0.1, partials=True),
                   1e-4)
    wp = PlainTensor(data=torch.ones((128, 256), device=dev, dtype=torch.float16))
    with pytest.raises(ValueError):
        qmm_fp(wp, torch.ones((9, 256), device=dev))
    with pytest.raises(ValueError):
        qmm_fp(PlainTensor(data=wp.data.cpu()), torch.ones((1, 256), device=dev))
    with pytest.raises(ValueError):
        mha_decode_attn(q[:, 0], k.cpu(), v, torch.tensor([8], device=dev), 0.1)
    with pytest.raises(ValueError):
        mha_decode_attn(q[:, 0], k[..., :60], v[..., :60],
                        torch.tensor([8], device=dev), 0.1)


def _close_triples(got, want, rel):
    """(acc, m, l) against (acc, m, l): rows that see no slot (m -1e30 in
    want) are the empty triple exactly (acc 0, l 0, m -1e30); elsewhere m
    within ``rel`` of its scale, and acc and l within ``rel`` of their scale
    once both are rescaled to the common maximum."""
    (acc, m, l), (acc_w, m_w, l_w) = got, want
    assert acc.shape == acc_w.shape and m.shape == m_w.shape == l.shape == l_w.shape
    empty = m_w <= -1e29
    assert bool((m[empty] == -1e30).all()) and not l[empty].any()
    assert not acc[empty].any()
    live = ~empty
    if not bool(live.any()):
        return
    torch.testing.assert_close(m[live], m_w[live], rtol=0,
                               atol=rel * max(1.0, m_w[live].abs().max().item()))
    mx = torch.maximum(m, m_w)
    a, b = torch.exp(m - mx), torch.exp(m_w - mx)
    _close(l * a, l_w * b, rel)
    _close(acc * a[..., None], acc_w * b[..., None], rel)


def _merged(parts):
    """The exact flash merge of shard triples."""
    ms = torch.stack([p[1] for p in parts])
    mg = ms.amax(0)
    num = sum(a * torch.exp(m - mg)[..., None] for a, m, _ in parts)
    den = sum(l * torch.exp(m - mg) for _, m, l in parts)
    return num / den.clamp(min=1e-30)[..., None]


def _shard_scales(kind, sc, sl):
    """A shard's scale arguments: the (B,S) latent scales sliced, or the
    head-major view of the shard's own (B,S,H) slice."""
    if sc is None:
        return {}
    a, b = sc
    if kind == "mla":
        return dict(ckv_scale=a[:, sl], krope_scale=b[:, sl])
    return dict(k_scale=a[:, sl].transpose(1, 2), v_scale=b[:, sl].transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kind,H,S,kv_len", [
    ("mla", 128, 4096, [4000, 1500]), ("mla", 20, 302, [301, 3]),
    ("mha", 16, 4096, [4000, 1500]), ("mha", 3, 302, [301, 3])])
def test_decode_partials_match_plain(kind, H, S, kv_len, q8, dev):
    """K3's and K8's partials bodies over each half of the window (the
    second sequence's live prefix ends in shard 0, so shard 1 is empty for
    it: every split empty) against their plain versions, and the two
    shards merged against the normalized kernel over the whole window.
    Tolerance 1e-4 of the scale: f32 sums in other orders, fast exp. Each
    launch counts in ``.partials`` (``.partials.int8`` over int8 rows)."""
    g = torch.Generator().manual_seed(S + H)
    B, half = 2, S // 2
    if kind == "mla":
        R, P = 512, 64
        q = [torch.randn((B, H, R), generator=g).to(dev),
             torch.randn((B, H, P), generator=g).to(dev)]
        shapes = ((B, S, R), (B, S, P))
        fn, plain, scale = mla_decode_attn, mla_decode_attn_plain, 1.0 / math.sqrt(192)
    else:
        Dh, Dv = 192, 128
        q = [torch.randn((B, H, Dh), generator=g).to(dev)]
        shapes = ((B, S, H, Dh), (B, S, H, Dv))
        fn, plain, scale = mha_decode_attn, mha_decode_attn_plain, 1.0 / math.sqrt(Dh)
    if q8:
        (a, a_s), (b, b_s) = (_int8_rows(sh, g, dev) for sh in shapes)
        sc = (a_s, b_s)
    else:
        a, b = ((torch.randn(sh, generator=g) * 0.3).to(torch.bfloat16).to(dev)
                for sh in shapes)
        sc = None
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    counter = fn.partials.int8 if q8 else fn.partials
    before = (fn.launches, counter.launches)
    parts = []
    for s in range(2):
        sl = slice(s * half, (s + 1) * half)
        kl_s = (kl - s * half).clamp(0, half)
        # a rank's shard is a cache of its own: contiguous
        a_s_, b_s_ = a[:, sl].contiguous(), b[:, sl].contiguous()
        got = fn(*q, a_s_, b_s_, kl_s, scale, partials=True,
                 **_shard_scales(kind, sc, sl))
        want = plain(*q, a_s_, b_s_, kl_s, scale, partials=True,
                     **_shard_scales(kind, sc, sl))
        _close_triples(got, want, 1e-4)
        parts.append(got)
    assert bool((parts[1][1][1] == -1e30).all()) and not parts[1][0][1].any()
    assert (fn.launches, counter.launches) == (before[0], before[1] + 2)
    _close(_merged(parts), fn(*q, a, b, kl, scale, **_shard_scales(kind, sc, slice(None))),
           1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kind,T,H,S,q_pos0", [
    ("mla", 256, 128, 4096, 3840), ("mla", 256, 128, 4096, 0),
    ("mha", 256, 16, 4096, 1024), ("mha", 37, 3, 102, 9)])
def test_prefill_partials_match_plain(kind, T, H, S, q_pos0, q8, dev):
    """K9's and K10's partials bodies over each half of the window (shard 1
    at cache_pos0 S/2: for a chunk at the window's start no query sees it,
    the blocks walk no tile and write the empty triple) against their plain
    versions, then the halves merged against the normalized kernel over the
    whole window. Tolerance 1e-4 of the scale, as the normalized ones."""
    g = torch.Generator().manual_seed(T + S + q_pos0)
    B, half = 1, S // 2
    if kind == "mla":
        R, P = 512, 64
        q = [(torch.randn((B, T, H, R), generator=g) * 0.3).to(dev),
             (torch.randn((B, T, H, P), generator=g) * 0.3).to(dev)]
        shapes = ((B, S, R), (B, S, P))
        fn, plain, scale = mla_prefill_attn, mla_prefill_attn_plain, 1.0 / math.sqrt(192)
    else:
        Dh, Dv = 192, 128
        q = [(torch.randn((B, T, H, Dh), generator=g) * 0.3).to(dev)]
        shapes = ((B, S, H, Dh), (B, S, H, Dv))
        fn, plain, scale = mha_prefill_attn, mha_prefill_attn_plain, 1.0 / math.sqrt(Dh)
    if q8:
        (a, a_s), (b, b_s) = (_int8_rows(sh, g, dev) for sh in shapes)
        sc = (a_s, b_s)
    else:
        a, b = ((torch.randn(sh, generator=g) * 0.3).to(torch.bfloat16).to(dev)
                for sh in shapes)
        sc = None
    counter = fn.partials.int8 if q8 else fn.partials
    before = (fn.launches, counter.launches)
    parts = []
    for s in range(2):
        sl = slice(s * half, (s + 1) * half)
        args = (*q, a[:, sl].contiguous(), b[:, sl].contiguous(), q_pos0, s * half, scale)
        kw = _shard_scales(kind, sc, sl)
        got = fn(*args, partials=True, **kw)
        _close_triples(got, plain(*args, partials=True, **kw), 1e-4)
        parts.append(got)
    if q_pos0 + T <= half:
        assert bool((parts[1][1] == -1e30).all()) and not parts[1][0].any()
    assert (fn.launches, counter.launches) == (before[0], before[1] + 2)
    _close(_merged(parts), fn(*q, a, b, q_pos0, 0, scale,
                              **_shard_scales(kind, sc, slice(None))), 1e-4)


def _fp8(E, d, n, block, seed, dev):
    """A random blockwise F8E5M2 table (E, d, n) (E = 0: one 2-D weight)
    with its ceil-sized grid of scales in [0.005, 0.02]."""
    g = torch.Generator().manual_seed(seed)
    lead = (E,) if E else ()
    data = torch.randn((*lead, d, n), generator=g).to(torch.float8_e5m2)
    sc = torch.rand((*lead, -(-d // block[0]), -(-n // block[1])), generator=g) * 0.015 + 0.005
    return Fp8Tensor(data=data.view(torch.uint8).to(dev).view(torch.float8_e5m2),
                     scale=sc.to(dev), block_size=block)


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(576, 2048), (2048, 10944), (300, 448), (64, 256)],
                         ids=["wkv_a", "w2-dense", "ragged-both", "small"])
@pytest.mark.parametrize("rows", [1, 8, 11, 16, 40, 256])
def test_k5_fp8_matches_plain(d, n, rows, dev):
    """K5's fp8 body (the matvec up to ROW_TILE_MIN rows, 8 x rows a pass; the
    row-tiled route above) against its plain version on 128x128 grids with
    ragged row and column blocks. Tolerance 1e-4 of the output scale: the same products, the
    scale applied per 16-column partial sum (matvec) or per weight (tiles),
    summed in other orders."""
    qt = _fp8(0, d, n, (128, 128), seed=d + n, dev=dev)
    x = torch.randn((rows, n), generator=torch.Generator().manual_seed(rows)).to(dev)
    before = (qmm_fp8.launches, qmm_fp8_rows.launches)
    _close(qmm(qt, x), qmm_plain(qt, x), 1e-4)
    tiled = rows > ROW_TILE_MIN
    assert (qmm_fp8.launches, qmm_fp8_rows.launches) == (
        before[0] + (not tiled), before[1] + tiled)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 5, 13])
def test_k5_fp8_matvec_small_blocks(rows, dev):
    """K5's fp8 matvec with 32x16 blocks, so that every 16-weight vector of
    a row reads another scale, on a weight ragged in both directions.
    Tolerance as above."""
    qt = _fp8(0, 300, 448, (32, 16), seed=rows, dev=dev)
    x = torch.randn((rows, 448), generator=torch.Generator().manual_seed(rows)).to(dev)
    before = qmm_fp8.launches
    _close(qmm(qt, x), qmm_plain(qt, x), 1e-4)
    assert qmm_fp8.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("E,d,n,block", [(66, 2816, 2048, (128, 128)),
                                         (66, 2048, 1408, (128, 128)),
                                         (16, 128, 512, (128, 128)),
                                         (4, 100, 320, (32, 64)),
                                         (4, 300, 448, (128, 128)),
                                         (4, 100, 336, (32, 48))],
                         ids=["w13s", "w2s", "wv_b", "small-blocks", "ragged-128",
                              "blocks-of-3-vectors"])
def test_k2_fp8_matches_plain(E, d, n, block, dev):
    """K2's fp8 body: 8 pairs (a repeated expert) against the plain version
    (the selected experts dequantized). Tolerance as K5."""
    qt = _fp8(E, d, n, block, seed=E + d, dev=dev)
    idx = torch.tensor([0, 5 % E, 5 % E, E - 1, 1, 2, 3, E - 2], device=dev)
    x = torch.randn((8, n), generator=torch.Generator().manual_seed(3)).to(dev)
    before = qmm_experts_fp8.launches
    _close(qmm_experts(qt, idx, x), qmm_experts_plain(qt, idx, x), 1e-4)
    assert qmm_experts_fp8.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,block", [(2816, 2048, (128, 128)), (2048, 1408, (128, 128)),
                                       (200, 576, (128, 128)), (200, 576, (32, 64))])
def test_k6_fp8_matches_plain(d, n, block, dev):
    """K6's fp8 body over 5 tiles of 3 experts, with and without live-row
    counts (the rows past a tile's count are not compared)."""
    qt = _fp8(3, d, n, block, seed=d, dev=dev)
    x = torch.randn((5, 128, n), generator=torch.Generator().manual_seed(4)).to(dev)
    te = torch.tensor([0, 0, 2, 1, 2], device=dev, dtype=torch.int32)
    before = qmm_grouped_fp8.launches
    _close(qmm_grouped(qt, te, x), qmm_grouped_plain(qt, te, x), 1e-4)
    rows = torch.tensor([128, 7, 0, 64, 1], device=dev, dtype=torch.int32)
    live = torch.arange(128, device=dev)[None, :] < rows[:, None]
    _close(qmm_grouped(qt, te, x, rows)[live],
           qmm_grouped_plain(qt, te, x, rows)[live], 1e-4)
    assert qmm_grouped_fp8.launches == before + 2


@pytest.mark.cuda
def test_fp8_wrappers_reject_what_they_cannot_take(dev):
    """A per-tensor scale, a block the kernels do not take, a wrong grid, a
    non-contiguous or CPU weight raise instead of launching."""
    qt = _fp8(0, 256, 256, (128, 128), seed=0, dev=dev)
    x = torch.ones((1, 256), device=dev)
    per_tensor = Fp8Tensor(data=qt.data, scale=torch.ones((), device=dev))
    for fn in (qmm_fp8, qmm_fp8_rows):
        with pytest.raises(ValueError, match="per-tensor"):
            fn(per_tensor, x)
    with pytest.raises(ValueError):
        qmm_fp8(_fp8(0, 256, 256, (128, 8), seed=1, dev=dev), x)
    with pytest.raises(ValueError):
        qmm_fp8_rows(_fp8(0, 256, 256, (128, 32), seed=1, dev=dev), x)
    with pytest.raises(ValueError):
        qmm_fp8(Fp8Tensor(data=qt.data, scale=qt.scale[:1], block_size=(128, 128)), x)
    with pytest.raises(ValueError):
        qmm_fp8(qt.map(lambda t: t.t().contiguous().t()), x)
    with pytest.raises(ValueError):
        qmm_fp8(qt.map(lambda t: t.cpu()), x)
    tab = _fp8(2, 128, 256, (128, 128), seed=2, dev=dev)
    pt_tab = Fp8Tensor(data=tab.data, scale=torch.ones((2, 1, 1), device=dev))
    te = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="per-tensor"):
        qmm_experts_fp8(pt_tab, te, x)
    with pytest.raises(ValueError, match="per-tensor"):
        qmm_grouped_fp8(pt_tab, te, torch.ones((1, 128, 256), device=dev))


@pytest.mark.cuda
def test_per_head_up_fp8(dev):
    """Absorbed-MLA decode's per-head wv_b product: a blockwise fp8 wv_b
    whose row blocks split by head launches K2's fp8 body and matches the
    dequantized product; one whose row blocks straddle two heads (Dv = 128
    under 256-row blocks) raises on the card instead of dequantizing."""
    from deepseek_tpu_torch.models.deepseek import per_head_up
    H, Dv, R = 16, 128, 512
    lat = torch.randn((2, H, R), generator=torch.Generator().manual_seed(5)).to(dev)
    wv_b = _fp8(0, H * Dv, R, (128, 128), seed=6, dev=dev)
    before = qmm_experts_fp8.launches
    want = torch.einsum("bhr,hvr->bhv", lat,
                        wv_b.dequant(torch.float32).reshape(H, Dv, R))
    _close(per_head_up(wv_b, lat), want, 1e-4)
    assert qmm_experts_fp8.launches == before + 1
    with pytest.raises(ValueError, match="straddles"):
        per_head_up(_fp8(0, H * Dv, R, (256, 128), seed=7, dev=dev), lat)


def _packed(E, d, n, quant, seed, dev):
    """A random packed Q2_K/Q3_K table (E, d, n) (E = 0: one 2-D weight):
    random plane bytes, Q3_K scales in [-32, 32), super scales and mins in
    [0.001, 0.01] (the JAX _direct_qtensor's ranges)."""
    g = torch.Generator().manual_seed(seed)
    lead = (E,) if E else ()

    def u8(cols):
        return torch.randint(0, 256, (*lead, d, cols), generator=g, dtype=torch.uint8)

    def sup():
        return torch.rand((*lead, d, n // 256), generator=g) * 0.009 + 0.001
    if quant == "q2_k":
        qt = Q2KTensor(qs=u8(n // 4), sm=u8(n // 16), d=sup(), dmin=sup())
    else:
        qt = Q3KTensor(qs=u8(n // 4), hm=u8(n // 8), d=sup(),
                       sc=torch.randint(-32, 32, (*lead, d, n // 16), generator=g,
                                        dtype=torch.int8))
    return qt.map(lambda t: t.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("d,n", [(100, 256), (300, 1536), (4096, 7168), (64, 18432)],
                         ids=["small", "ragged-rows", "w13-like", "w2-dense-width"])
@pytest.mark.parametrize("rows", [1, 3, 16, 17, 130])
def test_k5_packed_matches_plain(quant, d, n, rows, dev):
    """K5's packed bodies (the matvec up to ROW_TILE_MIN rows, the row-tiled route
    above, with a ragged row tile at 17 and 130 rows and ragged column
    blocks) against the plain version. Tolerance 1e-4 of the output scale:
    f32 sums in other orders, and the matvec's x in two int8 terms a group
    (2-4e-5 of max|ref| in the CPU emulation, tests/test_torch_packed_mv.py)."""
    qt = _packed(0, d, n, quant, seed=d + n, dev=dev)
    x = torch.randn((rows, n), generator=torch.Generator().manual_seed(rows)).to(dev)
    before = (qmm_packed.launches, qmm_packed_rows.launches)
    _close(qmm(qt, x), qmm_plain(qt, x), 1e-4)
    tiled = rows > ROW_TILE_MIN
    assert (qmm_packed.launches, qmm_packed_rows.launches) == (
        before[0] + (not tiled), before[1] + tiled)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("E,d,n", [(16, 4096, 7168), (16, 7168, 2048), (128, 128, 512),
                                   (4, 100, 256)],
                         ids=["w13", "w2", "wv_b", "small"])
def test_k2_packed_matches_plain(quant, E, d, n, dev):
    """K2's packed bodies: 9 pairs with a repeated expert against the plain
    version (the selected experts dequantized). Tolerance as K5."""
    qt = _packed(E, d, n, quant, seed=E + d, dev=dev)
    idx = torch.tensor([0, 5 % E, 5 % E, E - 1, 1, 2, 3, E - 2, 3], device=dev)
    x = torch.randn((9, n), generator=torch.Generator().manual_seed(3)).to(dev)
    before = qmm_experts_packed.launches
    _close(qmm_experts(qt, idx, x), qmm_experts_plain(qt, idx, x), 1e-4)
    assert qmm_experts_packed.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("d,n", [(200, 512), (4096, 7168), (200, 2048)])
def test_k6_packed_matches_plain(quant, d, n, dev):
    """K6's packed bodies over 5 tiles of 3 experts, with and without
    live-row counts (dead rows: the rows past a tile's count are not
    compared); n = 7168 ends on a 256-column tail stage."""
    qt = _packed(3, d, n, quant, seed=d, dev=dev)
    x = torch.randn((5, 128, n), generator=torch.Generator().manual_seed(4)).to(dev)
    te = torch.tensor([0, 0, 2, 1, 2], device=dev, dtype=torch.int32)
    before = qmm_grouped_packed.launches
    _close(qmm_grouped(qt, te, x), qmm_grouped_plain(qt, te, x), 1e-4)
    rows = torch.tensor([128, 7, 0, 64, 1], device=dev, dtype=torch.int32)
    live = torch.arange(128, device=dev)[None, :] < rows[:, None]
    _close(qmm_grouped(qt, te, x, rows)[live],
           qmm_grouped_plain(qt, te, x, rows)[live], 1e-4)
    assert qmm_grouped_packed.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_per_head_up_packed(quant, dev):
    """Absorbed-MLA decode's per-head wv_b product on a packed wv_b (128
    heads of 128 x 512) launches K2's packed body and matches the
    dequantized product."""
    from deepseek_tpu_torch.models.deepseek import per_head_up
    H, Dv, R = 128, 128, 512
    lat = torch.randn((1, H, R), generator=torch.Generator().manual_seed(5)).to(dev)
    wv_b = _packed(0, H * Dv, R, quant, seed=6, dev=dev)
    want = torch.einsum("bhr,hvr->bhv", lat,
                        wv_b.dequant(torch.float32).reshape(H, Dv, R))
    before = qmm_experts_packed.launches
    _close(per_head_up(wv_b, lat), want, 1e-4)
    assert qmm_experts_packed.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_packed_wrappers_reject_what_they_cannot_take(quant, dev):
    """In-features that are no multiple of 256 (no converter writes them),
    a CPU plane, a non-contiguous or misaligned plane and a wrong plane
    shape raise instead of launching or falling back."""
    x = torch.ones((1, 256), device=dev)
    bad_n = _packed(0, 16, 128, quant, seed=0, dev=dev)
    for fn in (qmm_packed, qmm_packed_rows, qmm):
        with pytest.raises(ValueError, match="256"):
            fn(bad_n, torch.ones((1, 128), device=dev))
    with pytest.raises(ValueError, match="256"):
        qmm_experts(bad_n.map(lambda t: t[None]), torch.zeros(1, device=dev,
                                                             dtype=torch.int32),
                    torch.ones((1, 128), device=dev))
    qt = _packed(0, 16, 256, quant, seed=1, dev=dev)
    with pytest.raises(ValueError):
        qmm_packed(qt.map(lambda t: t.cpu()), x)
    with pytest.raises(ValueError):
        qmm_packed(qt.map(lambda t: t.t().contiguous().t()), x)
    with pytest.raises(ValueError):
        qmm_packed(dataclasses.replace(qt, qs=torch.zeros(16 * 64 + 1, dtype=torch.uint8,
                                                          device=dev)[1:].view(16, 64)), x)
    with pytest.raises(ValueError):
        qmm_packed(dataclasses.replace(qt, d=qt.d[:8]), x)
    tab = _packed(2, 16, 256, quant, seed=2, dev=dev)
    te = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        qmm_grouped_packed(tab.map(lambda t: t.cpu()), te,
                           torch.ones((1, 128, 256), device=dev))
    with pytest.raises(ValueError):
        qmm_experts_packed(tab, te, torch.ones((2, 256), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("d,n", [(301, 7168), (1001, 1536), (203, 16384), (77, 18432),
                                 (99, 512)],
                         ids=["wkvq-like", "wcr-like", "wo-like", "w2-like", "wv_b-like"])
@pytest.mark.parametrize("rows", [1, 2, 3, 4])
def test_k5_packed_mv_cases(quant, d, n, rows, dev):
    """K5's packed matvec (csrc/packed_mv.cu) at every row count it takes,
    over V3's in-features (32, 8 and 2 lanes a row; n = 18432 leaves a
    partial last step of superblocks) with row counts no item size divides,
    against the plain version. Tolerance 1e-4 of the output scale: x in two
    int8 terms (~2-4e-5 of max|ref| on the CPU emulation) and f32 folds."""
    qt = _packed(0, d, n, quant, seed=d + n + rows, dev=dev)
    x = torch.randn((rows, n), generator=torch.Generator().manual_seed(rows + n)).to(dev)
    before = qmm_packed.launches
    _close(qmm_packed(qt, x), qmm_plain(qt, x), 1e-4)
    assert qmm_packed.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("ids", [torch.int64, torch.int32])
@pytest.mark.parametrize("E,d,n,pairs", [(16, 4096, 7168, 8), (16, 7168, 2048, 8),
                                         (128, 128, 512, 128), (5, 301, 1536, 8)],
                         ids=["w13s", "w2s", "wv_b", "ragged"])
def test_k2_packed_mv_cases(quant, ids, E, d, n, pairs, dev):
    """K2's packed matvec over 8 pairs with repeated experts (wv_b: one
    pair a head), the ids read as given in int64 or int32, against the
    plain version. Tolerance as K5's."""
    qt = _packed(E, d, n, quant, seed=E + d + pairs, dev=dev)
    idx = (torch.arange(pairs) if pairs == E else
           torch.tensor([3 % E, 0, 3 % E, E - 1, 1, 3 % E, 0, 2]))[:pairs].to(dev, ids)
    x = torch.randn((pairs, n), generator=torch.Generator().manual_seed(pairs + n)).to(dev)
    before = qmm_experts_packed.launches
    _close(qmm_experts_packed(qt, idx, x), qmm_experts_plain(qt, idx, x), 1e-4)
    assert qmm_experts_packed.launches == before + 1


def _turbo(E, d, n, quant, seed, dev):
    """A random turbo table (E, d, n) (E = 0: one 2-D weight): the packed
    draw of ``_packed`` converted on the card."""
    qt = _packed(E, d, n, quant, seed, dev)
    return q2k_to_turbo(qt) if quant == "q2_k" else q3k_to_turbo(qt)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("d,n", [(100, 256), (300, 1536), (4096, 7168), (64, 18432),
                                 (200, 512)],
                         ids=["small", "ragged-rows", "w13-like", "w2-dense-width",
                              "kv-lora"])
@pytest.mark.parametrize("rows", [1, 3, 16, 17, 130])
def test_k5_turbo_matches_plain(quant, d, n, rows, dev):
    """K5's turbo bodies (the matvec up to ROW_TILE_MIN rows, the row-tiled route
    above) against the plain version (the turbo dequantization, bf16
    scales, and one f32 product). Tolerance 1e-4 of the output scale: f32
    sums in other orders, and the matvec's exact 0.5 + u/256 floats whose
    offset cancels against f32 group sums."""
    qt = _turbo(0, d, n, quant, seed=d + n, dev=dev)
    x = torch.randn((rows, n), generator=torch.Generator().manual_seed(rows)).to(dev)
    before = (qmm_turbo.launches, qmm_turbo_rows.launches)
    _close(qmm(qt, x), qmm_plain(qt, x), 1e-4)
    tiled = rows > ROW_TILE_MIN
    assert (qmm_turbo.launches, qmm_turbo_rows.launches) == (
        before[0] + (not tiled), before[1] + tiled)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("E,d,n", [(16, 4096, 7168), (16, 7168, 2048), (128, 128, 512),
                                   (4, 100, 256)],
                         ids=["w13", "w2", "wv_b", "small"])
def test_k2_turbo_matches_plain(quant, E, d, n, dev):
    """K2's turbo bodies: 9 pairs with a repeated expert against the plain
    version (the selected experts dequantized). Tolerance as K5."""
    qt = _turbo(E, d, n, quant, seed=E + d, dev=dev)
    idx = torch.tensor([0, 5 % E, 5 % E, E - 1, 1, 2, 3, E - 2, 3], device=dev)
    x = torch.randn((9, n), generator=torch.Generator().manual_seed(3)).to(dev)
    before = qmm_experts_turbo.launches
    _close(qmm_experts(qt, idx, x), qmm_experts_plain(qt, idx, x), 1e-4)
    assert qmm_experts_turbo.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("d,n", [(200, 512), (4096, 7168), (200, 2048)])
def test_k6_turbo_matches_plain(quant, d, n, dev):
    """K6's turbo bodies over 5 tiles of 3 experts, with and without
    live-row counts (the rows past a tile's count are not compared)."""
    qt = _turbo(3, d, n, quant, seed=d, dev=dev)
    x = torch.randn((5, 128, n), generator=torch.Generator().manual_seed(4)).to(dev)
    te = torch.tensor([0, 0, 2, 1, 2], device=dev, dtype=torch.int32)
    before = qmm_grouped_turbo.launches
    _close(qmm_grouped(qt, te, x), qmm_grouped_plain(qt, te, x), 1e-4)
    rows = torch.tensor([128, 7, 0, 64, 1], device=dev, dtype=torch.int32)
    live = torch.arange(128, device=dev)[None, :] < rows[:, None]
    _close(qmm_grouped(qt, te, x, rows)[live],
           qmm_grouped_plain(qt, te, x, rows)[live], 1e-4)
    assert qmm_grouped_turbo.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_per_head_up_turbo(quant, dev):
    """The per-head wv_b product on a turbo wv_b (128 heads of 128 x 512)
    launches K2's turbo body and matches the dequantized product."""
    from deepseek_tpu_torch.models.deepseek import per_head_up
    H, Dv, R = 128, 128, 512
    lat = torch.randn((1, H, R), generator=torch.Generator().manual_seed(5)).to(dev)
    wv_b = _turbo(0, H * Dv, R, quant, seed=6, dev=dev)
    want = torch.einsum("bhr,hvr->bhv", lat,
                        wv_b.dequant(torch.float32).reshape(H, Dv, R))
    before = qmm_experts_turbo.launches
    _close(per_head_up(wv_b, lat), want, 1e-4)
    assert qmm_experts_turbo.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_turbo_wrappers_reject_what_they_cannot_take(quant, dev):
    """In-features that are no multiple of 256, a CPU plane, a
    non-contiguous plane and a wrong plane shape raise instead of launching
    or falling back."""
    bad_n = _turbo(0, 16, 256, quant, seed=0, dev=dev).map(lambda t: t[:, :t.shape[1] // 2])
    for fn in (qmm_turbo, qmm_turbo_rows):
        with pytest.raises(ValueError, match="256"):
            fn(bad_n.map(lambda t: t.contiguous()), torch.ones((1, 128), device=dev))
    qt = _turbo(0, 16, 256, quant, seed=1, dev=dev)
    x = torch.ones((1, 256), device=dev)
    with pytest.raises(ValueError):
        qmm_turbo(qt.map(lambda t: t.cpu()), x)
    with pytest.raises(ValueError):
        qmm_turbo(qt.map(lambda t: t.t().contiguous().t()), x)
    with pytest.raises(ValueError):
        qmm_turbo(dataclasses.replace(qt, p=qt.p[:8]), x)
    tab = _turbo(2, 16, 256, quant, seed=2, dev=dev)
    te = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        qmm_grouped_turbo(tab.map(lambda t: t.cpu()), te,
                          torch.ones((1, 128, 256), device=dev))
    with pytest.raises(ValueError):
        qmm_experts_turbo(tab, te, torch.ones((2, 256), device=dev))


def _same_nucleus(got, want, tol):
    """Two nucleus distributions (B, V) of the same logits, agreeing within
    ``tol`` per row; or, in a row whose keep sets differ, differing only at
    the cut: the tokens kept on one side only are no more probable than
    (1 + 1e-4) x that side's least common token (a mass sum over 129280
    probabilities, taken in another order, may land on the other side of
    top_p there), and renormalized over the common keep set the two rows
    agree within ``tol``."""
    for g, w in zip(got, want):
        kg, kw = g > 0, w > 0
        if torch.equal(kg, kw):
            torch.testing.assert_close(g, w, rtol=0, atol=tol)
            continue
        both = kg & kw
        for side, keep in ((g, kg), (w, kw)):
            only = keep & ~both
            if only.any():
                assert side[only].max() <= side[both].min() * (1 + 1e-4)
        gc, wc = torch.where(both, g, 0.0), torch.where(both, w, 0.0)
        torch.testing.assert_close(gc / gc.sum(), wc / wc.sum(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["greedy", "nucleus", "top_k_min_p", "per_row"])
def test_sample_token_cuda_matches_cpu(case, dev):
    """sample_token on the card picks the CPU tokens from the same logits
    and key (the same threefry integers; the gumbel floats may differ by an
    ulp of log, a near-tie only), and nucleus_dist agrees within 1e-6 up to
    a token at the cut (``_same_nucleus``), at DeepSeek-V3's vocabulary."""
    from deepseek_tpu_torch.ops import prng
    from deepseek_tpu_torch.ops.sampling import nucleus_dist, sample_token
    params = {"greedy": dict(temperature=0.0, top_p=0.95),
              "nucleus": dict(temperature=0.8, top_p=0.95),
              "top_k_min_p": dict(temperature=1.0, top_p=0.9, top_k=40, min_p=0.02),
              "per_row": dict(temperature=torch.tensor([0.0, 0.7, 1.3]),
                              top_p=torch.tensor([0.9, 0.95, 1.0]))}[case]
    on_dev = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in params.items()}
    g = torch.Generator().manual_seed(9)
    for trial in range(4):
        lg = torch.randn((3, 129280), generator=g) * 4
        key = prng.split(prng.PRNGKey(trial))[1]
        want = sample_token(lg, key, **params)
        got = sample_token(lg.to(dev), key, **on_dev)
        assert torch.equal(got.cpu(), want)
        _same_nucleus(nucleus_dist(lg.to(dev), **on_dev).cpu(),
                      nucleus_dist(lg, **params), 1e-6)
    key = prng.PRNGKey(5)
    assert torch.equal(prng.random_bits(key, (4, 1000), dev).cpu(),
                       prng.random_bits(key, (4, 1000)))


def _decode_block_under_sync_debug(dev, kv_cache_dtype, quant="q3_k",
                                   rowperm=False, block=8):
    from deepseek_tpu_torch.models.deepseek import forward_decode, make_decode_loop
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.models.testing import (
        deepseek_v3_proportions, random_fused_params)
    from deepseek_tpu_torch.ops import prng
    cfg = deepseek_v3_proportions(
        n_layers=2, dim=512, hidden_dim=1024, n_heads=4, vocab_size=1024,
        first_k_dense_replace=1, n_routed_experts=8, n_active_routed=2,
        moe_intermediate_size=256, n_group=2, topk_group=1, q_lora_rank=512)
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_cache_dtype)
    params = random_fused_params(cfg, quant, seed=1, device=dev, rowperm=rowperm)
    cache = init_cache(cfg, device=dev)
    tok = torch.tensor([[5]], device=dev)
    with torch.inference_mode():
        forward_decode(params, cache, tok, 0, cfg)           # builds the kernels
    loop = make_decode_loop(cfg, block)
    torch.cuda.synchronize()
    for temperature in (0.0, 0.8):
        torch.cuda.set_sync_debug_mode("error")
        try:
            toks, logits, _ = loop(params, cache, tok, 1, prng.PRNGKey(2), temperature,
                                   0.95, top_k=20, min_p=0.01)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert toks.shape == (1, block) and bool(torch.isfinite(logits).all())


@pytest.mark.cuda
def test_decode_block_does_not_synchronize(dev):
    """A decode block of a small random packed Q3_K model runs under
    torch.cuda.set_sync_debug_mode("error"), which raises on any operation
    that synchronizes the host with the card, greedy and sampled; reading
    its tokens afterwards is the one synchronization."""
    _decode_block_under_sync_debug(dev, "bfloat16")


@pytest.mark.cuda
def test_int8_decode_block_does_not_synchronize(dev):
    """The same over an int8 KV cache: quantizing each written row, its
    scale and the sink masters' updates add no synchronization."""
    _decode_block_under_sync_debug(dev, "int8")


@pytest.mark.cuda
def test_permuted_decode_block_does_not_synchronize(dev):
    """A 32-token decode block of a small nibble model whose expert tables
    are row-permuted (every MoE step one K7 launch, no occupancy query or
    host read inside the block) under set_sync_debug_mode("error")."""
    before = qmm_expert_ffn.launches
    _decode_block_under_sync_debug(dev, "bfloat16", "q3_k_nibble", rowperm=True,
                                   block=32)
    assert qmm_expert_ffn.launches - before >= 2 * 32


def _prefill_case(kind, dtype, B, T, H, S, d, q_scale, g, dev):
    """Queries, cache planes of ``dtype`` ("int8": rows with their scales,
    K9's head-major) and the call's scale for K9 (d = Dh, Dv 128) or K10
    (d = P, R 512)."""
    if kind == "mha":
        qs = [torch.randn((B, T, H, d), generator=g) * q_scale]
        shapes, scale = ((B, S, H, d), (B, S, H, 128)), 1.0 / math.sqrt(d)
    else:
        qs = [torch.randn((B, T, H, 512), generator=g) * q_scale,
              torch.randn((B, T, H, d), generator=g) * q_scale]
        shapes, scale = ((B, S, 512), (B, S, d)), 1.0 / math.sqrt(192)
    if dtype == "int8":
        (a, a_s), (b, b_s) = (_int8_rows(sh, g, dev) for sh in shapes)
        if kind == "mha":
            a_s, b_s = a_s.transpose(1, 2), b_s.transpose(1, 2)
        kw = (dict(k_scale=a_s, v_scale=b_s) if kind == "mha"
              else dict(ckv_scale=a_s, krope_scale=b_s))
    else:
        dt = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}[dtype]
        a, b = ((torch.randn(sh, generator=g) * 0.3).to(dt).to(dev) for sh in shapes)
        kw = {}
    return [q.to(dev) for q in qs], a, b, scale, kw


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype,T,H,S,d,q_pos0,cache_pos0,q_scale,partials", [
    # V2-Lite's K9 at the window's end: 64 row blocks, the split window
    ("mha", "bf16", 256, 16, 4096, 192, 3840, 0, 0.3, False),
    ("mha", "int8", 256, 16, 4096, 192, 3840, 0, 0.3, False),
    ("mha", "f16", 256, 16, 4096, 192, 3840, 0, 0.3, False),
    ("mha", "f32", 256, 16, 4096, 192, 3840, 0, 0.3, False),
    # scores reaching about +-30
    ("mha", "bf16", 64, 4, 300, 192, 200, 0, 25.0, False),
    ("mha", "f32", 64, 4, 300, 192, 200, 0, 25.0, False),
    ("mla", "bf16", 40, 16, 300, 64, 200, 0, 16.0, False),
    ("mla", "f16", 40, 16, 300, 64, 200, 0, 16.0, False),
    # a key width that is not a multiple of 16 (Dh 52; P 20: R + P 532)
    ("mha", "bf16", 40, 3, 77, 52, 50, 0, 0.3, False),
    ("mha", "f16", 40, 3, 77, 52, 50, 0, 0.3, False),
    ("mha", "int8", 40, 3, 77, 52, 50, 0, 0.3, True),
    ("mla", "bf16", 30, 3, 90, 20, 60, 0, 0.3, False),
    ("mla", "f32", 30, 3, 90, 20, 60, 0, 0.3, False),
    ("mla", "int8", 30, 3, 90, 20, 60, 0, 0.3, True),
    # K10 with T * H not a multiple of the block's 64 rows
    ("mla", "bf16", 7, 5, 70, 64, 40, 0, 0.3, False),
    ("mla", "int8", 100, 5, 333, 64, 250, 3, 0.3, False),
    # the partials bodies through the split window, and an empty shard
    ("mha", "bf16", 256, 16, 2048, 192, 3840, 2048, 0.3, True),
    ("mha", "int8", 256, 16, 2048, 192, 3840, 2048, 0.3, True),
    ("mha", "bf16", 256, 16, 2048, 192, 0, 2048, 0.3, True),
    ("mla", "int8", 100, 5, 2048, 64, 0, 2048, 0.3, True),
])
def test_prefill_tensor_core_cases(kind, dtype, T, H, S, d, q_pos0, cache_pos0,
                                   q_scale, partials, dev):
    """K9 and K10 on the tensor cores (split bf16 operands) against their
    plain versions at the cases the design has to get right, each counted
    once by its body's launch counter (f16 and f32 caches: also by the
    two-term bodies' own). Tolerance 1e-4 of the output scale
    (of each of acc, m, l for partials), as every K9/K10 check."""
    g = torch.Generator().manual_seed(T * H + S + d)
    qs, a, b, scale, kw = _prefill_case(kind, dtype, 1, T, H, S, d, q_scale, g, dev)
    fn, plain = ((mha_prefill_attn, mha_prefill_attn_plain) if kind == "mha"
                 else (mla_prefill_attn, mla_prefill_attn_plain))
    if q_scale > 1:       # the scores reach about +-30
        kf = torch.cat([a, b], -1) if kind == "mla" else a
        q = torch.cat(qs, -1)
        eq = "bthd,bsd->bhts" if kind == "mla" else "bthd,bshd->bhts"
        assert float(torch.einsum(eq, q, kf.float()).abs().max()) * scale > 20.0
    counter = fn.partials if partials else fn
    counter = counter.int8 if dtype == "int8" else counter
    two_term = getattr(fn, dtype) if dtype in ("f16", "f32") and not partials else None
    before = counter.launches, two_term.launches if two_term else 0
    args = (*qs, a, b, q_pos0, cache_pos0, scale)
    got = fn(*args, partials=partials, **kw)
    want = plain(*args, partials=partials, **kw)
    assert counter.launches == before[0] + 1
    if two_term:
        assert two_term.launches == before[1] + 1
    if partials:
        _close_triples(got, want, 1e-4)
        if q_pos0 + T <= cache_pos0:
            assert bool((got[1] == -1e30).all()) and not got[0].any()
    else:
        _close(got, want, 1e-4)


def _tile_table(kind, E, d, n, seed, dev):
    """A random table (E, d, n) of one tile GEMM kind (E = 0: one 2-D
    weight): nibble with (q2_k) or without (q3_k) its min plane, packed,
    turbo or F8E5M2 on 128x128 blocks."""
    quant = "q2_k" if "q2" in kind else "q3_k"
    if kind.startswith("nibble"):
        qt = _nibble(max(E, 1), d, n, quant, seed, dev)
        return qt if E else qt.map(lambda t: t[0].contiguous())
    if kind.startswith("packed"):
        return _packed(E, d, n, quant, seed, dev)
    if kind.startswith("turbo"):
        return _turbo(E, d, n, quant, seed, dev)
    return _fp8(E, d, n, (128, 128), seed, dev)


_TILE_KINDS = ["nibble-q2", "nibble-q3", "fp8", "packed-q2", "packed-q3", "turbo-q2",
               "turbo-q3"]
_GROUPED_COUNTER = {"nibble": qmm_grouped, "fp8": qmm_grouped_fp8,
                    "packed": qmm_grouped_packed, "turbo": qmm_grouped_turbo}
_ROWS_ROUTE = {"nibble": qmm_rows, "fp8": qmm_fp8_rows, "packed": qmm_packed_rows,
                 "turbo": qmm_turbo_rows}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", _TILE_KINDS + ["nibble-q2-xperm", "nibble-q3-xperm"])
def test_tile_gemm_tensor_core_cases(kind, dev):
    """The tile GEMM on the tensor cores (split bf16 operands, the MMA
    width from the live rows) against the plain versions, for every kind
    (nibble with and without c, and with x prepermuted: kinds 0, 1, 10,
    11; fp8 5; packed 6, 7; turbo 8, 9): K6 over tiles of 128, 7, 0, 64,
    1, 30, 100 and 17 live rows (widths 128, 16, empty, 64, 16, 32, 128,
    32) on 300 weight rows (a ragged column block) and three 256-column
    slots (fp8: 576 columns, a ragged scale block), each tile's live rows
    compared. Tolerance 1e-4 of the output scale, as every tile GEMM
    check; one launch counted a call."""
    xperm = kind.endswith("-xperm")
    kind = kind.replace("-xperm", "")
    E, d = 3, 300
    n = 576 if kind == "fp8" else 768
    qt = _tile_table(kind, E, d, n, seed=len(kind) + xperm, dev=dev)
    g = torch.Generator().manual_seed(11)
    x = torch.randn((8, 128, n), generator=g).to(dev)
    te = torch.tensor([0, 0, 2, 1, 2, 1, 0, 2], device=dev, dtype=torch.int32)
    rows = torch.tensor([128, 7, 0, 64, 1, 30, 100, 17], device=dev, dtype=torch.int32)
    live = torch.arange(128, device=dev)[None, :] < rows[:, None]
    xin = perm_x(x).contiguous() if xperm else x
    counter = _GROUPED_COUNTER[kind.split("-")[0]]
    counter = counter.prepermuted if xperm else counter
    before = counter.launches
    got = qmm_grouped(qt, te, xin, rows, x_prepermuted=xperm)
    assert counter.launches == before + 1
    want = qmm_grouped_plain(qt, te, xin, rows, x_prepermuted=xperm)
    _close(got[live], want[live], 1e-4)
    if not xperm:        # every row of every tile
        _close(qmm_grouped(qt, te, x), qmm_grouped_plain(qt, te, x), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [17, 256, 4096])
@pytest.mark.parametrize("kind", _TILE_KINDS)
def test_tile_gemm_row_tiled_cases(kind, rows, dev):
    """The row-tiled routes (K1's and K5's bodies, which qmm takes above
    ROW_TILE_MIN rows) on the tensor cores at 17 rows (one tile of width
    32), 256 (two full tiles) and 4096 (32), 300 weight rows; each counted
    once by its own counter. Tolerance 1e-4 of the output scale."""
    d, n = 300, 576 if kind == "fp8" else 512
    qt = _tile_table(kind, 0, d, n, seed=rows, dev=dev)
    x = torch.randn((rows, n), generator=torch.Generator().manual_seed(rows)).to(dev)
    route = _ROWS_ROUTE[kind.split("-")[0]]
    before = route.launches
    _close(route(qt, x), qmm_plain(qt, x), 1e-4)
    assert route.launches == before + 1


@pytest.mark.cuda
def test_tile_gemm_fp8_ragged_edges(dev):
    """K6's and K5's fp8 bodies at DeepSeek-V2-Lite's ragged shapes: wkv_a's
    576 rows (a partial last row block of scales) and the dense w2's 10944
    columns (a partial last column block), narrow and full tiles."""
    for d, n in ((576, 2048), (2048, 10944)):
        qt = _fp8(2, d, n, (128, 128), seed=d, dev=dev)
        x = torch.randn((3, 128, n), generator=torch.Generator().manual_seed(5)).to(dev)
        te = torch.tensor([1, 0, 1], device=dev, dtype=torch.int32)
        rows = torch.tensor([5, 128, 40], device=dev, dtype=torch.int32)
        live = torch.arange(128, device=dev)[None, :] < rows[:, None]
        _close(qmm_grouped(qt, te, x, rows)[live],
               qmm_grouped_plain(qt, te, x, rows)[live], 1e-4)
        w = qt.map(lambda t: t[1].contiguous())
        xr = x.reshape(-1, n)[:256]
        _close(qmm_fp8_rows(w, xr), qmm_plain(w, xr), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("E,d,n,pairs", [
    (16, 4096, 7168, 9),      # V3's w13s: one token's 8 routed + 1 shared
    (66, 2816, 2048, 8),      # V2-Lite's w13s: 6 routed + 2 shared
    (66, 2048, 1408, 8),      # V2-Lite's w2s
    (5, 301, 520, 8),         # d not a multiple of a warp's 4 rows
    (3, 4096, 7168, 1),       # a single pair
])
def test_k2_plain_cases(dtype, E, d, n, pairs, dev):
    """K2's plain body (persistent warps, x read beside the table) against
    its plain version at V3 and V2-Lite shapes, a ragged row group and a
    single pair, with repeated experts. Tolerance 1e-4 of the output
    scale: f32 sums of the same widened products in other orders."""
    g = torch.Generator().manual_seed(E + d + pairs)
    qt = PlainTensor(data=(torch.randn((E, d, n), generator=g) * 0.05).to(dev, dtype))
    x = torch.randn((pairs, n), generator=g).to(dev)
    idx = torch.tensor([(7 * p) % E for p in range(pairs - 1)] + [E - 1], device=dev)
    before = qmm_experts_fp.launches
    _close(qmm_experts(qt, idx, x), qmm_experts_plain(qt, idx, x), 1e-4)
    assert qmm_experts_fp.launches == before + 1


def _card_kernels(fn, tries=3, calls=3):
    """The names of the CUDA kernels ``calls`` calls of ``fn`` run (torch.profiler;
    profiled again, up to ``tries`` times, where a session reports no
    device time at all)."""
    from torch.profiler import ProfilerActivity, profile
    names = set()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = {ev.key for ev in prof.key_averages()
                 if (getattr(ev, "device_time_total", None)
                     or getattr(ev, "cuda_time_total", 0)) > 0
                 and not ev.key.startswith(("aten::", "cuda", "Memset", "Memcpy"))}
        if names:
            break
    return names


def _only_kernels(names, allowed):
    """Every kernel run is one of ``allowed`` (no cast or copy launch)."""
    assert names, "the profiler saw no kernel"
    stray = [k for k in names if not any(a in k for a in allowed)]
    assert not stray, f"kernels beyond {allowed}: {stray}"


_NIB_KERNELS = ("xsplit_kernel", "nib_mv_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("d,n", [(2112, 7168), (301, 7168), (1001, 1536), (203, 16384),
                                 (77, 18432), (99, 512)],
                         ids=["wkvq", "wkvq-ragged", "wcr-like", "wo-like", "w2-like",
                              "wv_b-like"])
@pytest.mark.parametrize("rows", [1, 2, 3, 4])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k1_nibble_mv_cases(quant, d, n, rows, x_dtype, dev):
    """K1's matvec (csrc/nibble_mv.cu ``nibble_mv``) at every row count it
    takes, over V3's in-features and row counts no tile divides, with x in
    f32 and in bf16 (read as it is: the profiler sees the pre-pass and the
    matvec and nothing else), against the plain version. Tolerance 1e-4 of
    the output scale: x split into two int8 terms a 16-column group (~15
    bits), exact __dp4a products with the nibbles, f32 folds."""
    qt = _nibble(1, d, n, quant, seed=d + n + rows, dev=dev).map(lambda t: t[0].contiguous())
    x = torch.randn((rows, n), generator=torch.Generator().manual_seed(rows + n)) \
        .to(dev, x_dtype)
    before = qmm.launches
    _close(qmm(qt, x), qmm_plain(qt, x), 1e-4)
    assert qmm.launches == before + 1
    _only_kernels(_card_kernels(lambda: qmm(qt, x)), _NIB_KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("ids", [torch.int64, torch.int32])
@pytest.mark.parametrize("E,d,n,pairs", [(16, 4096, 7168, 9), (16, 7168, 2048, 9),
                                         (128, 128, 512, 128), (5, 301, 1536, 8)],
                         ids=["w13s", "w2s", "wv_b", "ragged"])
@pytest.mark.parametrize("xperm", [False, True], ids=["natural", "prepermuted"])
def test_k2_nibble_mv_cases(quant, ids, E, d, n, pairs, xperm, dev):
    """K2's nibble bodies on the same kernel: pairs with repeated experts
    (wv_b: one pair a head), the ids read as given in int64 or int32, x
    natural or in the stride-16 permuted order, counted apart, against the
    plain version; no cast launch. Tolerance as K1's."""
    qt = _nibble(E, d, n, quant, seed=E + d + pairs, dev=dev)
    idx = (torch.arange(pairs) if pairs == E else
           torch.tensor([3 % E, 0, 3 % E, E - 1, 1, 3 % E, 0, 2, E - 1]))[:pairs].to(dev, ids)
    x = torch.randn((pairs, n), generator=torch.Generator().manual_seed(pairs + n)).to(dev)
    if xperm:
        x = perm_x(x).contiguous()
    count = qmm_experts.prepermuted if xperm else qmm_experts
    before = count.launches
    _close(qmm_experts(qt, idx, x, x_prepermuted=xperm),
           qmm_experts_plain(qt, idx, x, x_prepermuted=xperm), 1e-4)
    assert count.launches == before + 1
    _only_kernels(_card_kernels(lambda: qmm_experts(qt, idx, x, x_prepermuted=xperm)),
                  _NIB_KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["f32", "f16", "bf16"])
@pytest.mark.parametrize("experts", [False, True], ids=["K5", "K2"])
def test_packed_mv_reads_x_as_given(quant, x_dtype, experts, dev):
    """The packed matvec's pre-pass (csrc/xsplit.cuh, shared with the
    nibble matvec) reads x in its own dtype: K5 at 3 rows and K2 over 9
    pairs with int32 ids, x in f32, f16 and bf16, against the plain
    version, and the profiler sees the pre-pass and the matvec and nothing
    else. Tolerance as K5's packed bodies."""
    E = 8 if experts else 0
    qt = _packed(E, 300, 1536, quant, seed=11, dev=dev)
    rows = 9 if experts else 3
    x = torch.randn((rows, 1536), generator=torch.Generator().manual_seed(5)).to(dev, x_dtype)
    kernels = ("xsplit_kernel", "packed_mv_kernel")
    if experts:
        idx = torch.tensor([0, 5, 5, 7, 1, 2, 3, 6, 3], device=dev, dtype=torch.int32)
        before = qmm_experts_packed.launches
        _close(qmm_experts(qt, idx, x), qmm_experts_plain(qt, idx, x), 1e-4)
        assert qmm_experts_packed.launches == before + 1
        _only_kernels(_card_kernels(lambda: qmm_experts(qt, idx, x)), kernels)
    else:
        before = qmm_packed.launches
        _close(qmm(qt, x), qmm_plain(qt, x), 1e-4)
        assert qmm_packed.launches == before + 1
        _only_kernels(_card_kernels(lambda: qmm(qt, x)), kernels)


# DeepSeek-V2-Lite's F8E5M2 projections (128x128 blocks): (d, n)
_V2_FP8 = {"wq": (3072, 2048), "wkv_a": (576, 2048), "wkv_b": (4096, 512),
           "wo": (2048, 2048), "w13": (21888, 2048), "w2": (2048, 10944),
           "lm_head": (102400, 2048)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_V2_FP8))
@pytest.mark.parametrize("rows", [1, 2, 3, 4])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k5_fp8_mv_cases(name, rows, x_dtype, dev):
    """K5's fp8 matvec (csrc/fp8_mv.cu ``fp8_mv``) at V2-Lite's shapes and
    every row count it takes, x in f32 and bf16 (read as it is: one kernel,
    no cast), against the plain version. Tolerance 1e-4 of the output
    scale: exact weights and x, f32 products, each 4-column word's sum
    scaled by its block, f32 sums in other orders."""
    d, n = _V2_FP8[name]
    qt = _fp8(0, d, n, (128, 128), seed=d + n, dev=dev)
    x = torch.randn((rows, n), generator=torch.Generator().manual_seed(rows)).to(dev, x_dtype)
    before = qmm_fp8.launches
    _close(qmm(qt, x), qmm_plain(qt, x), 1e-4)
    assert qmm_fp8.launches == before + 1
    _only_kernels(_card_kernels(lambda: qmm(qt, x)), ("fp8_mv_kernel",))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [5, 13])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.float16], ids=["f32", "f16"])
def test_k5_fp8_mv_small_block_passes(rows, x_dtype, dev):
    """32x16 blocks keep K5 on the matvec at any rows: passes of four x
    rows (two and four launches of the kernel, one call), x in f32 and
    f16, against the plain version. Tolerance as above."""
    qt = _fp8(0, 300, 448, (32, 16), seed=rows + 7, dev=dev)
    x = torch.randn((rows, 448), generator=torch.Generator().manual_seed(rows)).to(dev, x_dtype)
    before = qmm_fp8.launches
    _close(qmm(qt, x), qmm_plain(qt, x), 1e-4)
    assert qmm_fp8.launches == before + 1
    _only_kernels(_card_kernels(lambda: qmm(qt, x)), ("fp8_mv_kernel",))
