"""The port's grouped products against the JAX package: K1's row-tiled
route, K6 (qmm_grouped), K11 (megablox gmm) and the grouped MoE prefill FFN
around them. The same numpy-seeded inputs go through the Pallas kernels in
interpret mode and through the port's wrappers on CPU tensors, which run
the plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import megablox

from deepseek_tpu.config import ActivationType as JaxAct
from deepseek_tpu.ops import matmul as jmm
from deepseek_tpu.ops.pallas.qmm import _group_sums, _perm_x
from deepseek_tpu.ops.pallas.qmm import qmm as jax_qmm
from deepseek_tpu.ops.pallas.qmm import qmm_grouped as jax_qmm_grouped
from deepseek_tpu.parallel.spmd import NULL_CTX
from deepseek_tpu.parallel.spmd import counting_rank as jax_counting_rank
from deepseek_tpu.quant.qtensor import PlainTensor as JaxPlain
from deepseek_tpu_torch.config import ActivationType
from deepseek_tpu_torch.ops import matmul as tmm
from deepseek_tpu_torch.ops.kernels.qmm import (
    ROW_TILE_MIN, gmm, qmm, qmm_grouped, qmm_rows,
)
from deepseek_tpu_torch.quant.qtensor import PlainTensor
from tests.test_torch_qmm import _raw, jax_nibble, rnd, torch_nibble
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_k1_row_tiled_plain_matches_jax(quant):
    """K1 at 200 rows (the row-tiled route) against the Pallas qmm, which
    tiles the rows by 128. Tolerance 1e-4: f32 products of the same
    dequantized weights, summed in other orders."""
    rows, d, n = 200, 64, 512
    raw = _raw(rnd((d, n), seed=11), quant)
    x = rnd((rows, n), seed=12)
    assert rows > ROW_TILE_MIN
    want = np.asarray(jax_qmm(jax_nibble(raw, quant, d, n), jnp.asarray(x),
                              interpret=True))
    qt = torch_nibble(raw, quant, d, n)
    got = qmm(qt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(qmm_rows(qt, torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_k6_plain_matches_pallas_interpret(quant):
    """K6 over 4 tiles of 3 nibble experts (one repeated). The port takes
    natural-order tiles; the Pallas kernel the permuted tiles and the group
    sums. Tolerance as K1. With live-row counts the rows past them are 0."""
    E, d, n, G = 3, 64, 256, 4
    raw = _raw(rnd((E, d, n), seed=13), quant)
    x = rnd((G, 128, n), seed=14)
    te = np.asarray([2, 0, 2, 1], np.int32)
    xj = jnp.asarray(x)
    want = np.asarray(jax_qmm_grouped(
        jax_nibble(raw, quant, d, n), jnp.asarray(te), _perm_x(xj, n),
        s16_tiles=_group_sums(xj, n), interpret=True))
    qt = torch_nibble(raw, quant, d, n)
    got = qmm_grouped(qt, torch.from_numpy(te), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    rows = torch.tensor([128, 5, 0, 77])
    part = qmm_grouped(qt, torch.from_numpy(te), torch.from_numpy(x), rows).numpy()
    for g, r in enumerate(rows.tolist()):
        np.testing.assert_array_equal(part[g, :r], got[g, :r])
        assert not part[g, r:].any()


@pytest.mark.parametrize("x_dtype,w_dtype", [
    ("float32", "float16"), ("float32", "float32"), ("bfloat16", "float16"),
    ("bfloat16", "bfloat16")])
def test_k11_plain_matches_megablox_interpret(x_dtype, w_dtype):
    """K11 (gmm: rows grouped by expert, a zero-size group among them)
    against megablox.gmm in interpret mode with the table cast to the
    compute dtype, as grouped_expert_ffn does. Tolerance 1e-4 relative to
    the output scale: f32 sums of the same exact products."""
    E, n, k, M = 4, 128, 256, 256
    lhs = rnd((M, k), seed=15)
    rhs = rnd((E, n, k), seed=16, scale=0.1)
    sizes = np.asarray([100, 0, 120, 36], np.int32)
    lj = jnp.asarray(lhs, x_dtype)
    rj = jnp.asarray(rhs, w_dtype).astype(x_dtype)
    want = np.asarray(megablox.gmm(lj, rj, jnp.asarray(sizes),
                                   preferred_element_type=jnp.float32,
                                   transpose_rhs=True, tiling=(128, 128, 128),
                                   interpret=True))
    lt = torch.from_numpy(np.array(lj.astype(jnp.float32))).to(getattr(torch, x_dtype))
    rt = torch.from_numpy(np.array(jnp.asarray(rhs, w_dtype).astype(jnp.float32))
                          ).to(getattr(torch, w_dtype))
    got = gmm(lt, rt, torch.from_numpy(sizes)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_counting_rank_and_capacity_match_jax():
    cls = np.random.default_rng(17).integers(0, 6, 50).astype(np.int32)
    want = jax_counting_rank(jnp.asarray(cls), 6)
    got = tmm.counting_rank(torch.from_numpy(cls), 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the tile budget G = E + C/128 with the JAX package's capacity C at ep == 1
    for n in (1, 128, 129, 2304):
        flat = torch.from_numpy(np.random.default_rng(n).integers(0, 6, n))
        _, rows, _, G = tmm.tile_dispatch(flat, 6)
        assert G == 6 + jmm.ep_prefill_capacity(n, 1, 0.0) // 128
        assert int(rows.sum()) == n


def _routing(B, T, k, E, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, E, (B, T, k)).astype(np.int32)
    wts = rng.uniform(size=(B, T, k)).astype(np.float32)
    return idx, wts


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_grouped_ffn_nibble_matches_jax(quant):
    """The nibble MoE prefill FFN (counting dispatch into 128-row tiles +
    K6) against the JAX _quantized_grouped_ffn with qmm_grouped in
    interpret mode: 140 pairs over 4 experts, so tiles are ragged and the
    budget has surplus tiles. Tolerance 1e-4 of the output scale."""
    E, m, dim, B, T, k = 4, 256, 256, 1, 70, 2
    raws = [_raw(rnd(s, seed=20 + i, scale=0.1), quant)
            for i, s in enumerate([(E, m, dim), (E, dim, m), (E, m, dim)])]
    shapes = [(m, dim), (dim, m), (m, dim)]
    xb = rnd((B, T, dim), seed=24, scale=0.3)
    idx, wts = _routing(B, T, k, E, 25)
    jw = [jax_nibble(r, quant, *s) for r, s in zip(raws, shapes)]
    want = np.asarray(jmm.grouped_expert_ffn(
        *jw, jnp.asarray(xb), jnp.asarray(wts), jnp.asarray(idx), JaxAct.SILU,
        NULL_CTX, interpret=True)[0])
    tw = [torch_nibble(r, quant, *s) for r, s in zip(raws, shapes)]
    got = tmm.grouped_expert_ffn(*tw, torch.from_numpy(xb), torch.from_numpy(wts),
                                 torch.from_numpy(idx), ActivationType.SILU).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_ffn_plain_matches_jax(dtype):
    """The plain-table MoE prefill FFN (counting sort + K11) against the
    JAX grouped_expert_ffn (megablox gmm, interpret) with a fused [w1; w3]
    f16 table, in the compute dtype. Tolerance: 1e-4 of the output scale in
    f32; in bf16 one bf16 rounding of h and of the output (2^-8)."""
    E, m, dim, B, T, k = 4, 128, 128, 1, 70, 2
    w13 = rnd((E, 2 * m, dim), seed=26, scale=0.1).astype(np.float16)
    w2 = rnd((E, dim, m), seed=27, scale=0.1).astype(np.float16)
    xb = rnd((B, T, dim), seed=28, scale=0.3)
    idx, wts = _routing(B, T, k, E, 29)
    xj = jnp.asarray(xb).astype(dtype)
    want = np.asarray(jmm.grouped_expert_ffn(
        None, JaxPlain(data=jnp.asarray(w2)), None, xj, jnp.asarray(wts),
        jnp.asarray(idx), JaxAct.SILU, NULL_CTX, interpret=True,
        w13=JaxPlain(data=jnp.asarray(w13)))[0].astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tmm.grouped_expert_ffn(
        None, PlainTensor(data=torch.from_numpy(w2)), None, xt,
        torch.from_numpy(wts), torch.from_numpy(idx), ActivationType.SILU,
        w13=PlainTensor(data=torch.from_numpy(w13))).float().numpy()
    tol = 1e-4 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
