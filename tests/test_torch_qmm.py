"""Kernels K1 (qmm) and K2 (qmm_experts, nibble and plain bodies) of the port against the JAX package.

The same numpy-seeded weights go through the JAX K-quant path (quantize,
repack, nibble planes) and the Pallas kernels in interpret mode, and through
the port's wrappers on CPU tensors, which run the plain versions. Shapes
follow tests/test_pallas_qmm.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu.ops.pallas.qmm import qmm as jax_qmm
from deepseek_tpu.ops.pallas.qmm import qmm_experts as jax_qmm_experts
from deepseek_tpu.quant import kquant, repack
from deepseek_tpu.quant.qtensor import PlainTensor as JaxPlain
from deepseek_tpu.quant.qtensor import Q2KTensor, Q3KTensor, q2k_to_nibble, q3k_to_nibble
from deepseek_tpu_torch.ops.kernels.qmm import qmm, qmm_experts, qmm_experts_fp
from deepseek_tpu_torch.quant import qtensor as tq
from deepseek_tpu_torch.quant.repack import repack_q2k, repack_q3k
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def rnd(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _raw(w, quant):
    fn = kquant.quantize_q2_k if quant == "q2_k" else kquant.quantize_q3_k
    return fn(w) if w.ndim == 2 else np.stack([fn(e) for e in w])


def jax_nibble(raw, quant, rows, cols):
    if quant == "q2_k":
        qs, sm, d, dmin = repack.repack_q2k(raw, rows, cols)
        return q2k_to_nibble(Q2KTensor(qs=jnp.asarray(qs), sm=jnp.asarray(sm),
                                       d=jnp.asarray(d), dmin=jnp.asarray(dmin)))
    qs, hm, sc, d = repack.repack_q3k(raw, rows, cols)
    return q3k_to_nibble(Q3KTensor(qs=jnp.asarray(qs), hm=jnp.asarray(hm),
                                   sc=jnp.asarray(sc), d=jnp.asarray(d)))


def torch_nibble(raw, quant, rows, cols):
    if quant == "q2_k":
        return tq.q2k_to_nibble(*repack_q2k(raw, rows, cols))
    return tq.q3k_to_nibble(*repack_q3k(raw, rows, cols))


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_nibble_planes_match_jax(quant):
    """The port's load conversion produces the JAX package's planes bit for
    bit, and the same f32 dequant."""
    w = rnd((64, 512), seed=1)
    raw = _raw(w, quant)
    jt, tt = jax_nibble(raw, quant, 64, 512), torch_nibble(raw, quant, 64, 512)
    assert tt.off == jt.off and (tt.c is None) == (jt.c is None)
    np.testing.assert_array_equal(tt.p.numpy(), np.asarray(jt.p))
    np.testing.assert_array_equal(tt.a.view(torch.int16).numpy().view(np.uint16),
                                  _bits(jt.a))
    np.testing.assert_array_equal(tt.dequant().numpy(), np.asarray(jt.dequant(jnp.float32)))


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("B", [1, 3])
def test_k1_plain_matches_pallas_interpret(quant, B):
    """Tolerance 1e-4 (as tests/test_pallas_qmm.py): both are f32 products
    of the same dequantized weights, summed in different orders."""
    w = rnd((64, 512), seed=1)
    x = rnd((B, 512), seed=2)
    raw = _raw(w, quant)
    want = np.asarray(jax_qmm(jax_nibble(raw, quant, 64, 512), jnp.asarray(x),
                              interpret=True))
    got = qmm(torch_nibble(raw, quant, 64, 512), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("B", [1, 3])
def test_k2_plain_matches_pallas_interpret(quant, B):
    """Gathered-expert rows, with a repeated expert; tolerance as K1."""
    E, m, n, k = 8, 32, 512, 3
    w = rnd((E, m, n), seed=7)
    raw = _raw(w, quant)
    idx = np.random.default_rng(B).integers(0, E, (B, k)).astype(np.int32)
    idx[0, 1] = idx[0, 0]
    x = rnd((B, k, n), seed=8)
    want = np.asarray(jax_qmm_experts(jax_nibble(raw, quant, m, n),
                                      jnp.asarray(idx), jnp.asarray(x),
                                      interpret=True))
    got = qmm_experts(torch_nibble(raw, quant, m, n), torch.from_numpy(idx),
                      torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_k2_plain_body_matches_pallas_interpret(dtype):
    """K2's plain body (a plain expert table, as a plain-weight checkpoint's
    MoE pair path gives it) against the Pallas qmm_experts with its plain
    body in interpret mode. Both widen the table to f32 and sum f32
    products; tolerance 1e-4 of the output scale for the summation order."""
    E, m, n, B, k = 5, 48, 256, 2, 3
    w = rnd((E, m, n), seed=9, scale=0.1)
    wj = jnp.asarray(w, dtype)
    idx = np.asarray([[4, 0, 4], [2, 1, 0]], np.int32)
    x = rnd((B, k, n), seed=10)
    want = np.asarray(jax_qmm_experts(JaxPlain(data=wj), jnp.asarray(idx),
                                      jnp.asarray(x), interpret=True))
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = qmm_experts(tq.PlainTensor(data=wt), torch.from_numpy(idx),
                      torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers take the plain versions: no launch."""
    raw = _raw(rnd((16, 256), seed=3), "q3_k")
    qt = torch_nibble(raw, "q3_k", 16, 256)
    before = (qmm.launches, qmm_experts.launches, qmm_experts_fp.launches)
    qmm(qt, torch.ones(1, 256))
    qmm_experts(qt.map(lambda t: t[None]), torch.zeros(2, dtype=torch.int64),
                torch.ones(2, 256))
    qmm_experts(tq.PlainTensor(data=torch.ones(1, 16, 256)),
                torch.zeros(2, dtype=torch.int64), torch.ones(2, 256))
    assert (qmm.launches, qmm_experts.launches, qmm_experts_fp.launches) == before
