"""The port's numpy K-quant encoders and decoders (``deepseek_tpu_torch/
quant/kquant.py``) against the JAX package's (``deepseek_tpu/quant/
kquant.py``): byte for byte on random matrices from several seeds and on
all-zero, constant, large-magnitude and tiny rows; ``dequantize_*``,
``quantize_q8_k`` and the integer ``vec_dot_*`` equal too. (The native
encoder is held against the JAX native encoder in test_torch_native.py:
the native and numpy encoders agree on only most bytes.)"""

import numpy as np
import pytest

from deepseek_tpu.quant import kquant as jk
from deepseek_tpu_torch.quant import kquant as tk
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _rows(kind, seed, rows=6, cols=512):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    if kind == "zero":
        x[:] = 0.0
    elif kind == "constant":
        x[:] = 0.37
        x[1] = -2.5
    elif kind == "large":
        x *= 3.0e4
    elif kind == "tiny":
        x *= 1e-9
    elif kind == "mixed":
        # a zero row, a constant row, a spike, tiny and large rows together
        x[0] = 0.0
        x[1] = 1.0
        x[2, 17] = 500.0
        x[3] *= 1e-12
        x[4] *= 1e4
    return x


CASES = [("random", s) for s in (0, 1, 2, 3)] + [
    (k, 5) for k in ("zero", "constant", "large", "tiny", "mixed")]


@pytest.mark.parametrize("kind,seed", CASES)
@pytest.mark.parametrize("method", ["q2_k", "q3_k"])
def test_encoders_and_decoders_equal_jax(kind, seed, method):
    x = _rows(kind, seed)
    enc = {"q2_k": (jk.quantize_q2_k, tk.quantize_q2_k),
           "q3_k": (jk.quantize_q3_k, tk.quantize_q3_k)}[method]
    dec = {"q2_k": (jk.dequantize_q2_k, tk.dequantize_q2_k),
           "q3_k": (jk.dequantize_q3_k, tk.dequantize_q3_k)}[method]
    want = enc[0](x)
    got = enc[1](x)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(dec[1](got, *x.shape), dec[0](want, *x.shape))


@pytest.mark.parametrize("kind,seed", CASES)
def test_q8k_and_vec_dots_equal_jax(kind, seed):
    x = _rows(kind, seed)
    a = _rows("random", seed + 10, rows=1)[0]
    for got, want in zip(tk.quantize_q8_k(a), jk.quantize_q8_k(a)):
        np.testing.assert_array_equal(got, want)
    d, qs, bs = tk.quantize_q8_k(a)
    np.testing.assert_array_equal(tk.dequantize_q8_k(d, qs), jk.dequantize_q8_k(d, qs))
    for r in range(x.shape[0]):
        q2, q3 = tk.quantize_q2_k(x[r:r + 1]), tk.quantize_q3_k(x[r:r + 1])
        assert tk.vec_dot_q2_k_q8_k(q2, d, qs, bs) == jk.vec_dot_q2_k_q8_k(q2, d, qs, bs)
        assert tk.vec_dot_q3_k_q8_k(q3, d, qs) == jk.vec_dot_q3_k_q8_k(q3, d, qs)


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_helpers_equal_jax(seed):
    """The per-group fits and the Q3_K scale packing on their own."""
    g = np.random.default_rng(seed).standard_normal((64, 16)).astype(np.float32)
    g[3] = 0.0
    for got, want in zip(tk._make_qkx2_quants(g, np.abs(g), 3, -0.5, 0.1, 15, True),
                         jk._make_qkx2_quants(g, np.abs(g), 3, -0.5, 0.1, 15, True)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tk._make_q3_quants(g.copy()), jk._make_q3_quants(g.copy())):
        np.testing.assert_array_equal(got, want)
    sc6 = np.random.default_rng(seed).integers(0, 64, (5, 16))
    np.testing.assert_array_equal(tk._pack_q3_scales(sc6), jk._pack_q3_scales(sc6))
    np.testing.assert_array_equal(tk.unpack_q3_scales(tk._pack_q3_scales(sc6)), sc6)


def test_encoders_reject_ragged_columns():
    with pytest.raises(AssertionError):
        tk.quantize_q2_k(np.zeros((2, 300), np.float32))
