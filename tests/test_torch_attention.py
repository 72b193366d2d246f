"""Kernel K3 (absorbed-MLA decode attention) of the port against the JAX
package: the Pallas kernel in interpret mode and the jnp reference, with
kv_len < S per sequence and a ragged S (not a multiple of any tile)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu.ops.attention import decode_attn_mla as jax_decode_attn_mla
from deepseek_tpu.ops.pallas.attention import mla_decode_attn as jax_mla_decode_attn
from deepseek_tpu_torch.ops.attention import decode_attn_mla
from deepseek_tpu_torch.ops.kernels.attention import mla_decode_attn
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _inputs(B, H, S, R, P, seed):
    rng = np.random.default_rng(seed)
    qc = rng.standard_normal((B, H, R)).astype(np.float32)
    qr = rng.standard_normal((B, H, P)).astype(np.float32)
    ckv = (rng.standard_normal((B, S, R)) * 0.5).astype(np.float16)
    kr = (rng.standard_normal((B, S, P)) * 0.5).astype(np.float16)
    return qc, qr, ckv, kr


@pytest.mark.parametrize("S,kv_len", [(40, [37, 5]), (64, [64, 1]), (23, [17, 23])])
def test_k3_plain_matches_jax(S, kv_len):
    """Tolerance 2e-5: all three are f32 softmax-weighted sums of the same
    f16 cache values; they differ only in summation order (the Pallas body
    uses the online softmax over tiles)."""
    B, H, R, P = 2, 4, 64, 16
    qc, qr, ckv, kr = _inputs(B, H, S, R, P, seed=S)
    scale = 1.0 / math.sqrt(48 + P)
    kl = np.asarray(kv_len, np.int32)
    want_pl = np.asarray(jax_mla_decode_attn(
        jnp.asarray(qc), jnp.asarray(qr), jnp.asarray(ckv), jnp.asarray(kr),
        jnp.asarray(kl), scale, interpret=True))
    want_jnp = np.asarray(jax_decode_attn_mla(
        jnp.asarray(qc), jnp.asarray(qr), jnp.asarray(ckv), jnp.asarray(kr),
        jnp.asarray(kl), 48 + P, softmax_scale=scale))
    args = [torch.from_numpy(a) for a in (qc, qr, ckv, kr)]
    got = mla_decode_attn(*args, torch.from_numpy(kl), scale).numpy()
    np.testing.assert_allclose(got, want_pl, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_jnp, rtol=2e-5, atol=2e-5)
    # the default scale is 1/sqrt(head_dim), as in the JAX function
    np.testing.assert_allclose(
        decode_attn_mla(*args, torch.from_numpy(kl), 48 + P).numpy(), got,
        rtol=1e-6, atol=1e-6)


def test_k3_slots_past_kv_len_do_not_count():
    """What the ring holds past kv_len must not change the output."""
    B, H, S, R, P = 1, 2, 16, 32, 8
    qc, qr, ckv, kr = _inputs(B, H, S, R, P, seed=1)
    args = [torch.from_numpy(a) for a in (qc, qr, ckv, kr)]
    want = mla_decode_attn(*args, torch.tensor([9]), 0.1)
    args[2][:, 9:] = 100.0
    args[3][:, 9:] = -100.0
    torch.testing.assert_close(mla_decode_attn(*args, torch.tensor([9]), 0.1),
                               want, rtol=0, atol=0)
