"""The port's CUDA kernels against their plain versions on the card.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed; there tests/conftest.py (which imports JAX) is
skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each test skips where no CUDA GPU is visible.
"""

import math

import numpy as np
import pytest
import torch

from deepseek_tpu_torch.ops.kernels.attention import (
    mla_decode_attn, mla_decode_attn_plain,
)
from deepseek_tpu_torch.ops.kernels.qmm import (
    qmm, qmm_experts, qmm_experts_plain, qmm_plain,
)
from deepseek_tpu_torch.quant.qtensor import KNibbleTensor


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
    scale: f32 sums in other orders, and the kernel's exact 0.5 + u/256
    nibble floats whose offset cancels against f32 group sums."""
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
    (2, 2, 40, 256, 64, [37, 1]),
    (1, 20, 301, 512, 64, [301]),
])
def test_mla_kernel_matches_plain(dtype, B, H, S, R, P, kv_len, dev):
    """K3 against its plain version. Tolerance 1e-4: f32 sums over up to
    4096 slots in other orders, and the fast exp."""
    args = _attn_inputs(B, H, S, R, P, H, dtype, dev)
    kl = torch.tensor(kv_len, device=dev)
    scale = 1.0 / math.sqrt(192)
    torch.testing.assert_close(mla_decode_attn(*args, kl, scale),
                               mla_decode_attn_plain(*args, kl, scale),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_mla_kernel_ignores_slots_past_kv_len(dev):
    args = _attn_inputs(1, 4, 64, 256, 64, 0, torch.bfloat16, dev)
    kl = torch.tensor([40], device=dev)
    want = mla_decode_attn(*args, kl, 0.1)
    args[2][:, 40:] = float("nan")
    args[3][:, 40:] = float("nan")
    got = mla_decode_attn(*args, kl, 0.1)
    assert torch.equal(got, want)
    assert not np.isnan(got.cpu().numpy()).any()
