"""The reference's decoders on hand-built blocks: a Q3_K block laid out as
GGML stores it (decoded here element by element, from the format), through
the port's loader repack into the plane layout that the benchmark draws,
then the reference's plane decoder; and F8E5M2 bytes with block scales."""

import numpy as np
import torch

from gpubench.reference.decode import fp8_to_f32, q3k_to_f32


def q3k_block(rng):
    """A raw 110-byte Q3_K block and its 256 weights decoded by hand:
    w[e] = d * (s[g] - 32) * (((qs[32*h + e%32] >> 2*j) & 3) - 4*(1 - hbit)),
    e = 128*h + 32*j + e%32, group g = 8*h + 2*j + (e%32)//16, high bit
    (hmask[e%32] >> (4*h + j)) & 1, the 6-bit scales packed 12 bytes."""
    hmask = rng.integers(0, 256, 32, dtype=np.uint8)
    qs = rng.integers(0, 256, 64, dtype=np.uint8)
    s6 = rng.integers(0, 64, 16)
    packed = np.zeros(12, np.uint8)
    for g in range(16):
        lo, hi = s6[g] & 0xF, s6[g] >> 4
        packed[g % 8] |= lo << (4 * (g // 8))
        packed[8 + g % 4] |= hi << (2 * (g // 4))
    d = np.float16(rng.uniform(0.01, 0.1))
    raw = np.concatenate([hmask, qs, packed, np.frombuffer(d.tobytes(), np.uint8)])
    w = np.zeros(256)
    for e in range(256):
        h, j, r = e // 128, (e % 128) // 32, e % 32
        q = (int(qs[32 * h + r]) >> (2 * j)) & 3
        hb = (int(hmask[r]) >> (4 * h + j)) & 1
        g = 8 * h + 2 * j + r // 16
        w[e] = float(d) * (int(s6[g]) - 32) * (q - 4 * (1 - hb))
    return raw, w


def test_q3k_planes_decode_to_the_format():
    from deepseek_tpu_torch.quant.repack import repack_q3k
    rng = np.random.default_rng(0)
    rows, blocks = 3, 2
    raws, ws = zip(*[q3k_block(rng) for _ in range(rows * blocks)])
    raw = np.stack([np.concatenate(raws[r * blocks:(r + 1) * blocks]) for r in range(rows)])
    want = np.stack([np.concatenate(ws[r * blocks:(r + 1) * blocks]) for r in range(rows)])
    qs, hm, sc, d = (torch.from_numpy(np.ascontiguousarray(a))
                     for a in repack_q3k(raw, rows, blocks * 256))
    got = q3k_to_f32(qs, hm, sc, d).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_fp8_blocks():
    vals = torch.tensor([[1.0, -2.0, 0.5, 3.0, -0.25], [0.0, 1.5, -1.0, 2.0, 4.0],
                         [-3.0, 0.75, 1.25, -0.5, 6.0]])
    data = vals.to(torch.float8_e5m2).view(torch.uint8)
    scale = torch.tensor([[2.0, 10.0], [-1.0, 0.5]])          # blocks of 2 x 3
    want = vals * torch.tensor([[2.0, 2.0, 2.0, 10.0, 10.0], [2.0, 2.0, 2.0, 10.0, 10.0],
                                [-1.0, -1.0, -1.0, 0.5, 0.5]])
    assert torch.equal(fp8_to_f32(data, scale, (2, 3)), want)
    assert int(data[0, 0]) == 0x3C and int(data[0, 1]) == 0xC0   # e5m2 1.0 and -2.0
