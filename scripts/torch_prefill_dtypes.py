"""K9 and K10 (the prefill flash attention) timed by cache dtype, for one
checkout of the PyTorch/CUDA port (one GPU).

    python scripts/torch_prefill_dtypes.py [ROOT]

ROOT is the root of the checkout whose ``deepseek_tpu_torch`` is timed
(default: this one); unpack another commit with ``git archive`` into a
directory that ``.gitignore`` lists and run the script once for each tree
in one call to compare the two on the same card. At the prefill chunk
that sees the whole window (T 256 at position 3840 over 4096 slots) it
runs K9 at DeepSeek-V3's 128 heads and DeepSeek-V2-Lite's 16 (Dh 192,
Dv 128) and K10 at V3's (128 heads, R 512, P 64), over bf16, f16 and f32
rows drawn in f32 from a seed. For each it prints the kernel's mean device
time (each call behind a 512 MB write that evicts the L2 and a device
spin, as ``chip_smoke.py`` times) and its max abs error against the plain
version as a fraction of max|ref|. Needs a CUDA GPU; exits 2 without one.
"""

import math
import sys

import torch


def time_ms(fn, flush, iters=10):
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_prefill_dtypes: no CUDA GPU visible", file=sys.stderr)
        return 2
    root = sys.argv[1] if len(sys.argv) > 1 else "."
    sys.path.insert(0, root)
    from deepseek_tpu_torch.ops.kernels import build
    from deepseek_tpu_torch.ops.kernels.prefill_attn import (
        mha_prefill_attn, mha_prefill_attn_plain, mla_prefill_attn,
        mla_prefill_attn_plain)

    build.build_all()
    flush = torch.empty(128 * 2**20, dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    S, T = 4096, 256
    q_pos0 = S - T
    dtypes = (torch.bfloat16, torch.float16, torch.float32)
    for H in (128, 16):
        Dh, Dv = 192, 128
        scale = 1 / math.sqrt(Dh)
        q = torch.randn((1, T, H, Dh), generator=g, device="cuda") * 0.3
        for dt in dtypes:
            k = (torch.randn((1, S, H, Dh), generator=g, device="cuda") * 0.3).to(dt)
            v = (torch.randn((1, S, H, Dv), generator=g, device="cuda") * 0.3).to(dt)
            got = mha_prefill_attn(q, k, v, q_pos0, 0, scale)
            want = mha_prefill_attn_plain(q, k, v, q_pos0, 0, scale)
            err = float((got - want).abs().max()) / float(want.abs().max())
            t = time_ms(lambda: mha_prefill_attn(q, k, v, q_pos0, 0, scale), flush)
            print(f"{root} K9 H={H} {dt}: {t:.4f} ms, rel err {err:.2e}", flush=True)
            del k, v
    H, R, P = 128, 512, 64
    scale = 1 / math.sqrt(192)
    qc = torch.randn((1, T, H, R), generator=g, device="cuda") * 0.3
    qr = torch.randn((1, T, H, P), generator=g, device="cuda") * 0.3
    for dt in dtypes:
        c = (torch.randn((1, S, R), generator=g, device="cuda") * 0.3).to(dt)
        r = (torch.randn((1, S, P), generator=g, device="cuda") * 0.3).to(dt)
        got = mla_prefill_attn(qc, qr, c, r, q_pos0, 0, scale)
        want = mla_prefill_attn_plain(qc, qr, c, r, q_pos0, 0, scale)
        err = float((got - want).abs().max()) / float(want.abs().max())
        t = time_ms(lambda: mla_prefill_attn(qc, qr, c, r, q_pos0, 0, scale), flush)
        print(f"{root} K10 H={H} {dt}: {t:.4f} ms, rel err {err:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
