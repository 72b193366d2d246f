"""K8 (MHA decode attention) and K11 (grouped plain expert matmul) timed at
the main path's shapes, for one checkout of the PyTorch/CUDA port (one
GPU).

    python scripts/torch_k8_k11.py [ROOT] [--flush write|read|none]

ROOT is the root of the checkout whose ``deepseek_tpu_torch`` is timed
(default: this one); unpack another commit with ``git archive`` into a
directory that ``.gitignore`` lists and run the script once for each tree
in one call (parent, change, change, parent) to compare them on one card.
The inputs are drawn from a seed, the same for every tree:

- K8 over the 4096-slot cache at DeepSeek-V2-Lite's 16 heads and V3's 128
  (Dh 192, Dv 128), kv_len 68 and 4000, bf16 and int8 rows (int8 with
  their (B,H,S) scale views), and the partials body over a seq=2 shard
  (S_local 2048, 16 heads);
- K11 at DeepSeek-V3's w13/w2 widths over 64 bf16 tables (a 256-token
  top-8 routing plus a shared slot: 2304 rows), the w13 shape with f32
  rows, and at DeepSeek-V2-Lite's w13/w2 widths over 66 f16 tables with
  bf16 rows (top-6 plus 2 shared slots: 2048 rows).

For each it prints the kernel's mean device time and its max abs error
against the plain version as a fraction of max|ref|. Each timed call
follows a device spin and, by default, a 512 MB write that evicts the L2,
as ``chip_smoke.py`` times (``--flush write``; the write leaves the L2
full of dirty lines that the kernel's own reads must first write back);
``--flush read`` evicts it with a 512 MB read instead, ``--flush none``
leaves it warm. For K8 it also prints the device time of each of its two
launches (the split kernel, the merge) from the profiler. Needs a CUDA
GPU; exits 2 without one.
"""

import math
import sys

import torch


def time_ms(fn, evict, iters=20):
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        evict()
        torch.cuda._sleep(2_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def rel_err(got, want):
    if isinstance(want, tuple):          # a partials triple: its accumulator
        got, want = got[0], want[0]
    return float((got - want).abs().max()) / float(want.abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k8_k11: no CUDA GPU visible", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    mode = "write"
    if "--flush" in args:
        i = args.index("--flush")
        mode = args[i + 1]
        del args[i:i + 2]
    root = args[0] if args else "."
    sys.path.insert(0, root)
    from deepseek_tpu_torch.ops.kernels import build
    from deepseek_tpu_torch.ops.kernels.attention import (
        mha_decode_attn, mha_decode_attn_plain)
    from deepseek_tpu_torch.ops.kernels.qmm import gmm, gmm_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    flush = torch.empty(128 * 2**20, dtype=torch.float32, device="cuda")
    sink = torch.empty(1, device="cuda")
    evict = {"write": flush.zero_, "read": lambda: torch.sum(flush, 0, keepdim=True, out=sink),
             "none": lambda: None}[mode]
    print(f"{root}: flush {mode}", flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def report(name, fn, plain, launches=False):
        err = rel_err(fn(), plain())
        line = f"{root} {name}: {time_ms(fn, evict):.4f} ms, rel err {err:.2e}"
        if launches:
            line += "; " + ", ".join(f"{k} {v:.4f} ms" for k, v in kernel_times(fn).items())
        print(line, flush=True)

    def kernel_times(fn, iters=20):
        """Mean device time of each kernel fn launches (the profiler)."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                evict()
                fn()
            torch.cuda.synchronize()
        return {e.key.split("(")[0].split("::")[-1].split("<")[0]:
                e.device_time_total / e.count / 1e3
                for e in prof.key_averages() if "mha" in e.key}

    Dh, Dv = 192, 128
    scale = 1 / math.sqrt(Dh)
    for H, S, kvs, partials in ((16, 4096, (68, 4000), False),
                                (128, 4096, (68, 4000), False),
                                (16, 2048, (1952,), True)):
        q = torch.randn((1, H, Dh), generator=g, device="cuda")
        k = (torch.randn((1, S, H, Dh), generator=g, device="cuda") * 0.3).to(torch.bfloat16)
        v = torch.randn((1, S, H, Dv), generator=g, device="cuda").to(torch.bfloat16)
        k8 = torch.randint(-127, 128, (1, S, H, Dh), generator=g, device="cuda",
                           dtype=torch.int8)
        v8 = torch.randint(-127, 128, (1, S, H, Dv), generator=g, device="cuda",
                           dtype=torch.int8)
        ks = (torch.rand((1, S, H), generator=g, device="cuda") * 0.02 + 0.001).transpose(1, 2)
        vs = (torch.rand((1, S, H), generator=g, device="cuda") * 0.02 + 0.001).transpose(1, 2)
        tag = " partials" if partials else ""
        for kv in kvs:
            kl = torch.tensor([kv], device="cuda", dtype=torch.int32)
            report(f"K8{tag} bf16 H={H} S={S} kv_len={kv}",
                   lambda: mha_decode_attn(q, k, v, kl, scale, partials=partials),
                   lambda: mha_decode_attn_plain(q, k, v, kl, scale, partials=partials),
                   launches=True)
            report(f"K8{tag} int8 H={H} S={S} kv_len={kv}",
                   lambda: mha_decode_attn(q, k8, v8, kl, scale, k_scale=ks, v_scale=vs,
                                           partials=partials),
                   lambda: mha_decode_attn_plain(q, k8, v8, kl, scale, ks, vs,
                                                 partials=partials))
        del k, v, k8, v8

    T = 256
    for label, E_r, top, E_s, dim, m, x_dt, w_dt in (
            ("V3", 63, 8, 1, 7168, 2048, torch.bfloat16, torch.bfloat16),
            ("V3 f32 rows", 63, 8, 1, 7168, 2048, torch.float32, torch.bfloat16),
            ("V2-Lite f16", 64, 6, 2, 2048, 1408, torch.bfloat16, torch.float16)):
        routed = torch.rand((T, E_r), generator=g, device="cuda").topk(top, dim=-1).indices
        idx = torch.cat([routed, torch.arange(E_r, E_r + E_s, device="cuda").expand(T, -1)], -1)
        sizes = torch.bincount(idx.reshape(-1), minlength=E_r + E_s)
        M = idx.numel()
        shapes = (("w13", 2 * m, dim),) if "f32" in label else (("w13", 2 * m, dim),
                                                                ("w2", dim, m))
        for name, n, kk in shapes:
            rhs = (torch.randn((E_r + E_s, n, kk), generator=g, device="cuda") * 0.02).to(w_dt)
            lhs = torch.randn((M, kk), generator=g, device="cuda").to(x_dt)
            report(f"K11 {label} {name} {E_r + E_s}x{n}x{kk} rows={M}",
                   lambda: gmm(lhs, rhs, sizes), lambda: gmm_plain(lhs, rhs, sizes))
            del rhs, lhs
    return 0


if __name__ == "__main__":
    sys.exit(main())
