"""K3 (absorbed-MLA decode attention), K2's fp8 body and K5's fp8 and packed
matvecs timed at the main path's shapes, for one checkout of the
PyTorch/CUDA port (one GPU).

    python scripts/torch_k3_k2fp8.py [ROOT] [--only PREFIX] [--profile] [--sass]

ROOT is the root of the checkout whose ``deepseek_tpu_torch`` is timed
(default: this one); unpack another commit with ``git archive`` into a
directory that ``.gitignore`` lists and run the script once for each tree
in one call (parent, change, change, parent) to compare them on one card.
``--only`` keeps the rows whose name starts with PREFIX (e.g. ``K3``);
``--profile`` adds, for each
row, the mean device time of every CUDA kernel one call launches
(``torch.profiler``); ``--sass`` prints the static instruction mix of K2's
fp8 body (``cuobjdump -sass`` of the built library: each opcode's count
in ``plain_matvec_kernel<unsigned char>``, whose unrolled loop body
handles 2 x 4 x 16 = 128 weights a lane) and exits. The inputs are drawn
on the
card from a seed, the same for every tree:

- K3 at DeepSeek-V3's widths (128 heads, R 512, P 64) over the 4096-slot
  window at kv_len 4000 and 32, over bf16, f16, f32 and int8 rows (int8
  with its (B,S) f32 scales), and its partials body over one seq=2 shard
  (S_local 2048, 1952 live slots) in bf16 and int8; beside each, its two
  floors: the bytes (the live rows, the queries, the output) at 3.35 TB/s
  and the split-operand MMA work (2 bf16 passes for bf16 and int8 rows,
  3 for f16 and f32) at 989 TFLOP/s; and, for K3 over bf16 rows at 4000,
  the host time of one call (the wrapper's checks, allocations and the
  launches, enqueued behind a device spin, so no call waits on the card);
- K2's fp8 body (F8E5M2, 128x128 blocks) over DeepSeek-V2-Lite's folded
  tables (64 routed + 2 shared experts of 2816 x 2048 w13s and 2048 x
  1408 w2s) for one token's 8 pairs;
- K10 and K9, which share K3's kernel file: V3's K10 (128 heads, R 512,
  P 64), K9 at V3's (128 heads, Dh 192, Dv 128: the hybrid prefill) and
  V2-Lite's (16 heads) widths over bf16 rows, the window's last 256-token
  chunk at 3840 of 4096 slots;
- K5's fp8 matvec at one row over V2-Lite's attention projections (wq
  3072 x 2048, wkv_a 576 x 2048, wkv_b 4096 x 512, wo 2048 x 2048) and
  K5's packed Q3_K matvec at one row over V3's (wkvq 2112 x 7168, wcr
  73728 x 1536, wo 7168 x 16384), each beside its byte floor.

For each it prints the kernel's mean device time, its max abs error
against the plain version as a fraction of max|ref| (of acc, m and l for
the partials), and its floors. Each timed call follows a 512 MB read that
evicts the L2 (``chip_smoke.py`` writes instead: its times also carry the
write-backs of the dirty lines, ~15 us at 50 MB) and a device spin. Needs
a CUDA GPU; exits 2 without one.
"""

import subprocess
import sys
import time

import torch

HBM = 3.35e12       # bytes/s, the H100 SXM's published rate
BF16 = 989e12       # dense bf16 FLOP/s


def evict(flush):
    """Evict the 50 MB L2 by reading 512 MB (a read leaves no dirty lines
    whose write-backs would share the next call's memory traffic)."""
    torch.sum(flush, dtype=torch.float32)


def time_ms(fn, flush, iters=20):
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        evict(flush)
        torch.cuda._sleep(2_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def host_us(fn, calls=200):
    """Host microseconds of one call: ``calls`` calls enqueued behind a
    device spin long enough that none of them waits for the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def rel_err(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) == 3:             # a partials triple: rescale acc, l to a common m
        (acc, m, l), (acc_w, m_w, l_w) = got, want
        mx = torch.maximum(m, m_w)
        a, b = torch.exp(m - mx), torch.exp(m_w - mx)
        got = (acc * a[..., None], m, l * a)
        want = (acc_w * b[..., None], m_w, l_w * b)
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want))


def sass_mix(root) -> int:
    """The opcode counts of K2's fp8 body in the built qmm library."""
    import collections
    import re
    from deepseek_tpu_torch.ops.kernels import build
    build.build_all(["qmm"])
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(build._target("qmm"))],
                          capture_output=True, text=True, check=True).stdout
    body, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = "plain_matvec_kernelIhE" in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                body.append(m.group(1))
    mix = collections.Counter(op.split(".")[0] for op in body)
    print(f"{root} plain_matvec_kernel<unsigned char>: {len(body)} instructions; "
          + ", ".join(f"{k} {v}" for k, v in mix.most_common()), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k3_k2fp8: no CUDA GPU visible", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    profile, sass = "--profile" in args, "--sass" in args
    args = [a for a in args if a not in ("--profile", "--sass")]
    only = ""
    if "--only" in args:
        i = args.index("--only")
        only = args[i + 1]
        del args[i:i + 2]
    root = args[0] if args else "."
    sys.path.insert(0, root)
    from deepseek_tpu_torch.models.kvcache import quantize_rows
    from deepseek_tpu_torch.ops.kernels import attention as A
    from deepseek_tpu_torch.ops.kernels import qmm as Q
    from deepseek_tpu_torch.quant.qtensor import Fp8Tensor, Q3KTensor

    if sass:
        return sass_mix(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"{root}: card {card}; torch {torch.__version__}", flush=True)
    flush = torch.empty(128 * 2**20, dtype=torch.float32, device="cuda")
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def report(name, fn, plain, nbytes, mma_flops=None, host=False):
        if not name.startswith(only):
            return
        err = rel_err(fn(), plain())
        extra = f", host {host_us(fn):.1f} us a call" if host else ""
        line = (f"{root} {name}: {time_ms(fn, flush):.4f} ms, rel err {err:.2e}, "
                f"byte floor {nbytes / HBM * 1e3:.4f} ms")
        if mma_flops is not None:
            line += f", split-operand MMA floor {mma_flops / BF16 * 1e3:.4f} ms"
        print(line + extra, flush=True)
        if profile:
            print(f"    kernels: {kernel_times(fn)}", flush=True)

    def kernel_times(fn, calls=5):
        """Mean device microseconds a call of each CUDA kernel ``fn`` launches."""
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                evict(flush)
                fn()
            torch.cuda.synchronize()
        out = []
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            if "at::" in ev.key or us == 0:
                continue
            out.append(f"{ev.key[:90]} {us / calls:.1f} us x{ev.count // calls}")
        return "; ".join(out)

    # K3 at V3's widths over the 4096-slot window
    H, R, P, S = 128, 512, 64, 4096
    scale = 1.0 / 192 ** 0.5
    qc = torch.randn((1, H, R), generator=g, device=dev)
    qr = torch.randn((1, H, P), generator=g, device=dev)
    rows = torch.randn((1, S, R + P), generator=g, device=dev) * 0.5
    q_bytes = 4 * H * (R + P)
    for tag in ("bf16", "f16", "f32", "int8"):
        if tag == "int8":
            (ckv, cs), (kr, rs) = quantize_rows(rows[..., :R]), quantize_rows(rows[..., R:])
            sc, row_b, passes = dict(ckv_scale=cs, krope_scale=rs), R + P + 8, 2
        else:
            dt = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}[tag]
            ckv, kr = rows[..., :R].to(dt).contiguous(), rows[..., R:].to(dt).contiguous()
            sc, row_b = {}, (R + P) * ckv.element_size()
            passes = 2 if tag == "bf16" else 3
        for kv in (4000, 32):
            kl = torch.tensor([kv], device=dev, dtype=torch.int32)
            report(f"K3 {tag} S={S} kv_len={kv} H={H}",
                   lambda: A.mla_decode_attn(qc, qr, ckv, kr, kl, scale, **sc),
                   lambda: A.mla_decode_attn_plain(qc, qr, ckv, kr, kl, scale,
                                                   sc.get("ckv_scale"),
                                                   sc.get("krope_scale")),
                   kv * row_b + q_bytes + 4 * H * R,
                   passes * 2.0 * H * kv * (2 * R + P),
                   host=tag == "bf16" and kv == 4000)
        if tag in ("bf16", "int8"):      # the partials body over one seq=2 shard
            half, kv_l = S // 2, 4000 - S // 2
            c_l, r_l = ckv[:, half:].contiguous(), kr[:, half:].contiguous()
            sc_l = {k: v[:, half:].contiguous() for k, v in sc.items()}
            kl = torch.tensor([kv_l], device=dev, dtype=torch.int32)
            report(f"K3-part {tag} S_local={half} kv_len_local={kv_l} H={H}",
                   lambda: A.mla_decode_attn(qc, qr, c_l, r_l, kl, scale, partials=True,
                                             **sc_l),
                   lambda: A.mla_decode_attn_plain(
                       qc, qr, c_l, r_l, kl, scale, sc_l.get("ckv_scale"),
                       sc_l.get("krope_scale"), partials=True),
                   kv_l * row_b + q_bytes + 4 * H * (R + 2),
                   passes * 2.0 * H * kv_l * (2 * R + P))
        del ckv, kr

    # K10 and K9 at the window's last chunk
    from deepseek_tpu_torch.ops.kernels import prefill_attn as PA
    T, q_pos0 = 256, S - 256
    pairs = sum(min(S, q_pos0 + t + 1) for t in range(T))
    qc_t = torch.randn((1, T, H, R), generator=g, device=dev) * 0.3
    qr_t = torch.randn((1, T, H, P), generator=g, device=dev) * 0.3
    ckv, kr = rows[..., :R].bfloat16().contiguous(), rows[..., R:].bfloat16().contiguous()
    report(f"K10 bf16 T={T} q_pos0={q_pos0} S={S} H={H}",
           lambda: PA.mla_prefill_attn(qc_t, qr_t, ckv, kr, q_pos0, 0, scale),
           lambda: PA.mla_prefill_attn_plain(qc_t, qr_t, ckv, kr, q_pos0, 0, scale),
           4 * T * H * (2 * R + P) + S * (R + P) * 2, 2 * 2.0 * pairs * H * (2 * R + P))
    del qc_t, qr_t, ckv, kr
    Dh, Dv = 192, 128
    for H2 in (H, 16):
        q = torch.randn((1, T, H2, Dh), generator=g, device=dev) * 0.3
        k = (torch.randn((1, S, H2, Dh), generator=g, device=dev) * 0.5).bfloat16()
        v = (torch.randn((1, S, H2, Dv), generator=g, device=dev) * 0.5).bfloat16()
        report(f"K9 bf16 T={T} q_pos0={q_pos0} S={S} H={H2} Dh={Dh} Dv={Dv}",
               lambda: PA.mha_prefill_attn(q, k, v, q_pos0, 0, 1.0 / Dh ** 0.5),
               lambda: PA.mha_prefill_attn_plain(q, k, v, q_pos0, 0, 1.0 / Dh ** 0.5),
               4 * T * H2 * (Dh + Dv) + S * H2 * (Dh + Dv) * 2,
               2 * 2.0 * pairs * H2 * (Dh + Dv))
        del q, k, v

    def fp8(E, d, n):
        lead = (E,) if E else ()
        data = torch.randn((*lead, d, n), generator=g, device=dev).to(torch.float8_e5m2)
        s = torch.rand((*lead, -(-d // 128), -(-n // 128)), generator=g, device=dev)
        return Fp8Tensor(data=data, scale=s * 0.015 + 0.005, block_size=(128, 128))

    def fp8_bytes(qt):
        return qt.data.numel() + 4 * qt.scale.numel()

    # K2's fp8 body: V2-Lite's folded tables, one token's 6 routed + 2 shared
    sel = torch.randperm(64, generator=g, device=dev)[:6].sort().values
    eids = torch.cat([sel, torch.arange(64, 66, device=dev)])
    for label, d, n in (("w13s", 2816, 2048), ("w2s", 2048, 1408)):
        qt = fp8(66, d, n)
        x = torch.randn((8, n), generator=g, device=dev)
        per = fp8_bytes(qt) / 66
        report(f"K2-fp8 V2-Lite {label} 8x{d}x{n}", lambda: Q.qmm_experts(qt, eids, x),
               lambda: Q.qmm_experts_plain(qt, eids, x),
               8 * per + 4 * 8 * (n + d))
        del qt

    # K5's fp8 matvec at one row: V2-Lite's attention projections
    for label, d, n in (("wq", 3072, 2048), ("wkv_a", 576, 2048),
                        ("wkv_b", 4096, 512), ("wo", 2048, 2048)):
        qt = fp8(0, d, n)
        x = torch.randn((1, n), generator=g, device=dev)
        report(f"K5-fp8 V2-Lite {label} 1x{d}x{n}", lambda: Q.qmm(qt, x),
               lambda: Q.qmm_plain(qt, x), fp8_bytes(qt) + 4 * (n + d))

    # K5's packed Q3_K matvec at one row: V3's attention projections
    def packed(d, n):
        def u8(cols):
            return torch.randint(0, 256, (d, cols), generator=g, device=dev,
                                 dtype=torch.uint8)
        sup = torch.rand((d, n // 256), generator=g, device=dev) * 0.009 + 0.001
        sc = torch.randint(-32, 32, (d, n // 16), generator=g, device=dev,
                           dtype=torch.int8)
        return Q3KTensor(qs=u8(n // 4), hm=u8(n // 8), d=sup, sc=sc)

    for label, d, n in (("wkvq", 2112, 7168), ("wcr", 73728, 1536), ("wo", 7168, 16384)):
        qt = packed(d, n)
        x = torch.randn((1, n), generator=g, device=dev)
        nb = sum(t.numel() * t.element_size() for t in (qt.qs, qt.hm, qt.d, qt.sc))
        report(f"K5-packed V3 {label} 1x{d}x{n}", lambda: Q.qmm(qt, x),
               lambda: Q.qmm_plain(qt, x), nb + 4 * (n + d))
        del qt
    return 0


if __name__ == "__main__":
    sys.exit(main())
