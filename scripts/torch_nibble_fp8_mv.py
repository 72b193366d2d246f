"""The nibble matvec (K1, K2's nibble bodies) and K5's fp8 matvec timed at
DeepSeek-V3's and DeepSeek-V2-Lite's shapes, for one checkout of the
PyTorch/CUDA port (one GPU), with K4's f16 lm_head as an unchanged control.

    python scripts/torch_nibble_fp8_mv.py [ROOT] [--only A|B|K4] [--profile] [--sass]
    python scripts/torch_nibble_fp8_mv.py --ablate

ROOT is the root of the checkout whose ``deepseek_tpu_torch`` is timed
(default: this one). To compare two commits on one card, unpack the other
with ``git archive`` into a directory that ``.gitignore`` lists and run the
script once for each tree in one call, parent, change, change, parent, then
``scripts/torch_profile_decode.py`` (the V3 nibble model) and ``--model
v2-lite-fp8`` from each tree for the decode steps:

    git archive HEAD~1 | (mkdir -p build/parent && tar -x -C build/parent)
    for r in build/parent . . build/parent; do python scripts/torch_nibble_fp8_mv.py $r; done

Rows: "A" K1 over V3's nibble wkvq (2112 x 7168), wcr (73728 x 1536), wo
(7168 x 16384), the dense w13 (36864 x 7168, at 1 to 4 rows) and w2 (7168 x
18432) and the lm_head (129280 x 7168), Q3_K and Q2_K, and K2 over one
token's 9 pairs (8 routed + 1 shared, one repeated) of 32-expert w13s
(4096 x 7168) and w2s (7168 x 2048) tables, the per-head wv_b (128 heads
of 128 x 512) and the prepermuted w2s; "B" K5 over V2-Lite's F8E5M2 wq
(3072 x 2048), wkv_a (576 x 2048), wkv_b (4096 x 512), wo (2048 x 2048),
the dense w13 (21888 x 2048) and w2 (2048 x 10944) and the lm_head (102400
x 2048, at 1 to 4 rows), 128x128 blocks; "K4" the f16 lm_head (102400 x
2048) through K4. x is f32 (what the parent's kernels read) unless a row
says bf16 (the cells' compute dtype: the parent casts it in a launch of
its own, this tree reads it as it is). Each row prints the call's mean
device time over 20 calls, each after a 512 MB read that evicts the L2 and
a device spin, its max abs error against the plain version as a fraction
of max|ref|, and its byte floor (the weight's bytes for the experts it
reads, x and y, at 3.35 TB/s). ``--only`` keeps one group; ``--profile``
adds each call's kernels and their mean device times (torch.profiler);
``--sass`` prints the static instruction mix of the matvecs in the built
library (cuobjdump) and exits. ``--ablate`` (this tree only) builds
variants of ``csrc/nibble_mv.cu`` or ``csrc/fp8_mv.cu`` with one piece of
work taken out (each a
text substitution checked to apply; their results are wrong by design) or
prints each one's call time and its matvec kernel's own
device time at a few shapes: where the time goes. Needs a CUDA GPU; exits
2 without one.
"""

import collections
import re
import subprocess
import sys

import torch

HBM = 3.35e12       # bytes/s, the H100 SXM's published rate


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


def kernel_times(fn, flush, calls=5):
    """Mean device microseconds a call of each CUDA kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            evict(flush)
            fn()
        torch.cuda.synchronize()
    out = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us == 0 or "reduce_kernel" in ev.key or "Memset" in ev.key:   # the eviction's sum
            continue
        out.append(f"{ev.key[:90]} {us / calls:.1f} us x{ev.count / calls:g}")
    return "; ".join(out)


def sass_mix(root) -> int:
    """The opcode counts of the matvecs in this checkout's built libraries:
    this tree's nib_mv_kernel (a step: one row x 256 weights a lane) and
    fp8_mv_kernel at 128-column blocks (a step, one row x 8 words, is
    inlined four times, for each word buffer with and without a guard a
    word: 128 weights a lane), or the parent's
    knib_matvec_kernel (32 lanes a row: a quad step is 4 rows x 64 weights
    a lane) and plain_mv_kernel<uint8_t, 1> (2 steps of 4 rows x 16
    weights a lane)."""
    from deepseek_tpu_torch.ops.kernels import build
    if "nibble_mv" in build.SIGNATURES:
        libs = {"nibble_mv": {"A Q3_K nib_mv_kernel<false, 1 row>":
                              ("nib_mv_kernelILb0ELi1ELb0E", 256),
                              "A Q2_K nib_mv_kernel<true, 1 row>":
                              ("nib_mv_kernelILb1ELi1ELb0E", 256),
                              "A Q3_K nib_mv_kernel<false, 4 rows>":
                              ("nib_mv_kernelILb0ELi4ELb0E", 256)},
                "fp8_mv": {"B fp8_mv_kernel<f32, 1 row, B128>": ("fp8_mv_kernelILi0ELi1ELb1E", 128),
                           "B fp8_mv_kernel<bf16, 1 row, B128>": ("fp8_mv_kernelILi2ELi1ELb1E", 128),
                           "B fp8_mv_kernel<f32, 4 rows, B128>": ("fp8_mv_kernelILi0ELi4ELb1E", 128)}}
    else:
        libs = {"qmm": {"A Q3_K knib_matvec_kernel<32, false>":
                        ("knib_matvec_kernelILi32ELb0ELb0E", 256),
                        "A Q2_K knib_matvec_kernel<32, true>":
                        ("knib_matvec_kernelILi32ELb1ELb0E", 256),
                        "B plain_mv_kernel<uint8_t, 1>": ("plain_mv_kernelIhLi1E", 128)}}
    for lib, kernels in libs.items():
        sass_lib(build, root, lib, kernels)
    return 0


def sass_lib(build, root, lib, kernels):
    """Print the opcode counts of ``kernels`` ({label: (mangled-name key,
    weights a lane an unrolled step)}) in the built library ``lib``."""
    build.build_all([lib])
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(build._target(lib))],
                          capture_output=True, text=True, check=True).stdout
    for label, (key, per_step) in kernels.items():
        body, inside = [], False
        for line in text.splitlines():
            if "Function :" in line:
                inside = key in line
            elif inside:
                m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
                if m:
                    body.append(m.group(1))
        mix = collections.Counter(op.split(".")[0] for op in body)
        print(f"{root} {label}: {len(body)} instructions, {len(body) / per_step:.2f} a weight "
              f"over one unrolled step of {per_step} weights a lane; "
              + ", ".join(f"{k} {v}" for k, v in mix.most_common(14)), flush=True)
    return 0


# (name, library, [(text in its source, the replacement), ...]); each builds
# a variant of the library with one piece of work taken out (its results
# are wrong by design)
ABLATIONS = [
    ("A: no x-term loads", "nibble_mv", [(
        """    t.a[bb] = terms[((2 * xr) * 16 + j) * nsb + sb];
    t.b[bb] = terms[((2 * xr + 1) * 16 + j) * nsb + sb];
    t.s[bb] = aux[(xr * 16 + j) * nsb + sb];""",
        """    t.a[bb] = make_uint4(j, sb, xr, 7);
    t.b[bb] = make_uint4(sb, j, 3, xr);
    t.s[bb] = make_float2(1e-3f * j, 1.f);""")]),
    ("A: dp4a as IMAD", "nibble_mv", [("__dp4a(", "imad4("), (
        """// one step's slabs: a superblock of one row""",
        """__device__ __forceinline__ int imad4(int a, int b, int c) { return a * b + c; }

// one step's slabs: a superblock of one row""")]),
    ("A: plane loads alone", "nibble_mv", [(
        """      XTerms<NB> xt;
      if (kAhead) load_x<NB, EXPERTS>(xt, terms, aux, b, 0, sb, nsb);""",
        """      {
        uint32_t xo = st.a[0].x ^ st.a[1].w;
#pragma unroll
        for (int o = 0; o < 8; ++o) xo ^= st.q[o].x ^ st.q[o].y ^ st.q[o].z ^ st.q[o].w;
        acc[0] += __uint_as_float(xo & 0x3fffffffu);
        if (true) continue;
      }
      XTerms<NB> xt;
      if (kAhead) load_x<NB, EXPERTS>(xt, terms, aux, b, 0, sb, nsb);""")]),
    ("B: no x loads", "fp8_mv", [
        ("const float4 xv = x_word<XK>(xb[b] + 128 * k * kX);",
         "const float4 xv = make_float4(1.f, 2.f, 3.f, (float)k);")]),
    ("B: weight loads alone", "fp8_mv", [
        ("    if (k < live) {\n      const float sc",
         "    if (k < live) acc[0] += __uint_as_float(u[k] & 0x3fffffffu);\n"
         "    if (false) {\n      const float sc")]),
]


def ablate(flush, nibble, fp8) -> int:
    """Build and time each of ABLATIONS beside the unchanged kernels: the
    call's time and its matvec kernel's own (torch.profiler) at Q3_K w13
    and the lm_head (one row), K2's w2s (9 pairs), fp8 wkv_a, w13 and lm_head."""
    import ctypes
    from deepseek_tpu_torch.ops.kernels import build
    from deepseek_tpu_torch.ops.kernels import qmm as Q
    from torch.profiler import ProfilerActivity, profile

    build.build_all(["nibble_mv", "fp8_mv"])
    out_dir = build.BUILD_DIR / "ablate_mv"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    variants = [("unchanged A", "nibble_mv", []), ("unchanged B", "fp8_mv", [])] + ABLATIONS
    for i, (name, lib_name, subs) in enumerate(variants):
        text = (build.CSRC / f"{lib_name}.cu").read_text()
        # the shared pre-pass header inline, so that a substitution may reach it
        text = text.replace('#include "xsplit.cuh"', (build.CSRC / "xsplit.cuh").read_text())
        for old, new in (subs if isinstance(subs, list) else []):
            if old not in text:
                raise RuntimeError(f"ablation {name!r}: its text is not in {lib_name}.cu")
            text = text.replace(old, new)
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)]
        procs.append((name, lib_name, subs, so,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)))
    libs = []
    for name, lib_name, subs, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablation {name!r} does not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in build.SIGNATURES[lib_name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs.append((name, lib_name, subs, lib))
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    cases = []
    for label, d, n in (("Q3_K w13", 36864, 7168), ("Q3_K lm_head", 129280, 7168)):
        qt = nibble("Q3_K", (), d, n)
        x = torch.randn((1, n), generator=g, device="cuda")
        cases.append(("A", f"K1 {label} 1x{d}x{n}", (lambda qt=qt, x=x: Q.qmm(qt, x))))
    qt = nibble("Q3_K", (32,), 7168, 2048)
    ids = torch.arange(9, device="cuda")
    x9 = torch.randn((9, 2048), generator=g, device="cuda")
    cases.append(("A", "K2 Q3_K w2s 9x7168x2048", lambda: Q.qmm_experts(qt, ids, x9)))
    for label, d, n in (("wkv_a", 576, 2048), ("w13", 21888, 2048), ("lm_head", 102400, 2048)):
        w = fp8(d, n)
        x = torch.randn((1, n), generator=g, device="cuda")
        cases.append(("B", f"K5 fp8 {label} 1x{d}x{n}", (lambda w=w, x=x: Q.qmm(w, x))))
    for name, lib_name, subs, lib in libs:
        saved = build.library(lib_name)
        build._libs[lib_name] = lib
        for kind, label, fn in cases:
            if kind != name.split()[-1][0] and not name.startswith(kind + ":"):
                continue
            ms = time_ms(fn, flush)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    evict(flush)
                    fn()
                torch.cuda.synchronize()
            us = sum(getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
                     for ev in prof.key_averages()
                     if "nib_mv_kernel" in ev.key or "fp8_mv_kernel" in ev.key) / 5
            print(f"ablate {label} {name}: call {ms:.4f} ms, matvec kernel {us:.1f} us",
                  flush=True)
        build._libs[lib_name] = saved
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_nibble_fp8_mv: no CUDA GPU visible", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    profile, sass, abl = "--profile" in args, "--sass" in args, "--ablate" in args
    args = [a for a in args if a not in ("--profile", "--sass", "--ablate")]
    only = ""
    if "--only" in args:
        i = args.index("--only")
        only = args[i + 1]
        del args[i:i + 2]
    root = args[0] if args else "."
    sys.path.insert(0, root)
    from deepseek_tpu_torch.ops.kernels import qmm as Q
    from deepseek_tpu_torch.quant.qtensor import (
        Fp8Tensor, KNibbleTensor, PlainTensor, perm_x,
    )

    if sass:
        return sass_mix(root)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"{root}: card {card}; torch {torch.__version__}", flush=True)
    flush = torch.empty(128 * 2**20, dtype=torch.float32, device="cuda")
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def nibble(quant, lead, d, n):
        p = torch.randint(0, 256, (*lead, d, n // 2), generator=g, device=dev,
                          dtype=torch.uint8)
        a = (torch.rand((*lead, d, n // 16), generator=g, device=dev) * 0.009
             + 0.001).to(torch.bfloat16)
        if quant == "Q2_K":
            c = (torch.rand((*lead, d, n // 16), generator=g, device=dev) * 0.0045
                 + 0.0005).to(torch.bfloat16)
            return KNibbleTensor(p=p, a=a, c=c, off=0)
        return KNibbleTensor(p=p, a=a, c=None, off=4)

    def fp8(d, n):
        data = torch.randn((d, n), generator=g, device=dev).to(torch.bfloat16) \
            .to(torch.float8_e5m2)
        sc = torch.rand((-(-d // 128), -(-n // 128)), generator=g, device=dev) * 0.015 + 0.005
        return Fp8Tensor(data=data, scale=sc, block_size=(128, 128))

    if abl:
        return ablate(flush, nibble, fp8)

    def report(group, name, fn, plain, nbytes):
        if not group.startswith(only):
            return
        got, want = fn(), plain()
        err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        ms, floor = time_ms(fn, flush), nbytes / HBM * 1e3
        print(f"{root} {name}: {ms:.4f} ms, rel err {err:.2e}, byte floor {floor:.4f} ms "
              f"({floor / ms:.0%})", flush=True)
        if profile:
            print(f"    kernels: {kernel_times(fn, flush)}", flush=True)

    if "A".startswith(only):
        for quant in ("Q3_K", "Q2_K"):
            for label, d, n, rows_list in (("wkvq", 2112, 7168, (1,)),
                                           ("wcr", 73728, 1536, (1,)),
                                           ("wo", 7168, 16384, (1,)),
                                           ("w13", 36864, 7168, (1, 2, 3, 4)),
                                           ("w2", 7168, 18432, (1,)),
                                           ("lm_head", 129280, 7168, (1,))):
                qt = nibble(quant, (), d, n)
                for rows in rows_list:
                    x = torch.randn((rows, n), generator=g, device=dev)
                    report("A", f"K1 {quant} {label} {rows}x{d}x{n}", lambda: Q.qmm(qt, x),
                           lambda: Q.qmm_plain(qt, x), qt.nbytes_active + 4 * rows * (n + d))
                    if label == "w13" and rows == 1:
                        xb = x.to(torch.bfloat16)
                        report("A", f"K1 {quant} {label} {rows}x{d}x{n} bf16 x",
                               lambda: Q.qmm(qt, xb), lambda: Q.qmm_plain(qt, xb),
                               qt.nbytes_active + 2 * rows * n + 4 * rows * d)
                del qt
            for label, E, d, n, perm in (("w13s", 32, 4096, 7168, False),
                                         ("w2s", 32, 7168, 2048, False),
                                         ("w2s prepermuted", 32, 7168, 2048, True),
                                         ("wv_b", 128, 128, 512, False)):
                qt = nibble(quant, (E,), d, n)
                if E == 128:
                    ids = torch.arange(E, device=dev)
                else:
                    sel = torch.randperm(E, generator=g, device=dev)[:8].sort().values
                    ids = torch.cat([sel, sel[:1]])          # 9 pairs, one repeated
                x = torch.randn((ids.numel(), n), generator=g, device=dev)
                if perm:
                    x = perm_x(x).contiguous()
                per = qt.nbytes_active // E
                report("A", f"K2 {quant} {label} {ids.numel()}x{d}x{n}",
                       lambda: Q.qmm_experts(qt, ids, x, x_prepermuted=perm),
                       lambda: Q.qmm_experts_plain(qt, ids, x, x_prepermuted=perm),
                       per * ids.unique().numel() + 4 * ids.numel() * (n + d))
                del qt
    if "B".startswith(only):
        for label, d, n, rows_list in (("wq", 3072, 2048, (1,)), ("wkv_a", 576, 2048, (1,)),
                                       ("wkv_b", 4096, 512, (1,)), ("wo", 2048, 2048, (1,)),
                                       ("w13", 21888, 2048, (1,)), ("w2", 2048, 10944, (1,)),
                                       ("lm_head", 102400, 2048, (1, 2, 3, 4))):
            qt = fp8(d, n)
            nb = qt.data.numel() + 4 * qt.scale.numel()
            for rows in rows_list:
                x = torch.randn((rows, n), generator=g, device=dev)
                report("B", f"K5 fp8 {label} {rows}x{d}x{n}", lambda: Q.qmm(qt, x),
                       lambda: Q.qmm_plain(qt, x), nb + 4 * rows * (n + d))
                if rows == 1:
                    xb = x.to(torch.bfloat16)
                    report("B", f"K5 fp8 {label} {rows}x{d}x{n} bf16 x", lambda: Q.qmm(qt, xb),
                           lambda: Q.qmm_plain(qt, xb), nb + 2 * rows * n + 4 * rows * d)
            del qt
    if "K4".startswith(only):
        w = PlainTensor(data=torch.randn((102400, 2048), generator=g, device=dev)
                        .to(torch.float16) * 0.02)
        x = torch.randn((1, 2048), generator=g, device=dev)
        report("K4", "K4 f16 lm_head 1x102400x2048", lambda: Q.qmm(w, x),
               lambda: Q.qmm_fp_plain(w, x), w.data.numel() * 2 + 4 * (2048 + 102400))
    return 0


if __name__ == "__main__":
    sys.exit(main())
