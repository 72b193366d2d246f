"""K5's and K2's packed Q2_K/Q3_K matvec timed at DeepSeek-V3's shapes,
for one checkout of the PyTorch/CUDA port (one GPU).

    python scripts/torch_packed_mv.py [ROOT] [--only PREFIX] [--profile] [--sass]
    python scripts/torch_packed_mv.py --ablate

ROOT is the root of the checkout whose ``deepseek_tpu_torch`` is timed
(default: this one). To compare two commits on one card, unpack the other
with ``git archive`` into a directory that ``.gitignore`` lists and run the
script once for each tree in one call, parent, change, change, parent, then
the benchmark's traced run of the packed V3 cell (``python3 gpubench/run.py
--workload v3-q3k.serve --seed N --seconds S --trace 1``) from each tree for
the decode steps:

    git archive HEAD~1 | (mkdir -p build/parent && tar -x -C build/parent)
    for r in build/parent . . build/parent; do python scripts/torch_packed_mv.py $r; done

``--ablate`` (this tree only) builds variants of ``csrc/packed_mv.cu``
with one piece of work taken out, each a text substitution checked to
apply (their results are wrong by design), and prints each one's call
time and the matvec kernel's own device time at Q3_K wkvq and dense w13
(one row) and w13 at 4 rows: where the time goes.
``--only`` keeps the rows whose name starts with PREFIX (e.g. ``K2``);
``--profile`` adds, for each row, the mean device time of every CUDA
kernel one call launches (``torch.profiler``: the matvec and, in this
tree, its x pre-pass; K2 in the parent also an int64 -> int32 cast of the
ids); ``--sass`` prints the static instruction mix of the packed matvec
at one x row in the built library (``cuobjdump -sass``: this tree's
``packed_mv_kernel``, whose unrolled step handles 2 rows x 256 weights a
lane, or the parent's ``packed_matvec_kernel`` at 32 lanes a row, whose
unrolled step handles 4 rows x 64 weights) and exits.

The inputs are random planes drawn on the card from a seed, the same for
every tree, in the ranges of models/testing.py: K5 at one row over V3's
wkvq (2112 x 7168), wcr (73728 x 1536), wo (7168 x 16384), the dense w13
(36864 x 7168) and w2 (7168 x 18432) and the lm_head (129280 x 7168), and
over w13 at 2, 3 and 4 rows; K2 over one token's 8 routed experts of 32
w13s (4096 x 7168) and w2s (7168 x 2048) tables and the per-head wv_b (128
heads of 128 x 512), int64 ids as the model's top-k gives them. Each row
prints the call's mean device time, its max abs error against the plain
version as a fraction of max|ref| and its byte floor: the planes the call
reads (each expert once), x and y, at 3.35 TB/s. Each timed call follows
a 512 MB read that evicts the L2 and a device spin. Needs a CUDA GPU;
exits 2 without one.
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
    """The opcode counts of the packed matvec at one x row, Q3_K and Q2_K,
    in the built library of this checkout."""
    from deepseek_tpu_torch.ops.kernels import build
    lib = "packed_mv" if "packed_mv" in build.SIGNATURES else "qmm"
    build.build_all([lib])
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(build._target(lib))],
                          capture_output=True, text=True, check=True).stdout
    if lib == "packed_mv":     # <Q3, NB = 1, K5>: a step is 2 rows x 256 weights a lane
        kernels = {"Q3_K": "packed_mv_kernelILb1ELi1ELb0E",
                   "Q2_K": "packed_mv_kernelILb0ELi1ELb0E"}
        per_step = 2 * 256
    else:                      # <LPR 32, Q3>: a quad step is 4 rows x 64 weights a lane
        kernels = {"Q3_K": "packed_matvec_kernelILi32ELb1E",
                   "Q2_K": "packed_matvec_kernelILi32ELb0E"}
        per_step = 4 * 64
    for quant, key in kernels.items():
        body, inside = [], False
        for line in text.splitlines():
            if "Function :" in line:
                inside = key in line
            elif inside:
                m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
                if m:
                    body.append(m.group(1))
        mix = collections.Counter(op.split(".")[0] for op in body)
        print(f"{root} {quant} {key}: {len(body)} instructions, "
              f"{len(body) / per_step:.2f} a weight over one unrolled step of "
              f"{per_step} weights a lane; " + ", ".join(f"{k} {v}" for k, v in mix.most_common()),
              flush=True)
    return 0


# (name, [(text in csrc/packed_mv.cu, its replacement), ...])
ABLATIONS = [
    ("no x-term loads", [(
        """    t.a[bb] = terms[((2 * xr) * 16 + j) * nsb + sb];
    t.b[bb] = terms[((2 * xr + 1) * 16 + j) * nsb + sb];
    t.s[bb] = aux[(xr * 16 + j) * nsb + sb];""",
        """    t.a[bb] = make_uint4(j, sb, xr, 7);
    t.b[bb] = make_uint4(sb, j, 3, xr);
    t.s[bb] = make_float2(1e-3f * j, 1.f);""")]),
    ("trivial unpack", [(
        """__device__ __forceinline__ void unpack(uint32_t t, uint32_t h, uint32_t u[4]) {""",
        """__device__ __forceinline__ void unpack(uint32_t t, uint32_t h, uint32_t u[4]) {
  if (true) { u[0] = t; u[1] = t >> 2; u[2] = t >> 4; u[3] = h; return; }""")]),
    ("dp4a as IMAD", [("__dp4a(", "imad4("), (
        """// Q3_K's high bits of 4 groups""",
        """__device__ __forceinline__ int imad4(int a, int b, int c) { return a * b + c; }

// Q3_K's high bits of 4 groups""")]),
    ("plane loads alone", [(
        """      float part[kPkRows][NB], pmin[kPkRows][NB];""",
        """      uint32_t xo = 0;
#pragma unroll
      for (int rr = 0; rr < kPkRows; ++rr) {
#pragma unroll
        for (int jq = 0; jq < 4; ++jq) xo ^= st.q[rr][jq].x ^ st.q[rr][jq].w;
        xo ^= st.h[rr][0].x ^ st.h[rr][1].y ^ st.sc[rr].z ^ __float_as_uint(st.dv[rr]);
      }
      acc[0][0] += __uint_as_float(xo & 0x3fffffffu);
      if (true) continue;
      float part[kPkRows][NB], pmin[kPkRows][NB];""")]),
    ("matvec returns after the wait", [(
        """  const int warps = gridDim.x * (kPkThreads / 32);
  bool waited = false;""",
        """  const int warps = gridDim.x * (kPkThreads / 32);
  bool waited = false;
  if (true) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    if (threadIdx.x == 0) y[blockIdx.x] = 0.f;
    return;
  }""")]),
]
ABLATIONS.append(("one empty launch, no pre-pass", ABLATIONS[-1][1] + [(
    """  cudaError_t err = launch_xsplit(x, x_dtype, 0, terms, aux, groups, n, 4, kind == 0, st);""",
    "  cudaError_t err = cudaSuccess;")]))


def ablate(flush) -> int:
    """Build and time each of ABLATIONS beside the unchanged kernel."""
    import ctypes
    from pathlib import Path
    from torch.profiler import ProfilerActivity, profile
    from deepseek_tpu_torch.ops.kernels import build
    from deepseek_tpu_torch.ops.kernels import qmm as Q
    from deepseek_tpu_torch.quant.qtensor import Q3KTensor

    src = (build.CSRC / "packed_mv.cu").read_text()
    # the shared pre-pass header inline, so that a substitution may reach it
    src = src.replace('#include "xsplit.cuh"', (build.CSRC / "xsplit.cuh").read_text())
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, subs) in enumerate([("unchanged", [])] + ABLATIONS):
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"ablation {name!r}: its text is not in packed_mv.cu")
            text = text.replace(old, new)
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)]
        procs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs = []
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablation {name!r} does not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.packed_mv.argtypes = build.SIGNATURES["packed_mv"]["packed_mv"]
        lib.packed_mv.restype = ctypes.c_int
        libs.append((name, lib))
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, d, n, rows in (("wkvq", 2112, 7168, 1), ("w13", 36864, 7168, 1),
                              ("w13", 36864, 7168, 4)):
        u8 = lambda c: torch.randint(0, 256, (d, c), generator=g, device="cuda",
                                     dtype=torch.uint8)
        qt = Q3KTensor(qs=u8(n // 4), hm=u8(n // 8), d=torch.rand((d, n // 256), generator=g,
                                                                 device="cuda") * 0.009 + 0.001,
                       sc=torch.randint(-32, 32, (d, n // 16), generator=g, device="cuda",
                                        dtype=torch.int8))
        x = torch.randn((rows, n), generator=g, device="cuda")
        for name, lib in libs:
            def call():
                y = torch.empty((rows, d), device="cuda")
                scratch = torch.empty(rows * (n // 16) * 40, dtype=torch.uint8, device="cuda")
                err = lib.packed_mv(x.data_ptr(), 0, *Q._packed_ptrs(qt), None, 0,
                                    scratch.data_ptr(), y.data_ptr(), rows, d, n,
                                    Q.packed_lanes(n), Q.packed_warps(rows, d, n, sms),
                                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"ablation {name!r}: CUDA error {err}")
            ms = time_ms(call, flush)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    evict(flush)
                    call()
                torch.cuda.synchronize()
            mv = sum(getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
                     for ev in prof.key_averages() if "packed_mv_kernel" in ev.key) / 5
            print(f"ablate Q3_K {label} {rows}x{d}x{n} {name}: call {ms:.4f} ms, matvec kernel "
                  f"{mv:.1f} us", flush=True)
        del qt
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_packed_mv: no CUDA GPU visible", file=sys.stderr)
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
    from deepseek_tpu_torch.quant.qtensor import Q2KTensor, Q3KTensor

    if sass:
        return sass_mix(root)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"{root}: card {card}; torch {torch.__version__}", flush=True)
    flush = torch.empty(128 * 2**20, dtype=torch.float32, device="cuda")
    if abl:
        return ablate(flush)
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def packed(quant, lead, d, n):
        u8 = lambda c: torch.randint(0, 256, (*lead, d, c), generator=g, device=dev,
                                     dtype=torch.uint8)
        sup = lambda: torch.rand((*lead, d, n // 256), generator=g, device=dev) * 0.009 \
            + 0.001
        if quant == "Q2_K":
            return Q2KTensor(qs=u8(n // 4), sm=u8(n // 16), d=sup(), dmin=sup())
        sc = torch.randint(-32, 32, (*lead, d, n // 16), generator=g, device=dev,
                           dtype=torch.int8)
        return Q3KTensor(qs=u8(n // 4), hm=u8(n // 8), sc=sc, d=sup())

    def report(name, fn, plain, nbytes):
        if not name.startswith(only):
            return
        got, want = fn(), plain()
        err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        ms, floor = time_ms(fn, flush), nbytes / HBM * 1e3
        print(f"{root} {name}: {ms:.4f} ms, rel err {err:.2e}, byte floor {floor:.4f} ms "
              f"({floor / ms:.0%})", flush=True)
        if profile:
            print(f"    kernels: {kernel_times(fn, flush)}", flush=True)

    for quant in ("Q3_K", "Q2_K"):
        for label, d, n, rows_list in (("wkvq", 2112, 7168, (1,)),
                                       ("wcr", 73728, 1536, (1,)),
                                       ("wo", 7168, 16384, (1,)),
                                       ("w13", 36864, 7168, (1, 2, 3, 4)),
                                       ("w2", 7168, 18432, (1,)),
                                       ("lm_head", 129280, 7168, (1,))):
            qt = packed(quant, (), d, n)
            for rows in rows_list:
                x = torch.randn((rows, n), generator=g, device=dev)
                report(f"K5-packed {quant} {label} {rows}x{d}x{n}", lambda: Q.qmm(qt, x),
                       lambda: Q.qmm_plain(qt, x), qt.nbytes_active + 4 * rows * (n + d))
            del qt
        for label, E, d, n, pairs in (("w13s", 32, 4096, 7168, 8), ("w2s", 32, 7168, 2048, 8),
                                      ("wv_b", 128, 128, 512, 128)):
            qt = packed(quant, (E,), d, n)
            ids = torch.arange(E, device=dev) if pairs == E else \
                torch.randperm(E, generator=g, device=dev)[:pairs].sort().values
            x = torch.randn((pairs, n), generator=g, device=dev)
            per = qt.nbytes_active // E
            report(f"K2-packed {quant} {label} {pairs}x{d}x{n}",
                   lambda: Q.qmm_experts(qt, ids, x), lambda: Q.qmm_experts_plain(qt, ids, x),
                   per * ids.unique().numel() + 4 * pairs * (n + d))
            del qt
    return 0


if __name__ == "__main__":
    sys.exit(main())
