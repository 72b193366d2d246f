"""Batched decode past one row, timed for one checkout of the PyTorch/CUDA
port (one GPU): K8's span plan and the decode step's projections.

    python scripts/torch_decode_rows.py [ROOT] [--only K8|steps]

ROOT is the root of the checkout whose ``deepseek_tpu_torch`` is timed
(default: this one); unpack another commit with ``git archive`` into a
directory that ``.gitignore`` lists and run the script once for each tree
in one call (parent, change, change, parent) to compare them on one card.
The inputs are drawn from a seed, the same for every tree:

- K8 (``mha_decode_attn``) over a 4096-slot cache at DeepSeek-V2-Lite's 16
  heads (Dh 192, Dv 128) at B = 1 and 4, every row at kv_len 4000, bf16
  and int8 rows, and its partials body over a seq=2 shard (S_local 2048,
  kv_len 1952): the mean device time of a call (a device spin and a 512 MB
  write that evicts the L2 before each, as ``chip_smoke.py`` times), the
  span plan (``decode_splits``), the byte bound (each cache row read once
  at 3.35 TB/s) and the max abs error against the plain version as a
  fraction of max|ref|;
- the decode step (``forward_decode``) at B = 4 and 8 on DeepSeek-V3's
  widths in packed Q3_K cut to 4 layers and on DeepSeek-V2-Lite's in
  F8E5M2 cut to 2 (``chip_smoke.py::mesh_model``'s draws: f32 compute, a
  bf16 cache, rows at positions 300, 350, ...): the median wall of 20
  steps (the card synchronized around each) and the device-busy time a
  step (the profiler's kernel time over 20 more steps), with the launches
  of each wrapper a step.

Needs a CUDA GPU; exits 2 without one.
"""

import math
import sys
import time

import numpy as np
import torch

STEPS = 20
HBM = 3.35e12                     # bytes/s, the H100 SXM's data sheet


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


def k8(root, evict):
    from deepseek_tpu_torch.ops.kernels.attention import (
        decode_splits, mha_decode_attn, mha_decode_attn_plain)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    H, Dh, Dv = 16, 192, 128
    scale = 1 / math.sqrt(Dh)
    for B, S, kv, partials in ((1, 4096, 4000, False), (4, 4096, 4000, False),
                               (1, 2048, 1952, True), (4, 2048, 1952, True)):
        q = torch.randn((B, H, Dh), generator=g, device="cuda")
        k = (torch.randn((B, S, H, Dh), generator=g, device="cuda") * 0.3).to(torch.bfloat16)
        v = torch.randn((B, S, H, Dv), generator=g, device="cuda").to(torch.bfloat16)
        k8_ = torch.randint(-127, 128, (B, S, H, Dh), generator=g, device="cuda",
                            dtype=torch.int8)
        v8 = torch.randint(-127, 128, (B, S, H, Dv), generator=g, device="cuda",
                           dtype=torch.int8)
        ks = (torch.rand((B, S, H), generator=g, device="cuda") * 0.02 + 0.001).transpose(1, 2)
        vs = (torch.rand((B, S, H), generator=g, device="cuda") * 0.02 + 0.001).transpose(1, 2)
        kl = torch.full((B,), kv, device="cuda", dtype=torch.int32)
        plan = decode_splits(B, H, S)
        tag = " partials" if partials else ""
        for dt, args, kw, per in (
                ("bf16", (q, k, v, kl, scale), {}, 2 * (Dh + Dv)),
                ("int8", (q, k8_, v8, kl, scale), dict(k_scale=ks, v_scale=vs),
                 Dh + Dv + 8)):
            fn = lambda: mha_decode_attn(*args, **kw, partials=partials)      # noqa: E731
            ref = mha_decode_attn_plain(*args, kw.get("k_scale"), kw.get("v_scale"),
                                        partials=partials)
            bound = B * kv * H * per / HBM * 1e3
            print(f"{root} K8{tag} {dt} B={B} H={H} S={S} kv_len={kv}: "
                  f"{time_ms(fn, evict):.4f} ms, bound {bound:.4f} ms (bytes), splits "
                  f"{plan}, rel err {rel_err(fn(), ref):.2e}", flush=True)
        del q, k, v, k8_, v8, ks, vs


def steps(root):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepseek_tpu_torch.config import QuantKind
    from deepseek_tpu_torch.models.deepseek import forward_decode
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.models.testing import (
        deepseek_v2_lite_proportions, deepseek_v3_proportions, random_fp8_params,
        random_fused_params)
    from deepseek_tpu_torch.ops.kernels import qmm as kq
    from deepseek_tpu_torch.ops.kernels import attention as ka

    wrappers = {"K5-packed": kq.qmm_packed, "K5r-packed": kq.qmm_packed_rows,
                "K5-fp8": kq.qmm_fp8, "K5r-fp8": kq.qmm_fp8_rows,
                "K2-packed": kq.qmm_experts_packed, "K2-fp8": kq.qmm_experts_fp8,
                "K3": ka.mla_decode_attn, "K8": ka.mha_decode_attn}
    for model in ("v3", "v2"):
        if model == "v3":
            cfg = deepseek_v3_proportions(n_layers=4, compute_dtype="float32",
                                          kv_cache_dtype="bfloat16")
            params = random_fused_params(cfg, "q3_k", seed=0, device="cuda")
            label = "V3 packed Q3_K, 4 layers"
        else:
            cfg = deepseek_v2_lite_proportions(
                n_layers=2, weight_quant=QuantKind.F8E5M2, block_size=(128, 128),
                compute_dtype="float32", kv_cache_dtype="bfloat16")
            params = random_fp8_params(cfg, seed=0, device="cuda")
            label = "V2-Lite F8E5M2, 2 layers"
        for B in (4, 8):
            cache = init_cache(cfg, batch=B, device="cuda")
            tok = torch.full((B, 1), 7, dtype=torch.int64, device="cuda")
            pos = 300 + 50 * np.arange(B)
            walls = []
            with torch.inference_mode():
                for i in range(STEPS + 2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    forward_decode(params, cache, tok, pos + i, cfg)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                before = {k: w.launches for k, w in wrappers.items()}
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for i in range(STEPS):
                        forward_decode(params, cache, tok, pos + STEPS + 2 + i, cfg)
                    torch.cuda.synchronize()
            # device-kernel rows only: an aten op's row repeats the device
            # time of the kernels it launched
            busy = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                       if getattr(e, "device_type", None) == DeviceType.CUDA)
            launched = {k: (w.launches - before[k]) / STEPS for k, w in wrappers.items()
                        if w.launches > before[k]}
            print(f"{root} decode step {label} B={B}: wall median "
                  f"{1e3 * float(np.median(walls[2:])):.3f} ms (min "
                  f"{1e3 * min(walls[2:]):.3f}), device busy {busy / 1e3 / STEPS:.3f} ms a "
                  f"step; launches a step {launched}", flush=True)
            del cache
        del params
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_decode_rows: no CUDA GPU visible", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    only = None
    if "--only" in args:
        i = args.index("--only")
        only = args[i + 1]
        del args[i:i + 2]
    root = args[0] if args else "."
    sys.path.insert(0, root)
    from deepseek_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    flush = torch.empty(128 * 2**20, dtype=torch.float32, device="cuda")
    if only in (None, "K8"):
        k8(root, flush.zero_)
    del flush
    if only in (None, "steps"):
        steps(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
