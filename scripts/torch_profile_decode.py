"""Where a decode step's and a prefill chunk's time goes in the
PyTorch/CUDA port (one GPU).

    python scripts/torch_profile_decode.py [--model v3|v3-perm|v3-q3k|v3-q2k|v3-q3kt|
                                                    v3-q2kt|v2-lite|v2-lite-fp8]
                                           [--layers N] [--kv-dtype int8]
                                           [--steps 16] [--chunks 4]
                                           [--cells all|prefill]
                                           [--trace out.json]

``--model v3`` (the default) builds the DeepSeek-V3-width nibble model
with the factor weights wq_b / wkv_b, 4 layers unless --layers says
otherwise, ``v3-perm`` the same draw with its expert w13s row-permuted
(the fused expert FFN's layout: K6 on w13s, K6's prepermuted body on
w2s), ``v3-q3k`` / ``v3-q2k`` the same model in the packed Q3_K /
Q2_K planes, ``v3-q3kt`` / ``v3-q2kt`` in the turbo int8 planes;
``--model v2-lite`` builds the F16 decompressed-MHA
DeepSeek-V2-Lite and ``--model v2-lite-fp8`` the same model in F8E5M2
with 128x128 block scales, all 27 layers unless --layers says otherwise
(random weights from a seed, models/testing.py). ``--kv-dtype int8``
keeps the KV cache in int8 with f32 row scales (the JAX CLI's
``--kv-dtype int8``: K3's, K8's, K9's and K10's int8 bodies; the hybrid
prefill dequantizes the window for the float K9) instead of the model's
bf16. It profiles:
  short: greedy decode at positions 0.. (kv_len grows from 1; attention is
         negligible);
  block: the Engine's decode block, 32 steps a unit through
         make_decode_loop at temperature 0.8 (top_p 0.95), the token
         sampled on the card (positions from 0);
  long:  greedy decode from the 4096-slot window onwards, over a cache
         filled with random rows (kv_len = 4096: K3, or K8 for V2-Lite, at
         the full window, the ring wrapped, sinks re-rotating);
  prefill-{k9,k10}-{first,last}: one 256-token prefill chunk, with the
         factor weights (decompressed: K9) or without (absorbed: K10; V3
         only), at the start of the window or at its end (over 4096
         filled slots).
``--cells prefill`` profiles the prefill cells only.
For each cell it prints the wall time per step or chunk (host clock around
synchronized work), the device time per unit summed over the profiler's
kernel events, the device's idle share, and the kernels by device time.
Needs a CUDA GPU; exits 2 without one.
"""

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_cell(name, run, n, unit, trace):
    """``run(k)`` does k units (decode steps or prefill chunks); time n of
    them on the host clock, then profile n more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        run(2)                                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(n)
            torch.cuda.synchronize()
    # device-kernel rows only: an aten op's row repeats the device time of
    # the kernels it launched, so summing every row would count it twice
    avgs = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA),
                  key=_device_us, reverse=True)
    dev_ms = sum(_device_us(e) for e in avgs) / 1e3 / n
    print(f"[{name}] wall {wall_ms:.3f} ms/{unit}, device busy {dev_ms:.3f} "
          f"ms/{unit} (profiled window), idle share "
          f"{max(0.0, 1 - dev_ms / wall_ms):.3f}")
    print(f"[{name}] device time per {unit} by kernel:")
    for e in avgs[:16]:
        us = _device_us(e) / n
        if us <= 0:
            break
        print(f"    {us:9.1f} us  x{e.count / n:5.1f}  {e.key[:90]}")
    if trace:
        prof.export_chrome_trace(f"{trace}.{name}.json")


def filled_cache(cfg):
    """A cache whose every slot holds a random row (an int8 cache: the
    quantized rows, their scales and the sink masters)."""
    from deepseek_tpu_torch.models.kvcache import init_cache, quantize_rows
    cache = init_cache(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    for f, fs in (("ckv", "ckv_s"), ("krope", "krope_s"), ("k", "k_s"), ("v", "v_s")):
        t = getattr(cache, f)
        if t is None:
            continue
        x = torch.randn(t.shape, generator=g, device="cuda")
        if cache.quantized:
            t[...], getattr(cache, fs)[...] = quantize_rows(x)
        else:
            t.copy_(x)
    for m in (cache.sink_krope, cache.sink_k):
        if m is not None:
            m.copy_(torch.randn(m.shape, generator=g, device="cuda"))
    return cache


def decode_cell(name, params, cfg, pos0, steps, trace):
    from deepseek_tpu_torch.models.deepseek import forward_decode
    from deepseek_tpu_torch.models.kvcache import init_cache

    cache = filled_cache(cfg) if pos0 > 0 else init_cache(cfg, device="cuda")
    state = {"tok": torch.tensor([[1]], device="cuda"), "pos": pos0}

    def run(k):
        for _ in range(k):
            state["tok"] = forward_decode(params, cache, state["tok"], state["pos"],
                                          cfg).argmax(-1, keepdim=True)
            state["pos"] += 1
    print(f"[{name}] decode from position {pos0}")
    profile_cell(name, run, steps, "step", trace)


def block_cell(name, params, cfg, blocks, trace, temperature=0.8):
    from deepseek_tpu_torch.models.deepseek import make_decode_loop
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.ops import prng

    loop = make_decode_loop(cfg, 32)
    cache = init_cache(cfg, device="cuda")
    state = {"tok": torch.tensor([[1]], device="cuda"), "pos": 0,
             "key": prng.PRNGKey(0)}

    def run(k):
        for _ in range(k):
            state["key"], sub = prng.split(state["key"])
            toks, _, _ = loop(params, cache, state["tok"], state["pos"], sub,
                              temperature, 0.95)
            state["tok"], state["pos"] = toks[:, -1:], state["pos"] + 32
    print(f"[{name}] decode blocks of 32 steps at temperature {temperature}")
    profile_cell(name, run, blocks, "block", trace)


def prefill_cell(name, params, cfg, pos0, chunks, trace):
    """The same 256-token chunk prefilled at pos0 again and again (each run
    rewrites the same slots)."""
    from deepseek_tpu_torch.models.deepseek import forward_prefill

    cache = filled_cache(cfg)
    g = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(3, cfg.vocab_size, (1, 256), generator=g, device="cuda")

    def run(k):
        for _ in range(k):
            forward_prefill(params, cache, toks, pos0, cfg, "last")
    print(f"[{name}] prefill chunk of 256 at position {pos0}")
    profile_cell(name, run, chunks, "chunk", trace)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_decode: no CUDA GPU visible", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("v3", "v3-perm", "v3-q3k", "v3-q2k", "v3-q3kt",
                                        "v3-q2kt", "v2-lite", "v2-lite-fp8"),
                    default="v3")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: 4 for v3, 27 for v2-lite)")
    ap.add_argument("--kv-dtype", choices=("int8",), default=None,
                    help="KV cache dtype (default: the model's bf16)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--cells", choices=("all", "prefill"), default="all")
    ap.add_argument("--trace", default=None, help="chrome-trace path prefix")
    args = ap.parse_args()

    import subprocess
    from deepseek_tpu_torch.config import QuantKind
    from deepseek_tpu_torch.models.testing import (
        deepseek_v2_lite_proportions, deepseek_v3_proportions, random_fp8_params,
        random_fused_params, random_plain_params)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.model == "v2-lite":
        cfg = deepseek_v2_lite_proportions(n_layers=args.layers or 27)
        params = random_plain_params(cfg, torch.float16, seed=0, device="cuda")
        variants = (("k9", params),)
    elif args.model == "v2-lite-fp8":
        cfg = deepseek_v2_lite_proportions(n_layers=args.layers or 27,
                                           weight_quant=QuantKind.F8E5M2,
                                           block_size=(128, 128))
        params = random_fp8_params(cfg, seed=0, device="cuda")
        variants = (("k9", params),)
    else:
        cfg = deepseek_v3_proportions(n_layers=args.layers or 4)
        quant = {"v3": "q3_k_nibble", "v3-perm": "q3_k_nibble", "v3-q3k": "q3_k",
                 "v3-q2k": "q2_k", "v3-q3kt": "q3_k_turbo",
                 "v3-q2kt": "q2_k_turbo"}[args.model]
        params = random_fused_params(cfg, quant, seed=0, device="cuda", factors=True)
        if args.model == "v3-perm":
            from deepseek_tpu_torch.models.loader import rowperm_expert_w13
            params = rowperm_expert_w13(params, cfg)
        variants = (("k9", params), ("k10", dataclasses.replace(params, layers=[
            dataclasses.replace(lp, wq_b=None, wkv_b=None) for lp in params.layers])))
    if args.kv_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_dtype)
    print(f"model: {args.model}, {cfg.n_layers} layers, {cfg.kv_cache_dtype} KV cache")
    if args.cells == "all":
        decode_cell("short", params, cfg, 0, args.steps, args.trace)
        block_cell("block", params, cfg, 2, args.trace)
        decode_cell("long", params, cfg, cfg.kv_window, args.steps, args.trace)
    for label, p in variants:
        for where, pos0 in (("first", 0), ("last", cfg.kv_window - 256)):
            prefill_cell(f"prefill-{label}-{where}", p, cfg, pos0, args.chunks,
                         args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
