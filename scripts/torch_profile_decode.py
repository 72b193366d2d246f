"""Where a decode step's time goes in the PyTorch/CUDA port (one GPU).

    python scripts/torch_profile_decode.py [--layers 4] [--steps 16]
                                           [--trace out.json]

Builds the DeepSeek-V3-width nibble model (random weights from a seed,
models/testing.py) and decodes greedily in two cells:
  short: positions 0.. (kv_len grows from 1; attention is negligible);
  long:  positions from the 4096-slot window onwards, over a cache filled
         with random latents (kv_len = 4096: K3 at the full window, the
         ring wrapped, sinks re-rotating).
For each cell it prints the wall time per step (host clock around
synchronized work), the device time per step summed over the profiler's
kernel events, the device's idle share, and the kernels by device time.
Needs a CUDA GPU; exits 2 without one.
"""

import argparse
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


def run_cell(name, params, cfg, pos0, steps, trace):
    from torch.profiler import ProfilerActivity, profile

    from deepseek_tpu_torch.models.deepseek import forward_decode
    from deepseek_tpu_torch.models.kvcache import init_cache

    cache = init_cache(cfg, device="cuda")
    if pos0 > 0:
        g = torch.Generator(device="cuda").manual_seed(1)
        cache.ckv.copy_(torch.randn(cache.ckv.shape, generator=g, device="cuda"))
        cache.krope.copy_(torch.randn(cache.krope.shape, generator=g, device="cuda"))
    tok = torch.tensor([[1]], device="cuda")

    def steps_from(p0, n):
        nonlocal tok
        for pos in range(p0, p0 + n):
            tok = forward_decode(params, cache, tok, pos, cfg).argmax(-1, keepdim=True)

    with torch.inference_mode():
        steps_from(pos0, 4)                          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps_from(pos0 + 4, steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            steps_from(pos0 + 4 + steps, steps)
            torch.cuda.synchronize()
    # device-kernel rows only: an aten op's row repeats the device time of
    # the kernels it launched, so summing every row would count it twice
    from torch.autograd import DeviceType
    avgs = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA),
                  key=_device_us, reverse=True)
    dev_ms = sum(_device_us(e) for e in avgs) / 1e3 / steps
    print(f"[{name}] positions {pos0 + 4}..{pos0 + 4 + steps}: wall {wall_ms:.3f} "
          f"ms/step ({1e3 / wall_ms:.1f} tok/s), device busy {dev_ms:.3f} ms/step "
          f"(profiled window), idle share {max(0.0, 1 - dev_ms / wall_ms):.3f}")
    print(f"[{name}] device time per step by kernel:")
    for e in avgs[:16]:
        us = _device_us(e) / steps
        if us <= 0:
            break
        print(f"    {us:9.1f} us  x{e.count / steps:5.1f}  {e.key[:90]}")
    if trace:
        prof.export_chrome_trace(f"{trace}.{name}.json")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_decode: no CUDA GPU visible", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--trace", default=None, help="chrome-trace path prefix")
    args = ap.parse_args()

    import subprocess
    from deepseek_tpu_torch.models.testing import (
        deepseek_v3_proportions, random_fused_params)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = deepseek_v3_proportions(n_layers=args.layers)
    params = random_fused_params(cfg, "q3_k_nibble", seed=0, device="cuda")
    run_cell("short", params, cfg, 0, args.steps, args.trace)
    run_cell("long", params, cfg, cfg.kv_window, args.steps, args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
