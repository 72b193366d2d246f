"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:
  1. the card: name and power limit, and the build of every CUDA kernel
     (one nvcc per source, in parallel, into build/torch_kernels/);
  2. entry point: a tiny random Q3_K checkpoint written with the port's
     codec, decoded greedily by Engine(..., device="cuda") and held against
     the same Engine on the CPU (plain versions);
  3. the kernels: K1 (Q3_K and Q2_K nibble), K2 and K3 at the shapes of the
     DeepSeek-V3-width model, each against its plain version on the card,
     with its time, the plain version's time and its bound;
  4. full width: the DeepSeek-V3-width 4-layer nibble model (random weights
     from a seed) decodes 64 greedy tokens through the port's forward; the
     launch counts read around this run show that K1, K2 and K3 ran.
The line before last holds the card's name and power limit; the last line
is the JSON result. Without a CUDA GPU the script exits 2 and prints none.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
N_DECODE = 64
N_WARMUP = 4
SEED = 0


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(fn, iters=10):
    """Mean device time of one call. Each call is enqueued behind a 512 MB
    write that evicts the 50 MB L2 (decode finds its weights cold) and keeps
    the device busy while the host prepares the call, so the interval
    between the two events holds device time only."""
    flush = time_ms.flush
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def bound_ms(nbytes: float, flops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------
# phase 2: the entry point on a tiny checkpoint
# ---------------------------------------------------------------------------

def write_tiny_checkpoint(path: str, rng) -> None:
    from deepseek_tpu_torch.config import (
        ActivationType, ModelConfig, QuantKind, ScoringFunc, TopKMethod)
    from deepseek_tpu_torch.quant.kquant import Q3K_BLOCK_BYTES, QK_K
    from deepseek_tpu_torch.utils.codec import pack_tokenizer_tokens, save_checkpoint

    cfg = ModelConfig(
        dim=512, hidden_dim=1024, n_layers=2, n_heads=4, vocab_size=512,
        max_seq_len=64, rope_theta=10000.0, norm_eps=1e-6,
        act=ActivationType.SILU, first_k_dense_replace=1, n_shared_experts=1,
        n_routed_experts=8, n_active_routed=2, moe_intermediate_size=256,
        routed_scaling_factor=2.5, n_group=2, norm_topk_prob=True,
        scoring_func=ScoringFunc.SIGMOID, topk_group=1,
        topk_method=TopKMethod.NOAUX_TC, has_moegate_bias=True, use_mla=True,
        kv_lora_rank=512, q_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, weight_quant=QuantKind.Q3_K,
        rs_original_max_position_embeddings=32, arch="DeepseekV3ForCausalLM")

    def q3k(*shape):
        """Random Q3_K blocks with small f16 super-scales."""
        *lead, rows, cols = shape
        nb = cols // QK_K
        raw = rng.integers(0, 256, (*lead, rows, nb, Q3K_BLOCK_BYTES), dtype=np.uint8)
        d = rng.uniform(2e-4, 6e-4, (*lead, rows, nb)).astype(np.float16)
        raw[..., 108:110] = d[..., None].view(np.uint8).reshape(*d.shape, 2)
        return raw.reshape(*lead, rows, nb * Q3K_BLOCK_BYTES)

    def f32(*shape, scale=0.02, base=0.0):
        return (base + rng.standard_normal(shape) * scale).astype(np.float32)

    c = cfg
    H, R, P, Dv, ql = c.n_heads, c.kv_lora_rank, c.qk_rope_head_dim, c.v_head_dim, c.q_lora_rank
    E, m = c.n_routed_experts, c.moe_intermediate_size
    t = {"model.embed.weight": q3k(c.vocab_size, c.dim),
         "model.output.weight": q3k(c.vocab_size, c.dim),
         "model.norm.weight": f32(c.dim, scale=0.1, base=1.0)}
    for l in range(c.n_layers):
        p = f"model.layers.{l}"
        t.update({
            f"{p}.attn.norm.weight": f32(c.dim, scale=0.1, base=1.0),
            f"{p}.mlp.norm.weight": f32(c.dim, scale=0.1, base=1.0),
            f"{p}.attn.kv_a_norm.weight": f32(R, scale=0.1, base=1.0),
            f"{p}.attn.q_a_norm.weight": f32(ql, scale=0.1, base=1.0),
            f"{p}.attn.wkv_a.weight": q3k(R + P, c.dim),
            f"{p}.attn.wq_a.weight": q3k(ql, c.dim),
            f"{p}.attn.wc.weight": q3k(H * R, ql),
            f"{p}.attn.wq_rope_b.weight": q3k(H * P, ql),
            f"{p}.attn.wv_b.weight": q3k(H * Dv, R),
            f"{p}.attn.wo.weight": q3k(c.dim, H * Dv),
        })
        if c.is_moe_layer(l):
            t.update({
                f"{p}.moegate.weight": f32(E, c.dim, scale=0.05),
                f"{p}.moegate.bias": f32(E, scale=0.01),
                f"{p}.mlp.w1.weight": q3k(E, m, c.dim),
                f"{p}.mlp.w3.weight": q3k(E, m, c.dim),
                f"{p}.mlp.w2.weight": q3k(E, c.dim, m),
                f"{p}.shared_mlp.w1.weight": q3k(m, c.dim),
                f"{p}.shared_mlp.w3.weight": q3k(m, c.dim),
                f"{p}.shared_mlp.w2.weight": q3k(c.dim, m),
            })
        else:
            t.update({f"{p}.mlp.w1.weight": q3k(c.hidden_dim, c.dim),
                      f"{p}.mlp.w3.weight": q3k(c.hidden_dim, c.dim),
                      f"{p}.mlp.w2.weight": q3k(c.dim, c.hidden_dim)})
    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{i:02X}>".encode() for i in range(256)]
    vocab += [f"tok{i}".encode() for i in range(len(vocab), c.vocab_size)]
    t["tokenizer.tokens"] = pack_tokenizer_tokens(vocab)
    md = cfg.to_metadata()
    md.update(bos_token_id="1", eos_token_id="2")
    save_checkpoint(path, [t], md)


def entry_point_phase(counts):
    from deepseek_tpu_torch.engine import Engine

    rng = np.random.default_rng(SEED)
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_tiny")
    shutil.rmtree(tmp, ignore_errors=True)
    write_tiny_checkpoint(tmp, rng)
    eng = Engine(tmp, device="cuda", seed=SEED)
    ref = Engine(tmp, device="cpu", seed=SEED)
    prompt = eng.tokenizer.encode("hello", bos=True)
    n_new = 40 - len(prompt)                  # past the 32-slot window
    reset(counts)
    out, stats = eng.generate(prompt, num_steps=n_new, temperature=0.0)
    torch.cuda.synchronize()
    launched = read(counts)
    log(f"entry point: Engine(tiny Q3_K .dseek, device='cuda').generate -> "
        f"{len(out)} greedy tokens {out}")
    log(f"entry point: launches {launched}, {stats.tok_per_s:.1f} tok/s "
        f"(tiny model, launch-bound)")
    missing = [k for k, v in launched.items() if v == 0]
    if missing:
        raise RuntimeError(f"entry point never launched {missing}")
    # teacher-forced logits against the CPU engine's plain versions on
    # the same tokens. Tolerance 1e-3 of the logit scale: the f32 sums
    # run in other orders and a latent can round to the neighbouring f16
    # cache value (2^-11 relative), as in tests/test_torch_engine.py
    toks = prompt + out
    c_gpu, c_cpu = eng.new_cache(), ref.new_cache()
    worst, scale = 0.0, 0.0
    for pos in range(len(toks) - 1):
        a = eng.step(c_gpu, toks[pos], pos)[0].float().cpu()
        b = ref.step(c_cpu, toks[pos], pos)[0].float()
        if not torch.isfinite(a).all():
            raise RuntimeError(f"non-finite logits at position {pos}")
        worst = max(worst, float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
        if pos >= len(prompt) - 1:
            want = int(b.argmax())
            got = toks[pos + 1]
            if got != want and float(b[want] - b[got]) > 1e-3 * scale:
                raise RuntimeError(
                    f"greedy token {got} at position {pos + 1}, CPU says {want}")
    log(f"entry point: logits vs CPU plain: max abs err {worst:.3e} "
        f"(tolerance {1e-3 * scale:.3e} = 1e-3 of max|logit| {scale:.3f})")
    if not worst <= 1e-3 * scale:
        raise RuntimeError("entry-point logits disagree with the CPU engine")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the V3 slice's shapes
# ---------------------------------------------------------------------------

def rand_nibble(gen, rows, cols, quant):
    from deepseek_tpu_torch.quant.qtensor import KNibbleTensor
    p = torch.randint(0, 256, (rows, cols // 2), generator=gen, device="cuda",
                      dtype=torch.uint8)
    a = (torch.rand((rows, cols // 16), generator=gen, device="cuda") * 0.009
         + 0.001).to(torch.bfloat16)
    if quant == "q2_k":
        c = (torch.rand((rows, cols // 16), generator=gen, device="cuda") * 0.0045
             + 0.0005).to(torch.bfloat16)
        return KNibbleTensor(p=p, a=a, c=c, off=0)
    return KNibbleTensor(p=p, a=a, c=None, off=4)


def check(entry, got, want, rel_tol):
    err = float((got - want).abs().max())
    ref = float(want.abs().max())
    entry["max_abs_err"] = err
    ok = math.isfinite(err) and err <= rel_tol * max(ref, 1e-30)
    log(f"  {entry['name']}: max abs err {err:.3e} (tolerance {rel_tol:g} x "
        f"max|ref| {ref:.3f} = {rel_tol * ref:.3e}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{entry['name']} disagrees with its plain version")


def kernel_phase(params, cfg):
    from deepseek_tpu_torch.ops.kernels.attention import (
        mla_decode_attn, mla_decode_attn_plain)
    from deepseek_tpu_torch.ops.kernels.qmm import (
        qmm, qmm_experts, qmm_experts_plain, qmm_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    entries = []
    dense, moe = params.layers[0], params.layers[cfg.n_layers - 1]
    H = cfg.n_heads

    def emit(name, fn, plain, tol, nb, flops, source, replaces, kernel,
             library=None):
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "kernel": kernel}
        check(entry, fn(), plain(), tol)
        entry["ms"] = time_ms(fn)
        entry["plain_ms"] = time_ms(plain)
        entry["bound_ms"], entry["bound_by"] = bound_ms(nb, flops)
        entry["library_ms"] = time_ms(library) if library is not None else None
        log(f"  {name}: {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
            f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})"
            + (f", library {entry['library_ms']:.4f} ms" if library else ""))
        entries.append(entry)

    # K1 over every dense projection shape of the path; Q3_K from the model
    # itself, Q2_K (with its min plane) synthesized at the same shapes.
    # Tolerance 1e-4 of max|ref|: f32 sums in other orders, and the kernel's
    # 0.5 + u/256 nibble floats cancel their offset against f32 group sums.
    k1 = {"wkvq": dense.wkvq, "wcr": dense.wcr, "wo": dense.wo,
          "w13 (dense)": dense.w13, "w2 (dense)": dense.w2,
          "lm_head": params.lm_head}
    for quant in ("q3_k", "q2_k"):
        for label, qt in k1.items():
            d, n = qt.shape
            if quant == "q2_k":
                qt = rand_nibble(gen, d, n, quant)
            x = torch.randn((1, n), generator=gen, device="cuda")
            emit(f"K1 qmm {quant} nibble {label} {d}x{n}",
                 lambda: qmm(qt, x), lambda: qmm_plain(qt, x), 1e-4,
                 nbytes(x, qt.p, qt.a, qt.c) + 4 * d, 2.0 * d * n,
                 "deepseek_tpu_torch/csrc/qmm.cu",
                 "deepseek_tpu/ops/pallas/qmm.py:312 (qmm, _knib_body :206)", "K1")

    # K2: the MoE tables for one token's 8 routed + 1 shared experts, and the
    # per-head wv_b (idx = head id)
    E = cfg.n_routed_experts
    sel = torch.randperm(E, generator=gen, device="cuda")[:cfg.n_active_routed]
    eids = torch.cat([sel.sort().values, torch.tensor([E], device="cuda")])
    wv3 = dense.wv_b.map(lambda t: t.reshape(H, t.shape[0] // H, t.shape[1]))
    k2 = [("w13s (MoE)", moe.w13s, eids), ("w2s (MoE)", moe.w2s, eids),
          ("wv_b (per head)", wv3, torch.arange(H, device="cuda"))]
    for label, qt, idx in k2:
        _, d, n = qt.shape
        x = torch.randn((idx.numel(), n), generator=gen, device="cuda")
        u = idx.unique()
        emit(f"K2 qmm_experts q3_k nibble {label} {idx.numel()}x{d}x{n}",
             lambda: qmm_experts(qt, idx, x), lambda: qmm_experts_plain(qt, idx, x),
             1e-4, nbytes(x, qt.p[u], qt.a[u]) + 4 * d * idx.numel(),
             2.0 * idx.numel() * d * n, "deepseek_tpu_torch/csrc/qmm.cu",
             "deepseek_tpu/ops/pallas/qmm.py:566 (qmm_experts, _knib_body :206)",
             "K2")

    # K3 at the V3 window: kv_len < S, and a ragged S. Tolerance 1e-4 of
    # max|ref|: f32 sums over thousands of slots in other orders, fast exp.
    R, P = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    scale = cfg.attn_softmax_scale()
    for S, kv in ((cfg.kv_window, cfg.kv_window - 96), (cfg.kv_window - 3, 3001)):
        qc = torch.randn((1, H, R), generator=gen, device="cuda")
        qr = torch.randn((1, H, P), generator=gen, device="cuda")
        ckv = torch.randn((1, S, R), generator=gen, device="cuda").to(torch.bfloat16)
        kr = torch.randn((1, S, P), generator=gen, device="cuda").to(torch.bfloat16)
        kl = torch.tensor([kv], device="cuda", dtype=torch.int32)
        # yardstick only: SDPA over the concatenated MQA form [q_c|q_rope],
        # [ckv|krope], values ckv, slots >= kv_len masked (the port never calls it)
        q_cat = torch.cat([qc, qr], -1)[:, :, None].to(torch.bfloat16)
        k_cat = torch.cat([ckv, kr], -1)[:, None].expand(1, H, S, R + P)
        v_cat = ckv[:, None].expand(1, H, S, R)
        mask = (torch.arange(S, device="cuda") < kv)[None, None, None]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q_cat, k_cat, v_cat, attn_mask=mask, scale=scale)

        emit(f"K3 mla_decode_attn bf16 cache S={S} kv_len={kv} H={H}",
             lambda: mla_decode_attn(qc, qr, ckv, kr, kl, scale),
             lambda: mla_decode_attn_plain(qc, qr, ckv, kr, kl, scale), 1e-4,
             kv * (R + P) * 2 + nbytes(qc, qr) + 4 * H * R,
             2.0 * H * kv * (2 * R + P),
             "deepseek_tpu_torch/csrc/mla_decode.cu",
             "deepseek_tpu/ops/pallas/attention.py:170 (mla_decode_attn, _mla_body :89)",
             "K3", library=sdpa)
    return entries


# ---------------------------------------------------------------------------
# phase 4: the full-width decode
# ---------------------------------------------------------------------------

def full_width_phase(params, cfg, counts):
    from deepseek_tpu_torch.models.deepseek import forward_decode
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.models.loader import params_active_bytes

    cache = init_cache(cfg, device="cuda")
    tok = torch.tensor([[1]], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset(counts)
    toks = []
    with torch.inference_mode():
        for pos in range(N_DECODE + N_WARMUP):
            if pos == N_WARMUP:                 # time the steady state only
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            logits = forward_decode(params, cache, tok, pos, cfg)
            tok = logits.argmax(-1, keepdim=True)
            toks.append(tok)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launched = read(counts)
    toks = torch.cat(toks, 1)[0].tolist()
    if logits.shape != (1, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise RuntimeError(f"full-width logits {tuple(logits.shape)} not finite")
    per_tok = params_active_bytes(params, cfg, N_WARMUP + N_DECODE // 2)
    tps = N_DECODE / dt
    log(f"full width: DeepSeek-V3 widths, {cfg.n_layers} layers "
        f"({cfg.first_k_dense_replace} dense + {cfg.n_layers - cfg.first_k_dense_replace}"
        f" MoE), Q3_K nibble, {N_DECODE} greedy tokens: {tps:.2f} tok/s, "
        f"{per_tok * tps / 1e9:.1f} GB/s of {per_tok / 1e9:.3f} GB active bytes/token "
        f"(byte bound {per_tok / HBM_BYTES_PER_S * 1e3:.3f} ms/token = "
        f"{HBM_BYTES_PER_S / per_tok:.0f} tok/s), first tokens {toks[:12]}")
    log(f"full width: launches over {N_WARMUP} warm-up + {N_DECODE} timed steps {launched} "
        f"(per token {({k: v / (N_DECODE + N_WARMUP) for k, v in launched.items()})})")
    log(f"full width: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    missing = [k for k, v in launched.items() if v == 0]
    if missing:
        raise RuntimeError(f"the full-width decode never launched {missing}")
    return launched, tps


def counters():
    from deepseek_tpu_torch.ops.kernels.attention import mla_decode_attn
    from deepseek_tpu_torch.ops.kernels.qmm import qmm, qmm_experts
    return {"K1": qmm, "K2": qmm_experts, "K3": mla_decode_attn}


def reset(counts):
    for fn in counts.values():
        fn.launches = 0


def read(counts):
    return {k: fn.launches for k, fn in counts.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 2
    from deepseek_tpu_torch.ops.kernels import build
    from deepseek_tpu_torch.models.testing import (
        deepseek_v3_proportions, random_fused_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(build.SIGNATURES)}")
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    time_ms.flush = torch.empty(128 * 2**20, dtype=torch.float32, device="cuda")
    counts = counters()

    entry_point_phase(counts)

    cfg = deepseek_v3_proportions(n_layers=4)
    t0 = time.perf_counter()
    params = random_fused_params(cfg, "q3_k_nibble", seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"full width: random nibble model built on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    launched, _ = full_width_phase(params, cfg, counts)

    log("kernels (each against its plain version on the card):")
    entries = kernel_phase(params, cfg)
    for e in entries:
        e["launches"] = launched[e.pop("kernel")]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
