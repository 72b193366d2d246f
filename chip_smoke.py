"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:
  1. the card: name and power limit, and the build of every CUDA kernel
     (one nvcc per source, in parallel, into build/torch_kernels/), with
     each kernel's ptxas register and spill line; an instantiation of the
     tile GEMM (csrc/qmm_tiles.cu, K1/K5 row-tiled and K6 on the tensor
     cores), of K2's plain body or of K5's fp8 matvec (csrc/fp8_mv.cu)
     that spills fails the run;
  2. entry points: a tiny random Q3_K checkpoint written with the port's
     codec, hydrated by prefill and decoded greedily by Engine(...,
     device="cuda", kquant_runtime="nibble") and held against the same
     Engine on the CPU (plain versions); then a tiny bf16 MoE checkpoint
     with the factor weights,
     whose prompt puts 300 token-expert pairs in one chunk (K9, K11) and
     whose decode steps run its bf16 expert tables (K2's plain body); then a
     tiny F16 decompressed-MHA checkpoint (the converter's default kind)
     with a 32 MiB lm_head (K9, K11, then K8, K4, K2's plain body); then a
     tiny absorbed-MLA F8E5M2 checkpoint with 128x128 block scales (K5
     row-tiled, K6's fp8 body, K9, then K5, K2's fp8 body, K3); then tiny
     random Q3_K and Q2_K checkpoints through Engine(device="cuda") with
     default arguments, the packed planes (200 token-expert pairs in a
     chunk: K6's packed body, K5 row-tiled, K10; then K5, K2's packed body
     on the expert tables and wv_b, K3), plus a run sampled at temperature
     0.8 that must give the CPU Engine's tokens; then the same checkpoints
     with kquant_runtime="turbo" (the turbo bodies of K5, K2 and K6); then
     the packed Q3_K and the F16 MHA checkpoints with kv_cache_dtype="int8"
     (the int8 bodies of K3 and K10, and of K8 and K9), past the window so
     the sinks re-rotate from their float masters, whose greedy tokens and
     the packed Q3_K run sampled at 0.8 must equal the CPU Engine's, and
     the packed Q3_K one with kv_cache_dtype="float32" (K10's f32 body;
     the default f16 cache runs its f16 body, the f32 compute K9's f32
     body, both counted apart); then
     the tiny Q3_K checkpoint with kquant_runtime="nibble" loaded under
     DSEEK_FUSED_FFN=1 (the script sets it for those loads only; the
     expert [w1;w3] tables row-permuted), 96-token prefill chunks so one
     chunk runs K6 and K6's prepermuted body and the next K2 and K2's
     prepermuted body, then decode through K7, whose greedy tokens must
     equal the CPU Engine's. Every
     Engine runs its default 32-token decode block (on-device sampling);
  3. full width: the DeepSeek-V3-width 4-layer nibble model (random weights
     from a seed) decodes 64 greedy tokens through the port's forward
     (K1, K2, K3), then hydrates a 512-token prompt in 2 prefill chunks of
     256, with the factor weights (K9) and without (K10), each followed by
     16 greedy decode steps (K1 row-tiled, K6, and K1, K2, K3 again); then
     the same draw with its expert w13s row-permuted (the fused expert
     FFN: 64 decode steps through K7, the prefill through K6's prepermuted
     body, logits against the natural layout, decode tok/s at decode_block
     32 beside the natural model's, a block under sync debug mode, and K7,
     with the time of the K2 chain it replaces, and K2's and K6's
     prepermuted bodies against their plain versions); then
     the same model in packed Q3_K and in packed Q2_K (K5, K2's and K6's
     packed bodies, K5 row-tiled), each followed by its packed kernels at
     its shapes (and K1 on the nibble layout of the same w13), with the
     packed Q3_K model's decode timed at decode_block 1 and 32 (temperature
     0 and 0.8) and one block run under set_sync_debug_mode("error"), and
     the packed Q3_K model again with an int8 KV cache: 64 decode steps
     (K3's int8 body), the 512-token prefill with the factor weights (the
     window dequantized, the float K9) and without (K10's int8 body), a
     block under set_sync_debug_mode("error") and the cache's bytes; then
     the same draws in the turbo layout, Q3_K and Q2_K (K5, K2's and K6's
     turbo bodies, K5 row-tiled), each followed by its turbo kernels at its
     shapes beside packed K5 and nibble K1 on one w13;
  4. the kernels: K1 (the nibble matvec of csrc/nibble_mv.cu at every
     dense V3 shape, Q3_K and Q2_K, at 1 to 4 rows; row-tiled; the two
     routes timed at 1 to 32 rows), K2 (nibble bodies with int64 and int32
     ids, plain body), K3, K6, K9, K10 and K11 at
     the shapes of the DeepSeek-V3-width model, K2's plain body and K4
     and K8 at those of DeepSeek-V2-Lite (and V3's lm_head and 128
     heads), and the fp8 bodies
     of K5 (the matvec of csrc/fp8_mv.cu at every V2-Lite F8E5M2 shape at 1
     to 4 rows and on 32x16 blocks at 5 and 13 rows; row-tiled), K2 and K6
     at DeepSeek-V2-Lite's F8E5M2 shapes, and the int8 bodies of K3 and K10 at V3's and of K8 and K9 at
     V2-Lite's shapes (beside the bf16 body's time over the same rows; for
     K9 an entry of its own, V2-Lite's split window, with SDPA's time),
     and the bodies that take the cache in two bf16 terms (K9 over f32 keys
     and values at V3's and V2-Lite's widths and over an f16 cache at
     V2-Lite's, K10 over f16 and f32 caches at V3's), each against its
     plain version on the card, with its time, the plain version's time, a
     PyTorch library call's time where one computes the same function, and
     its bound;
  5. DeepSeek-V2-Lite (decompressed MHA, F16) at full width and depth from
     random weights: a 512-token prompt in 2 prefill chunks (K9, K11), then
     greedy decode (K8, K4, K2's plain body), then the same with an int8
     KV cache (K9's and K8's int8 bodies); then its first 2 layers hydrate
     to the 4096-slot window's edge and decode past it, against the same
     run on the CPU, with an f16 and with an int8 cache; then the same
     model in F8E5M2 with 128x128
     blocks (K5 row-tiled, K6's fp8 body, K9; then K5, K2's fp8 body, K8),
     and its first 2 layers against the CPU over a 300-token prompt;
  6. the seq mesh axis (seq=2): with the parent's models freed, the
     unsharded runs on the card, then two ranks spawned by
     deepseek_tpu_torch/parallel/launch.py, gloo ranks that share the one
     card, run the same paths over their halves of the KV window: the
     DeepSeek-V3-width packed Q3_K model (a 512-token prompt in two
     context-parallel chunks, with and without the factor weights: the
     partials bodies of K9 and K10; 32 decode steps: K3's; bf16 and int8
     caches, bf16 and f32 compute; a 32-token decode block at 0.8 whose
     tokens both ranks must share), DeepSeek-V2-Lite F16 cut to 8 layers
     (K9's and K8's partials bodies, bf16 and int8 caches, bf16 and f32
     compute) and 2 of its layers hydrated to the window's edge and
     decoded past it, each against the unsharded run; then every partials
     body against its plain version at the shards' shapes and on an empty
     shard.
  7. the CLI and single-sequence speculation: after the entry points, a
     random F8E5M2 checkpoint at DeepSeek-V2-Lite's widths (MHA, 2 layers,
     ~1.1 GB) and a 1-layer draft, written with the port's codec, through
     ``python -m deepseek_tpu_torch`` subprocesses (completion at -t 0,
     -t 0.8 and --kv-dtype int8, perplexity -w, passkey -n 64 -l 10,
     interactive and chat from stdin, --ngram-spec, --draft), held against
     the same routes in process (texts, perplexity within 1e-3, the
     speculative texts against plain greedy); then --mtp-spec on a tiny
     packed Q3_K V3-arch checkpoint with an MTP layer, against the CPU
     Engine; and, on the V3-width packed Q3_K
     draw with a random MTP layer, the draft-model, n-gram and MTP
     speculation rounds against plain greedy decode, each round's launches
     counted and its time beside plain decode.
  8. batched decode and continuous batching: a tiny packed Q3_K .dseek
     through BatchScheduler on the card against the CPU scheduler (5
     requests through 2 slots at temperature 0.8: the same tokens); `-m
     serve --batch 4` (and `--serve-spec`) as a subprocess on a free
     loopback port over the CLI phase's V2-Lite-width checkpoint: /health,
     4 concurrent completions (streamed, with a stop string, with logprobs,
     top_k 1) whose greedy text is the CLI's, then spec="ngram" serving in
     process (K9 with per-row starts); on the V3-width packed Q3_K draw
     (its MTP layer, f32 compute) 8 requests of 20-600 prompt tokens
     through BatchScheduler(batch_size=4, logprobs=True,
     prefix_cache_mb=64): greedy slots equal their runs alone (near ties
     allowed), the logprobs the log-softmax of the single-sequence
     teacher-forced logits within 1e-3 (batched decode is batch-invariant:
     a served row computes the bits of the sequence alone), a prefix-cache
     hit; then spec="ngram" and spec="mtp" serving (K10 with
     per-row starts) against plain; tok/s at batch 1 and 4, a decode
     step's wall and device-busy time at B = 1 and 4, a serving block
     under set_sync_debug_mode("error"); then K5/K1 at 4 and 8 rows, K2
     over a batch of 4 tokens' pairs, K3 at B = 4 with unequal kv_len and
     K9/K10 with per-row starts (beside the scalar form) against their
     plain versions.
  9. the tensor and expert mesh axes: after the seq phase, the unsharded
     runs on the card, then gloo ranks spawned on the one card (tensor=2,
     expert=2, expert=2 x tensor=2) each draw the DeepSeek-V3-width packed
     Q3_K model cut to 4 layers (f32 compute, bf16 cache, no factor
     weights) and keep their slice (``shard_params``): a 512-token prompt
     in 2 chunks (K10 at 64 heads at tensor=2, K5 row-tiled on cut planes,
     K6 over the local experts under the EP capacity) and 16 steps fed the
     unsharded greedy tokens (K3, K5 and K2 at the local shapes, non-owned
     pairs aliased), and at tensor=2 the DeepSeek-V2-Lite-width F8E5M2
     model cut to 2 layers (K9 and K8 at 8 heads, its ragged dense FFN
     whole on both ranks): logits within 1e-3 of the unsharded run's, the
     same bits and the same 0.8-sampled block on every rank; each rank's
     walls, peak and resident memory and time in collectives; then each
     kernel at those local shapes against its plain version;
 10. sessions: the tiny packed Q3_K checkpoint through Engine(device="cuda")
     with f16, bf16 and int8 caches, hydrated past its window and saved;
     a fresh Engine loads the session and resumes with the uninterrupted
     run's tokens.
 11. the data axis: the unsharded runs on the card, then gloo ranks on the
     one card (data=2, data=2 x expert=2) serve 4 requests of the serving
     mix through BatchScheduler(batch_size=4, logprobs=True,
     prefix_cache_mb=64, mesh=...) on the DeepSeek-V3-width packed Q3_K
     model cut to 4 layers (f32 compute, bf16 cache, no factor weights),
     each rank holding 2 of the 4 batch rows; then spec="ngram" and the
     DeepSeek-V2-Lite-width F8E5M2 model cut to 2 layers at data=2: greedy
     tokens the unsharded run's (near ties allowed), log-probs within 1e-3
     of its, every rank the same tokens and log-probs, and spec="ngram"
     bit for bit the unsharded batch-4 spec scheduler's (a verify chunk's
     rows are batch invariant); each rank's wall, time in collectives,
     peak and resident memory; then verify chunks on the same V3 draw
     over B = 1, 2 and 4 sequences (spec_k 4): each sequence's rows
     bit-equal to its chunk alone, timed on the invariant route and on
     the parent's; then K3, K5, K2 and K10 (verify mode) at a data
     shard's 2 rows against their plain versions;
 12. pipeline stages: the same V3-width draw through a 2-stage Pipeline in
     one process (both stages on the card) against the unsharded run, its
     decode_microbatched (2 microbatches of 2) against decode_step, 2
     stages x tensor=2 over 4 gloo ranks against the unsharded run, and 3
     stages over an int8 cache on a tiny 3-layer packed Q3_K checkpoint
     against its Engine past the window.
 13. conversion (``python -m deepseek_tpu_torch.convert``): (a) three tiny
     HF directories (V2 MHA fp16; V3 with an MTP layer, --mla --quant
     q3_k; an HF-FP8 input, --quant f8e5m2) converted by subprocesses on
     the card and in process on the CPU, byte-equal but attn.wc, then
     Engine(device="cuda") on each against the CPU Engine's greedy
     tokens; (b) DeepSeek-V3's published widths cut to its first 2 (dense)
     layers, F8_E4M3 + BF16 safetensors (~4.9 GB), to Q2_K with the
     native encoder: seconds, weights a second, peak RSS, bytes; a
     512-token prompt and 16 greedy tokens on the card, 32 tokens and 2
     steps against the CPU Engine with a debug capture on each side, the
     native tokenizer against the Python one; (c) DeepSeek-V2-Lite's
     widths cut to 2 layers, BF16, to fp16 and f8e5m2 on the card, each
     against the CPU Engine over 300 tokens and 8 steps (its K-quant
     conversion raises: 1408 and 10944 are no multiples of 256). The
     native libraries must build.
The launch counts are set to 0 just before each driven path and read just
after; a kernel that its path never launched fails the run. The line
before last holds the card's name and power limit; the last line is the
JSON result. Without a CUDA GPU the script exits 2 and prints none.
"""

import contextlib
import dataclasses
import json
import math
import os
import re
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
PREFILL_TOKENS = 512       # two chunks of the default prefill_chunk (256)
PREFILL_DECODE = 16
V2_LITE_LAYERS = 27        # DeepSeek-V2-Lite's full depth
V2_LITE_DECODE = 32
CUT_DECODE = 8             # decode steps of the 2-layer cuts held against the CPU
FP8_CUT_PROMPT = 300       # the fp8 cut: a chunk of 256 and one of 44


T_START = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - T_START:7.1f} s]", *a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(fn, iters=10):
    """Mean device time of one call. Each call is enqueued behind a 512 MB
    write that evicts the 50 MB L2 (decode finds its weights cold) and a
    ~1 ms device spin that keeps the device busy while the host prepares
    the call (the write alone drains before a wrapper's checks end), so the
    interval between the two events holds device time only. A call slower
    than 20 ms (a plain version over every expert) is timed 3 times."""
    flush = time_ms.flush
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 0.02:
        iters = min(iters, 3)
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


def bound_ms(nbytes: float, flops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------
# phase 2: the entry point on a tiny checkpoint
# ---------------------------------------------------------------------------

def save_tiny(path: str, cfg, tensors: dict, metadata=None) -> None:
    """Write a tiny checkpoint with the port's codec: the tensors, a
    byte-fallback vocabulary and the config's metadata (and ``metadata``)."""
    from deepseek_tpu_torch.utils.codec import pack_tokenizer_tokens, save_checkpoint

    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{i:02X}>".encode() for i in range(256)]
    vocab += [f"tok{i}".encode() for i in range(len(vocab), cfg.vocab_size)]
    tensors["tokenizer.tokens"] = pack_tokenizer_tokens(vocab)
    md = cfg.to_metadata()
    md.update(bos_token_id="1", eos_token_id="2", **(metadata or {}))
    save_checkpoint(path, [tensors], md)


def write_tiny_checkpoint(path: str, rng, quant: str = "q3_k",
                          max_seq_len: int = 64, window: int = 32,
                          mtp: bool = False, n_layers: int = 2) -> None:
    """A tiny absorbed-MLA MoE checkpoint of random Q3_K (or Q2_K) blocks
    with small f16 super scales, without the factor weights, 2 layers (one
    dense, one MoE) or ``n_layers`` (the first dense); with
    ``mtp``, DeepSeek-V3's multi-token-prediction layer too (``model.mtp.*``:
    the norms, eh_proj and an MoE block), drawn after the others."""
    from deepseek_tpu_torch.config import (
        ActivationType, ModelConfig, QuantKind, ScoringFunc, TopKMethod)
    from deepseek_tpu_torch.quant.kquant import Q2K_BLOCK_BYTES, Q3K_BLOCK_BYTES, QK_K

    cfg = ModelConfig(
        dim=512, hidden_dim=1024, n_layers=n_layers, n_heads=4, vocab_size=512,
        max_seq_len=max_seq_len, rope_theta=10000.0, norm_eps=1e-6,
        act=ActivationType.SILU, first_k_dense_replace=1, n_shared_experts=1,
        n_routed_experts=8, n_active_routed=2, moe_intermediate_size=256,
        routed_scaling_factor=2.5, n_group=2, norm_topk_prob=True,
        scoring_func=ScoringFunc.SIGMOID, topk_group=1,
        topk_method=TopKMethod.NOAUX_TC, has_moegate_bias=True, use_mla=True,
        kv_lora_rank=512, q_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128,
        weight_quant=QuantKind.Q3_K if quant == "q3_k" else QuantKind.Q2_K,
        rs_original_max_position_embeddings=window, arch="DeepseekV3ForCausalLM")

    def q3k(*shape):
        """Random Q3_K (Q2_K) blocks with small f16 super scales (and mins)."""
        *lead, rows, cols = shape
        nb = cols // QK_K
        if quant == "q2_k":
            raw = rng.integers(0, 256, (*lead, rows, nb, Q2K_BLOCK_BYTES), dtype=np.uint8)
            for at in (80, 82):                       # d, then dmin
                v = rng.uniform(2e-4, 6e-4, (*lead, rows, nb)).astype(np.float16)
                raw[..., at:at + 2] = v[..., None].view(np.uint8).reshape(*v.shape, 2)
            return raw.reshape(*lead, rows, nb * Q2K_BLOCK_BYTES)
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
    blocks = [(f"model.layers.{l}", c.is_moe_layer(l)) for l in range(c.n_layers)]
    if mtp:
        blocks.append(("model.mtp.block", True))
    for p, moe in blocks:
        if p == "model.mtp.block":
            t.update({"model.mtp.enorm.weight": f32(c.dim, scale=0.1, base=1.0),
                      "model.mtp.hnorm.weight": f32(c.dim, scale=0.1, base=1.0),
                      "model.mtp.norm.weight": f32(c.dim, scale=0.1, base=1.0),
                      "model.mtp.eh_proj.weight": q3k(c.dim, 2 * c.dim)})
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
        if moe:
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
    save_tiny(path, c, t)


def compare_hydrate(eng, ref, toks, label):
    """Engine.hydrate on the card against the CPU engine (plain versions):
    last logits within 1e-3 of their scale, the collected log-softmax rows
    within 2e-3 (a row moves by at most twice its logits' error)."""
    _, last, rows, _ = eng.hydrate(eng.new_cache(), toks, collect_all_logits=True)
    _, want_last, want_rows, _ = ref.hydrate(ref.new_cache(), toks,
                                             collect_all_logits=True)
    scale = float(np.abs(want_last).max())
    e_last = float(np.abs(last - want_last).max())
    e_rows = float(np.abs(rows - want_rows).max())
    log(f"{label}: hydrate of {len(toks)} tokens vs CPU plain: last logits max "
        f"abs err {e_last:.3e} (tolerance {1e-3 * scale:.3e}), log-softmax rows "
        f"{e_rows:.3e} (tolerance {2e-3 * scale:.3e})")
    if not (np.isfinite(last).all() and e_last <= 1e-3 * scale
            and e_rows <= 2e-3 * scale):
        raise RuntimeError(f"{label}: hydrate disagrees with the CPU engine")


def check_greedy(ref, prompt, out, label):
    """Each greedy token of the card's run is the CPU engine's argmax after
    the same tokens on generate's schedule (prefill the prompt, then one
    decode step a token), or within 1e-3 of the logit scale of it (a
    near-tie that the sums' order may break either way)."""
    cache = ref.new_cache()
    _, logits, _, pos = ref.hydrate(cache, prompt)
    tol = 1e-3 * float(np.abs(logits).max())
    for i, got in enumerate(out):
        want = int(logits.argmax())
        if got != want and float(logits[want] - logits[got]) > tol:
            raise RuntimeError(f"{label}: greedy token {got} at position "
                               f"{len(prompt) + i}, CPU says {want}")
        logits = ref.step(cache, got, pos)[0].float().cpu().numpy()
        pos += 1


def drive(counts, expect, label, fn):
    """Run one path with every launch count set to 0 just before and read
    just after; fail if a kernel of the path never launched."""
    reset(counts)
    out = fn()
    torch.cuda.synchronize()
    launched = read(counts)
    log(f"{label}: launches {launched}")
    missing = [k for k in expect if launched[k] == 0]
    if missing:
        raise RuntimeError(f"{label} never launched {missing}")
    return out, launched


def entry_point_phase(counts):
    from deepseek_tpu_torch.engine import Engine

    rng = np.random.default_rng(SEED)
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_tiny")
    shutil.rmtree(tmp, ignore_errors=True)
    write_tiny_checkpoint(tmp, rng)
    eng = Engine(tmp, device="cuda", seed=SEED, kquant_runtime="nibble")
    ref = Engine(tmp, device="cpu", seed=SEED, kquant_runtime="nibble")
    # 20 prompt tokens: the prefill chunk's projections take K1's row-tiled
    # route; the greedy tokens run past the 32-slot window
    prompt = eng.tokenizer.encode("hello, a prompt of twenty tokens", bos=True)[:20]
    n_new = 40 - len(prompt)
    (out, stats), launched = drive(
        counts, ("K1", "K1r", "K2", "K3", "K3-f16", "K10", "K10-f16"), "entry point",
        lambda: eng.generate(prompt, num_steps=n_new, temperature=0.0))
    log(f"entry point: Engine(tiny Q3_K .dseek, device='cuda', "
        f"kquant_runtime='nibble').generate -> "
        f"{len(out)} greedy tokens {out}, {stats.tok_per_s:.1f} tok/s "
        f"(tiny model, launch-bound)")
    toks = prompt + out
    compare_hydrate(eng, ref, toks[:30], "entry point")
    # teacher-forced decode logits against the CPU engine's plain versions
    # on the same tokens. Tolerance 1e-3 of the logit scale: the f32 sums
    # run in other orders and a latent can round to the neighbouring f16
    # cache value (2^-11 relative), as in tests/test_torch_engine.py
    c_gpu, c_cpu = eng.new_cache(), ref.new_cache()
    worst, scale = 0.0, 0.0
    for pos in range(len(toks) - 1):
        a = eng.step(c_gpu, toks[pos], pos)[0].float().cpu()
        b = ref.step(c_cpu, toks[pos], pos)[0].float()
        if not torch.isfinite(a).all():
            raise RuntimeError(f"non-finite logits at position {pos}")
        worst = max(worst, float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
    log(f"entry point: decode logits vs CPU plain: max abs err {worst:.3e} "
        f"(tolerance {1e-3 * scale:.3e} = 1e-3 of max|logit| {scale:.3f})")
    if not worst <= 1e-3 * scale:
        raise RuntimeError("entry-point logits disagree with the CPU engine")
    check_greedy(ref, prompt, out, "entry point")
    return launched


def kquant_entry_point_phase(counts, quant, runtime=None, sampled=False, kv=None):
    """A tiny random Q3_K or Q2_K checkpoint through Engine(device="cuda")
    with default arguments (the packed planes; ``runtime="turbo"``: the
    int8 turbo planes) against the same Engine on the CPU: a 100-token
    prompt is one prefill chunk with 200 token-expert pairs (300 where
    Q2_K turbo folds the shared expert into its tables), so the MoE layer
    runs K6 and the projections K5's row-tiled route, the attention K10;
    then 40 greedy tokens past the 128-slot window in the default 32-token
    decode blocks (K5's matvec, K2 on the expert tables and the per-head
    wv_b, K3). ``sampled``: fresh engines on the card and the CPU at the
    same seed then generate 40 tokens at temperature 0.8 (top_p 0.95), the
    first from the host sampler and the rest from the on-device sampler,
    and must give the same tokens. ``kv="int8"``: both Engines keep an int8
    KV cache (K3's and K10's int8 bodies), the sinks re-rotating from their
    float masters past the window, and the greedy tokens must equal the
    CPU Engine's. ``kv="float32"``: an f32 cache (K10's f32 body; the
    default f16 cache runs its f16 body)."""
    from deepseek_tpu_torch.engine import Engine
    from deepseek_tpu_torch.quant.qtensor import (
        Q2KTensor, Q2KTurboTensor, Q3KTensor, Q3KTurboTensor)

    kind = runtime or "packed"
    label = f"{kind} {quant.upper()} entry point" + (f", {kv} cache" if kv else "")
    rng = np.random.default_rng(SEED + 8)
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       f"chip_smoke_{quant}")
    shutil.rmtree(tmp, ignore_errors=True)
    write_tiny_checkpoint(tmp, rng, quant, max_seq_len=256, window=128)
    opts = dict(seed=SEED, kquant_runtime=runtime, kv_cache_dtype=kv)
    eng = Engine(tmp, device="cuda", **opts)
    ref = Engine(tmp, device="cpu", **opts)
    cls = {("packed", "q3_k"): Q3KTensor, ("packed", "q2_k"): Q2KTensor,
           ("turbo", "q3_k"): Q3KTurboTensor, ("turbo", "q2_k"): Q2KTurboTensor}[
        (kind, quant)]
    moe = eng.params.layers[1]
    tables = ((moe.w13s, moe.w2s) if kind == "turbo" and quant == "q2_k"
              else (moe.w13, moe.shared_w13))
    if not (all(isinstance(t, cls) for t in tables)
            and isinstance(eng.params.layers[0].wv_b, cls)):
        raise RuntimeError(f"{label}: expected {cls.__name__} planes")
    sfx = "-turbo" if kind == "turbo" else "-packed"
    attn = {"int8": ("K3-int8", "K10-int8"),
            "float32": ("K3", "K3-f32", "K10", "K10-f32")} \
        .get(kv, ("K3", "K3-f16", "K10", "K10-f16"))
    prompt = [int(v) for v in rng.integers(3, 512, 100)]
    (out, stats), launched = drive(
        counts, (*attn, *(k + sfx for k in ("K5", "K5r", "K2", "K6"))),
        label, lambda: eng.generate(prompt, num_steps=40, temperature=0.0))
    log(f"{label}: Engine(tiny {quant.upper()} .dseek, device='cuda', "
        f"kquant_runtime={runtime!r}, kv_cache_dtype={kv!r}).generate (decode_block "
        f"{eng.decode_block}) -> {len(out)} greedy tokens past the 128-slot "
        f"window, first {out[:12]}")
    compare_hydrate(eng, ref, (prompt + out)[:140], label)
    check_greedy(ref, prompt, out, label)
    if kv == "int8":
        same_tokens(out, ref.generate(prompt, num_steps=40, temperature=0.0)[0],
                    f"{label}, greedy")
    if sampled:
        got, _ = Engine(tmp, device="cuda", **opts) \
            .generate(prompt, num_steps=40, temperature=0.8, top_p=0.95)
        want, _ = Engine(tmp, device="cpu", **opts) \
            .generate(prompt, num_steps=40, temperature=0.8, top_p=0.95)
        same_tokens(got, want, f"{label}, 40 tokens sampled at temperature 0.8, "
                    f"seed {SEED}")
    return launched


def same_tokens(got, want, label):
    """The card's tokens must be the CPU Engine's, all of them."""
    log(f"{label}: card {got}, CPU {want}")
    if got != want:
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                     min(len(got), len(want)))
        raise RuntimeError(f"{label}: token {first} differs: card "
                           f"{got[first:first + 1]}, CPU {want[first:first + 1]}")


def write_bf16_checkpoint(path: str, rng) -> None:
    """A tiny MoE checkpoint with bf16 weights (widths multiples of 128)
    that keeps the factor weights wq_b/wkv_b, so its prefill attends in
    decompressed head space (K9) and its MoE chunk runs K11."""
    from deepseek_tpu_torch.config import (
        ActivationType, ModelConfig, QuantKind, ScoringFunc, TopKMethod)
    from deepseek_tpu_torch.utils.codec import _DTYPE_TO_NP

    c = ModelConfig(
        dim=512, hidden_dim=1024, n_layers=2, n_heads=4, vocab_size=512,
        max_seq_len=256, rope_theta=10000.0, norm_eps=1e-6,
        act=ActivationType.SILU, first_k_dense_replace=1, n_shared_experts=1,
        n_routed_experts=8, n_active_routed=2, moe_intermediate_size=256,
        routed_scaling_factor=2.5, n_group=2, norm_topk_prob=True,
        scoring_func=ScoringFunc.SIGMOID, topk_group=1,
        topk_method=TopKMethod.NOAUX_TC, has_moegate_bias=True, use_mla=True,
        kv_lora_rank=512, q_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, weight_quant=QuantKind.F16,
        rs_original_max_position_embeddings=128, arch="DeepseekV3ForCausalLM")

    def bf16(*shape, scale=0.02):
        return to_bf16(rng.standard_normal(shape) * scale)

    def f32(*shape, scale=0.02, base=0.0):
        return (base + rng.standard_normal(shape) * scale).astype(np.float32)

    H, R, P, Dv, ql = c.n_heads, c.kv_lora_rank, c.qk_rope_head_dim, c.v_head_dim, c.q_lora_rank
    E, m, nope = c.n_routed_experts, c.moe_intermediate_size, c.qk_nope_head_dim

    def absorbed():
        """The factors wq_b/wkv_b and their absorption wc, wq_rope_b, wv_b
        as deepseek_tpu/convert.py:350-371 derives them."""
        q_b = rng.standard_normal((H, nope + P, ql)) * 0.05
        kv_b = rng.standard_normal((H, nope + Dv, R)) * 0.05
        c_proj = np.einsum("hnr,hnq->hrq", kv_b[:, :nope], q_b[:, :nope])
        return {"wq_b": q_b.reshape(-1, ql), "wkv_b": kv_b.reshape(-1, R),
                "wc": c_proj.reshape(-1, ql),
                "wq_rope_b": q_b[:, nope:].reshape(-1, ql),
                "wv_b": kv_b[:, nope:].reshape(-1, R)}

    def to_bf16(a):
        x = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return x.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16) \
            .view(_DTYPE_TO_NP["BF16"])

    t = {"model.embed.weight": bf16(c.vocab_size, c.dim, scale=1.0),
         "model.output.weight": bf16(c.vocab_size, c.dim),
         "model.norm.weight": f32(c.dim, scale=0.1, base=1.0)}
    for l in range(c.n_layers):
        p = f"model.layers.{l}"
        t.update({
            f"{p}.attn.norm.weight": f32(c.dim, scale=0.1, base=1.0),
            f"{p}.mlp.norm.weight": f32(c.dim, scale=0.1, base=1.0),
            f"{p}.attn.kv_a_norm.weight": f32(R, scale=0.1, base=1.0),
            f"{p}.attn.q_a_norm.weight": f32(ql, scale=0.1, base=1.0),
            f"{p}.attn.wkv_a.weight": bf16(R + P, c.dim),
            f"{p}.attn.wq_a.weight": bf16(ql, c.dim),
            f"{p}.attn.wo.weight": bf16(c.dim, H * Dv),
        })
        t.update({f"{p}.attn.{k}.weight": to_bf16(v) for k, v in absorbed().items()})
        if c.is_moe_layer(l):
            t.update({
                f"{p}.moegate.weight": f32(E, c.dim, scale=0.05),
                f"{p}.moegate.bias": f32(E, scale=0.01),
                f"{p}.mlp.w1.weight": bf16(E, m, c.dim),
                f"{p}.mlp.w3.weight": bf16(E, m, c.dim),
                f"{p}.mlp.w2.weight": bf16(E, c.dim, m),
                f"{p}.shared_mlp.w1.weight": bf16(m, c.dim),
                f"{p}.shared_mlp.w3.weight": bf16(m, c.dim),
                f"{p}.shared_mlp.w2.weight": bf16(c.dim, m),
            })
        else:
            t.update({f"{p}.mlp.w1.weight": bf16(c.hidden_dim, c.dim),
                      f"{p}.mlp.w3.weight": bf16(c.hidden_dim, c.dim),
                      f"{p}.mlp.w2.weight": bf16(c.dim, c.hidden_dim)})
    save_tiny(path, c, t)


def write_mha_checkpoint(path: str, rng) -> None:
    """A tiny 2-layer MoE checkpoint as the converter writes one by
    default: F16 weights, decompressed MHA (use_mla=0), no query LoRA.
    Vocab 16384 x dim 1024 makes the lm_head 32 MiB, so its decode steps
    take K4."""
    from deepseek_tpu_torch.config import (
        ActivationType, ModelConfig, QuantKind, ScoringFunc, TopKMethod)

    c = ModelConfig(
        dim=1024, hidden_dim=2048, n_layers=2, n_heads=4, vocab_size=16384,
        max_seq_len=256, rope_theta=10000.0, norm_eps=1e-6,
        act=ActivationType.SILU, first_k_dense_replace=1, n_shared_experts=1,
        n_routed_experts=8, n_active_routed=2, moe_intermediate_size=256,
        routed_scaling_factor=1.0, n_group=1, norm_topk_prob=False,
        scoring_func=ScoringFunc.SOFTMAX, topk_group=1,
        topk_method=TopKMethod.GREEDY, has_moegate_bias=False, use_mla=False,
        kv_lora_rank=256, q_lora_rank=0, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, weight_quant=QuantKind.F16,
        rs_original_max_position_embeddings=128, arch="DeepseekV2ForCausalLM")

    def f16(*shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float16)

    def f32(*shape, scale=0.02, base=0.0):
        return (base + rng.standard_normal(shape) * scale).astype(np.float32)

    H, R, P, Dv = c.n_heads, c.kv_lora_rank, c.qk_rope_head_dim, c.v_head_dim
    E, m, nope = c.n_routed_experts, c.moe_intermediate_size, c.qk_nope_head_dim
    t = {"model.embed.weight": f16(c.vocab_size, c.dim, scale=1.0),
         "model.output.weight": f16(c.vocab_size, c.dim),
         "model.norm.weight": f32(c.dim, scale=0.1, base=1.0)}
    for l in range(c.n_layers):
        p = f"model.layers.{l}"
        t.update({
            f"{p}.attn.norm.weight": f32(c.dim, scale=0.1, base=1.0),
            f"{p}.mlp.norm.weight": f32(c.dim, scale=0.1, base=1.0),
            f"{p}.attn.kv_a_norm.weight": f32(R, scale=0.1, base=1.0),
            f"{p}.attn.wkv_a.weight": f16(R + P, c.dim),
            f"{p}.attn.wq.weight": f16(H * c.head_dim, c.dim),
            f"{p}.attn.wkv_b.weight": f16(H * (nope + Dv), R, scale=0.05),
            f"{p}.attn.wo.weight": f16(c.dim, H * Dv),
        })
        if c.is_moe_layer(l):
            t.update({
                f"{p}.moegate.weight": f32(E, c.dim, scale=0.05),
                f"{p}.mlp.w1.weight": f16(E, m, c.dim),
                f"{p}.mlp.w3.weight": f16(E, m, c.dim),
                f"{p}.mlp.w2.weight": f16(E, c.dim, m),
                f"{p}.shared_mlp.w1.weight": f16(m, c.dim),
                f"{p}.shared_mlp.w3.weight": f16(m, c.dim),
                f"{p}.shared_mlp.w2.weight": f16(c.dim, m),
            })
        else:
            t.update({f"{p}.mlp.w1.weight": f16(c.hidden_dim, c.dim),
                      f"{p}.mlp.w3.weight": f16(c.hidden_dim, c.dim),
                      f"{p}.mlp.w2.weight": f16(c.dim, c.hidden_dim)})
    save_tiny(path, c, t)


def mha_entry_point_phase(counts, kv=None):
    """The converter's default kind of checkpoint (F16, MHA) through
    Engine(device="cuda") against Engine(device="cpu"): a 100-token prompt
    is one prefill chunk (K9; 300 token-expert pairs: K11), then 40 greedy
    decode steps past the 128-slot window (K8, K4 on the lm_head, K2's
    plain body on the expert tables). ``kv="int8"``: both Engines keep an
    int8 KV cache (K9's and K8's int8 bodies; the sink keys re-rotate from
    their float masters), and the greedy tokens must equal the CPU's."""
    from deepseek_tpu_torch.engine import Engine

    label = "MHA entry point" + (f", {kv} cache" if kv else "")
    rng = np.random.default_rng(SEED + 4)
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_mha")
    shutil.rmtree(tmp, ignore_errors=True)
    write_mha_checkpoint(tmp, rng)
    eng = Engine(tmp, device="cuda", seed=SEED, kv_cache_dtype=kv)
    ref = Engine(tmp, device="cpu", seed=SEED, kv_cache_dtype=kv)
    if eng.cfg.use_mla or eng.params.layers[0].wq is None:
        raise RuntimeError("MHA checkpoint: expected use_mla=0 and wq")
    prompt = [int(v) for v in rng.integers(3, 16384, 100)]
    attn = ("K8-int8", "K9-int8") if kv == "int8" else ("K8", "K9", "K9-f16")
    (out, stats), launched = drive(
        counts, ("K2f", "K4", "K11", *attn), label,
        lambda: eng.generate(prompt, num_steps=40, temperature=0.0))
    log(f"{label}: Engine(tiny F16 MHA .dseek, device='cuda', kv_cache_dtype="
        f"{kv!r}).generate -> {len(out)} greedy tokens past the 128-slot window, "
        f"first {out[:12]}")
    compare_hydrate(eng, ref, (prompt + out)[:140], label)
    check_greedy(ref, prompt, out, label)
    if kv == "int8":
        same_tokens(out, ref.generate(prompt, num_steps=40, temperature=0.0)[0],
                    f"{label}, greedy")
    return launched


def bf16_entry_point_phase(counts):
    """The bf16 MoE checkpoint through Engine(device="cuda"): a 100-token
    prompt is one prefill chunk with 300 token-expert pairs (k = 2 routed +
    1 shared), so the MoE layer runs K11; the attention runs K9. The decode
    steps after it run the bf16 expert tables through K2's plain body."""
    from deepseek_tpu_torch.engine import Engine

    rng = np.random.default_rng(SEED + 2)
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_bf16")
    shutil.rmtree(tmp, ignore_errors=True)
    write_bf16_checkpoint(tmp, rng)
    eng = Engine(tmp, device="cuda", seed=SEED)
    ref = Engine(tmp, device="cpu", seed=SEED)
    if eng.params.layers[1].w13s is None or eng.params.layers[0].wkv_b is None:
        raise RuntimeError("bf16 checkpoint: expected folded experts and factor weights")
    prompt = [int(v) for v in rng.integers(3, 512, 100)]
    (out, stats), launched = drive(
        counts, ("K2f", "K3", "K9", "K9-f32", "K11"), "bf16 entry point",
        lambda: eng.generate(prompt, num_steps=40, temperature=0.0))
    log(f"bf16 entry point: Engine(tiny bf16 MoE .dseek, device='cuda').generate "
        f"-> {len(out)} greedy tokens past the 128-slot window, first {out[:12]}")
    compare_hydrate(eng, ref, prompt, "bf16 entry point")
    check_greedy(ref, prompt, out, "bf16 entry point")
    return launched


def write_fp8_checkpoint(path: str, rng) -> None:
    """A tiny absorbed-MLA MoE checkpoint in F8E5M2 with 128x128 block
    scales, as the converter writes one (quantized with the port's
    quant/fp8.py and written with its codec, which needs no ml_dtypes): it
    keeps the factor weights wq_b/wkv_b, and its wkv_a (576 rows) and dense
    FFN (1088 wide) have partial edge blocks."""
    from deepseek_tpu_torch.config import (
        ActivationType, ModelConfig, QuantKind, ScoringFunc, TopKMethod)
    from deepseek_tpu_torch.quant.fp8 import blockwise_quantize
    from deepseek_tpu_torch.utils.codec import _DTYPE_TO_NP

    c = ModelConfig(
        dim=512, hidden_dim=1088, n_layers=2, n_heads=4, vocab_size=512,
        max_seq_len=256, rope_theta=10000.0, norm_eps=1e-6,
        act=ActivationType.SILU, first_k_dense_replace=1, n_shared_experts=1,
        n_routed_experts=8, n_active_routed=2, moe_intermediate_size=256,
        routed_scaling_factor=2.5, n_group=2, norm_topk_prob=True,
        scoring_func=ScoringFunc.SIGMOID, topk_group=1,
        topk_method=TopKMethod.NOAUX_TC, has_moegate_bias=True, use_mla=True,
        kv_lora_rank=512, q_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, weight_quant=QuantKind.F8E5M2,
        block_size=(128, 128), rs_original_max_position_embeddings=128,
        arch="DeepseekV3ForCausalLM")

    def fp8(name, w):
        """name.weight (fp8 bytes, per expert grids for a stack) and
        name.scale (f32) from a float weight."""
        mats = [w] if w.ndim == 2 else list(w)
        qs, ss = zip(*(blockwise_quantize(torch.from_numpy(np.ascontiguousarray(
            m, np.float32)), c.block_size) for m in mats))
        q = torch.stack(qs) if w.ndim == 3 else qs[0]
        s = torch.stack(ss) if w.ndim == 3 else ss[0]
        return {f"{name}.weight": q.view(torch.uint8).numpy().view(_DTYPE_TO_NP["F8_E5M2"]),
                f"{name}.scale": s.numpy()}

    def rnd(*shape, scale=0.02):
        return rng.standard_normal(shape) * scale

    def f32(*shape, scale=0.02, base=0.0):
        return (base + rng.standard_normal(shape) * scale).astype(np.float32)

    H, R, P, Dv, ql = c.n_heads, c.kv_lora_rank, c.qk_rope_head_dim, c.v_head_dim, c.q_lora_rank
    E, m, nope = c.n_routed_experts, c.moe_intermediate_size, c.qk_nope_head_dim
    t = {"model.norm.weight": f32(c.dim, scale=0.1, base=1.0)}
    t.update(fp8("model.embed", rnd(c.vocab_size, c.dim, scale=1.0)))
    t.update(fp8("model.output", rnd(c.vocab_size, c.dim)))
    for l in range(c.n_layers):
        p = f"model.layers.{l}"
        t.update({
            f"{p}.attn.norm.weight": f32(c.dim, scale=0.1, base=1.0),
            f"{p}.mlp.norm.weight": f32(c.dim, scale=0.1, base=1.0),
            f"{p}.attn.kv_a_norm.weight": f32(R, scale=0.1, base=1.0),
            f"{p}.attn.q_a_norm.weight": f32(ql, scale=0.1, base=1.0),
        })
        q_b = rnd(H, nope + P, ql, scale=0.05)
        kv_b = rnd(H, nope + Dv, R, scale=0.05)
        # the absorption of deepseek_tpu/convert.py:350-371
        for k, w in (("wkv_a", rnd(R + P, c.dim)), ("wq_a", rnd(ql, c.dim)),
                     ("wo", rnd(c.dim, H * Dv)), ("wq_b", q_b.reshape(-1, ql)),
                     ("wkv_b", kv_b.reshape(-1, R)),
                     ("wc", np.einsum("hnr,hnq->hrq", kv_b[:, :nope],
                                      q_b[:, :nope]).reshape(-1, ql)),
                     ("wq_rope_b", q_b[:, nope:].reshape(-1, ql)),
                     ("wv_b", kv_b[:, nope:].reshape(-1, R))):
            t.update(fp8(f"{p}.attn.{k}", w))
        if c.is_moe_layer(l):
            t.update({f"{p}.moegate.weight": f32(E, c.dim, scale=0.05),
                      f"{p}.moegate.bias": f32(E, scale=0.01)})
            for k, shape in (("mlp.w1", (E, m, c.dim)), ("mlp.w3", (E, m, c.dim)),
                             ("mlp.w2", (E, c.dim, m)), ("shared_mlp.w1", (m, c.dim)),
                             ("shared_mlp.w3", (m, c.dim)), ("shared_mlp.w2", (c.dim, m))):
                t.update(fp8(f"{p}.{k}", rnd(*shape)))
        else:
            for k, shape in (("w1", (c.hidden_dim, c.dim)), ("w3", (c.hidden_dim, c.dim)),
                             ("w2", (c.dim, c.hidden_dim))):
                t.update(fp8(f"{p}.mlp.{k}", rnd(*shape)))
    save_tiny(path, c, t)


def fp8_entry_point_phase(counts):
    """The tiny F8E5M2 MLA checkpoint through Engine(device="cuda") against
    Engine(device="cpu"): a 100-token prompt is one prefill chunk with 300
    token-expert pairs (K6's fp8 body), its projections and wkv_b over the
    window on K5's row-tiled route, attention through K9; then 40 greedy
    decode steps past the 128-slot window (K5's matvec, K2's fp8 body on
    the expert tables and the per-head wv_b, K3)."""
    from deepseek_tpu_torch.engine import Engine

    rng = np.random.default_rng(SEED + 7)
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_fp8")
    shutil.rmtree(tmp, ignore_errors=True)
    write_fp8_checkpoint(tmp, rng)
    eng = Engine(tmp, device="cuda", seed=SEED)
    ref = Engine(tmp, device="cpu", seed=SEED)
    lp0, lp1 = eng.params.layers
    if not (eng.cfg.block_size == (128, 128) and lp1.w13s is not None
            and lp0.wkv_b is not None and lp0.wkv_a.shape[0] % 128
            and lp0.w1.shape[0] % 128):
        raise RuntimeError("fp8 checkpoint: expected 128x128 blocks, folded "
                           "experts, factor weights, ragged wkv_a and w1")
    prompt = [int(v) for v in rng.integers(3, 512, 100)]
    (out, stats), launched = drive(
        counts, ("K3", "K5", "K5r", "K2-fp8", "K6-fp8", "K9"), "fp8 entry point",
        lambda: eng.generate(prompt, num_steps=40, temperature=0.0))
    log(f"fp8 entry point: Engine(tiny F8E5M2 MLA .dseek, device='cuda').generate "
        f"-> {len(out)} greedy tokens past the 128-slot window, first {out[:12]}")
    compare_hydrate(eng, ref, (prompt + out)[:140], "fp8 entry point")
    check_greedy(ref, prompt, out, "fp8 entry point")
    return launched


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


def rand_packed(gen, rows, cols, quant):
    """A random packed Q2_K/Q3_K weight on the card, in the ranges of
    models/testing.py::random_fused_params."""
    from deepseek_tpu_torch.quant.qtensor import Q2KTensor, Q3KTensor
    u8 = lambda c: torch.randint(0, 256, (rows, c), generator=gen, device="cuda",
                                 dtype=torch.uint8)
    sup = lambda: torch.rand((rows, cols // 256), generator=gen, device="cuda") \
        * 0.009 + 0.001
    if quant == "q2_k":
        return Q2KTensor(qs=u8(cols // 4), sm=u8(cols // 16), d=sup(), dmin=sup())
    sc = torch.randint(-32, 32, (rows, cols // 16), generator=gen, device="cuda",
                       dtype=torch.int8)
    return Q3KTensor(qs=u8(cols // 4), hm=u8(cols // 8), sc=sc, d=sup())


def check(entry, got, want, rel_tol):
    err = float((got - want).abs().max())
    ref = float(want.abs().max())
    entry["max_abs_err"] = err
    ok = math.isfinite(err) and err <= rel_tol * max(ref, 1e-30)
    log(f"  {entry['name']}: max abs err {err:.3e} (tolerance {rel_tol:g} x "
        f"max|ref| {ref:.3f} = {rel_tol * ref:.3e}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{entry['name']} disagrees with its plain version")


def make_emit(entries, path=None):
    """emit(...) checks one kernel against its plain version, times both
    (and a library call, where one computes the same function) and appends
    the entry to ``entries``; ``path`` names the driven run whose launch
    counts the entry reports (default: the kernel's entry in main's
    path_of)."""
    def emit(name, fn, plain, tol, nb, flops, source, replaces, kernel,
             library=None, select=lambda y: y):
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "kernel": kernel, "path": path}
        check(entry, select(fn()), select(plain()), tol)
        entry["ms"] = time_ms(fn)
        entry["plain_ms"] = time_ms(plain)
        entry["bound_ms"], entry["bound_by"] = bound_ms(nb, flops)
        if library is not None:
            try:
                library()
            except Exception as exc:    # the yardstick only; the port never calls it
                log(f"  {name}: library call unavailable: {type(exc).__name__}: "
                    f"{str(exc)[:200]}")
                library = None
        entry["library_ms"] = time_ms(library) if library is not None else None
        log(f"  {name}: {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
            f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})"
            + (f", library {entry['library_ms']:.4f} ms" if library else ""))
        entries.append(entry)
        return entry
    return emit


def kernel_phase(params, cfg, entries):
    from deepseek_tpu_torch.models.testing import deepseek_v2_lite_proportions
    from deepseek_tpu_torch.ops.kernels.attention import (
        mla_decode_attn, mla_decode_attn_plain)
    from deepseek_tpu_torch.ops.kernels.qmm import (
        ROW_TILE_MIN, qmm, qmm_experts, qmm_experts_plain, qmm_plain)
    from deepseek_tpu_torch.quant.qtensor import PlainTensor

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    emit = make_emit(entries)
    dense, moe = params.layers[0], params.layers[cfg.n_layers - 1]
    H = cfg.n_heads

    # K1 over every dense projection shape of the path at 1 to ROW_TILE_MIN
    # rows (the matvec's row counts); Q3_K from the model itself, Q2_K (with
    # its min plane) synthesized at the same shapes. Tolerance 1e-4 of
    # max|ref|: x split into two int8 terms a 16-column group (~15 bits)
    # against the exact nibbles in __dp4a, f32 folds in other orders.
    mv_src = "deepseek_tpu_torch/csrc/nibble_mv.cu"
    k1 = {"wkvq": dense.wkvq, "wcr": dense.wcr, "wo": dense.wo,
          "w13 (dense)": dense.w13, "w2 (dense)": dense.w2,
          "lm_head": params.lm_head}
    for quant in ("q3_k", "q2_k"):
        for label, qt in k1.items():
            d, n = qt.shape
            if quant == "q2_k":
                qt = rand_nibble(gen, d, n, quant)
            for rows in range(1, ROW_TILE_MIN + 1):
                x = torch.randn((rows, n), generator=gen, device="cuda")
                emit(f"K1 qmm {quant} nibble {label} {rows}x{d}x{n}",
                     lambda: qmm(qt, x), lambda: qmm_plain(qt, x), 1e-4,
                     nbytes(x, qt.p, qt.a, qt.c) + 4 * rows * d, 2.0 * rows * d * n,
                     mv_src, "deepseek_tpu/ops/pallas/qmm.py:312 (qmm, _knib_body :206, "
                     "pallas_call :400)", "K1")
            del qt

    # K2: the MoE tables for one token's 8 routed + 1 shared experts, and the
    # per-head wv_b (idx = head id), the ids as the model gives them (int64)
    # and as int32, both read as given
    E = cfg.n_routed_experts
    sel = torch.randperm(E, generator=gen, device="cuda")[:cfg.n_active_routed]
    eids = torch.cat([sel.sort().values, torch.tensor([E], device="cuda")])
    wv3 = dense.wv_b.map(lambda t: t.reshape(H, t.shape[0] // H, t.shape[1]))
    k2 = [("w13s (MoE)", moe.w13s, eids), ("w2s (MoE)", moe.w2s, eids),
          ("wv_b (per head)", wv3, torch.arange(H, device="cuda"))]
    for label, qt, ids in k2:
        _, d, n = qt.shape
        x = torch.randn((ids.numel(), n), generator=gen, device="cuda")
        u = ids.unique()
        for idx in (ids, ids.to(torch.int32)):
            emit(f"K2 qmm_experts q3_k nibble {label} {str(idx.dtype)[6:]} ids "
                 f"{idx.numel()}x{d}x{n}",
                 lambda: qmm_experts(qt, idx, x), lambda: qmm_experts_plain(qt, idx, x),
                 1e-4, nbytes(x, idx, qt.p[u], qt.a[u]) + 4 * d * idx.numel(),
                 2.0 * idx.numel() * d * n, mv_src,
                 "deepseek_tpu/ops/pallas/qmm.py:566 (qmm_experts, _knib_body :206, "
                 "pallas_call :710)", "K2")

    # K2's plain body: bf16 MoE tables at V3 widths for one token's 9
    # experts, the expert count cut from 257 to 16 (the pair path reads
    # only the 9 it is given). Tolerance 1e-4 of max|ref|: f32 sums of the
    # same widened products in other orders.
    m = cfg.moe_intermediate_size
    for label, d, n in (("w13s", 2 * m, cfg.dim), ("w2s", cfg.dim, m)):
        qt = PlainTensor(data=torch.randn((16, d, n), generator=gen, device="cuda",
                                          dtype=torch.bfloat16) * 0.02)
        idx = torch.randperm(16, generator=gen, device="cuda")[:9].sort().values
        x = torch.randn((9, n), generator=gen, device="cuda")
        # yardstick only: torch.bmm over the 9 gathered bf16 tables with x in
        # bf16 (f32 accumulation), both gathered and cast before the clock
        wsel, x16 = qt.data[idx], x.to(torch.bfloat16)[:, :, None]
        emit(f"K2 qmm_experts bf16 plain table {label} 9x{d}x{n}",
             lambda: qmm_experts(qt, idx, x), lambda: qmm_experts_plain(qt, idx, x),
             1e-4, nbytes(x) + 9 * d * n * 2 + 4 * d * 9, 2.0 * 9 * d * n,
             "deepseek_tpu_torch/csrc/qmm.cu",
             "deepseek_tpu/ops/pallas/qmm.py:566 (qmm_experts, plain body :651)",
             "K2f", library=lambda: torch.bmm(wsel, x16))
        del qt, wsel

    # K3 at the V3 window over every float cache dtype (bf16: the V3 cells';
    # f16: the Engine's default; f32), at kv_len < S, a ragged S and a short
    # window (kv_len 32: all but one span empty). Tolerance 1e-4 of
    # max|ref|: the split bf16 operands, f32 sums over thousands of slots
    # in other orders, exp2.
    R, P = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    scale = cfg.attn_softmax_scale()
    k3_cells = [(torch.bfloat16, cfg.kv_window, cfg.kv_window - 96),
                (torch.bfloat16, cfg.kv_window - 3, 3001),
                (torch.bfloat16, cfg.kv_window, 32)]
    k3_cells += [(dt, cfg.kv_window, kv) for dt in (torch.float16, torch.float32)
                 for kv in (cfg.kv_window - 96, 32)]
    for dt, S, kv in k3_cells:
        tag = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}[dt]
        qc = torch.randn((1, H, R), generator=gen, device="cuda")
        qr = torch.randn((1, H, P), generator=gen, device="cuda")
        ckv = torch.randn((1, S, R), generator=gen, device="cuda").to(dt)
        kr = torch.randn((1, S, P), generator=gen, device="cuda").to(dt)
        kl = torch.tensor([kv], device="cuda", dtype=torch.int32)
        # yardstick only: SDPA over the concatenated MQA form [q_c|q_rope],
        # [ckv|krope], values ckv, slots >= kv_len masked (the port never
        # calls it), in the cache's dtype (bf16 for an f32 cache)
        sd = torch.bfloat16 if dt == torch.float32 else dt
        q_cat = torch.cat([qc, qr], -1)[:, :, None].to(sd)
        k_cat = torch.cat([ckv, kr], -1).to(sd)[:, None].expand(1, H, S, R + P)
        v_cat = ckv.to(sd)[:, None].expand(1, H, S, R)
        mask = (torch.arange(S, device="cuda") < kv)[None, None, None]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q_cat, k_cat, v_cat, attn_mask=mask, scale=scale)

        emit(f"K3 mla_decode_attn {tag} cache S={S} kv_len={kv} H={H}",
             lambda: mla_decode_attn(qc, qr, ckv, kr, kl, scale),
             lambda: mla_decode_attn_plain(qc, qr, ckv, kr, kl, scale), 1e-4,
             kv * (R + P) * ckv.element_size() + nbytes(qc, qr) + 4 * H * R,
             2.0 * H * kv * (2 * R + P), "deepseek_tpu_torch/csrc/prefill_attn.cu",
             "deepseek_tpu/ops/pallas/attention.py:170 (mla_decode_attn, _mla_body :89, "
             "pallas_call :221)", "K3" if dt == torch.bfloat16 else f"K3-{tag}",
             library=sdpa)
        del ckv, kr, k_cat, v_cat

    emit_v2 = make_emit(entries, "V2-Lite")
    # K2's plain body at DeepSeek-V2-Lite's decode shape: one token's 6
    # routed + 2 shared experts over its F16 w13s and w2s (66 tables),
    # launched 52 times a V2-Lite token. Yardstick: torch.bmm over the 8
    # gathered f16 tables with x in f16 (f32 accumulation): the same
    # bytes, the activation's rounding left out.
    v2 = deepseek_v2_lite_proportions()
    mv = v2.moe_intermediate_size
    for label, d, n in (("w13s", 2 * mv, v2.dim), ("w2s", v2.dim, mv)):
        n_tab = v2.n_routed_experts + v2.n_shared_experts
        qt = PlainTensor(data=torch.randn((n_tab, d, n), generator=gen, device="cuda",
                                          dtype=torch.float16) * 0.02)
        routed = torch.randperm(v2.n_routed_experts, generator=gen,
                                device="cuda")[:v2.n_active_routed].sort().values
        idx = torch.cat([routed, torch.arange(v2.n_routed_experts, n_tab, device="cuda")])
        x = torch.randn((idx.numel(), n), generator=gen, device="cuda")
        wsel, x16 = qt.data[idx], x.to(torch.float16)[:, :, None]
        emit_v2(f"K2 qmm_experts f16 plain table {label} (V2-Lite) {idx.numel()}x{d}x{n}",
                lambda: qmm_experts(qt, idx, x), lambda: qmm_experts_plain(qt, idx, x),
                1e-4, nbytes(x) + idx.numel() * d * n * 2 + 4 * d * idx.numel(),
                2.0 * idx.numel() * d * n, "deepseek_tpu_torch/csrc/qmm.cu",
                "deepseek_tpu/ops/pallas/qmm.py:566 (qmm_experts, plain body :651)",
                "K2f", library=lambda: torch.bmm(wsel, x16))
        del qt, wsel
    prefill_kernel_entries(params, cfg, gen, emit, emit_v2)
    mha_kernel_entries(gen, emit)
    fp8_kernel_entries(gen, emit)
    int8_kernel_entries(cfg, gen, emit, emit_v2)


def rand_fp8(gen, lead, d, n, block=(128, 128)):
    """A random blockwise F8E5M2 weight or table on the card: normal bf16
    values cast to e5m2, scales uniform in [0.005, 0.02] on the ceil grid."""
    from deepseek_tpu_torch.quant.qtensor import Fp8Tensor
    data = torch.randn((d, n), generator=gen, device="cuda").to(torch.bfloat16) \
        .to(torch.float8_e5m2).view(torch.uint8)
    sc = torch.rand((-(-d // block[0]), -(-n // block[1])), generator=gen,
                    device="cuda") * 0.015 + 0.005
    if lead:
        data = data.expand(lead, d, n).contiguous()
        sc = sc.expand(lead, *sc.shape).contiguous()
    return Fp8Tensor(data=data.view(torch.float8_e5m2), scale=sc, block_size=block)


def fp8_kernel_entries(gen, emit):
    """The fp8 bodies at DeepSeek-V2-Lite's F8E5M2 shapes (128x128 blocks):
    K5's matvec (the lm_head, wq, the ragged wkv_a, wkv_b, wo and the dense
    w13 and ragged w2) at 1 to ROW_TILE_MIN rows (the most it takes at these
    blocks), and on a 32x16-block weight at 5 and 13 rows (passes of
    ROW_TILE_MIN), its row-tiled route (wq over a
    256-token chunk, wkv_b over the 4096-slot window), K2's fp8 body on the folded tables for one token's 6
    routed + 2 shared experts, and K6's on a 256-token chunk's tiles. No
    PyTorch call computes a block-scaled e5m2 x f32 product, so
    library_ms is null; `bf16_copy_ms` times torch.matmul over a bf16 copy
    of the dequantized weight (another function, reading twice the
    bytes). Tolerance 1e-4 of
    max|ref|: the same products, the scale applied per 4-column word sum
    (matvec) or per weight (tiles), summed in other orders."""
    from deepseek_tpu_torch.ops.kernels.qmm import (
        ROW_TILE_MIN, qmm, qmm_experts, qmm_experts_plain, qmm_grouped,
        qmm_grouped_plain, qmm_plain, qmm_fp8_rows)
    from deepseek_tpu_torch.ops.matmul import tile_dispatch

    qmm_src, tiles_src = "deepseek_tpu_torch/csrc/qmm.cu", "deepseek_tpu_torch/csrc/qmm_tiles.cu"
    mv_src = "deepseek_tpu_torch/csrc/fp8_mv.cu"
    k5 = "deepseek_tpu/ops/pallas/qmm.py:312 (qmm, _fp8_body :260, pallas_call :418)"

    def fp8_bytes(qt):
        return qt.data.numel() + 4 * qt.scale.numel()

    def with_copy(entry_fn, qt, x):
        """emit, then time the bf16-copy yardstick beside the entry."""
        entry = entry_fn()
        w16 = qt.dequant(torch.float32).to(torch.bfloat16)
        x16 = x.to(torch.bfloat16)
        entry["bf16_copy_ms"] = time_ms(lambda: torch.matmul(x16, w16.t()))
        log(f"  {entry['name']}: torch.matmul over a bf16 copy of the weight "
            f"(another function) {entry['bf16_copy_ms']:.4f} ms")
        del w16

    shapes = [("lm_head", 102400, 2048), ("wq", 3072, 2048),
              ("wkv_a (ragged rows)", 576, 2048), ("w2 dense (ragged columns)", 2048, 10944),
              ("wkv_b", 4096, 512), ("wo", 2048, 2048), ("w13 dense", 21888, 2048)]
    for label, d, n in shapes:
        qt = rand_fp8(gen, 0, d, n)
        for rows in range(1, ROW_TILE_MIN + 1):    # the matvec's row counts
            x = torch.randn((rows, n), generator=gen, device="cuda")
            entry = lambda: emit(
                f"K5 qmm fp8 128x128 {label} (V2-Lite) {rows}x{d}x{n}",
                lambda: qmm(qt, x), lambda: qmm_plain(qt, x), 1e-4,
                nbytes(x) + fp8_bytes(qt) + 4 * rows * d, 2.0 * rows * d * n,
                mv_src, k5, "K5")
            if rows in (1, ROW_TILE_MIN):
                with_copy(entry, qt, x)
            else:
                entry()
        # the cells' bf16 x, read as it is (no cast launch)
        xb = torch.randn((1, n), generator=gen, device="cuda").to(torch.bfloat16)
        emit(f"K5 qmm fp8 128x128 {label} (V2-Lite) bf16 x 1x{d}x{n}",
             lambda: qmm(qt, xb), lambda: qmm_plain(qt, xb), 1e-4,
             nbytes(xb) + fp8_bytes(qt) + 4 * d, 2.0 * d * n, mv_src, k5, "K5")
        del qt
    # a weight whose 32x16 blocks keep K5 on the matvec at any rows: passes
    # of ROW_TILE_MIN x rows, each reading the weight once
    qt = rand_fp8(gen, 0, 300, 448, block=(32, 16))
    for rows in (5, 13):
        x = torch.randn((rows, 448), generator=gen, device="cuda")
        passes = -(-rows // ROW_TILE_MIN)
        emit(f"K5 qmm fp8 32x16 blocks (small-block matvec, {passes} passes) {rows}x300x448",
             lambda: qmm(qt, x), lambda: qmm_plain(qt, x), 1e-4,
             nbytes(x) + fp8_bytes(qt) + 4 * rows * 300, 2.0 * rows * 300 * 448,
             mv_src, k5, "K5")
    del qt

    # K5's two routes at few rows, to place ROW_TILE_MIN for fp8 weights:
    # the matvec (qmm with the threshold raised past the row count; 8 x
    # rows a pass) against the tile GEMM (qmm_fp8_rows)
    import deepseek_tpu_torch.ops.kernels.qmm as qmm_mod
    keep = qmm_mod.ROW_TILE_MIN
    for label, d, n in (shapes[0], shapes[1], shapes[3]):
        qt = rand_fp8(gen, 0, d, n)
        won = {}
        for rows in (1, 2, 4, 8, 16, 24, 32):
            x = torch.randn((rows, n), generator=gen, device="cuda")
            qmm_mod.ROW_TILE_MIN = 1 << 30
            try:
                t_vec = time_ms(lambda: qmm_mod.qmm(qt, x))
            finally:
                qmm_mod.ROW_TILE_MIN = keep
            t_tile = time_ms(lambda: qmm_fp8_rows(qt, x))
            won[rows] = t_tile < t_vec
            log(f"  K5 fp8 routes {label} {d}x{n} at {rows} rows: matvec "
                f"{t_vec:.4f} ms, row-tiled {t_tile:.4f} ms")
        first = min((r for r in won if all(won[q] for q in won if q >= r)),
                    default=None)
        log(f"  K5 fp8 routes {label}: row-tiled faster from {first} rows on "
            f"(ROW_TILE_MIN = {keep}: the matvec up to it)")
        del qt

    for label, d, n, rows in (("wq", 3072, 2048, 256), ("wkv_b", 4096, 512, 4096)):
        qt = rand_fp8(gen, 0, d, n)
        x = torch.randn((rows, n), generator=gen, device="cuda")
        with_copy(lambda: emit(
            f"K5 qmm row-tiled fp8 128x128 {label} (V2-Lite) {rows}x{d}x{n}",
            lambda: qmm_fp8_rows(qt, x), lambda: qmm_plain(qt, x), 1e-4,
            nbytes(x) + fp8_bytes(qt) + 4 * rows * d, 2.0 * rows * d * n,
            tiles_src, k5 + ", rows tiled by 128 :347-351", "K5r"), qt, x)
        del qt

    # the folded V2-Lite tables: 64 routed + 2 shared experts
    E, ns, k, T = 64, 2, 6, 256
    tables = {"w13s": rand_fp8(gen, E + ns, 2816, 2048),
              "w2s": rand_fp8(gen, E + ns, 2048, 1408)}
    sel = torch.randperm(E, generator=gen, device="cuda")[:k].sort().values
    eids = torch.cat([sel, torch.arange(E, E + ns, device="cuda")])
    for label, qt in tables.items():
        _, d, n = qt.shape
        x = torch.randn((eids.numel(), n), generator=gen, device="cuda")
        per_expert = qt.data[0].numel() + 4 * qt.scale[0].numel()
        emit(f"K2 qmm_experts fp8 128x128 {label} (V2-Lite MoE) {eids.numel()}x{d}x{n}",
             lambda: qmm_experts(qt, eids, x), lambda: qmm_experts_plain(qt, eids, x),
             1e-4, nbytes(x) + per_expert * eids.numel() + 4 * d * eids.numel(),
             2.0 * eids.numel() * d * n, qmm_src,
             "deepseek_tpu/ops/pallas/qmm.py:566 (qmm_experts, fp8 body :664, "
             "_fp8_body :260)", "K2-fp8")

    # K6: a random 256-token routing, 6 routed + 2 shared experts a token
    # (2048 pairs); only the live rows are computed, compared and counted
    routed = torch.rand((T, E), generator=gen, device="cuda").topk(k, dim=-1).indices
    idx = torch.cat([routed, torch.arange(E, E + ns, device="cuda").expand(T, ns)], -1)
    te, tr, _, G = tile_dispatch(idx.reshape(-1), E + ns)
    live = torch.arange(128, device="cuda")[None, :] < tr[:, None]
    n_live, n_exp = int(tr.sum()), int(te[tr > 0].unique().numel())
    for label, qt in tables.items():
        _, d, n = qt.shape
        x = torch.randn((G, 128, n), generator=gen, device="cuda")
        per_expert = qt.data[0].numel() + 4 * qt.scale[0].numel()
        emit(f"K6 qmm_grouped fp8 128x128 {label} (V2-Lite MoE) {G} tiles, "
             f"{n_live} pairs over {n_exp} experts, {d}x{n}",
             lambda: qmm_grouped(qt, te, x, tr),
             lambda: qmm_grouped_plain(qt, te, x, tr), 1e-4,
             n_live * n * 4 + per_expert * n_exp + n_live * d * 4,
             2.0 * n_live * d * n, tiles_src,
             "deepseek_tpu/ops/pallas/qmm.py:449 (qmm_grouped, pallas_call :538, "
             "fp8 body :502-508)", "K6-fp8", select=lambda y: y[live])
    del tables


def packed_to_nibble(qt):
    """The nibble layout of a packed Q2_K/Q3_K weight, on the card (the
    port's q2k_to_nibble / q3k_to_nibble, bf16 scales): the same random
    weights timed through K1 beside the packed K5."""
    from deepseek_tpu_torch.quant.qtensor import KNibbleTensor, Q2KTensor
    u = torch.cat([(qt.qs >> s) & 3 for s in (0, 2, 4, 6)], dim=-1)
    q2 = isinstance(qt, Q2KTensor)
    if not q2:
        u = u + (torch.cat([(qt.hm >> b) & 1 for b in range(8)], dim=-1) << 2)
    n = u.shape[-1]
    p = (u[..., :n // 2] | (u[..., n // 2:] << 4)).contiguous()
    rep = lambda t: t.repeat_interleave(16, dim=-1)
    if q2:
        a = rep(qt.d) * (qt.sm & 0xF).float()
        c = (rep(qt.dmin) * (qt.sm >> 4).float()).to(torch.bfloat16)
        return KNibbleTensor(p=p, a=a.to(torch.bfloat16), c=c, off=0)
    a = rep(qt.d) * qt.sc.float()
    return KNibbleTensor(p=p, a=a.to(torch.bfloat16), c=None, off=4)


def packed_kernel_entries(params, cfg, quant, entries, dec_path, pre_path):
    """The packed bodies at the V3-width model's shapes, each against its
    plain version on the card: K5's matvec (csrc/packed_mv.cu) on the
    attention projections wkvq, wcr and wo, the fused dense w13 and w2 and
    the lm_head at 1 row, and on w13 at 2 to ROW_TILE_MIN rows (each weight
    byte read once for all of them); its row-tiled route on w13 over a
    256-token chunk and wkv_b over the 4096-slot window; K2's on the routed w13/w2 tables
    for the 8 experts of one token and on the per-head wv_b (128 heads of
    128 x 512); K6's on w13/w2 for a 256-token chunk (2048 pairs over 256
    experts: the shared expert is not folded into packed tables). Beside
    K5 on w13 at 1 and ROW_TILE_MIN rows, K1 on the nibble layout of the
    same weights. No PyTorch call computes a K-quant product (library_ms
    null); `bf16_copy_ms` times torch.matmul over a bf16 copy of the
    dequantized w13 (another function, 4.7-6.1x the bytes). Tolerance 1e-4
    of max|ref|: the matvec takes x in two int8 terms (2-4e-5 of max|ref|
    in the CPU emulation, tests/test_torch_packed_mv.py) and f32 sums in
    other orders."""
    from deepseek_tpu_torch.ops.kernels.qmm import (
        ROW_TILE_MIN, qmm, qmm_experts, qmm_experts_plain, qmm_grouped,
        qmm_grouped_plain, qmm_packed_rows, qmm_plain)
    from deepseek_tpu_torch.ops.matmul import tile_dispatch
    from deepseek_tpu_torch.quant.qtensor import rows_to_experts

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    emit_dec, emit_pre = make_emit(entries, dec_path), make_emit(entries, pre_path)
    emit_nib = make_emit(entries)
    dense, moe = params.layers[0], params.layers[cfg.n_layers - 1]
    Q, H = quant.upper(), cfg.n_heads
    mv_src = "deepseek_tpu_torch/csrc/packed_mv.cu"
    tiles_src = "deepseek_tpu_torch/csrc/qmm_tiles.cu"
    body = "_q2k_body :361" if quant == "q2_k" else "_q3k_body :368"
    k5 = f"deepseek_tpu/ops/pallas/qmm.py:312 (qmm, {body})"

    for label, qt, rows_list in (("wkvq", dense.wkvq, (1,)), ("wcr", dense.wcr, (1,)),
                                 ("wo", dense.wo, (1,)),
                                 ("w13 (dense)", dense.w13, range(1, ROW_TILE_MIN + 1)),
                                 ("w2 (dense)", dense.w2, (1,)),
                                 ("lm_head", params.lm_head, (1,))):
        d, n = qt.shape
        for rows in rows_list:
            x = torch.randn((rows, n), generator=gen, device="cuda")
            entry = emit_dec(f"K5 qmm {Q} packed {label} {rows}x{d}x{n}",
                             lambda: qmm(qt, x), lambda: qmm_plain(qt, x), 1e-4,
                             nbytes(x) + qt.nbytes_active + 4 * rows * d,
                             2.0 * rows * d * n, mv_src, k5, "K5-packed")
            if label != "w13 (dense)" or rows not in (1, ROW_TILE_MIN):
                continue
            nib = packed_to_nibble(qt)
            emit_nib(f"K1 qmm {Q} nibble (the same w13, converted) {rows}x{d}x{n}",
                     lambda: qmm(nib, x), lambda: qmm_plain(nib, x), 1e-4,
                     nbytes(x, nib.p, nib.a, nib.c) + 4 * rows * d, 2.0 * rows * d * n,
                     "deepseek_tpu_torch/csrc/nibble_mv.cu",
                     "deepseek_tpu/ops/pallas/qmm.py:312 (qmm, _knib_body :206)", "K1")
            del nib
            if rows == 1:
                w16 = qt.dequant(torch.float32).to(torch.bfloat16)
                x16 = x.to(torch.bfloat16)
                entry["bf16_copy_ms"] = time_ms(lambda: torch.matmul(x16, w16.t()))
                log(f"  {entry['name']}: torch.matmul over a bf16 copy of the weight "
                    f"(another function) {entry['bf16_copy_ms']:.4f} ms")
                del w16

    for label, qt, rows in (("w13 (dense)", dense.w13, 256),
                            ("wkv_b", dense.wkv_b, cfg.kv_window)):
        d, n = qt.shape
        x = torch.randn((rows, n), generator=gen, device="cuda")
        emit_pre(f"K5 qmm row-tiled {Q} packed {label} {rows}x{d}x{n}",
                 lambda: qmm_packed_rows(qt, x), lambda: qmm_plain(qt, x), 1e-4,
                 nbytes(x) + qt.nbytes_active + 4 * rows * d, 2.0 * rows * d * n,
                 tiles_src, k5 + ", rows tiled by 128 :347-351", "K5r-packed")

    # K2: one token's 8 routed experts (sorted, as the pair list holds them)
    E = cfg.n_routed_experts
    eids = torch.randperm(E, generator=gen, device="cuda")[:cfg.n_active_routed]
    eids = eids.sort().values
    k2 = (f"deepseek_tpu/ops/pallas/qmm.py:566 (qmm_experts, {body}, "
          f"bodies selected :622-629)")
    for label, qt, idx in (("w13 (MoE)", moe.w13, eids), ("w2 (MoE)", moe.w2, eids),
                           ("wv_b (per head)", rows_to_experts(dense.wv_b, H),
                            torch.arange(H, device="cuda"))):
        n_tab, d, n = qt.shape
        x = torch.randn((idx.numel(), n), generator=gen, device="cuda")
        per = qt.nbytes_active / n_tab
        emit_dec(f"K2 qmm_experts {Q} packed {label} {idx.numel()}x{d}x{n}",
                 lambda: qmm_experts(qt, idx, x), lambda: qmm_experts_plain(qt, idx, x),
                 1e-4, nbytes(x) + per * idx.unique().numel() + 4 * d * idx.numel(),
                 2.0 * idx.numel() * d * n, mv_src, k2, "K2-packed")

    # K6: a random 256-token routing, 8 routed experts a token (2048 pairs);
    # only the live rows are computed, compared and counted
    T = 256
    routed = torch.rand((T, E), generator=gen, device="cuda") \
        .topk(cfg.n_active_routed, dim=-1).indices
    te, tr, _, G = tile_dispatch(routed.reshape(-1), E)
    live = torch.arange(128, device="cuda")[None, :] < tr[:, None]
    n_live, n_exp = int(tr.sum()), int(te[tr > 0].unique().numel())
    for label, qt in (("w13", moe.w13), ("w2", moe.w2)):
        _, d, n = qt.shape
        x = torch.randn((G, 128, n), generator=gen, device="cuda")
        per = qt.nbytes_active / E
        emit_pre(f"K6 qmm_grouped {Q} packed {label} (MoE) {G} tiles, {n_live} pairs "
                 f"over {n_exp} experts, {d}x{n}",
                 lambda: qmm_grouped(qt, te, x, tr),
                 lambda: qmm_grouped_plain(qt, te, x, tr), 1e-4,
                 n_live * n * 4 + per * n_exp + n_live * d * 4,
                 2.0 * n_live * d * n, tiles_src,
                 f"deepseek_tpu/ops/pallas/qmm.py:449 (qmm_grouped, {body}, "
                 f"pallas_call :538)", "K6-packed", select=lambda y: y[live])
        del x


def turbo_kernel_entries(params, cfg, quant, entries, dec_path, pre_path):
    """The turbo bodies at the V3-width model's shapes, each against its
    plain version on the card (the turbo dequantization, bf16 scales, and
    one f32 product): K5's matvec on a dense w13 drawn in the packed layout
    and converted (1 and ROW_TILE_MIN rows), beside K5's packed body and K1
    on the nibble layout of the same weights; wo (1 row); the row-tiled route on
    the model's w13 over a 256-token chunk and wkv_b over the 4096-slot
    window; K2 on one token's experts of the MoE tables (Q2_K turbo's
    folded tables: the 8 routed and the shared expert) and on the per-head
    wv_b; K6 on a 256-token chunk's 2048 routed pairs. No PyTorch call
    computes a K-quant product (library_ms null). Tolerance 1e-4 of
    max|ref|: f32 sums in other orders, and the matvec's exact 0.5 + u/256
    floats whose offset cancels against f32 group sums."""
    from deepseek_tpu_torch.ops.kernels.qmm import (
        ROW_TILE_MIN, qmm, qmm_experts, qmm_experts_plain, qmm_grouped,
        qmm_grouped_plain, qmm_plain, qmm_turbo_rows)
    from deepseek_tpu_torch.ops.matmul import tile_dispatch
    from deepseek_tpu_torch.quant.qtensor import (
        q2k_to_turbo, q3k_to_turbo, rows_to_experts)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    emit_dec, emit_pre = make_emit(entries, dec_path), make_emit(entries, pre_path)
    Q, H = quant.upper(), cfg.n_heads
    emit_nib, emit_packed = make_emit(entries), make_emit(
        entries, f"full-width packed {Q} decode")
    dense, moe = params.layers[0], params.layers[cfg.n_layers - 1]
    qmm_src = "deepseek_tpu_torch/csrc/qmm.cu"
    tiles_src = "deepseek_tpu_torch/csrc/qmm_tiles.cu"
    body = "_q2kt_body :169, launched :378" if quant == "q2_k" else \
        "_q3kt_body :195, launched :385"
    k5 = f"deepseek_tpu/ops/pallas/qmm.py:312 (qmm, {body})"
    to_turbo = q2k_to_turbo if quant == "q2_k" else q3k_to_turbo

    # one dense w13 drawn as packed planes: turbo, packed and nibble
    d, n = 2 * cfg.hidden_dim, cfg.dim
    packed = rand_packed(gen, d, n, quant)
    turbo, nib = to_turbo(packed), packed_to_nibble(packed)
    for rows in (1, ROW_TILE_MIN):                 # the matvec's row counts
        x = torch.randn((rows, n), generator=gen, device="cuda")
        emit_dec(f"K5 qmm {Q} turbo w13 (dense) {rows}x{d}x{n}",
                 lambda: qmm(turbo, x), lambda: qmm_plain(turbo, x), 1e-4,
                 nbytes(x) + turbo.nbytes_active + 4 * rows * d, 2.0 * rows * d * n,
                 qmm_src, k5, "K5-turbo")
        if rows > 1:
            continue
        emit_packed(f"K5 qmm {Q} packed (the same w13) {rows}x{d}x{n}",
                    lambda: qmm(packed, x), lambda: qmm_plain(packed, x), 1e-4,
                    nbytes(x) + packed.nbytes_active + 4 * rows * d, 2.0 * rows * d * n,
                    "deepseek_tpu_torch/csrc/packed_mv.cu",
                    "deepseek_tpu/ops/pallas/qmm.py:312 (qmm, packed bodies "
                    ":361/:368)", "K5-packed")
        emit_nib(f"K1 qmm {Q} nibble (the same w13) {rows}x{d}x{n}",
                 lambda: qmm(nib, x), lambda: qmm_plain(nib, x), 1e-4,
                 nbytes(x, nib.p, nib.a, nib.c) + 4 * rows * d, 2.0 * rows * d * n,
                 "deepseek_tpu_torch/csrc/nibble_mv.cu",
                 "deepseek_tpu/ops/pallas/qmm.py:312 (qmm, _knib_body :206)", "K1")
    del packed, turbo, nib
    d, n = dense.wo.shape
    x = torch.randn((1, n), generator=gen, device="cuda")
    emit_dec(f"K5 qmm {Q} turbo wo 1x{d}x{n}", lambda: qmm(dense.wo, x),
             lambda: qmm_plain(dense.wo, x), 1e-4,
             nbytes(x) + dense.wo.nbytes_active + 4 * d, 2.0 * d * n, qmm_src, k5,
             "K5-turbo")

    for label, qt, rows in (("w13 (dense)", dense.w13, 256),
                            ("wkv_b", dense.wkv_b, cfg.kv_window)):
        d, n = qt.shape
        x = torch.randn((rows, n), generator=gen, device="cuda")
        emit_pre(f"K5 qmm row-tiled {Q} turbo {label} {rows}x{d}x{n}",
                 lambda: qmm_turbo_rows(qt, x), lambda: qmm_plain(qt, x), 1e-4,
                 nbytes(x) + qt.nbytes_active + 4 * rows * d, 2.0 * rows * d * n,
                 tiles_src, k5 + ", rows tiled by 128 :347-351", "K5r-turbo")

    # K2: one token's experts as the pair list holds them (sorted routed
    # ids, then Q2_K turbo's folded shared expert)
    E = cfg.n_routed_experts
    eids = torch.randperm(E, generator=gen, device="cuda")[:cfg.n_active_routed]
    eids = eids.sort().values
    folded = moe.w13s is not None
    if folded:
        eids = torch.cat([eids, torch.arange(E, E + cfg.n_shared_experts, device="cuda")])
    t13, t2 = (moe.w13s, moe.w2s) if folded else (moe.w13, moe.w2)
    k2 = (f"deepseek_tpu/ops/pallas/qmm.py:566 (qmm_experts, {body}, "
          f"bodies selected :630-637)")
    for label, qt, idx in (("w13 (MoE)", t13, eids), ("w2 (MoE)", t2, eids),
                           ("wv_b (per head)", rows_to_experts(dense.wv_b, H),
                            torch.arange(H, device="cuda"))):
        n_tab, d, n = qt.shape
        x = torch.randn((idx.numel(), n), generator=gen, device="cuda")
        per = qt.nbytes_active / n_tab
        emit_dec(f"K2 qmm_experts {Q} turbo {label} {idx.numel()}x{d}x{n}",
                 lambda: qmm_experts(qt, idx, x), lambda: qmm_experts_plain(qt, idx, x),
                 1e-4, nbytes(x) + per * idx.unique().numel() + 4 * d * idx.numel(),
                 2.0 * idx.numel() * d * n, qmm_src, k2, "K2-turbo")

    # K6: a random 256-token routing, 8 routed experts a token (2048 pairs);
    # only the live rows are computed, compared and counted
    T = 256
    routed = torch.rand((T, E), generator=gen, device="cuda") \
        .topk(cfg.n_active_routed, dim=-1).indices
    te, tr, _, G = tile_dispatch(routed.reshape(-1), t2.shape[0])
    live = torch.arange(128, device="cuda")[None, :] < tr[:, None]
    n_live, n_exp = int(tr.sum()), int(te[tr > 0].unique().numel())
    for label, qt in (("w13", t13), ("w2", t2)):
        _, d, n = qt.shape
        x = torch.randn((G, 128, n), generator=gen, device="cuda")
        per = qt.nbytes_active / qt.shape[0]
        emit_pre(f"K6 qmm_grouped {Q} turbo {label} (MoE) {G} tiles, {n_live} pairs "
                 f"over {n_exp} experts, {d}x{n}",
                 lambda: qmm_grouped(qt, te, x, tr),
                 lambda: qmm_grouped_plain(qt, te, x, tr), 1e-4,
                 n_live * n * 4 + per * n_exp + n_live * d * 4,
                 2.0 * n_live * d * n, tiles_src,
                 f"deepseek_tpu/ops/pallas/qmm.py:449 (qmm_grouped, {body}, "
                 f"bodies :479-487, pallas_call :538)", "K6-turbo",
                 select=lambda y: y[live])
        del x


def decode_tok_per_s(params, cfg, loop, blocked: bool, temperature: float,
                     n_tok=64, block=32):
    """Decode tok/s over ``n_tok`` tokens from a 1-token prompt, from a
    fresh cache after one warm-up block: ``blocked``, the 32-token blocks of
    ``loop`` (make_decode_loop: the token sampled on the card and fed back,
    one transfer a block); else forward_decode, the logits to the host and
    the host Sampler. Host clock around synchronized work."""
    from deepseek_tpu_torch.models.deepseek import forward_decode
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.ops import prng
    from deepseek_tpu_torch.sampler import Sampler

    cache = init_cache(cfg, device="cuda")
    sampler, key = Sampler(cfg.vocab_size, SEED), prng.PRNGKey(SEED)
    tok, pos = 1, 0

    def run(n):
        nonlocal tok, pos, key
        for _ in range(n // block if blocked else n):
            t = torch.full((1, 1), tok, dtype=torch.int64, device="cuda")
            if blocked:
                key, sub = prng.split(key)
                toks, _, _ = loop(params, cache, t, pos, sub, temperature, 0.95)
                got = toks[0].tolist()
            else:
                lg = forward_decode(params, cache, t, pos, cfg)[0].float().cpu().numpy()
                got = [sampler.sample(lg, temperature, 0.95)]
            pos, tok = pos + len(got), got[-1]

    with torch.inference_mode():
        run(block)                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n_tok)
        torch.cuda.synchronize()
    return n_tok / (time.perf_counter() - t0)


def decode_block_phase(params, cfg, label, reps=3):
    """Engine.generate's two decode loops at full width, 64 tokens from a
    1-token prompt at temperature 0 and 0.8 (top_p 0.95): decode_block 1
    (forward_decode, the logits to the host, the host Sampler) and
    decode_block 32 (make_decode_loop: the token sampled on the card and
    fed back, one transfer a block). The two alternate (1, 32, 32, 1, ...),
    ``reps`` runs each, every run from a fresh cache after one warm-up
    block; the host clock around synchronized work. Then one 32-token
    block at 0.8 runs under torch.cuda.set_sync_debug_mode("error"), which
    raises on an operation that synchronizes the host with the card."""
    from deepseek_tpu_torch.models.deepseek import make_decode_loop

    n_tok, block = 64, 32
    loop = make_decode_loop(cfg, block)
    res = {}
    with torch.inference_mode():
        for temperature in (0.0, 0.8):
            runs = {1: [], 32: []}
            for rep in range(reps):
                for b in ((1, 32) if rep % 2 == 0 else (32, 1)):
                    runs[b].append(decode_tok_per_s(params, cfg, loop, b == block,
                                                    temperature, n_tok, block))
            for b, v in runs.items():
                res[(b, temperature)] = v
                log(f"decode block ({label}), decode_block {b}, temperature "
                    f"{temperature}: {[round(x, 2) for x in v]} tok/s over {n_tok} "
                    f"tokens (runs alternating), median {float(np.median(v)):.2f}")
    sync_debug_block(params, cfg, label)
    return res


def sync_debug_block(params, cfg, label, block=32):
    """One 32-token decode block at temperature 0.8 under
    torch.cuda.set_sync_debug_mode("error"), which raises on an operation
    that synchronizes the host with the card (after a warm-up block)."""
    from deepseek_tpu_torch.models.deepseek import make_decode_loop
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.ops import prng

    loop = make_decode_loop(cfg, block)
    with torch.inference_mode():
        cache = init_cache(cfg, device="cuda")
        tok = torch.full((1, 1), 1, dtype=torch.int64, device="cuda")
        loop(params, cache, tok, 0, prng.PRNGKey(SEED), 0.8, 0.95)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            toks, logits, _ = loop(params, cache, tok, block, prng.PRNGKey(SEED),
                                   0.8, 0.95)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if toks.shape != (1, block) or not bool(torch.isfinite(logits).all()):
            raise RuntimeError("decode block under sync debug mode: bad output")
    log(f"decode block ({label}): a {block}-token block at temperature 0.8 ran "
        f"under set_sync_debug_mode('error') (no host synchronization inside it)")


def int8_cache_phase(params, cfg, counts, label, runs):
    """The V3-width model with an int8 KV cache (the JAX CLI's --kv-dtype
    int8): 64 greedy decode steps (K3's int8 body), the 512-token prefill
    in 2 chunks with the factor weights (the window dequantized, then the
    float K9) and without (K10's int8 body), one decode block under sync
    debug mode, and the cache's bytes beside the bf16 cache's."""
    from deepseek_tpu_torch.models.kvcache import init_cache

    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    lab = f"{label}, int8 cache"
    dec, pre = f"full-width {label} int8 decode", f"full-width {label} int8 prefill"
    runs[dec], _ = full_width_phase(params, cfg8, counts, lab,
                                    ("K5-packed", "K2-packed", "K3-int8"))
    runs[pre], _ = prefill_phase(
        params, cfg8, counts, lab, ("K5-packed", "K5r-packed", "K2-packed",
                                    "K3-int8", "K6-packed", "K9", "K10-int8"))
    sync_debug_block(params, cfg8, lab)
    n8 = init_cache(cfg8, device="cuda").nbytes
    n16 = init_cache(cfg, device="cuda").nbytes
    log(f"full width ({lab}): KV cache {n8 / 1e6:.3f} MB (int8 rows + f32 scales) "
        f"against {n16 / 1e6:.3f} MB in {cfg.kv_cache_dtype}, {cfg.n_layers} layers x "
        f"{cfg.kv_window} slots ({n8 / n16:.3f}x)")


# ---------------------------------------------------------------------------
# the fused expert FFN (DSEEK_FUSED_FFN=1): row-permuted nibble [w1;w3]
# tables, K7 and the prepermuted bodies of K2 and K6
# ---------------------------------------------------------------------------

def fused_entry_point_phase(counts):
    """The tiny Q3_K checkpoint of phase 2 (dim 512, m 256: fusable) through
    Engine(device="cuda", kquant_runtime="nibble") with DSEEK_FUSED_FFN=1
    set while the Engines load (the variable is read there, once), against
    the same Engine on the CPU: 96-token prefill chunks over a 100-token
    prompt in a 128-slot window put 192 token-expert pairs in the first
    chunk (K6 on the permuted w13, then K6's prepermuted body on w2) and 64
    in the second (K2, then K2's prepermuted body); then 40 greedy tokens in
    32-token decode blocks, one K7 launch a MoE layer a token. The tokens
    must equal the CPU Engine's."""
    from deepseek_tpu_torch.engine import Engine

    label = "fused FFN entry point"
    rng = np.random.default_rng(SEED + 8)
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_fused")
    shutil.rmtree(tmp, ignore_errors=True)
    write_tiny_checkpoint(tmp, rng, "q3_k", max_seq_len=256, window=128)
    opts = dict(seed=SEED, kquant_runtime="nibble", prefill_chunk=96)
    os.environ["DSEEK_FUSED_FFN"] = "1"
    try:
        eng = Engine(tmp, device="cuda", **opts)
        ref = Engine(tmp, device="cpu", **opts)
    finally:
        del os.environ["DSEEK_FUSED_FFN"]
    perm = [e.params.layers[1].w13.rowperm for e in (eng, ref)]
    if perm != [2, 2]:
        raise RuntimeError(f"{label}: expert w13 rowperm {perm}, expected 2")
    prompt = [int(v) for v in rng.integers(3, 512, 100)]
    (out, _), launched = drive(
        counts, ("K1", "K1r", "K2", "K2-xperm", "K3", "K6", "K6-xperm", "K7", "K10"),
        label, lambda: eng.generate(prompt, num_steps=40, temperature=0.0))
    log(f"{label}: Engine(tiny Q3_K .dseek, device='cuda', kquant_runtime='nibble', "
        f"prefill_chunk=96) with DSEEK_FUSED_FFN=1 at load: expert w13 rowperm 2, "
        f"{len(out)} greedy tokens past the 128-slot window, first {out[:12]}")
    compare_hydrate(eng, ref, (prompt + out)[:140], label)
    check_greedy(ref, prompt, out, label)
    same_tokens(out, ref.generate(prompt, num_steps=40, temperature=0.0)[0],
                f"{label}, greedy")
    return launched


def permuted_phase(params, cfg, counts, entries, runs):
    """The V3-width 4-layer nibble model of phase 3 with its expert w13s
    row-permuted (loader.rowperm_expert_w13 over the same draw, what
    fuse_projections does under DSEEK_FUSED_FFN=1): 64 greedy decode steps
    (K7, one launch a token), the 512-token prefill with and without the
    factor weights (K6, then K6's prepermuted body on w2s), teacher-forced
    logits against the natural layout from the same draw, decode tok/s at
    decode_block 32 beside the natural model's (alternating), one block
    under set_sync_debug_mode("error"), then the kernel entries."""
    from deepseek_tpu_torch.models.deepseek import forward_decode, make_decode_loop
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.models.loader import rowperm_expert_w13

    t0 = time.perf_counter()
    perm = rowperm_expert_w13(params, cfg)
    torch.cuda.synchronize()
    moe = cfg.n_layers - 1
    log(f"full width: expert w13s row-permuted on the card in "
        f"{time.perf_counter() - t0:.1f} s (rowperm {perm.layers[moe].w13s.rowperm}, "
        f"{nbytes(perm.layers[moe].w13s.p, perm.layers[moe].w13s.a) / 1e9:.3f} GB)")
    label = "Q3_K nibble, row-permuted"
    dec, pre = "full-width permuted decode", "full-width permuted prefill"
    runs[dec], _ = full_width_phase(perm, cfg, counts, label, ("K1", "K3", "K7"))
    runs[pre], _ = prefill_phase(perm, cfg, counts, label,
                                 ("K1", "K1r", "K3", "K6", "K6-xperm", "K7", "K9", "K10"))

    # teacher-forced logits, permuted against natural, on the same tokens.
    # Tolerance 1e-3 of the logit scale, as the entry points': the natural
    # chain rounds h2 and h to bf16, K7 keeps them f32
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    toks = torch.randint(3, cfg.vocab_size, (8,), generator=gen, device="cuda").tolist()
    caches = [init_cache(cfg, device="cuda") for _ in range(2)]
    worst, scale = 0.0, 0.0
    with torch.inference_mode():
        for pos, t in enumerate(toks):
            tok = torch.full((1, 1), t, dtype=torch.int64, device="cuda")
            a = forward_decode(perm, caches[0], tok, pos, cfg).float()
            b = forward_decode(params, caches[1], tok, pos, cfg).float()
            if not bool(torch.isfinite(a).all()):
                raise RuntimeError(f"{label}: non-finite logits at position {pos}")
            worst = max(worst, float((a - b).abs().max()))
            scale = max(scale, float(b.abs().max()))
    log(f"{label}: {len(toks)} teacher-forced decode steps vs the natural layout: "
        f"logits max abs err {worst:.3e} (tolerance {1e-3 * scale:.3e} = 1e-3 of "
        f"max|logit| {scale:.3f})")
    if not worst <= 1e-3 * scale:
        raise RuntimeError(f"{label}: logits disagree with the natural layout")
    del caches

    loop = make_decode_loop(cfg, 32)
    rates = {"natural": [], "permuted": []}
    for rep in range(3):
        for kind in (("natural", "permuted") if rep % 2 == 0 else ("permuted", "natural")):
            rates[kind].append(decode_tok_per_s(perm if kind == "permuted" else params,
                                                cfg, loop, True, 0.0))
    for kind, v in rates.items():
        log(f"decode block (Q3_K nibble, {kind} expert w13s), decode_block 32, "
            f"temperature 0: {[round(x, 2) for x in v]} tok/s over 64 tokens "
            f"(runs alternating), median {float(np.median(v)):.2f}")
    sync_debug_block(perm, cfg, label)
    log("kernels, the fused expert FFN (each against its plain version on the card):")
    fused_kernel_entries(perm, cfg, entries, dec, pre)
    del perm


def rand_nibble_table(gen, E, rows, cols, quant):
    """E distinct random nibble experts (E, rows, cols) on the card, in the
    ranges of rand_nibble."""
    from deepseek_tpu_torch.quant.qtensor import KNibbleTensor
    p = torch.randint(0, 256, (E, rows, cols // 2), generator=gen, device="cuda",
                      dtype=torch.uint8)
    a = (torch.rand((E, rows, cols // 16), generator=gen, device="cuda") * 0.009
         + 0.001).to(torch.bfloat16)
    if quant == "q2_k":
        c = (torch.rand((E, rows, cols // 16), generator=gen, device="cuda") * 0.0045
             + 0.0005).to(torch.bfloat16)
        return KNibbleTensor(p=p, a=a, c=c, off=0)
    return KNibbleTensor(p=p, a=a, c=None, off=4)


def fused_kernel_entries(perm, cfg, entries, dec_path, pre_path):
    """K7 at DeepSeek-V3's widths, Q3_K and Q2_K nibble, over 16 distinct
    random experts (w13 row-permuted) for one token's 9 pairs (8 routed
    and the shared slot), beside the time of the K2 chain it replaces on
    the same tables (K2 on w13, the GLU, K2's prepermuted body on w2, the
    weighted index_add_, as the pair path runs them); K2's prepermuted body
    on those w2 rows; K6's prepermuted body on the model's w2s for a
    256-token routing (2048 pairs). No PyTorch call computes these
    functions (library_ms null). Tolerance 1e-4 of max|ref|, as K1/K2's."""
    from deepseek_tpu_torch.config import ActivationType
    from deepseek_tpu_torch.models.loader import _rowperm_qt
    from deepseek_tpu_torch.ops.activations import glu_act
    from deepseek_tpu_torch.ops.kernels.qmm import (
        qmm_expert_ffn, qmm_expert_ffn_plain, qmm_experts, qmm_experts_plain,
        qmm_grouped, qmm_grouped_plain)
    from deepseek_tpu_torch.ops.matmul import tile_dispatch
    from deepseek_tpu_torch.quant.qtensor import perm_x

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 12)
    emit_dec, emit_pre = make_emit(entries, dec_path), make_emit(entries, pre_path)
    emit_k2 = make_emit(entries, "fused FFN entry point")
    mv_src = "deepseek_tpu_torch/csrc/nibble_mv.cu"
    m, dim, N, E = cfg.moe_intermediate_size, cfg.dim, cfg.n_active_routed + 1, 16
    act = ActivationType.SILU
    for quant in ("q3_k", "q2_k"):
        Q = quant.upper()
        w13 = _rowperm_qt(rand_nibble_table(gen, E, 2 * m, dim, quant), 2, undo=False)
        w2 = rand_nibble_table(gen, E, dim, m, quant)
        idx = torch.randperm(E, generator=gen, device="cuda")[:N].sort().values
        wts = torch.rand((N,), generator=gen, device="cuda")
        wts = torch.cat([wts[:-1] / wts[:-1].sum() * cfg.routed_scaling_factor,
                         torch.ones(1, device="cuda")])
        x = torch.randn((1, dim), generator=gen, device="cuda").to(torch.bfloat16)
        tok = torch.zeros(N, dtype=torch.int64, device="cuda")
        planes = lambda t: nbytes(t.p[idx], t.a[idx], None if t.c is None else t.c[idx])
        nb = nbytes(x, idx, wts) + planes(w13) + planes(w2) + 4 * dim

        def chain():
            h2 = qmm_experts(w13, idx, x.expand(N, dim)).to(x.dtype)
            h = glu_act(h2[:, :m], h2[:, m:], act)
            per = qmm_experts(w2, idx, h, x_prepermuted=True)
            out = torch.zeros((1, dim), dtype=torch.float32, device="cuda")
            return out.index_add_(0, tok, per * wts[:, None])

        entry = emit_dec(
            f"K7 qmm_expert_ffn {Q} nibble (MoE, w13 row-permuted) {N} pairs, "
            f"w13 {2 * m}x{dim}, w2 {dim}x{m}",
            lambda: qmm_expert_ffn(w13, w2, idx, x, wts, act),
            lambda: qmm_expert_ffn_plain(w13, w2, idx, x, wts, act), 1e-4, nb,
            2.0 * N * 3 * m * dim, "deepseek_tpu_torch/csrc/expert_ffn.cu",
            "deepseek_tpu/ops/pallas/qmm.py:771 (qmm_expert_ffn, pallas_call :930)",
            "K7")
        entry["chain_ms"] = time_ms(chain)
        err = float((chain() - qmm_expert_ffn(w13, w2, idx, x, wts, act)).abs().max())
        log(f"  {entry['name']}: the K2 chain it replaces (K2 w13, GLU, K2 "
            f"prepermuted w2, index_add_) {entry['chain_ms']:.4f} ms; chain vs K7 max "
            f"abs err {err:.3e} (bf16 h in the chain)")

        h = perm_x(torch.randn((N, m), generator=gen, device="cuda")).contiguous()
        emit_k2(f"K2 qmm_experts {Q} nibble, x prepermuted (w2 MoE) {N}x{dim}x{m}",
                lambda: qmm_experts(w2, idx, h, x_prepermuted=True),
                lambda: qmm_experts_plain(w2, idx, h, x_prepermuted=True), 1e-4,
                nbytes(h) + planes(w2) + 4 * dim * N, 2.0 * N * dim * m, mv_src,
                "deepseek_tpu/ops/pallas/qmm.py:566 (qmm_experts, _knib_body :206, "
                "x_prepermuted :602-609)", "K2-xperm")
        del w13, w2

    # K6's prepermuted body on the model's w2s: a random 256-token routing,
    # 8 routed experts a token; only the live rows computed, compared, counted
    w2s = perm.layers[cfg.n_layers - 1].w2s
    En = cfg.n_routed_experts
    T = 256
    routed = torch.rand((T, En), generator=gen, device="cuda") \
        .topk(cfg.n_active_routed, dim=-1).indices
    te, tr, _, G = tile_dispatch(routed.reshape(-1), En)
    live = torch.arange(128, device="cuda")[None, :] < tr[:, None]
    n_live, n_exp = int(tr.sum()), int(te[tr > 0].unique().numel())
    xt = perm_x(torch.randn((G, 128, m), generator=gen, device="cuda")).contiguous()
    per = w2s.nbytes_active / w2s.shape[0]
    emit_pre(f"K6 qmm_grouped Q3_K nibble, x prepermuted (w2s MoE) {G} tiles, "
             f"{n_live} pairs over {n_exp} experts, {dim}x{m}",
             lambda: qmm_grouped(w2s, te, xt, tr, x_prepermuted=True),
             lambda: qmm_grouped_plain(w2s, te, xt, tr, x_prepermuted=True), 1e-4,
             n_live * m * 4 + per * n_exp + n_live * dim * 4, 2.0 * n_live * dim * m,
             "deepseek_tpu_torch/csrc/qmm_tiles.cu",
             "deepseek_tpu/ops/pallas/qmm.py:449 (qmm_grouped, _knib_body, pallas_call "
             ":538; the rp branch of ops/matmul.py:268-285)", "K6-xperm",
             select=lambda y: y[live])


def mha_kernel_entries(gen, emit):
    """K4 at DeepSeek-V2-Lite's three large F16 weights (1 and 8 rows) and
    at DeepSeek-V3's bf16 lm_head; K8 over the 4096-slot bf16 MHA cache at
    V2-Lite's 16 heads and V3's 128 (Dh 192, Dv 128), kv_len 68 and 4000."""
    from deepseek_tpu_torch.ops.kernels.attention import (
        mha_decode_attn, mha_decode_attn_plain)
    from deepseek_tpu_torch.ops.kernels.qmm import qmm, qmm_fp_plain
    from deepseek_tpu_torch.quant.qtensor import PlainTensor

    # Tolerance 1e-5 of max|ref|: f32 sums of the same f32-widened products
    # in other orders.
    shapes = [("lm_head (V2-Lite)", 102400, 2048, torch.float16, (1, 8)),
              ("w13 dense (V2-Lite)", 21888, 2048, torch.float16, (1, 8)),
              ("w2 dense (V2-Lite)", 2048, 10944, torch.float16, (1, 8)),
              ("lm_head (V3)", 129280, 7168, torch.bfloat16, (1,))]
    for label, d, n, dt, rows_list in shapes:
        qt = PlainTensor(data=(torch.randn((d, n), generator=gen, device="cuda")
                               * 0.02).to(dt))
        for rows in rows_list:
            x = torch.randn((rows, n), generator=gen, device="cuda")
            emit(f"K4 qmm plain {str(dt)[6:]} {label} {rows}x{d}x{n}",
                 lambda: qmm(qt, x), lambda: qmm_fp_plain(qt, x), 1e-5,
                 nbytes(x, qt.data) + 4 * rows * d, 2.0 * rows * d * n,
                 "deepseek_tpu_torch/csrc/qmm.cu",
                 "deepseek_tpu/ops/pallas/qmm.py:312 (qmm, _plain_body :305, "
                 "pallas_call :329)", "K4",
                 library=lambda: torch.matmul(x.to(dt), qt.data.t()))
        del qt

    # K8. Tolerance 1e-4 of max|ref|: f32 sums over thousands of slots in
    # other orders, fast exp. The yardstick is SDPA over head-major copies
    # with the slots past kv_len masked (the port never calls it).
    S, Dh, Dv = 4096, 192, 128
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for H in (16, 128):
        q = torch.randn((1, H, Dh), generator=gen, device="cuda")
        k = (torch.randn((1, S, H, Dh), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
        v = torch.randn((1, S, H, Dv), generator=gen, device="cuda").to(torch.bfloat16)
        qh = q[:, :, None].to(torch.bfloat16)
        kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
        for kv in (68, 4000):
            kl = torch.tensor([kv], device="cuda", dtype=torch.int32)
            mask = (torch.arange(S, device="cuda") < kv)[None, None, None]
            scale = 1.0 / math.sqrt(Dh)
            emit(f"K8 mha_decode_attn bf16 cache S={S} kv_len={kv} H={H} "
                 f"Dh={Dh} Dv={Dv}",
                 lambda: mha_decode_attn(q, k, v, kl, scale),
                 lambda: mha_decode_attn_plain(q, k, v, kl, scale), 1e-4,
                 kv * H * (Dh + Dv) * 2 + nbytes(q) + 4 * H * Dv,
                 2.0 * H * kv * (Dh + Dv),
                 "deepseek_tpu_torch/csrc/mha_decode.cu",
                 "deepseek_tpu/ops/pallas/attention.py:320 (mha_decode_attn, "
                 "_mha_body :245, pallas_call :370)", "K8",
                 library=lambda: sdpa(qh, kh, vh, attn_mask=mask, scale=scale))
        del k, v, kh, vh


def int8_rows(gen, shape):
    """Random rows quantized as the int8 cache stores them: (int8 rows,
    their f32 amax/127 scales)."""
    from deepseek_tpu_torch.models.kvcache import quantize_rows
    return quantize_rows(torch.randn(shape, generator=gen, device="cuda") * 0.3)


def int8_kernel_entries(cfg, gen, emit, emit_v2):
    """K3, K8, K9 and K10 over an int8 cache with its f32 row scales, each
    against its plain version (the same dequantized rows), at the main
    path's full shapes: K3 and K10 at DeepSeek-V3's (128 heads, R 512, P
    64), K8 and K9 at DeepSeek-V2-Lite's (16 heads, Dh 192, Dv 128), the
    4096-slot window. Beside each, the float kernel's time at the same
    shape over the same rows in bf16 (the float cell's cache dtype); for
    K9 that is an entry of its own (``emit_v2``: launches from the V2-Lite
    run) with SDPA's time. The
    bounds count the int8 rows and their scales. No PyTorch call attends
    over an int8 cache with row scales, so there is no library time.
    Tolerances as the float entries: 1e-4 of max|ref| (f32 sums in other
    orders, fast exp)."""
    from deepseek_tpu_torch.models.kvcache import dequant_rows
    from deepseek_tpu_torch.ops.kernels.attention import (
        mha_decode_attn, mha_decode_attn_plain, mla_decode_attn,
        mla_decode_attn_plain)
    from deepseek_tpu_torch.ops.kernels.prefill_attn import (
        mha_prefill_attn, mha_prefill_attn_plain, mla_prefill_attn,
        mla_prefill_attn_plain)

    S, T, kv = cfg.kv_window, 256, cfg.kv_window - 96
    H, R, P = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    bf16 = lambda q, s: dequant_rows(q, s).to(torch.bfloat16)
    src = "deepseek_tpu_torch/csrc/"
    pallas = "deepseek_tpu/ops/pallas/attention.py:"

    def float_time(label, fn):
        t = time_ms(fn)
        log(f"  {label}: the float kernel over the same rows in bf16: {t:.4f} ms")

    # K3 at the V3 window: 4000 of 4096 slots, and a short window (32)
    qc = torch.randn((1, H, R), generator=gen, device="cuda")
    qr = torch.randn((1, H, P), generator=gen, device="cuda")
    (ckv, cs), (kr, rs) = int8_rows(gen, (1, S, R)), int8_rows(gen, (1, S, P))
    scale = cfg.attn_softmax_scale()
    for kv_k3 in (kv, 32):
        kl = torch.tensor([kv_k3], device="cuda", dtype=torch.int32)
        name = f"K3-int8 mla_decode_attn int8 cache S={S} kv_len={kv_k3} H={H}"
        emit(name, lambda: mla_decode_attn(qc, qr, ckv, kr, kl, scale, ckv_scale=cs,
                                           krope_scale=rs),
             lambda: mla_decode_attn_plain(qc, qr, ckv, kr, kl, scale, cs, rs), 1e-4,
             kv_k3 * (R + P + 8) + nbytes(qc, qr) + 4 * H * R,
             2.0 * H * kv_k3 * (2 * R + P), src + "prefill_attn.cu",
             pallas + "170 (mla_decode_attn, _mla_body :89, int8 scales :131-151)",
             "K3-int8")
        c16, r16 = bf16(ckv, cs), bf16(kr, rs)
        float_time(name, lambda: mla_decode_attn(qc, qr, c16, r16, kl, scale))

    # K10: the window's last 256-token chunk, which sees every slot
    q_pos0 = S - T
    pairs = sum(min(S, q_pos0 + t + 1) for t in range(T))
    qc = torch.randn((1, T, H, R), generator=gen, device="cuda") * 0.3
    qr = torch.randn((1, T, H, P), generator=gen, device="cuda") * 0.3
    name = f"K10-int8 mla_prefill_attn int8 cache T={T} S={S} H={H} R={R} P={P} " \
        f"q_pos0={q_pos0}"
    emit(name, lambda: mla_prefill_attn(qc, qr, ckv, kr, q_pos0, 0, scale,
                                        ckv_scale=cs, krope_scale=rs),
         lambda: mla_prefill_attn_plain(qc, qr, ckv, kr, q_pos0, 0, scale, cs, rs),
         1e-4, nbytes(qc, qr, ckv, kr, cs, rs) + 4 * T * H * R,
         2.0 * pairs * H * (2 * R + P), src + "prefill_attn.cu",
         pallas + "644 (mla_prefill_attn, pallas_call :707, int8 scales :613)",
         "K10-int8")
    float_time(name, lambda: mla_prefill_attn(qc, qr, c16, r16, q_pos0, 0, scale))
    del qc, qr, ckv, kr, c16, r16

    # K8 and K9 at DeepSeek-V2-Lite's widths; the scales are the head-major
    # views of the cache's (B,S,H) layout, as the model passes them
    H, Dh, Dv = 16, 192, 128
    scale = 1.0 / math.sqrt(Dh)
    kl = torch.tensor([kv], device="cuda", dtype=torch.int32)
    (k, ks), (v, vs) = int8_rows(gen, (1, S, H, Dh)), int8_rows(gen, (1, S, H, Dv))
    ksh, vsh = ks.transpose(1, 2), vs.transpose(1, 2)
    k16, v16 = bf16(k, ks), bf16(v, vs)
    q = torch.randn((1, H, Dh), generator=gen, device="cuda")
    name = f"K8-int8 mha_decode_attn int8 cache S={S} kv_len={kv} H={H} Dh={Dh} Dv={Dv}"
    emit(name, lambda: mha_decode_attn(q, k, v, kl, scale, k_scale=ksh, v_scale=vsh),
         lambda: mha_decode_attn_plain(q, k, v, kl, scale, ksh, vsh), 1e-4,
         kv * H * (Dh + Dv + 8) + nbytes(q) + 4 * H * Dv, 2.0 * H * kv * (Dh + Dv),
         src + "mha_decode.cu", pallas + "320 (mha_decode_attn, _mha_body :245, "
         "pallas_call :370, int8 scales :286-299)", "K8-int8")
    float_time(name, lambda: mha_decode_attn(q, k16, v16, kl, scale))
    q = torch.randn((1, T, H, Dh), generator=gen, device="cuda") * 0.3
    name = f"K9-int8 mha_prefill_attn int8 cache T={T} S={S} H={H} Dh={Dh} Dv={Dv} " \
        f"q_pos0={q_pos0}"
    emit(name, lambda: mha_prefill_attn(q, k, v, q_pos0, 0, scale, k_scale=ksh,
                                        v_scale=vsh),
         lambda: mha_prefill_attn_plain(q, k, v, q_pos0, 0, scale, ksh, vsh), 1e-4,
         nbytes(q, k, v, ks, vs) + 4 * T * H * Dv, 2.0 * pairs * H * (Dh + Dv),
         src + "prefill_attn.cu", pallas + "481 (mha_prefill_attn, pallas_call "
         ":543, int8 scales :449-458)", "K9-int8")
    # the float K9 over the same rows in bf16, V2-Lite's prefill cell (64
    # row blocks: the split window), against SDPA with the same causal mask
    mask = (torch.arange(S, device="cuda")[None, :]
            <= q_pos0 + torch.arange(T, device="cuda")[:, None])
    qh, kh, vh = (t.transpose(1, 2).to(torch.bfloat16).contiguous() for t in (q, k16, v16))
    emit_v2(f"K9 mha_prefill_attn bf16 V2-Lite T={T} S={S} H={H} Dh={Dh} Dv={Dv} "
            f"q_pos0={q_pos0}",
            lambda: mha_prefill_attn(q, k16, v16, q_pos0, 0, scale),
            lambda: mha_prefill_attn_plain(q, k16, v16, q_pos0, 0, scale), 1e-4,
            nbytes(q, k16, v16) + 4 * T * H * Dv, 2.0 * pairs * H * (Dh + Dv),
            src + "prefill_attn.cu", pallas + "481 (mha_prefill_attn, pallas_call :543)",
            "K9", library=lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, scale=scale))
    del k, v, k16, v16, qh, kh, vh
    # the two-term bodies at V2-Lite's widths, through the split window:
    # over an f16 cache (the Engine's default, the window-edge cell) and
    # over f32 keys and values
    for dt in (torch.float16, torch.float32):
        two_term_k9_entry(emit, " V2-Lite", q, gen, q_pos0, scale, pairs, mask, dt)


def two_term_k9_entry(emit, label, q, gen, q_pos0, scale, pairs, mask, dtype):
    """K9 over keys and values of ``dtype`` (f16 or f32: the body that
    takes them in two bf16 terms), drawn in f32 at q's shapes (Dh, Dv 128)
    over the 4096-slot window, against its plain version at 1e-4 of
    max|ref| and SDPA in ``dtype``."""
    from deepseek_tpu_torch.ops.kernels.prefill_attn import (
        mha_prefill_attn, mha_prefill_attn_plain)

    _, T, H, Dh = q.shape
    S, Dv = mask.shape[1], 128
    tag = {torch.float16: "f16", torch.float32: "f32"}[dtype]
    k = (torch.randn((1, S, H, Dh), generator=gen, device="cuda") * 0.3).to(dtype)
    v = (torch.randn((1, S, H, Dv), generator=gen, device="cuda") * 0.3).to(dtype)
    qh, kh, vh = (t.transpose(1, 2).to(dtype).contiguous() for t in (q, k, v))
    emit(f"K9-{tag} mha_prefill_attn {tag}{label} T={T} S={S} H={H} Dh={Dh} Dv={Dv} "
         f"q_pos0={q_pos0}",
         lambda: mha_prefill_attn(q, k, v, q_pos0, 0, scale),
         lambda: mha_prefill_attn_plain(q, k, v, q_pos0, 0, scale), 1e-4,
         nbytes(q, k, v) + 4 * T * H * Dv, 2.0 * pairs * H * (Dh + Dv),
         "deepseek_tpu_torch/csrc/prefill_attn.cu",
         "deepseek_tpu/ops/pallas/attention.py:481 (mha_prefill_attn, pallas_call :543)",
         f"K9-{tag}", library=lambda: torch.nn.functional.scaled_dot_product_attention(
             qh, kh, vh, attn_mask=mask, scale=scale))


def prefill_kernel_entries(params, cfg, gen, emit, emit_v2):
    """K1 row-tiled, K6, K9, K10 and K11 at the prefill shapes of the
    DeepSeek-V3-width model: a 256-token chunk, the 4096-slot window; K11
    also in f32 compute, and at DeepSeek-V2-Lite's widths over its F16
    tables (``emit_v2``: launches from the V2-Lite run)."""
    from deepseek_tpu_torch.ops.kernels.prefill_attn import (
        mha_prefill_attn, mha_prefill_attn_plain, mla_prefill_attn,
        mla_prefill_attn_plain)
    from deepseek_tpu_torch.models.testing import deepseek_v2_lite_proportions
    from deepseek_tpu_torch.ops.kernels.qmm import (
        gmm, gmm_plain, qmm_grouped, qmm_grouped_plain, qmm_plain, qmm_rows)
    from deepseek_tpu_torch.ops.matmul import tile_dispatch

    dense, moe = params.layers[0], params.layers[cfg.n_layers - 1]
    H, T, S = cfg.n_heads, 256, cfg.kv_window
    qtiles = "deepseek_tpu_torch/csrc/qmm_tiles.cu"

    # K1's row-tiled route: every projection of a 256-token chunk, and
    # wkv_b over the whole window (4096 rows). Tolerance 1e-4 of max|ref|:
    # f32 sums in other orders.
    for label, qt, rows in (("w13 (dense)", dense.w13, T), ("wkv_b", dense.wkv_b, S)):
        d, n = qt.shape
        x = torch.randn((rows, n), generator=gen, device="cuda")
        emit(f"K1 qmm row-tiled q3_k nibble {label} {rows}x{d}x{n}",
             lambda: qmm_rows(qt, x), lambda: qmm_plain(qt, x), 1e-4,
             nbytes(x, qt.p, qt.a, qt.c) + 4 * rows * d, 2.0 * rows * d * n,
             qtiles, "deepseek_tpu/ops/pallas/qmm.py:312 (qmm, _knib_body "
             ":206, rows tiled by 128 :347-351)", "K1r")

    # K1's two routes at few rows, to place ROW_TILE_MIN: the matvec (qmm
    # with the threshold raised past the row count) against the tile GEMM
    # (qmm_rows) on the dense w13 and wo
    import deepseek_tpu_torch.ops.kernels.qmm as qmm_mod
    keep, wins = qmm_mod.ROW_TILE_MIN, {}
    for label, qt in (("w13 (dense)", dense.w13), ("wo", dense.wo)):
        d, n = qt.shape
        for rows in (1, 2, 4, 8, 16, 32):
            x = torch.randn((rows, n), generator=gen, device="cuda")
            qmm_mod.ROW_TILE_MIN = 1 << 30
            try:
                t_vec = time_ms(lambda: qmm_mod.qmm(qt, x))
            finally:
                qmm_mod.ROW_TILE_MIN = keep
            t_tile = time_ms(lambda: qmm_rows(qt, x))
            wins.setdefault(label, {})[rows] = t_tile < t_vec
            log(f"  K1 routes {label} {d}x{n} at {rows} rows: matvec "
                f"{t_vec:.4f} ms, row-tiled {t_tile:.4f} ms")
    for label, won in wins.items():
        # the fewest rows from which the row-tiled route wins at every count
        first = min((r for r in won if all(won[q] for q in won if q >= r)),
                    default=None)
        log(f"  K1 routes {label}: row-tiled faster from {first} rows on "
            f"(ROW_TILE_MIN = {keep}: the matvec up to it)")

    # K6: the folded MoE tables under a random 256-token routing, 8 routed
    # experts + the shared one per token (2304 pairs, 275 tiles). Only the
    # tiles' live rows are computed, compared and counted in the bound.
    E = cfg.n_routed_experts
    routed = torch.rand((T, E), generator=gen, device="cuda") \
        .topk(cfg.n_active_routed, dim=-1).indices
    idx = torch.cat([routed, torch.full((T, 1), E, device="cuda")], dim=-1)
    te, tr, _, G = tile_dispatch(idx.reshape(-1), E + 1)
    live = torch.arange(128, device="cuda")[None, :] < tr[:, None]
    n_live = int(tr.sum())
    n_exp = int(te[tr > 0].unique().numel())
    for label, qt in (("w13s", moe.w13s), ("w2s", moe.w2s)):
        _, d, n = qt.shape
        x = torch.randn((G, 128, n), generator=gen, device="cuda")
        per_expert = nbytes(qt.p[0], qt.a[0], None if qt.c is None else qt.c[0])
        emit(f"K6 qmm_grouped q3_k nibble {label} (MoE) {G} tiles, {n_live} "
             f"pairs over {n_exp} experts, {d}x{n}",
             lambda: qmm_grouped(qt, te, x, tr),
             lambda: qmm_grouped_plain(qt, te, x, tr), 1e-4,
             n_live * n * 4 + per_expert * n_exp + n_live * d * 4,
             2.0 * n_live * d * n, qtiles,
             "deepseek_tpu/ops/pallas/qmm.py:449 (qmm_grouped, pallas_call "
             ":538, _knib_body :206)", "K6", select=lambda y: y[live])

    # K9 and K10: the window's last chunk, which sees every slot. The
    # yardstick is scaled_dot_product_attention with the same causal mask
    # (the port never calls it). Tolerance 1e-4 of max|ref|: f32 sums over
    # 4096 slots in other orders, fast exp.
    q_pos0 = S - T
    scale = cfg.attn_softmax_scale()
    pairs = sum(min(S, q_pos0 + t + 1) for t in range(T))
    mask = (torch.arange(S, device="cuda")[None, :]
            <= q_pos0 + torch.arange(T, device="cuda")[:, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    Dh, Dv, nope = cfg.head_dim, cfg.v_head_dim, cfg.qk_nope_head_dim
    q = torch.randn((1, T, H, Dh), generator=gen, device="cuda") * 0.3
    k = (torch.randn((1, S, H, Dh), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    v = (torch.randn((1, S, H, Dv), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    qh, kh, vh = (t.transpose(1, 2).to(torch.bfloat16).contiguous() for t in (q, k, v))
    emit(f"K9 mha_prefill_attn bf16 T={T} S={S} H={H} Dh={Dh} Dv={Dv} q_pos0={q_pos0}",
         lambda: mha_prefill_attn(q, k, v, q_pos0, 0, scale),
         lambda: mha_prefill_attn_plain(q, k, v, q_pos0, 0, scale), 1e-4,
         nbytes(q, k, v) + 4 * T * H * Dv, 2.0 * pairs * H * (Dh + Dv),
         "deepseek_tpu_torch/csrc/prefill_attn.cu",
         "deepseek_tpu/ops/pallas/attention.py:481 (mha_prefill_attn, "
         "pallas_call :543)", "K9",
         library=lambda: sdpa(qh, kh, vh, attn_mask=mask, scale=scale))
    del k, v, kh, vh
    # The bodies that take the cache in two bf16 terms, over rows drawn in
    # f32 (their lo terms are not 0): K9 over f32 keys and values (the
    # hybrid prefill in f32 compute, the Engine's default, casts them to
    # f32), K10 over f16 (the Engine's default cache) and f32 caches. SDPA
    # computes the same function in the rows' dtype.
    two_term_k9_entry(emit, "", q, gen, q_pos0, scale, pairs, mask, torch.float32)
    R, P = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    qc = torch.randn((1, T, H, R), generator=gen, device="cuda") * 0.3
    qr = torch.randn((1, T, H, P), generator=gen, device="cuda") * 0.3
    ckv = (torch.randn((1, S, R), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    kr = (torch.randn((1, S, P), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    # yardstick: SDPA over the concatenated MQA form [q_c|q_rope],
    # [ckv|krope], values ckv
    q_cat = torch.cat([qc, qr], -1).transpose(1, 2).to(torch.bfloat16).contiguous()
    k_cat = torch.cat([ckv, kr], -1)[:, None].expand(1, H, S, R + P)
    v_cat = ckv[:, None].expand(1, H, S, R)
    emit(f"K10 mla_prefill_attn bf16 T={T} S={S} H={H} R={R} P={P} q_pos0={q_pos0}",
         lambda: mla_prefill_attn(qc, qr, ckv, kr, q_pos0, 0, scale),
         lambda: mla_prefill_attn_plain(qc, qr, ckv, kr, q_pos0, 0, scale), 1e-4,
         nbytes(qc, qr, ckv, kr) + 4 * T * H * R, 2.0 * pairs * H * (2 * R + P),
         "deepseek_tpu_torch/csrc/prefill_attn.cu",
         "deepseek_tpu/ops/pallas/attention.py:644 (mla_prefill_attn, "
         "pallas_call :707)", "K10",
         library=lambda: sdpa(q_cat, k_cat, v_cat, attn_mask=mask, scale=scale))
    del ckv, kr, q_cat, k_cat, v_cat
    for tag, dt in (("f16", torch.float16), ("f32", torch.float32)):
        ckv = (torch.randn((1, S, R), generator=gen, device="cuda") * 0.3).to(dt)
        kr = (torch.randn((1, S, P), generator=gen, device="cuda") * 0.3).to(dt)
        q_cat = torch.cat([qc, qr], -1).transpose(1, 2).to(dt).contiguous()
        k_cat = torch.cat([ckv, kr], -1)[:, None].expand(1, H, S, R + P)
        v_cat = ckv[:, None].expand(1, H, S, R)
        emit(f"K10-{tag} mla_prefill_attn {tag} cache T={T} S={S} H={H} R={R} P={P} "
             f"q_pos0={q_pos0}",
             lambda: mla_prefill_attn(qc, qr, ckv, kr, q_pos0, 0, scale),
             lambda: mla_prefill_attn_plain(qc, qr, ckv, kr, q_pos0, 0, scale), 1e-4,
             nbytes(qc, qr, ckv, kr) + 4 * T * H * R, 2.0 * pairs * H * (2 * R + P),
             "deepseek_tpu_torch/csrc/prefill_attn.cu",
             "deepseek_tpu/ops/pallas/attention.py:644 (mla_prefill_attn, "
             "pallas_call :707)", f"K10-{tag}",
             library=lambda: sdpa(q_cat, k_cat, v_cat, attn_mask=mask, scale=scale))
        del ckv, kr, q_cat, k_cat, v_cat

    # K11: bf16 expert tables at V3 widths, the expert count cut from 257
    # to 64 (63 routed + 1 shared) so the tables and the plain version fit
    # beside the model; the same 256-token x 9-pair routing shape.
    # Tolerance 1e-4 of max|ref|: f32 sums of the same bf16 products (in
    # f32 compute, of the rows' bf16 hi + lo terms: within 2^-18 of each).
    gmm_src = "deepseek_tpu_torch/csrc/gmm.cu"
    gmm_tpu = "megablox.gmm via deepseek_tpu/ops/matmul.py:308-362 (grouped_expert_ffn)"

    def routing(n_routed, top, n_shared):
        """grouped_expert_ffn's rows for a T-token chunk: top-k routed
        experts a token plus the shared ones at the tables' tail."""
        routed = torch.rand((T, n_routed), generator=gen, device="cuda") \
            .topk(top, dim=-1).indices
        shared = torch.arange(n_routed, n_routed + n_shared, device="cuda").expand(T, -1)
        idx = torch.cat([routed, shared], dim=-1)
        sizes = torch.bincount(idx.reshape(-1), minlength=n_routed + n_shared)
        return sizes, idx.numel(), int((sizes > 0).sum()), \
            torch.cumsum(sizes, 0).to(torch.int32)

    def grouped_mm(lhs, rhs_t, offs):
        """torch._grouped_mm (the yardstick; the port never calls it; its
        output in the inputs' dtype), or None where this torch has none."""
        if not hasattr(torch, "_grouped_mm"):
            return None
        return lambda: torch._grouped_mm(lhs, rhs_t, offs=offs)

    E11 = 64
    sizes, M, n_grp, offs = routing(E11 - 1, cfg.n_active_routed, 1)
    m = cfg.moe_intermediate_size
    for label, n, k in (("w13", 2 * m, cfg.dim), ("w2", cfg.dim, m)):
        rhs = torch.randn((E11, n, k), generator=gen, device="cuda",
                          dtype=torch.bfloat16) * 0.02
        lhs = torch.randn((M, k), generator=gen, device="cuda", dtype=torch.bfloat16)
        emit(f"K11 gmm bf16 experts {label} {E11}x{n}x{k}, {M} rows in {n_grp} groups",
             lambda: gmm(lhs, rhs, sizes), lambda: gmm_plain(lhs, rhs, sizes), 1e-4,
             nbytes(lhs) + n_grp * n * k * 2 + 4 * M * n, 2.0 * M * n * k,
             gmm_src, gmm_tpu, "K11",
             library=grouped_mm(lhs, rhs.transpose(1, 2), offs))
        if label == "w13":
            # f32 compute (the bf16 entry point's MoE chunk): f32 rows
            # against the bf16 tables, two passes (rows hi, lo). The
            # yardstick is the f32 call on an f32 copy of the tables made
            # outside the timed call, TF32 off, where torch takes f32.
            lhs32 = torch.randn((M, k), generator=gen, device="cuda")
            rhs32_t = rhs.float().transpose(1, 2)
            emit(f"K11-f32 gmm f32 rows x bf16 experts {label} {E11}x{n}x{k}, {M} rows "
                 f"in {n_grp} groups",
                 lambda: gmm(lhs32, rhs, sizes), lambda: gmm_plain(lhs32, rhs, sizes),
                 1e-4, nbytes(lhs32) + n_grp * n * k * 2 + 4 * M * n, 2.0 * M * n * k,
                 gmm_src, gmm_tpu, "K11", library=grouped_mm(lhs32, rhs32_t, offs))
            del lhs32, rhs32_t
        del rhs, lhs

    # K11 at DeepSeek-V2-Lite's widths over its F16 tables (64 routed + 2
    # shared) in bf16 compute, the V2-Lite cell's function: the table
    # rounded to bf16, one pass. 2048 rows: a 256-token top-6 routing plus
    # the 2 shared slots a token, as grouped_expert_ffn builds them.
    # _grouped_mm takes no f16 table: it is timed on a bf16 copy made
    # outside the timed call (the same products).
    v2 = deepseek_v2_lite_proportions()
    E2 = v2.n_routed_experts + v2.n_shared_experts
    sizes, M, n_grp, offs = routing(v2.n_routed_experts, v2.n_active_routed,
                                    v2.n_shared_experts)
    m = v2.moe_intermediate_size
    for label, n, k in (("w13", 2 * m, v2.dim), ("w2", v2.dim, m)):
        rhs = (torch.randn((E2, n, k), generator=gen, device="cuda") * 0.02) \
            .to(torch.float16)
        lhs = torch.randn((M, k), generator=gen, device="cuda", dtype=torch.bfloat16)
        rhs_bf16_t = rhs.to(torch.bfloat16).transpose(1, 2)
        emit_v2(f"K11-f16 gmm f16 experts x bf16 rows (V2-Lite) {label} {E2}x{n}x{k}, "
                f"{M} rows in {n_grp} groups",
                lambda: gmm(lhs, rhs, sizes), lambda: gmm_plain(lhs, rhs, sizes), 1e-4,
                nbytes(lhs) + n_grp * n * k * 2 + 4 * M * n, 2.0 * M * n * k,
                gmm_src, gmm_tpu, "K11", library=grouped_mm(lhs, rhs_bf16_t, offs))
        del rhs, lhs, rhs_bf16_t


# ---------------------------------------------------------------------------
# phase 4: the full-width decode
# ---------------------------------------------------------------------------

def full_width_phase(params, cfg, counts, label="Q3_K nibble",
                     expect=("K1", "K2", "K3")):
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
        f" MoE), {label}, {N_DECODE} greedy tokens: {tps:.2f} tok/s, "
        f"{per_tok * tps / 1e9:.1f} GB/s of {per_tok / 1e9:.3f} GB active bytes/token "
        f"(byte bound {per_tok / HBM_BYTES_PER_S * 1e3:.3f} ms/token = "
        f"{HBM_BYTES_PER_S / per_tok:.0f} tok/s), first tokens {toks[:12]}")
    n_steps = N_DECODE + N_WARMUP
    log(f"full width ({label}): launches over {N_WARMUP} warm-up + {N_DECODE} timed "
        f"steps {launched} (per token "
        f"{ {k: v / n_steps for k, v in launched.items() if v} })")
    log(f"full width ({label}): peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    missing = [k for k in expect if launched[k] == 0]
    if missing:
        raise RuntimeError(f"the full-width {label} decode never launched {missing}")
    return launched, tps


def prefill_phase(params, cfg, counts, label="Q3_K nibble",
                  expect=("K1", "K1r", "K2", "K3", "K6", "K9", "K10")):
    """The 4-layer V3-width model hydrates a 512-token prompt through the
    port's hydrate_cache (Engine.hydrate's schedule: two prefill chunks of
    256), then decodes 16 greedy tokens: once with the factor weights
    (decompressed prefill, K9) and once without (absorbed prefill, K10).
    One path run for the launch counts."""
    from deepseek_tpu_torch.engine import hydrate_cache
    from deepseek_tpu_torch.models.deepseek import forward_decode
    from deepseek_tpu_torch.models.kvcache import init_cache

    chunk = 256
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    prompt = torch.randint(3, cfg.vocab_size, (PREFILL_TOKENS,), generator=gen,
                           device="cuda").tolist()
    absorbed = dataclasses.replace(params, layers=[
        dataclasses.replace(lp, wq_b=None, wkv_b=None) for lp in params.layers])
    stats, in_chunks = {}, {}

    def run():
        for kind, p in (("decompressed (K9)", params), ("absorbed (K10)", absorbed)):
            cache = init_cache(cfg, device="cuda")
            torch.cuda.reset_peak_memory_stats()
            marks = []

            def progress(i, n):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            before = read(counts)
            _, last, _, pos = hydrate_cache(p, cfg, cache, prompt,
                                            prefill_chunk=chunk, progress=progress)
            walls = [b - a for a, b in zip(marks, marks[1:])]
            in_chunks[kind] = {k: (v - before[k]) / len(walls)
                               for k, v in read(counts).items() if v > before[k]}
            if last.shape != (cfg.vocab_size,) or not np.isfinite(last).all():
                raise RuntimeError(f"prefill logits {last.shape} not finite")
            peak = torch.cuda.max_memory_allocated() / 2**30
            tok = torch.tensor([[int(last.argmax())]], device="cuda")
            toks = [int(tok)]
            with torch.inference_mode():
                for i in range(PREFILL_DECODE - 1):
                    logits = forward_decode(p, cache, tok, pos + i, cfg)
                    tok = logits.argmax(-1, keepdim=True)
                    toks.append(int(tok))
            if not torch.isfinite(logits).all():
                raise RuntimeError("decode logits after prefill not finite")
            stats[kind] = (walls, peak, toks)

    _, launched = drive(counts, expect, f"full-width prefill ({label})", run)
    for kind, (walls, peak, toks) in stats.items():
        log(f"full-width prefill ({label}), {kind}: {PREFILL_TOKENS} tokens in "
            f"{len(walls)} chunks of {chunk}: {PREFILL_TOKENS / sum(walls):.1f} "
            f"tok/s, wall per chunk {[round(w * 1e3, 3) for w in walls]} ms "
            f"(the first includes first-call setup), launches per chunk "
            f"{in_chunks[kind]}, peak device memory {peak:.2f} GiB; "
            f"{PREFILL_DECODE} greedy tokens {toks}")
    return launched, stats


# ---------------------------------------------------------------------------
# phase 5: DeepSeek-V2-Lite, the converter's default checkpoint (F16) and its
# blockwise F8E5M2 form, full size
# ---------------------------------------------------------------------------

def v2_lite_phase(counts):
    """Random F16 DeepSeek-V2-Lite at full width and depth (decompressed
    MHA, ~31.4 GB) hydrates a 512-token prompt through hydrate_cache (two
    chunks of 256: K9, K11) and decodes greedily (K8, K4, K2's plain body).
    Returns (launches, params, cfg, (prefill, decode) tok/s): the int8
    cache run and the window-edge phases reuse the model."""
    from deepseek_tpu_torch.models.testing import (
        deepseek_v2_lite_proportions, random_plain_params)

    cfg = deepseek_v2_lite_proportions(n_layers=V2_LITE_LAYERS)
    t0 = time.perf_counter()
    params = random_plain_params(cfg, torch.float16, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"V2-Lite: random F16 model, {cfg.n_layers} layers, "
        f"{weight_bytes(params) / 1e9:.2f} GB of weights, built on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    launched, rates = v2_lite_run("V2-Lite", params, cfg, counts, ("K9", "K11"),
                                  ("K2f", "K4", "K8"))
    return launched, params, cfg, rates


def v2_lite_fp8_phase(counts):
    """Random DeepSeek-V2-Lite in F8E5M2 with the converter's default
    128x128 block scales (decompressed MHA, ~15.7 GB; the 576-row wkv_a and
    layer 0's 10944-wide FFN have partial edge blocks) at full width and
    depth: the same 512-token prompt in 2 chunks (K5's row-tiled route,
    K6's fp8 body, K9) and greedy decode (K5's matvec, K2's fp8 body, K8).
    Returns (launches, params, cfg)."""
    from deepseek_tpu_torch.config import QuantKind
    from deepseek_tpu_torch.models.testing import (
        deepseek_v2_lite_proportions, random_fp8_params)

    cfg = deepseek_v2_lite_proportions(n_layers=V2_LITE_LAYERS,
                                       weight_quant=QuantKind.F8E5M2,
                                       block_size=(128, 128))
    t0 = time.perf_counter()
    params = random_fp8_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"V2-Lite fp8: random F8E5M2 model (128x128 blocks), {cfg.n_layers} "
        f"layers, {weight_bytes(params) / 1e9:.2f} GB of weights and scales, "
        f"built on the card in {time.perf_counter() - t0:.1f} s")
    launched, _ = v2_lite_run("V2-Lite fp8", params, cfg, counts,
                              ("K5r", "K6-fp8", "K9"), ("K5", "K2-fp8", "K8"))
    return launched, params, cfg


def weight_bytes(params) -> int:
    """Bytes of every weight tensor (planes and scales) of a model."""
    def nb(t):
        if t is None or isinstance(t, torch.Tensor):
            return 0
        return sum(nbytes(v) for v in vars(t).values() if isinstance(v, torch.Tensor))
    return sum(nb(t) for lp in params.layers for t in vars(lp).values()) \
        + nb(params.embed) + nb(params.lm_head)


def v2_lite_run(label, params, cfg, counts, prefill_kernels, decode_kernels):
    """The V2-Lite cell: a 512-token prompt through hydrate_cache (two
    chunks of 256), then 4 warm-up + 32 timed greedy decode steps. Prints
    prefill and decode tok/s, achieved GB/s of the active bytes against
    the byte bound, peak memory and launches per chunk and per token;
    fails if a kernel of either part never launched."""
    from deepseek_tpu_torch.engine import hydrate_cache
    from deepseek_tpu_torch.models.deepseek import forward_decode
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.models.loader import params_active_bytes

    if cfg.n_layers < 27:
        log(f"{label}: depth cut from 27 to {cfg.n_layers} layers (widths uncut)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    prompt = torch.randint(3, cfg.vocab_size, (PREFILL_TOKENS,), generator=gen,
                           device="cuda").tolist()
    chunk, split = 256, {}

    def run():
        cache = init_cache(cfg, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        marks = []

        def progress(i, n):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        _, last, _, pos = hydrate_cache(params, cfg, cache, prompt,
                                        prefill_chunk=chunk, progress=progress)
        split["prefill"] = read(counts)
        if last.shape != (cfg.vocab_size,) or not np.isfinite(last).all():
            raise RuntimeError(f"{label} prefill logits {last.shape} not finite")
        tok = torch.tensor([[int(last.argmax())]], device="cuda")
        toks = [int(tok)]
        with torch.inference_mode():
            for i in range(N_WARMUP + V2_LITE_DECODE):
                if i == N_WARMUP:
                    torch.cuda.synchronize()
                    t_dec = time.perf_counter()
                logits = forward_decode(params, cache, tok, pos + i, cfg)
                tok = logits.argmax(-1, keepdim=True)
                toks.append(int(tok))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t_dec
        if logits.shape != (1, cfg.vocab_size) or not torch.isfinite(logits).all():
            raise RuntimeError(f"{label} decode logits not finite")
        return [b - a for a, b in zip(marks, marks[1:])], dt, toks, pos

    kernels = prefill_kernels + decode_kernels
    (walls, dt, toks, pos), launched = drive(counts, kernels, label, run)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_tok = params_active_bytes(params, cfg, pos + (N_WARMUP + V2_LITE_DECODE) // 2)
    tps = V2_LITE_DECODE / dt
    n_steps = N_WARMUP + V2_LITE_DECODE
    pre = split["prefill"]
    dec = {k: launched[k] - pre[k] for k in launched}
    log(f"{label} prefill: {PREFILL_TOKENS} tokens in {len(walls)} chunks of {chunk}: "
        f"{PREFILL_TOKENS / sum(walls):.1f} tok/s, wall per chunk "
        f"{[round(w * 1e3, 3) for w in walls]} ms (the first includes first-call setup)")
    log(f"{label} decode: {V2_LITE_DECODE} greedy steps after {N_WARMUP} warm-up "
        f"(positions {pos}..{pos + n_steps - 1}): {tps:.2f} tok/s, "
        f"{per_tok * tps / 1e9:.1f} GB/s of {per_tok / 1e9:.3f} GB active bytes/token "
        f"(byte bound {per_tok / HBM_BYTES_PER_S * 1e3:.3f} ms/token = "
        f"{HBM_BYTES_PER_S / per_tok:.0f} tok/s); tokens {toks[:12]}")
    log(f"{label}: peak device memory {peak:.2f} GiB")
    log(f"{label} launches per chunk { {k: pre[k] / len(walls) for k in kernels} }, "
        f"per decode token { {k: dec[k] / n_steps for k in kernels} }")
    for k in decode_kernels:
        if dec[k] == 0:
            raise RuntimeError(f"{label} decode never launched {k}")
    for k in prefill_kernels:
        if pre[k] == 0:
            raise RuntimeError(f"{label} prefill never launched {k}")
    return launched, (PREFILL_TOKENS / sum(walls), tps)


def cpu_cut_phase(label, params, cfg, counts, n_prompt, expect,
                  kv_cache_dtype="float16"):
    """The first 2 layers of a V2-Lite model hydrate an ``n_prompt``-token
    prompt in chunks of 256 and then decode 8 greedy steps; the same run
    on the CPU (plain versions) is the reference: the logits after the
    prompt and after each step within 1e-3 of their scale, the greedy
    tokens its argmax (or a near-tie within that tolerance). Compute in
    f32, cache in ``kv_cache_dtype`` (f16: the Engine's default for a
    converted checkpoint). With a 4096-token prompt the decode steps run
    past the window's edge: the sinks' rope parts re-rotate (an int8 cache:
    the sink keys from their float masters, quantized fresh) and K8 attends
    over all 4096 slots."""
    from deepseek_tpu_torch.engine import hydrate_cache
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.models.deepseek import forward_decode
    from deepseek_tpu_torch.quant.qtensor import PlainTensor

    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32",
                               kv_cache_dtype=kv_cache_dtype)
    gpu = dataclasses.replace(params, layers=params.layers[:2])

    def to_cpu(t):
        if t is None or isinstance(t, torch.Tensor):
            return None if t is None else t.cpu()
        if isinstance(t, PlainTensor):
            return PlainTensor(data=t.data.cpu())
        return t.map(lambda a: a.cpu())

    cpu = dataclasses.replace(
        gpu, embed=to_cpu(gpu.embed), lm_head=to_cpu(gpu.lm_head),
        final_norm=gpu.final_norm.cpu(),
        layers=[dataclasses.replace(lp, **{f: to_cpu(v) for f, v in vars(lp).items()})
                for lp in gpu.layers])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    prompt = torch.randint(3, cfg.vocab_size, (n_prompt,), generator=gen,
                           device="cuda").tolist()

    def run(p, device, forced=None):
        cache = init_cache(cfg2, device=device)
        _, last, _, pos = hydrate_cache(p, cfg2, cache, prompt, prefill_chunk=256)
        logits, toks, rows = torch.from_numpy(last)[None], [], []
        with torch.inference_mode():
            for i in range(CUT_DECODE):
                tok = int(logits.argmax()) if forced is None else forced[i]
                toks.append(tok)
                rows.append(logits[0].float().cpu())
                logits = forward_decode(p, cache, torch.tensor([[tok]], device=device),
                                        pos + i, cfg2)
        rows.append(logits[0].float().cpu())
        return toks, torch.stack(rows)

    (toks, got), launched = drive(counts, expect, label, lambda: run(gpu, "cuda"))
    _, want = run(cpu, "cpu", forced=toks)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    log(f"{label}: 2 V2-Lite layers, {kv_cache_dtype} cache, {n_prompt}-token prompt "
        f"in {-(-n_prompt // 256)} chunks, then {CUT_DECODE} greedy steps (to position "
        f"{n_prompt + CUT_DECODE - 1}, a {cfg2.kv_window}-slot window): logits vs "
        f"CPU plain max abs err {err:.3e} (tolerance {1e-3 * scale:.3e}); tokens {toks}")
    if not (torch.isfinite(got).all() and err <= 1e-3 * scale):
        raise RuntimeError(f"{label} logits disagree with the CPU run")
    for i, tok in enumerate(toks):
        want_tok = int(want[i].argmax())
        if tok != want_tok and float(want[i, want_tok] - want[i, tok]) > 1e-3 * scale:
            raise RuntimeError(f"{label}: greedy token {tok} at step {i}, "
                               f"CPU says {want_tok}")
    return launched


# ---------------------------------------------------------------------------
# phase 6: the seq mesh axis (sequence-parallel decode, context-parallel
# prefill) on two ranks that share the card
# ---------------------------------------------------------------------------

SEQ = 2                    # ranks of the seq axis; gloo: they share one card
SEQ_DECODE = 32            # teacher-forced decode steps after the prompt
SEQ_V2_LAYERS = 8          # V2-Lite depth at seq=2: each rank holds the model
SEQ_EDGE_DECODE = 8        # decode steps past the window's edge (2-layer cut)
SEQ_TIMEOUT = 900          # seconds: a rank that hangs past it fails the run
ATTN_COUNTERS = ("K3", "K8", "K9", "K10", "K3-int8", "K8-int8", "K9-int8", "K10-int8")


# How a sharded run's logits are held against the unsharded run's, as
# fractions of max|logit|. In f32 compute the two differ by f32 sums in
# other orders (measured on the card: at most 4.8e-4 with an int8 cache,
# 1.2e-4 without): 1e-3. In bf16 compute (the V3 and V2-Lite cells' dtype)
# any change of summation order flips roundings of the bf16 residual
# stream that every later layer carries: measured 0.35-1.03% on the rows
# of the V3 cells and 1.28-1.70% on V2-Lite's (8 layers), argmax equal on
# all rows but near-ties, while two unsharded runs agree bit for bit: 2^-5
# (four bf16 ulps at the logit scale, about twice the largest measured).
# Each row's argmax must be the unsharded run's or a near-tie within it.
SEQ_TOL = {"float32": 1e-3, "bfloat16": 2.0 ** -5}


def seq_cells():
    """(name, model, variant, prefill kernels, decode kernels) of every path
    the seq phase drives: the variant's factor weights, cache and compute
    dtypes, and the partials bodies the path must launch. Each partials
    body runs in at least one f32-compute cell, where it is held at 1e-3."""
    f32 = "float32"
    return [
        ("V3 packed Q3_K, K9", "v3", dict(factors=True, kv="bfloat16"),
         ("K9-part",), ("K3-part",)),
        ("V3 packed Q3_K, K10", "v3", dict(factors=False, kv="bfloat16"),
         ("K10-part",), ("K3-part",)),
        ("V3 packed Q3_K int8, K9", "v3", dict(factors=True, kv="int8"),
         ("K9-part",), ("K3-part-int8",)),
        ("V3 packed Q3_K int8, K10", "v3", dict(factors=False, kv="int8"),
         ("K10-part-int8",), ("K3-part-int8",)),
        ("V3 packed Q3_K f32 compute, K9", "v3",
         dict(factors=True, kv="bfloat16", compute=f32), ("K9-part",), ("K3-part",)),
        ("V3 packed Q3_K f32 compute, K10", "v3",
         dict(factors=False, kv="bfloat16", compute=f32), ("K10-part",), ("K3-part",)),
        ("V3 packed Q3_K int8 f32 compute, K10", "v3",
         dict(factors=False, kv="int8", compute=f32), ("K10-part-int8",),
         ("K3-part-int8",)),
        ("V2-Lite F16", "v2", dict(kv="bfloat16"), ("K9-part",), ("K8-part",)),
        ("V2-Lite F16 int8", "v2", dict(kv="int8"), ("K9-part-int8",), ("K8-part-int8",)),
        ("V2-Lite F16 f32 compute", "v2", dict(kv="bfloat16", compute=f32),
         ("K9-part",), ("K8-part",)),
        ("V2-Lite F16 int8 f32 compute", "v2", dict(kv="int8", compute=f32),
         ("K9-part-int8",), ("K8-part-int8",)),
        ("window edge", "edge", dict(kv="float16"), ("K9-part",), ("K8-part",)),
    ]


def seq_model(model):
    """The seq phase's model of ``model`` ("v3", "v2", "edge"), drawn on the
    card from the seed: the same draw in the parent and in each rank."""
    from deepseek_tpu_torch.models.testing import (
        deepseek_v2_lite_proportions, deepseek_v3_proportions, random_fused_params,
        random_plain_params)
    if model == "v3":
        cfg = deepseek_v3_proportions(n_layers=4)
        return random_fused_params(cfg, "q3_k", seed=SEED, device="cuda",
                                   factors=True), cfg
    cfg = deepseek_v2_lite_proportions(n_layers=SEQ_V2_LAYERS)
    params = random_plain_params(cfg, torch.float16, seed=SEED, device="cuda")
    if model == "edge":      # its first 2 layers in f32 compute, as cpu_cut_phase
        cfg = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
        params = dataclasses.replace(params, layers=params.layers[:2])
    return params, cfg


def seq_inputs(cfg, model):
    """(prompt, teacher-forced decode tokens) of a seq cell, from the seed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    n = cfg.kv_window if model == "edge" else PREFILL_TOKENS
    steps = SEQ_EDGE_DECODE if model == "edge" else SEQ_DECODE
    toks = torch.randint(3, cfg.vocab_size, (n + steps,), generator=gen,
                         device="cuda").tolist()
    return toks[:n], toks[n:]


def seq_path(params, cfg, prompt, forced, ctx, cache, counts, steps=SEQ_EDGE_DECODE):
    """The prompt in prefill chunks of 256 (every chunk divides the seq
    axis: context-parallel), then the decode steps fed ``forced`` (None:
    ``steps`` greedy ones). Returns the logits after the prompt and after
    each step (a (steps + 1, V) f32 CPU tensor), the tokens fed, each
    part's launch counts, its wall seconds."""
    from deepseek_tpu_torch.models.deepseek import forward_decode, forward_prefill

    chunk, rows, fed, launched = 256, [], [], {}
    steps = steps if forced is None else len(forced)
    with torch.inference_mode():
        reset(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, len(prompt), chunk):
            last = i + chunk >= len(prompt)
            tok = torch.tensor([prompt[i:i + chunk]], device="cuda")
            logits = forward_prefill(params, cache, tok, i, cfg,
                                     "last" if last else "none", ctx)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launched["prefill"] = read(counts)
        reset(counts)
        for s in range(steps):
            rows.append(logits[0].float().cpu())
            t = int(rows[-1].argmax()) if forced is None else forced[s]
            fed.append(t)
            logits = forward_decode(params, cache, torch.tensor([[t]], device="cuda"),
                                    len(prompt) + s, cfg, ctx)
        rows.append(logits[0].float().cpu())
        torch.cuda.synchronize()
        launched["decode"] = read(counts)
    return torch.stack(rows), fed, launched, (t1 - t0, time.perf_counter() - t1)


def seq_cell_cfg(cfg, variant):
    return dataclasses.replace(cfg, kv_cache_dtype=variant["kv"],
                               compute_dtype=variant.get("compute", cfg.compute_dtype))


def seq_cell_params(params, variant):
    if variant.get("factors", True):
        return params
    return dataclasses.replace(params, layers=[
        dataclasses.replace(lp, wq_b=None, wkv_b=None) for lp in params.layers])


def seq_rank(rank, world, forced_of):
    """One rank of the seq phase: each cell over this rank's slice of the
    window (its forced tokens from the unsharded run, the window edge's
    greedy ones included), then a 32-token decode block at temperature 0.8
    after the V3 cell's prompt. Returns per cell the logits, the launch
    counts of its prefill and decode, its walls; the block's tokens; the
    rank's peak memory."""
    from deepseek_tpu_torch.models.deepseek import forward_prefill, make_decode_loop
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.ops import prng
    from deepseek_tpu_torch.parallel.mesh import make_mesh
    from deepseek_tpu_torch.parallel.sharding import shard_cache, shard_params
    from deepseek_tpu_torch.parallel.spmd import make_ctx

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(seq=world)
    counts = counters()
    out, models = {}, {}
    for name, model, variant, _, _ in seq_cells():
        if model not in models:
            models.clear()
            torch.cuda.empty_cache()
            models[model] = seq_model(model)
        params, cfg = models[model]
        params = shard_params(seq_cell_params(params, variant), cfg, mesh)
        cfg = seq_cell_cfg(cfg, variant)
        ctx = make_ctx(cfg, mesh)
        prompt, _ = seq_inputs(cfg, model)
        cache = shard_cache(init_cache(cfg, device="cuda"), cfg, mesh)
        rows, _, launched, walls = seq_path(params, cfg, prompt, forced_of[name], ctx,
                                            cache, counts)
        out[name] = dict(rows=rows, launched=launched, walls=walls)
        if name == "V3 packed Q3_K, K9":
            cache = shard_cache(init_cache(cfg, device="cuda"), cfg, mesh)
            with torch.inference_mode():
                for i in range(0, len(prompt), 256):
                    forward_prefill(params, cache, torch.tensor([prompt[i:i + 256]],
                                                                device="cuda"),
                                    i, cfg, "none", ctx)
            loop = make_decode_loop(cfg, 32, mesh=mesh)
            tok = torch.full((1, 1), prompt[-1], dtype=torch.int64, device="cuda")
            toks, _, _ = loop(params, cache, tok, len(prompt), prng.PRNGKey(SEED), 0.8,
                              0.95)
            out["block"] = toks[0].tolist()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def seq_phase(counts, runs):
    """The seq mesh axis at SEQ=2: the unsharded runs on the card first (the
    reference), then two ranks spawned by parallel/launch.py share the card
    (gloo) and run the same cells over their slices of the window:
    DeepSeek-V3 width, packed Q3_K, 4 layers, with and without the factor
    weights, bf16 and int8 caches (a 512-token prompt in two CP chunks:
    K9's or K10's partials; 32 decode steps: K3's), three of them again in
    f32 compute, and a 32-token decode block at 0.8 whose tokens both ranks
    must share; DeepSeek-V2-Lite F16 MHA cut to SEQ_V2_LAYERS layers, bf16
    and int8 caches (K9's, K8's), each also in f32 compute; and 2
    of its layers in f32 hydrated to the 4096-slot window's edge and
    decoded greedily past it (the ring wraps from shard 1's last slot into
    shard 0's, the sinks re-rotate on shard 0). Each rank's logits within
    SEQ_TOL (by compute dtype) of the unsharded run's, the same on both
    ranks, each row's argmax the same or a near-tie within the tolerance
    (the edge's greedy tokens so); each path launched its partials bodies and
    no normalized attention body. Every disagreement is logged before the
    phase fails. The partials bodies against their plain versions at the
    shards' shapes follow (``partials_kernel_entries``, run by main)."""
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.parallel.launch import launch
    from deepseek_tpu_torch.parallel.spmd import NULL_CTX

    t_phase = time.perf_counter()
    log(f"seq=2: V3 width 4 layers (depth cut from 61); V2-Lite depth cut from "
        f"{V2_LITE_LAYERS} to {SEQ_V2_LAYERS} layers, widths uncut (each rank holds "
        f"a whole model); the window-edge cell its first 2 layers in f32 compute")
    ref, forced_of, models = {}, {}, {}
    for name, model, variant, _, _ in seq_cells():
        if model not in models:
            models.clear()
            torch.cuda.empty_cache()
            models[model] = seq_model(model)
        params, cfg = models[model]
        params, cfg = seq_cell_params(params, variant), seq_cell_cfg(cfg, variant)
        prompt, forced = seq_inputs(cfg, model)
        forced = None if model == "edge" else forced
        rows, fed, _, walls = seq_path(params, cfg, prompt, forced, NULL_CTX,
                                       init_cache(cfg, device="cuda"), counts)
        ref[name], forced_of[name] = (rows, walls, str(cfg.compute_dtype)), fed
    models.clear()
    torch.cuda.empty_cache()
    log(f"seq=2: unsharded reference runs on the card in "
        f"{time.perf_counter() - t_phase:.1f} s; the parent holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB while the ranks run")

    t0 = time.perf_counter()
    ranks = launch(seq_rank, SEQ, forced_of, backend="gloo", timeout=SEQ_TIMEOUT,
                   threads=None)
    log(f"seq=2: {SEQ} gloo ranks on one card ran every cell in "
        f"{time.perf_counter() - t0:.1f} s (spawn and model draws included); peak "
        f"device memory per rank {[round(r['peak_gib'], 2) for r in ranks]} GiB")
    failed = []
    for name, model, variant, pre_k, dec_k in seq_cells():
        want, walls1, cdt = ref[name]
        scale = float(want.abs().max())
        tol = SEQ_TOL[cdt] * scale
        for r, res in enumerate(ranks):
            got, launched = res[name]["rows"], res[name]["launched"]
            row_err = (got - want).abs().amax(-1)
            err = float(row_err.max())
            top = got.argmax(-1)
            ties = want.gather(1, want.argmax(-1, keepdim=True))[:, 0] \
                - want.gather(1, top[:, None])[:, 0]
            log(f"seq=2 {name} ({cdt} compute, {variant['kv']} cache), rank {r}: logits "
                f"after the prompt and {len(got) - 1} decode steps vs unsharded: max abs "
                f"err {err:.3e} (per-row errors / max|logit| from "
                f"{float(row_err.min()) / scale:.2e} to {err / scale:.2e}; tolerance "
                f"{tol:.3e} = {SEQ_TOL[cdt]:g} of max|logit| {scale:.3f}), argmax equal on "
                f"{int((top == want.argmax(-1)).sum())} of {len(got)} rows; prefill / "
                f"decode wall {res[name]['walls'][0]:.3f} / {res[name]['walls'][1]:.3f} s "
                f"(unsharded {walls1[0]:.3f} / {walls1[1]:.3f} s; two ranks time-share "
                f"the card); launches prefill "
                f"{ {k: v for k, v in launched['prefill'].items() if v} }, decode "
                f"{ {k: v for k, v in launched['decode'].items() if v} }")
            if not (bool(torch.isfinite(got).all()) and err <= tol
                    and float(ties.max()) <= tol):
                failed.append(f"{name}: rank {r}'s logits disagree with the unsharded run")
            if r and not torch.equal(got, ranks[0][name]["rows"]):
                failed.append(f"{name}: rank {r}'s logits differ from rank 0's")
            for part, kernels in (("prefill", pre_k), ("decode", dec_k)):
                missing = [k for k in kernels if launched[part][k] == 0]
                normal = {k: launched[part][k] for k in ATTN_COUNTERS
                          if launched[part][k]}
                if missing or normal:
                    failed.append(f"{name} {part}, rank {r}: never launched {missing}, "
                                  f"launched normalized {normal}")
            if model == "edge":
                bad = [i for i, tok in enumerate(forced_of[name])
                       if int(got[i].argmax()) != tok
                       and float(got[i].max() - got[i, tok]) > tol]
                log(f"seq=2 window edge, rank {r}: the greedy tokens past the window's "
                    f"edge {'equal' if not bad else 'DIFFER from'} the unsharded run's "
                    f"{forced_of[name]} (or near-ties){f' at steps {bad}' if bad else ''}")
                if bad:
                    failed.append(f"window edge: rank {r}'s greedy tokens differ at {bad}")
        runs[f"seq=2 {name} prefill"] = ranks[0][name]["launched"]["prefill"]
        runs[f"seq=2 {name} decode"] = ranks[0][name]["launched"]["decode"]
    blocks = [r["block"] for r in ranks]
    log(f"seq=2: make_decode_loop(mesh=make_mesh(seq=2)) block at 0.8, tokens per "
        f"rank {blocks}")
    if any(b != blocks[0] for b in blocks):
        failed.append("the ranks sampled different tokens")
    log(f"seq=2 phase: {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise RuntimeError("seq=2: " + "; ".join(failed))


def check_triple(entry, got, want, rel_tol):
    """A partials triple against its plain version: the rows that see no
    slot are the empty triple exactly; elsewhere m within rel_tol of its
    scale, acc and l within rel_tol of their scale after rescaling both to
    the common maximum. max_abs_err is the largest of those errors."""
    (acc, m, l), (acc_w, m_w, l_w) = got, want
    empty = m_w <= -1e29
    ok = bool((m[empty] == -1e30).all()) and not l[empty].any() and not acc[empty].any()
    live = ~empty
    mx = torch.maximum(m, m_w)
    a, b = torch.exp(m - mx), torch.exp(m_w - mx)
    errs, tols = [], []
    for x, y, floor in ((m[live], m_w[live], 1.0), ((l * a)[live], (l_w * b)[live], 0.0),
                        ((acc * a[..., None])[live], (acc_w * b[..., None])[live], 0.0)):
        errs.append(float((x - y).abs().max()) if x.numel() else 0.0)
        tols.append(rel_tol * max(float(y.abs().max()) if y.numel() else 0.0, floor))
    entry["max_abs_err"] = max(errs)
    ok = ok and all(math.isfinite(e) and e <= t for e, t in zip(errs, tols))
    log(f"  {entry['name']}: max abs err m / l / acc {errs[0]:.3e} / {errs[1]:.3e} / "
        f"{errs[2]:.3e} (tolerances {tols[0]:.3e} / {tols[1]:.3e} / {tols[2]:.3e}, "
        f"{rel_tol:g} of each scale), {int(empty.sum())} empty rows -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{entry['name']} disagrees with its plain version")


def check_empty_shard(name, fn, plain):
    """A partials body on a shard that holds no slot its queries may see
    (on the main path, shard 1 while the prompt fills shard 0): every row
    the empty triple (acc 0, l 0, m -1e30) exactly, as its plain version
    gives, and no NaN."""
    got, want = fn(), plain()
    if [t.shape for t in got] != [t.shape for t in want]:
        raise RuntimeError(f"{name}: shapes {[tuple(t.shape) for t in got]}, plain "
                           f"{[tuple(t.shape) for t in want]}")
    if not bool((want[1] <= -1e29).all()):
        raise RuntimeError(f"{name}: the plain version sees a slot on the empty shard")
    check_triple({"name": name}, got, want, 0.0)


def emit_partials(entries, name, fn, plain, normalized, tol, nb, flops, source,
                  replaces, kernel, path, library=None):
    """One partials body: checked (check_triple) and timed beside its plain
    version, the normalized body over the same slice and a library call."""
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "kernel": kernel, "path": path}
    check_triple(entry, fn(), plain(), tol)
    entry["ms"] = time_ms(fn)
    entry["plain_ms"] = time_ms(plain)
    entry["normalized_ms"] = time_ms(normalized)
    entry["bound_ms"], entry["bound_by"] = bound_ms(nb, flops)
    if library is not None:
        try:
            library()
        except Exception as exc:    # the yardstick only; the port never calls it
            log(f"  {name}: library call unavailable: {type(exc).__name__}: "
                f"{str(exc)[:300]}")
            library = None
    entry["library_ms"] = time_ms(library) if library is not None else None
    log(f"  {name}: {entry['ms']:.4f} ms (normalized body over the same slice "
        f"{entry['normalized_ms']:.4f}), plain {entry['plain_ms']:.4f} ms, bound "
        f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})"
        + (f", library {entry['library_ms']:.4f} ms" if library else ""))
    entries.append(entry)


def lse_attention(q, k, v, mask, scale):
    """Yardstick only (the port never calls it): PyTorch's memory-efficient
    SDPA with its log-sum-exp, the flash statistics the partials body
    returns (lse = m + log l), over q (B,H,T,D), k/v (B,H,S,.) and a
    boolean (T,S) mask turned into an additive bias."""
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device).masked_fill(
        ~mask, float("-inf"))
    bias = bias[None, None].expand(q.shape[0], q.shape[1], *mask.shape)
    return torch.ops.aten._scaled_dot_product_efficient_attention(
        q, k, v, bias, True, scale=scale)


def partials_kernel_entries(entries):
    """The partials bodies of K3, K8, K9 and K10 at the seq=2 shards' shapes
    (each rank's 2048 of the 4096-slot window), the second shard's slice,
    float (bf16) and int8 rows: K3 and K10 at DeepSeek-V3's (128 heads, R
    512, P 64), K8 at DeepSeek-V2-Lite's (16 heads, Dh 192, Dv 128), K9 at
    both (the V3 hybrid prefill's 128 heads and V2-Lite's 16). Decode at
    kv_len 4000 (1952 live slots on the second shard); prefill the
    window's last 256-token chunk at 3840 (shard 1 at cache_pos0 2048).
    Each beside its normalized body over the same slice. Tolerance 1e-4 of
    each scale: f32 sums in other orders, fast exp. The bounds count the
    slice's rows (int8: and their f32 scales), the queries and the triple
    written. The library time is the memory-efficient SDPA with its
    log-sum-exp over the same mask (where PyTorch takes the shapes); over
    int8 rows with scales no PyTorch call attends, so none. Each body,
    float and int8, is also held on an empty shard at the same shapes
    (``check_empty_shard``): decode at kv_len_local 0, prefill the
    window's first chunk (q_pos0 0) on the second shard."""
    from deepseek_tpu_torch.ops.kernels.attention import (
        mha_decode_attn, mha_decode_attn_plain, mla_decode_attn,
        mla_decode_attn_plain)
    from deepseek_tpu_torch.ops.kernels.prefill_attn import (
        mha_prefill_attn, mha_prefill_attn_plain, mla_prefill_attn,
        mla_prefill_attn_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    S, half, kv, T = 4096, 2048, 4000, 256
    S_l, kv_l, q_pos0, base = half, kv - half, S - T, half
    pairs = sum(min(S_l, max(0, q_pos0 + t - base + 1)) for t in range(T))
    src, pallas = "deepseek_tpu_torch/csrc/", "deepseek_tpu/ops/pallas/attention.py:"
    kl = torch.tensor([kv_l], device="cuda", dtype=torch.int32)
    kl0 = torch.zeros(1, device="cuda", dtype=torch.int32)    # an empty shard
    bf = lambda *shape: (torch.randn(shape, generator=gen, device="cuda") * 0.3).to(
        torch.bfloat16)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    dec_mask = (torch.arange(S_l, device="cuda") < kv_l)[None]
    pre_mask = (base + torch.arange(S_l, device="cuda")[None]
                <= q_pos0 + torch.arange(T, device="cuda")[:, None])
    trip = lambda *lead: 4 * math.prod(lead)      # bytes of acc + m + l written

    # K3 partials (V3: 128 heads over the latent slice)
    H, R, P = 128, 512, 64
    scale = 1.0 / math.sqrt(192)
    qc, qr = rnd(1, H, R), rnd(1, H, P)
    for q8 in (False, True):
        if q8:
            (ckv, cs), (kr, rs) = int8_rows(gen, (1, S_l, R)), int8_rows(gen, (1, S_l, P))
            sc, row_b, tag, kern = dict(ckv_scale=cs, krope_scale=rs), R + P + 8, \
                "int8", "K3-part-int8"
            lib = None
        else:
            ckv, kr, sc, row_b, tag, kern = bf(1, S_l, R), bf(1, S_l, P), {}, \
                2 * (R + P), "bf16", "K3-part"
            qh = torch.cat([qc, qr], -1)[:, :, None].to(torch.bfloat16)
            kh = torch.cat([ckv, kr], -1)[:, None].expand(1, H, S_l, R + P)
            vh = ckv[:, None].expand(1, H, S_l, R)
            lib = lambda: lse_attention(qh, kh, vh, dec_mask, scale)
        emit_partials(
            entries, f"{kern} mla_decode_attn partials, {tag} shard S_local={S_l} "
            f"kv_len_local={kv_l} H={H}",
            lambda: mla_decode_attn(qc, qr, ckv, kr, kl, scale, partials=True, **sc),
            lambda: mla_decode_attn_plain(qc, qr, ckv, kr, kl, scale, partials=True, **sc),
            lambda: mla_decode_attn(qc, qr, ckv, kr, kl, scale, **sc), 1e-4,
            kv_l * row_b + nbytes(qc, qr) + trip(H, R + 2), 2.0 * H * kv_l * (2 * R + P),
            src + "prefill_attn.cu", pallas + "170 (mla_decode_attn, partials out specs "
            ":214-219, written :158-166)", kern, "seq=2 V3 packed Q3_K"
            + (" int8, K10 decode" if q8 else ", K9 decode"), library=lib)
        check_empty_shard(
            f"{kern} mla_decode_attn partials, {tag} empty shard kv_len_local=0",
            lambda: mla_decode_attn(qc, qr, ckv, kr, kl0, scale, partials=True, **sc),
            lambda: mla_decode_attn_plain(qc, qr, ckv, kr, kl0, scale, partials=True,
                                          **sc))
        del ckv, kr

    # K10 partials (V3), the window's last chunk on the second shard
    qc, qr = rnd(1, T, H, R) * 0.3, rnd(1, T, H, P) * 0.3
    for q8 in (False, True):
        if q8:
            (ckv, cs), (kr, rs) = int8_rows(gen, (1, S_l, R)), int8_rows(gen, (1, S_l, P))
            sc, row_b, tag, kern, lib = dict(ckv_scale=cs, krope_scale=rs), R + P + 8, \
                "int8", "K10-part-int8", None
        else:
            ckv, kr, sc, row_b, tag, kern = bf(1, S_l, R), bf(1, S_l, P), {}, \
                2 * (R + P), "bf16", "K10-part"
            qh = torch.cat([qc, qr], -1).transpose(1, 2).to(torch.bfloat16)
            kh = torch.cat([ckv, kr], -1)[:, None].expand(1, H, S_l, R + P)
            vh = ckv[:, None].expand(1, H, S_l, R)
            lib = lambda: lse_attention(qh, kh, vh, pre_mask, scale)
        emit_partials(
            entries, f"{kern} mla_prefill_attn partials, {tag} shard T={T} "
            f"S_local={S_l} H={H} q_pos0={q_pos0} cache_pos0={base}",
            lambda: mla_prefill_attn(qc, qr, ckv, kr, q_pos0, base, scale,
                                     partials=True, **sc),
            lambda: mla_prefill_attn_plain(qc, qr, ckv, kr, q_pos0, base, scale,
                                           partials=True, **sc),
            lambda: mla_prefill_attn(qc, qr, ckv, kr, q_pos0, base, scale, **sc), 1e-4,
            S_l * row_b + nbytes(qc, qr) + trip(T, H, R + 2),
            2.0 * pairs * H * (2 * R + P), src + "prefill_attn.cu",
            pallas + "644 (mla_prefill_attn, partials out specs :697, written :634)",
            kern, "seq=2 V3 packed Q3_K" + (" int8, K10 prefill" if q8 else ", K10 prefill"),
            library=lib)
        check_empty_shard(
            f"{kern} mla_prefill_attn partials, {tag} empty shard T={T} q_pos0=0 "
            f"cache_pos0={base}",
            lambda: mla_prefill_attn(qc, qr, ckv, kr, 0, base, scale, partials=True, **sc),
            lambda: mla_prefill_attn_plain(qc, qr, ckv, kr, 0, base, scale, partials=True,
                                           **sc))
        del ckv, kr
    del qc, qr

    # K9 partials: the V3 hybrid prefill (128 heads) and V2-Lite (16)
    Dh, Dv = 192, 128
    scale = 1.0 / math.sqrt(Dh)
    for H, q8, model in ((128, False, "V3"), (16, False, "V2-Lite"), (16, True, "V2-Lite")):
        q = rnd(1, T, H, Dh) * 0.3
        if q8:
            (k, ks), (v, vs) = int8_rows(gen, (1, S_l, H, Dh)), int8_rows(gen, (1, S_l, H, Dv))
            sc, row_b, tag, kern, lib = dict(k_scale=ks.transpose(1, 2),
                                             v_scale=vs.transpose(1, 2)), \
                H * (Dh + Dv + 8), "int8", "K9-part-int8", None
            path = "seq=2 V2-Lite F16 int8 prefill"
        else:
            k, v, sc, row_b, tag, kern = bf(1, S_l, H, Dh), bf(1, S_l, H, Dv), {}, \
                2 * H * (Dh + Dv), "bf16", "K9-part"
            qh, kh, vh = (t.transpose(1, 2).to(torch.bfloat16) for t in (q, k, v))
            lib = lambda: lse_attention(qh, kh, vh, pre_mask, scale)
            path = ("seq=2 V3 packed Q3_K, K9 prefill" if model == "V3"
                    else "seq=2 V2-Lite F16 prefill")
        emit_partials(
            entries, f"{kern} mha_prefill_attn partials ({model}), {tag} shard T={T} "
            f"S_local={S_l} H={H} Dh={Dh} Dv={Dv} q_pos0={q_pos0} cache_pos0={base}",
            lambda: mha_prefill_attn(q, k, v, q_pos0, base, scale, partials=True, **sc),
            lambda: mha_prefill_attn_plain(q, k, v, q_pos0, base, scale, partials=True,
                                           **sc),
            lambda: mha_prefill_attn(q, k, v, q_pos0, base, scale, **sc), 1e-4,
            S_l * row_b + nbytes(q) + trip(T, H, Dv + 2), 2.0 * pairs * H * (Dh + Dv),
            src + "prefill_attn.cu", pallas + "481 (mha_prefill_attn, partials out "
            "specs :533-541, written :468-474)", kern, path, library=lib)
        check_empty_shard(
            f"{kern} mha_prefill_attn partials ({model}), {tag} empty shard T={T} H={H} "
            f"q_pos0=0 cache_pos0={base}",
            lambda: mha_prefill_attn(q, k, v, 0, base, scale, partials=True, **sc),
            lambda: mha_prefill_attn_plain(q, k, v, 0, base, scale, partials=True, **sc))
        del q, k, v

    # K8 partials (V2-Lite: 16 heads)
    H = 16
    q = rnd(1, H, Dh)
    for q8 in (False, True):
        if q8:
            (k, ks), (v, vs) = int8_rows(gen, (1, S_l, H, Dh)), int8_rows(gen, (1, S_l, H, Dv))
            sc, row_b, tag, kern, lib = dict(k_scale=ks.transpose(1, 2),
                                             v_scale=vs.transpose(1, 2)), \
                H * (Dh + Dv + 8), "int8", "K8-part-int8", None
        else:
            k, v, sc, row_b, tag, kern = bf(1, S_l, H, Dh), bf(1, S_l, H, Dv), {}, \
                2 * H * (Dh + Dv), "bf16", "K8-part"
            qh = q[:, :, None].to(torch.bfloat16)
            kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
            lib = lambda: lse_attention(qh, kh, vh, dec_mask, scale)
        emit_partials(
            entries, f"{kern} mha_decode_attn partials, {tag} shard S_local={S_l} "
            f"kv_len_local={kv_l} H={H} Dh={Dh} Dv={Dv}",
            lambda: mha_decode_attn(q, k, v, kl, scale, partials=True, **sc),
            lambda: mha_decode_attn_plain(q, k, v, kl, scale, partials=True, **sc),
            lambda: mha_decode_attn(q, k, v, kl, scale, **sc), 1e-4,
            kv_l * row_b + nbytes(q) + trip(H, Dv + 2), 2.0 * H * kv_l * (Dh + Dv),
            src + "mha_decode.cu", pallas + "320 (mha_decode_attn, partials out specs "
            ":363, written :309-318)", kern,
            "seq=2 V2-Lite F16" + (" int8 decode" if q8 else " decode"), library=lib)
        check_empty_shard(
            f"{kern} mha_decode_attn partials, {tag} empty shard kv_len_local=0",
            lambda: mha_decode_attn(q, k, v, kl0, scale, partials=True, **sc),
            lambda: mha_decode_attn_plain(q, k, v, kl0, scale, partials=True, **sc))
        del k, v


# ---------------------------------------------------------------------------
# phase 9: the tensor and expert mesh axes on ranks that share the card
# ---------------------------------------------------------------------------

# (cell, mesh axes, the models it runs): the V3-width packed Q3_K draw cut
# to 4 layers over every cell, the V2-Lite-width F8E5M2 draw cut to 2 at
# tensor=2 (its ranks hold 8 of the 16 heads)
MESH_CELLS = (("tensor=2", dict(tensor=2), ("v3", "v2")),
              ("expert=2", dict(expert=2), ("v3",)),
              ("expert=2 x tensor=2", dict(expert=2, tensor=2), ("v3",)))
MESH_DECODE = 16           # teacher-forced decode steps after the prompt
MESH_BLOCK = 16            # a decode block at temperature 0.8 every rank samples
MESH_TOL = 1e-3            # of max|logit|, f32 compute (see SEQ_TOL)
# the kernels each model's path must launch (prefill, decode)
MESH_KERNELS = {"v3": (("K10", "K5r-packed", "K6-packed"), ("K3", "K5-packed", "K2-packed")),
                "v2": (("K9", "K5r", "K6-fp8"), ("K8", "K5", "K2-fp8"))}


def mesh_model(model):
    """The mesh phase's model drawn on the card from the seed, f32 compute:
    "v3" DeepSeek-V3 widths in packed Q3_K, 4 layers (3 dense, 1 MoE),
    without the factor weights (absorbed prefill: K10), a bf16 cache; "v2"
    DeepSeek-V2-Lite widths in F8E5M2 with 128x128 blocks, 2 layers (the
    dense one, whose 10944-wide FFN does not cut at tensor=2, and one
    MoE), a bf16 cache."""
    from deepseek_tpu_torch.config import QuantKind
    from deepseek_tpu_torch.models.testing import (
        deepseek_v2_lite_proportions, deepseek_v3_proportions, random_fp8_params,
        random_fused_params)
    if model == "v3":
        cfg = deepseek_v3_proportions(n_layers=4, compute_dtype="float32",
                                      kv_cache_dtype="bfloat16")
        return random_fused_params(cfg, "q3_k", seed=SEED, device="cuda"), cfg
    cfg = deepseek_v2_lite_proportions(n_layers=2, weight_quant=QuantKind.F8E5M2,
                                       block_size=(128, 128), compute_dtype="float32",
                                       kv_cache_dtype="bfloat16")
    return random_fp8_params(cfg, seed=SEED, device="cuda"), cfg


class CollectiveClock:
    """Wraps torch.distributed.all_reduce in a rank and counts its calls;
    while ``timing``, the card is synchronized before and after each call
    and the host clock between summed (a gloo all-reduce of CUDA tensors
    copies through host memory)."""

    def __init__(self):
        import torch.distributed as dist
        self.seconds, self.calls, self.timing, self._orig = 0.0, 0, True, dist.all_reduce

        def counted(*a, **kw):
            self.calls += 1
            if not self.timing:
                return self._orig(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._orig(*a, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out

        dist.all_reduce = counted

    def reset(self, timing: bool = True):
        self.seconds, self.calls, self.timing = 0.0, 0, timing


def mesh_rank(rank, world, shape, models, forced_of):
    """One rank of a mesh cell: each model drawn from the seed, cut to this
    rank's slice (``shard_params``; the whole draw freed), the 512-token
    prompt in 2 chunks and the teacher-forced decode steps (``seq_path``,
    the collectives timed), then a decode block at 0.8 on the host clock
    with the collectives untimed. Returns per model the logits, launches,
    walls, collective time and calls, peak and resident memory, the
    block's tokens and wall, what the rank holds."""
    from deepseek_tpu_torch.models.deepseek import (
        forward_prefill, local_heads, make_decode_loop)
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.ops import prng
    from deepseek_tpu_torch.parallel.mesh import make_mesh
    from deepseek_tpu_torch.parallel.sharding import shard_params
    from deepseek_tpu_torch.parallel.spmd import make_ctx

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(**shape)
    counts, clock = counters(), CollectiveClock()
    out = {"coords": (mesh.expert_index, mesh.tensor_index)}
    for model in models:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, cfg = mesh_model(model)
        sp = shard_params(params, cfg, mesh)
        del params
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        ctx = make_ctx(cfg, mesh)
        prompt, _ = seq_inputs(cfg, "v3")
        heads = local_heads(sp.layers[0], cfg)
        cache = init_cache(cfg, device="cuda", heads=heads)
        clock.reset()
        rows, _, launched, walls = seq_path(sp, cfg, prompt, forced_of[model], ctx, cache,
                                            counts)
        coll = (clock.seconds, clock.calls)
        cache = init_cache(cfg, device="cuda", heads=heads)
        with torch.inference_mode():
            for i in range(0, len(prompt), 256):
                forward_prefill(sp, cache, torch.tensor([prompt[i:i + 256]], device="cuda"),
                                i, cfg, "none", ctx)
        loop = make_decode_loop(cfg, MESH_BLOCK, mesh=mesh)
        tok = torch.full((1, 1), prompt[-1], dtype=torch.int64, device="cuda")
        clock.reset(timing=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _, _ = loop(sp, cache, tok, len(prompt), prng.PRNGKey(SEED), 0.8, 0.95)
        toks = toks[0].tolist()
        block = (time.perf_counter() - t0, clock.calls)
        dense_w2 = sp.layers[0].w2.shape[-1]
        experts = sp.layers[-1].w2.shape[0]
        out[model] = dict(rows=rows, launched=launched, walls=walls, coll=coll,
                          peak=torch.cuda.max_memory_allocated(), resident=resident,
                          block=toks, block_wall=block,
                          holds=dict(heads=heads, dense_w2_in=dense_w2, experts=experts,
                                     lm_head_rows=sp.lm_head.shape[0]))
        del sp, cache
    return out


def mesh_phase(counts, runs):
    """The tensor and expert mesh axes: the unsharded runs on the card first
    (the reference: the V3-width packed Q3_K draw and the V2-Lite-width
    F8E5M2 draw, a 512-token prompt in 2 chunks, then MESH_DECODE greedy
    steps), then each MESH_CELLS cell's ranks, spawned by parallel/launch.py
    and sharing the card over gloo, run the same paths teacher-forced with
    the unsharded greedy tokens over their slices (K10 / K9 at H/tp heads,
    K3 / K8 likewise, the packed and fp8 K5 on cut planes, K2 and K6 over
    the local experts with aliased pairs and the EP capacity). Each rank's
    logits within MESH_TOL of max|logit| of the unsharded run's (f32
    compute), the same bits on every rank, each row's argmax the unsharded
    greedy token or a near-tie; each path launched its kernels; the decode
    blocks at 0.8 give every rank the same tokens. Logs each rank's walls,
    peak and resident memory and time in collectives."""
    from deepseek_tpu_torch.models.deepseek import forward_prefill, make_decode_loop
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.ops import prng
    from deepseek_tpu_torch.parallel.launch import launch
    from deepseek_tpu_torch.parallel.spmd import NULL_CTX

    t_phase = time.perf_counter()
    ref, forced_of = {}, {}
    for model in ("v3", "v2"):
        params, cfg = mesh_model(model)
        prompt, _ = seq_inputs(cfg, "v3")
        rows, fed, launched, walls = seq_path(params, cfg, prompt, None, NULL_CTX,
                                              init_cache(cfg, device="cuda"), counts,
                                              steps=MESH_DECODE)
        ref[model], forced_of[model] = (rows, walls), fed
        cache = init_cache(cfg, device="cuda")
        with torch.inference_mode():
            for i in range(0, len(prompt), 256):
                forward_prefill(params, cache, torch.tensor([prompt[i:i + 256]],
                                                            device="cuda"), i, cfg, "none")
        tok = torch.full((1, 1), prompt[-1], dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block, _, _ = make_decode_loop(cfg, MESH_BLOCK)(params, cache, tok, len(prompt),
                                                         prng.PRNGKey(SEED), 0.8, 0.95)
        block = block[0].tolist()
        t_block = time.perf_counter() - t0
        log(f"mesh: unsharded {model} on the card: prefill / decode wall {walls[0]:.3f} / "
            f"{walls[1]:.3f} s, greedy tokens {fed}; a 0.8 block of {MESH_BLOCK} in "
            f"{t_block:.3f} s ({MESH_BLOCK / t_block:.2f} tok/s), tokens {block}")
        del params
        torch.cuda.empty_cache()
    log(f"mesh: unsharded reference runs in {time.perf_counter() - t_phase:.1f} s")
    failed = []
    for cell, shape, models in MESH_CELLS:
        t0 = time.perf_counter()
        n = math.prod(shape.values())
        ranks = launch(mesh_rank, n, shape, models, forced_of, backend="gloo",
                       timeout=SEQ_TIMEOUT, threads=None)
        log(f"mesh {cell}: {n} gloo ranks on one card in {time.perf_counter() - t0:.1f} s "
            f"(spawn and draws included); coordinates (expert, tensor) "
            f"{[r['coords'] for r in ranks]}")
        for model in models:
            want, walls1 = ref[model]
            scale = float(want.abs().max())
            tol = MESH_TOL * scale
            for r, res in enumerate(ranks):
                got = res[model]
                rows, launched = got["rows"], got["launched"]
                err = float((rows - want).abs().max())
                top = rows.argmax(-1)
                ties = want.gather(1, want.argmax(-1, keepdim=True))[:, 0] \
                    - want.gather(1, top[:, None])[:, 0]
                wall = sum(got["walls"])
                log(f"mesh {cell} {model}, rank {r} (holds {got['holds']}): logits vs "
                    f"unsharded max abs err {err:.3e} ({err / scale:.2e} of max|logit| "
                    f"{scale:.3f}; tolerance {MESH_TOL:g}), argmax equal on "
                    f"{int((top == want.argmax(-1)).sum())} of {len(rows)} rows; prefill / "
                    f"decode wall {got['walls'][0]:.3f} / {got['walls'][1]:.3f} s "
                    f"(unsharded {walls1[0]:.3f} / {walls1[1]:.3f}; the ranks time-share "
                    f"the card); collectives {got['coll'][1]} calls, {got['coll'][0]:.3f} s "
                    f"({100 * got['coll'][0] / wall:.1f}% of the wall; the card synced "
                    f"around each); peak device memory {got['peak'] / 2**30:.2f} GiB "
                    f"(the whole draw before the cut), resident after the cut "
                    f"{got['resident'] / 2**30:.2f} GiB; a 0.8 decode block of "
                    f"{MESH_BLOCK} in {got['block_wall'][0]:.3f} s "
                    f"({MESH_BLOCK / got['block_wall'][0]:.2f} tok/s, collectives untimed, "
                    f"{got['block_wall'][1]} all-reduces); launches prefill "
                    f"{ {k: v for k, v in launched['prefill'].items() if v} }, decode "
                    f"{ {k: v for k, v in launched['decode'].items() if v} }")
                if not (bool(torch.isfinite(rows).all()) and err <= tol
                        and float(ties.max()) <= tol):
                    failed.append(f"{cell} {model}: rank {r}'s logits disagree with the "
                                  f"unsharded run")
                if r and not torch.equal(rows, ranks[0][model]["rows"]):
                    failed.append(f"{cell} {model}: rank {r}'s logits differ from rank 0's")
                if got["block"] != ranks[0][model]["block"]:
                    failed.append(f"{cell} {model}: rank {r} sampled other tokens")
                for part, kernels in zip(("prefill", "decode"), MESH_KERNELS[model]):
                    missing = [k for k in kernels if launched[part][k] == 0]
                    if missing:
                        failed.append(f"{cell} {model} {part}, rank {r}: never launched "
                                      f"{missing}")
            log(f"mesh {cell} {model}: the 0.8 block's tokens on rank 0 "
                f"{ranks[0][model]['block']}")
            runs[f"mesh {cell} {model} prefill"] = ranks[0][model]["launched"]["prefill"]
            runs[f"mesh {cell} {model} decode"] = ranks[0][model]["launched"]["decode"]
    log(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise RuntimeError("mesh: " + "; ".join(failed))


def sdpa_yardstick(q, k, v, mask, scale):
    """Yardstick only (the port never calls it): scaled_dot_product_attention
    over q (B,H,T,D), k/v (B,H,S,.) and a boolean (T,S) mask."""
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask[None, None], scale=scale)


def mesh_kernel_entries(entries):
    """The kernels of the mesh paths at the local shapes they take there,
    each against its plain version on the card, on rank 0's slices (the
    parent cuts the same draws with ``shard_params`` over a Mesh that names
    the rank's place): at tensor=2, V3's K5 matvec (packed) on the cut
    planes at 1 row and its row-tiled route at 256, K2 on the per-head
    wv_b of 64 heads, K3 and K10 at 64 heads; at expert=2, K2 over the
    local tables with the aliased pairs of one token and K6 over the local
    experts' tiles under the EP capacity; V2-Lite's K5 (fp8) matvec and
    row-tiled route on the cut planes, K8 and K9 at 8 heads. Tolerance
    1e-4 of max|ref|, as the unsharded entries."""
    from deepseek_tpu_torch.ops.kernels.attention import (
        mha_decode_attn, mha_decode_attn_plain, mla_decode_attn, mla_decode_attn_plain)
    from deepseek_tpu_torch.ops.kernels.prefill_attn import (
        mha_prefill_attn, mha_prefill_attn_plain, mla_prefill_attn,
        mla_prefill_attn_plain)
    from deepseek_tpu_torch.ops.kernels.qmm import (
        qmm, qmm_experts, qmm_experts_plain, qmm_fp8_rows, qmm_grouped,
        qmm_grouped_plain, qmm_packed_rows, qmm_plain)
    from deepseek_tpu_torch.ops.matmul import (
        dispatch_pairs, ep_owned, ep_prefill_capacity, owned_tiles)
    from deepseek_tpu_torch.parallel.mesh import Mesh
    from deepseek_tpu_torch.parallel.sharding import shard_params
    from deepseek_tpu_torch.parallel.spmd import SpmdCtx
    from deepseek_tpu_torch.quant.qtensor import rows_to_experts

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    bf = lambda *shape: (rnd(*shape) * 0.3).to(torch.bfloat16)
    csrc, qpy, apy = ("deepseek_tpu_torch/csrc/", "deepseek_tpu/ops/pallas/qmm.py:",
                      "deepseek_tpu/ops/pallas/attention.py:")
    T, S, kv = 256, 4096, PREFILL_TOKENS + MESH_DECODE
    q_pos0 = PREFILL_TOKENS - T                    # the prompt's second chunk
    pairs = sum(q_pos0 + t + 1 for t in range(T))  # causal (query, slot) pairs
    params, cfg = mesh_model("v3")

    def matvecs(emit_dec, emit_pre, tp, weights, rows_kernel, k5, k5r, label):
        for name, qt in weights:
            d, n = qt.shape
            x = rnd(1, n)
            emit_dec(f"{k5} qmm {label} {name} at tensor={tp} 1x{d}x{n}",
                     lambda: qmm(qt, x), lambda: qmm_plain(qt, x), 1e-4,
                     nbytes(x) + qt.nbytes_active + 4 * d, 2.0 * d * n,
                     csrc + ("packed_mv.cu" if k5 == "K5-packed" else "fp8_mv.cu"),
                     qpy + "312 (qmm, " + ("_q3k_body :368)" if k5 == "K5-packed"
                                           else "_fp8_body :260, pallas_call :418)"), k5)
        for name, qt in weights[:3]:
            d, n = qt.shape
            x = rnd(T, n)
            emit_pre(f"{k5r} qmm row-tiled {label} {name} at tensor={tp} {T}x{d}x{n}",
                     lambda: rows_kernel(qt, x), lambda: qmm_plain(qt, x), 1e-4,
                     nbytes(x) + qt.nbytes_active + 4 * T * d, 2.0 * T * d * n,
                     csrc + "qmm_tiles.cu", qpy + "312 (qmm, rows tiled by 128 :347-351)",
                     k5r)

    # V3 at tensor=2: rank 0 holds heads 0..63, half the dense and shared
    # hidden width, half the vocab
    sp = shard_params(params, cfg, Mesh(tensor=2, tensor_index=0))
    dense, moe = sp.layers[0], sp.layers[cfg.n_layers - 1]
    H, R, P = dense.wo.shape[-1] // cfg.v_head_dim, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dec, pre = "mesh tensor=2 v3 decode", "mesh tensor=2 v3 prefill"
    emit_dec, emit_pre = make_emit(entries, dec), make_emit(entries, pre)
    matvecs(emit_dec, emit_pre, 2,
            [("wo", dense.wo), ("w1 (dense)", dense.w1), ("w2 (dense)", dense.w2),
             ("wc", dense.wc), ("wq_rope_b", dense.wq_rope_b),
             ("shared_w1", moe.shared_w1), ("shared_w2", moe.shared_w2),
             ("lm_head", sp.lm_head)], qmm_packed_rows, "K5-packed", "K5r-packed",
            "Q3_K packed")
    wv3 = rows_to_experts(dense.wv_b, H)
    ids = torch.arange(H, device="cuda")
    x = rnd(H, R)
    emit_dec(f"K2 qmm_experts Q3_K packed wv_b (per head) at tensor=2 {H}x"
             f"{wv3.shape[1]}x{R}", lambda: qmm_experts(wv3, ids, x),
             lambda: qmm_experts_plain(wv3, ids, x), 1e-4,
             nbytes(x) + wv3.nbytes_active + 4 * H * wv3.shape[1], 2.0 * H * wv3.shape[1] * R,
             csrc + "packed_mv.cu", qpy + "566 (qmm_experts, _q3k_body :368)", "K2-packed")
    scale = cfg.attn_softmax_scale()
    qc, qr = rnd(1, H, R), rnd(1, H, P)
    ckv, kr = bf(1, S, R), bf(1, S, P)
    kl = torch.tensor([kv], device="cuda", dtype=torch.int32)
    dmask = (torch.arange(S, device="cuda") < kv)[None]
    emit_dec(f"K3 mla_decode_attn bf16 cache at tensor=2 S={S} kv_len={kv} H={H}",
             lambda: mla_decode_attn(qc, qr, ckv, kr, kl, scale),
             lambda: mla_decode_attn_plain(qc, qr, ckv, kr, kl, scale), 1e-4,
             kv * (R + P) * 2 + nbytes(qc, qr) + 4 * H * R, 2.0 * H * kv * (2 * R + P),
             csrc + "prefill_attn.cu", apy + "170 (mla_decode_attn, pallas_call :221)", "K3",
             library=sdpa_yardstick(torch.cat([qc, qr], -1)[:, :, None].to(torch.bfloat16),
                                    torch.cat([ckv, kr], -1)[:, None].expand(1, H, S, R + P),
                                    ckv[:, None].expand(1, H, S, R), dmask, scale))
    qc, qr = rnd(1, T, H, R) * 0.3, rnd(1, T, H, P) * 0.3
    pmask = (torch.arange(S, device="cuda")[None]
             <= q_pos0 + torch.arange(T, device="cuda")[:, None])
    emit_pre(f"K10 mla_prefill_attn bf16 cache at tensor=2 T={T} S={S} H={H} "
             f"q_pos0={q_pos0}",
             lambda: mla_prefill_attn(qc, qr, ckv, kr, q_pos0, 0, scale),
             lambda: mla_prefill_attn_plain(qc, qr, ckv, kr, q_pos0, 0, scale), 1e-4,
             (q_pos0 + T) * (R + P) * 2 + nbytes(qc, qr) + 4 * T * H * R,
             2.0 * pairs * H * (2 * R + P), csrc + "prefill_attn.cu",
             apy + "644 (mla_prefill_attn, pallas_call :707)", "K10",
             library=sdpa_yardstick(
                 torch.cat([qc, qr], -1).transpose(1, 2).to(torch.bfloat16),
                 torch.cat([ckv, kr], -1)[:, None].expand(1, H, S, R + P),
                 ckv[:, None].expand(1, H, S, R), pmask, scale))
    del sp, dense, moe, wv3, ckv, kr

    # V3 at expert=2: rank 0 holds experts 0..127
    sp = shard_params(params, cfg, Mesh(expert=2, expert_index=0))
    moe = sp.layers[cfg.n_layers - 1]
    E, k = cfg.n_routed_experts, cfg.n_active_routed
    ctx = SpmdCtx(ep=2, eidx=0, ep_capacity_factor=cfg.ep_capacity_factor)
    emit_dec = make_emit(entries, "mesh expert=2 v3 decode")
    emit_pre = make_emit(entries, "mesh expert=2 v3 prefill")
    sel = torch.randperm(E, generator=gen, device="cuda")[:k][None]
    eid, wts, _, _ = dispatch_pairs(sel, torch.ones_like(sel, dtype=torch.float32),
                                    ctx=ctx, n_experts=E)
    owned = int((wts > 0).sum())
    for name, qt in (("w1", moe.w1), ("w2", moe.w2)):
        n_tab, d, n = qt.shape
        x = rnd(k, n)
        u = eid.unique().numel()
        emit_dec(f"K2 qmm_experts Q3_K packed {name} (MoE) at expert=2: {n_tab} local "
                 f"tables, {k} pairs ({owned} owned, the rest aliased) {k}x{d}x{n}",
                 lambda: qmm_experts(qt, eid, x), lambda: qmm_experts_plain(qt, eid, x),
                 1e-4, nbytes(x) + qt.nbytes_active / n_tab * u + 4 * d * k,
                 2.0 * k * d * n, csrc + "packed_mv.cu",
                 qpy + "566 (qmm_experts, _q3k_body :368, pallas_call :710)", "K2-packed")
    routed = torch.rand((T, E), generator=gen, device="cuda").topk(k, dim=-1).indices
    N = T * k
    lidx, own, within, cnt, _ = ep_owned(routed.reshape(-1), torch.ones(N, device="cuda"),
                                         ctx, E // 2)
    C = ep_prefill_capacity(N, 2, ctx.ep_capacity_factor)
    te, tr, _, _, G = owned_tiles(lidx, own, within, cnt, C)
    live = torch.arange(128, device="cuda")[None, :] < tr[:, None]
    n_live, n_exp = int(tr.sum()), int(te[tr > 0].unique().numel())
    for name, qt in (("w1", moe.w1), ("w2", moe.w2)):
        n_tab, d, n = qt.shape
        x = rnd(G, 128, n)
        emit_pre(f"K6 qmm_grouped Q3_K packed {name} (MoE) at expert=2: {G} tiles "
                 f"(capacity {C} of {N} pairs), {n_live} owned pairs over {n_exp} of "
                 f"{n_tab} local experts, {d}x{n}",
                 lambda: qmm_grouped(qt, te, x, tr),
                 lambda: qmm_grouped_plain(qt, te, x, tr), 1e-4,
                 n_live * n * 4 + qt.nbytes_active / n_tab * n_exp + n_live * d * 4,
                 2.0 * n_live * d * n, csrc + "qmm_tiles.cu",
                 qpy + "449 (qmm_grouped, _q3k_body :368, pallas_call :538)", "K6-packed",
                 select=lambda y: y[live])
    del sp, moe, params
    torch.cuda.empty_cache()

    # V2-Lite fp8 at tensor=2: rank 0 holds heads 0..7
    params, cfg = mesh_model("v2")
    sp = shard_params(params, cfg, Mesh(tensor=2, tensor_index=0))
    del params
    dense, moe = sp.layers[0], sp.layers[1]
    emit_dec = make_emit(entries, "mesh tensor=2 v2 decode")
    emit_pre = make_emit(entries, "mesh tensor=2 v2 prefill")
    matvecs(emit_dec, emit_pre, 2,
            [("wq", dense.wq), ("wo", dense.wo), ("wkv_b", dense.wkv_b),
             ("shared_w1", moe.shared_w1), ("shared_w2", moe.shared_w2),
             ("lm_head", sp.lm_head)], qmm_fp8_rows, "K5", "K5r", "F8E5M2")
    H = dense.wo.shape[-1] // cfg.v_head_dim
    Dh, Dv = cfg.head_dim, cfg.v_head_dim
    scale = cfg.attn_softmax_scale()
    k_c, v_c = bf(1, S, H, Dh), bf(1, S, H, Dv)
    q = rnd(1, H, Dh)
    emit_dec(f"K8 mha_decode_attn bf16 cache at tensor=2 S={S} kv_len={kv} H={H} "
             f"Dh={Dh} Dv={Dv}",
             lambda: mha_decode_attn(q, k_c, v_c, kl, scale),
             lambda: mha_decode_attn_plain(q, k_c, v_c, kl, scale), 1e-4,
             kv * H * (Dh + Dv) * 2 + nbytes(q) + 4 * H * Dv, 2.0 * H * kv * (Dh + Dv),
             csrc + "mha_decode.cu", apy + "320 (mha_decode_attn, pallas_call :370)", "K8",
             library=sdpa_yardstick(q[:, :, None].to(torch.bfloat16),
                                    k_c.transpose(1, 2), v_c.transpose(1, 2), dmask, scale))
    q = rnd(1, T, H, Dh) * 0.3
    emit_pre(f"K9 mha_prefill_attn bf16 cache at tensor=2 T={T} S={S} H={H} "
             f"q_pos0={q_pos0}",
             lambda: mha_prefill_attn(q, k_c, v_c, q_pos0, 0, scale),
             lambda: mha_prefill_attn_plain(q, k_c, v_c, q_pos0, 0, scale), 1e-4,
             (q_pos0 + T) * H * (Dh + Dv) * 2 + nbytes(q) + 4 * T * H * Dv,
             2.0 * pairs * H * (Dh + Dv), csrc + "prefill_attn.cu",
             apy + "481 (mha_prefill_attn, pallas_call :543)", "K9",
             library=sdpa_yardstick(q.transpose(1, 2).to(torch.bfloat16),
                                    k_c.transpose(1, 2), v_c.transpose(1, 2), pmask, scale))
    del sp, dense, moe, k_c, v_c
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10: session persistence
# ---------------------------------------------------------------------------

SESSION_PROMPT, SESSION_BEFORE, SESSION_AFTER = 120, 12, 12


def session_phase(counts, runs):
    """``Engine.save_session`` / ``load_session`` on the card: the tiny
    packed Q3_K checkpoint of phase 2 (a 128-slot window) with f16, bf16 and
    int8 caches: a 120-token prompt hydrated and 12 greedy steps (past the
    window: the ring wraps and the sinks re-rotate), the session saved,
    then a fresh Engine(device="cuda") loads it (every field on the card,
    the same bits as saved) and decodes 12 more steps (K3, K5, K2), which
    must give the uninterrupted run's tokens."""
    from deepseek_tpu_torch.engine import Engine

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    ck = os.path.join(root, "chip_smoke_q3_k")
    path = os.path.join(root, "chip_smoke_session.dseek")
    prompt = [int(v) for v in np.random.default_rng(SEED + 13).integers(3, 512,
                                                                        SESSION_PROMPT)]

    def greedy(eng, cache, tok, pos, n):
        out = []
        for _ in range(n):
            tok = int(eng.step(cache, tok, pos)[0].argmax())
            out.append(tok)
            pos += 1
        return out

    for kv in (None, "bfloat16", "int8"):
        label = f"session, {kv or 'float16'} cache"
        eng = Engine(ck, device="cuda", seed=SEED, kv_cache_dtype=kv)
        cache, logits, _, pos = eng.hydrate(eng.new_cache(), prompt)
        first = int(np.asarray(logits).reshape(-1).argmax())
        before = greedy(eng, cache, first, pos, SESSION_BEFORE)
        pos += SESSION_BEFORE
        t0 = time.perf_counter()
        eng.save_session(path, cache, pos, tokens=prompt + [first] + before)
        t_save = time.perf_counter() - t0
        saved = {f.name: getattr(cache, f.name).clone() for f in dataclasses.fields(cache)
                 if getattr(cache, f.name) is not None}
        want = greedy(eng, cache, before[-1], pos, SESSION_AFTER)
        fresh = Engine(ck, device="cuda", seed=SEED, kv_cache_dtype=kv)
        t0 = time.perf_counter()
        loaded, pos2, toks = fresh.load_session(path)
        t_load = time.perf_counter() - t0
        same = all(getattr(loaded, f).device.type == fresh.device.type
                   and torch.equal(getattr(loaded, f), t) for f, t in saved.items())
        attn = {"int8": "K3-int8", "bfloat16": "K3"}.get(kv, "K3-f16")
        got, launched = drive(counts, (attn, "K5-packed", "K2-packed"), label,
                              lambda: greedy(fresh, loaded, toks[-1], pos2, SESSION_AFTER))
        log(f"{label}: saved {os.path.getsize(path)} bytes at position {pos} in "
            f"{t_save:.3f} s, loaded in {t_load:.3f} s, fields {sorted(saved)} "
            f"{'equal' if same else 'DIFFER'} after the load; resumed tokens {got}, "
            f"uninterrupted {want}")
        if not (same and pos2 == pos and got == want):
            raise RuntimeError(f"{label}: the resumed run differs from the uninterrupted one")
        runs[label] = launched


# ---------------------------------------------------------------------------
# phase 11: continuous batching over a data mesh, with ranks that share the
# card
# ---------------------------------------------------------------------------

DATA_REQS = (0, 1, 2, 5)   # of serving_requests: 1 and 5 share a prefix, 2 samples
# (cell, mesh axes, the (model, spec, batch size) jobs each rank serves): a
# batch of 4 serves the DATA_REQS requests, a batch of 8 all 8 of the mix
DATA_CELLS = (("data=2", dict(data=2), (("v3", None, 4), ("v3", "ngram", 4),
                                        ("v3", None, 8), ("v2", None, 4))),
              ("data=2 x expert=2", dict(data=2, expert=2), (("v3", None, 4),)))
# the kernels each job's serving run must launch
DATA_KERNELS = {("v3", None, 4): ("K10", "K5r-packed", "K6-packed", "K3", "K5-packed",
                                  "K2-packed"),
                ("v3", "ngram", 4): ("K10", "K10-rows", "K5r-packed", "K3", "K2-packed"),
                ("v3", None, 8): ("K10", "K5r-packed", "K6-packed", "K3", "K5-packed",
                                  "K2-packed"),
                ("v2", None, 4): ("K9", "K5r", "K6-fp8", "K8", "K5", "K2-fp8")}
# the unsharded jobs whose greedy requests are also served alone (a batch of
# 1) and must be those rows bit for bit: the MHA draw (K8's spans) and the
# batch of 8 (decode past 4 rows on the matvec)
DATA_ALONE = (("v3", None, 8), ("v2", None, 4))


def data_job_name(cell, job):
    model, spec, batch = job
    return (f"{cell} {model} serving" + (f" {spec}" if spec else "")
            + (f" batch {batch}" if batch != 4 else ""))


def data_requests(eng, batch=4):
    """The requests of the serving phase's mix (``serving_requests``, the
    same seed) that a batch of ``batch`` serves (DATA_REQS, or all 8), as
    plain dicts a rank can rebuild."""
    reqs = serving_requests(eng, np.random.default_rng(SEED + 53))
    return [dict(prompt_tokens=r.prompt_tokens, max_new_tokens=r.max_new_tokens,
                 temperature=r.temperature, top_p=r.top_p, top_k=r.top_k, logprobs=True)
            for i, r in enumerate(reqs) if batch == 8 or i in DATA_REQS]


def data_serve(eng, reqs, mesh=None, spec=None, sched=None, batch=4):
    """BatchScheduler(batch_size=batch, logprobs=True, prefix_cache_mb=64)
    (or ``sched``, made so) over ``reqs``: (scheduler, finished requests in
    order, wall seconds)."""
    from deepseek_tpu_torch.serving import BatchScheduler, Request

    if sched is None:
        sched = BatchScheduler(eng, batch_size=batch, logprobs=True, prefix_cache_mb=64,
                               mesh=mesh, spec=spec)
    for r in reqs:
        sched.submit(Request(**r))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    return sched, done, time.perf_counter() - t0


def data_rank(rank, world, shape, jobs, reqs_of):
    """One rank of a data cell: per job the model drawn from the seed (kept
    for the next job of the same model), an Engine over it and a
    BatchScheduler over the mesh (the weights cut by ``shard_params``: at
    data=2 replicated, at expert=2 its experts, the whole draw then freed),
    serving the requests with the collectives timed. Returns per job the
    tokens and log-probs, launches, wall, collective time and calls, peak
    and resident memory, speculation and prefix-cache statistics and the
    slots whose cache rows the rank holds."""
    from deepseek_tpu_torch.parallel.mesh import make_mesh
    from deepseek_tpu_torch.serving import BatchScheduler

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(**shape)
    counts, clock = counters(), CollectiveClock()
    out = {"coords": (mesh.data_index, mesh.expert_index)}
    drawn = {}
    for j, (model, spec, batch) in enumerate(jobs):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if model not in drawn:
            drawn.clear()
            drawn[model] = mesh_model(model)
        params, cfg = drawn[model]
        eng = params_engine(params, cfg)
        sched = BatchScheduler(eng, batch_size=batch, logprobs=True, prefix_cache_mb=64,
                               mesh=mesh, spec=spec)
        if all(m != model for m, _, _ in jobs[j + 1:]):
            eng.params = sched.params            # the whole draw is no longer needed
            drawn.clear()
        del params
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        clock.reset()
        reset(counts)
        sched, done, wall = data_serve(eng, reqs_of[(model, batch)], sched=sched)
        launched = read(counts)
        out[(model, spec, batch)] = dict(
            toks=[r.out_tokens for r in done], lps=[r.out_logprobs for r in done],
            launched=launched, wall=wall, coll=(clock.seconds, clock.calls),
            peak=torch.cuda.max_memory_allocated(), resident=resident,
            spec=dict(sched.spec_stats), prefix=sched.prefix_cache.stats,
            slots=(sched._rows.start, sched._rows.stop))
        del sched, eng
    return out


def data_serving_phase(counts, runs):
    """Continuous batching over a data mesh: the unsharded runs on the card
    first (the reference: the V3-width packed Q3_K draw cut to 4 layers and
    the V2-Lite-width F8E5M2 draw cut to 2, f32 compute, bf16 cache, the
    DATA_REQS requests of the serving phase's mix through
    BatchScheduler(batch_size=4, logprobs=True, prefix_cache_mb=64), and
    all 8 of the mix at batch_size=8 on the V3 draw), then each DATA_CELLS
    cell's gloo ranks on the one card serve the same requests through the
    scheduler over the mesh, each rank holding half the batch rows (K3 at 2
    or 4 rows, K5 packed at 2 or 4 rows, K2 over 2 or 4 tokens' pairs; MHA:
    K8 and K9 over a batch cut in two): greedy requests the unsharded run's
    tokens (near ties allowed), their log-probs within SERVE_TOL of the
    unsharded run's, every rank the same tokens and log-probs (the sampled
    request too, drawn under each data shard's folded key), the
    prefix-cache hit. At data=2 every job's greedy tokens and log-probs
    must be the unsharded scheduler's bit for bit: a served row computes
    the bits of its sequence alone, whatever its batch (decode up to
    DECODE_INVARIANT_ROWS rows: one sequence's K3 and K8 spans, the
    projections on the matvec; verify chunks: ``ops/matmul.py::
    verify_chunk``), so also the DATA_ALONE jobs' greedy requests served
    alone (batch 1). Logs the decode step's wall at B = 4 and 8, and each
    rank's wall, time in collectives, peak and resident memory."""
    from deepseek_tpu_torch.parallel.launch import launch

    t_phase = time.perf_counter()
    ref, reqs_of, failed = {}, {}, []
    for model in ("v3", "v2"):
        params, cfg = mesh_model(model)
        eng = params_engine(params, cfg)
        for job in (j for j in DATA_CELLS[0][2] if j[0] == model):
            _, spec, batch = job
            reqs = reqs_of[(model, batch)] = data_requests(eng, batch)
            greedy = [i for i, r in enumerate(reqs)
                      if r["temperature"] == 0.0 or r["top_k"] == 1]
            label = "data mesh: " + data_job_name("unsharded", job)
            if spec is None:
                (sched, done, wall), launched = drive(
                    counts, DATA_KERNELS[job], label,
                    lambda: data_serve(eng, reqs, batch=batch))
                runs[data_job_name("unsharded", job)] = launched
            else:
                sched, done, wall = data_serve(eng, reqs, spec=spec, batch=batch)
            toks = [r.out_tokens for r in done]
            teach = {i: teacher_logits(eng, reqs[i]["prompt_tokens"], toks[i]) for i in greedy}
            n_tok = sum(len(t) for t in toks)
            ref[job] = dict(toks=toks, lps=[r.out_logprobs for r in done],
                            teach=teach, greedy=greedy)
            log(f"{label}: {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.2f} tok/s), prompts "
                f"{[len(r['prompt_tokens']) for r in reqs]}, greedy {greedy}, prefix cache "
                f"{sched.prefix_cache.stats}, spec {sched.spec_stats}")
            del sched
            if job in DATA_ALONE:
                _, alone, wall = data_serve(eng, reqs, batch=1)
                same = all(alone[i].out_tokens == toks[i]
                           and alone[i].out_logprobs == ref[job]["lps"][i] for i in greedy)
                gap = max(float(np.abs(np.asarray(alone[i].out_logprobs)
                                       - np.asarray(ref[job]["lps"][i])).max())
                          if len(alone[i].out_logprobs) == len(ref[job]["lps"][i])
                          else float("inf") for i in greedy)
                log(f"{label}: greedy requests {greedy} served alone (batch 1, {wall:.3f} s): "
                    f"tokens and log-probs bit-equal to the batch of {batch}'s: {same} (max "
                    f"abs log-prob diff {gap:.3e})")
                if not same:
                    failed.append(f"{label}: greedy rows differ from the rows alone by "
                                  f"{gap:.3e}")
            if job == ("v3", None, 8):
                walls = decode_step_walls(params, cfg)
                log(f"{label}: decode step wall, median of {DECODE_WALL_STEPS} synchronized "
                    f"steps: B = 4 {walls[4]:.3f} ms, B = 8 {walls[8]:.3f} ms ({card_line()})")
        del params, eng
        torch.cuda.empty_cache()
    log(f"data mesh: unsharded reference runs in {time.perf_counter() - t_phase:.1f} s")
    for cell, shape, jobs in DATA_CELLS:
        t0 = time.perf_counter()
        n = math.prod(shape.values())
        ranks = launch(data_rank, n, shape, jobs, reqs_of, backend="gloo",
                       timeout=SEQ_TIMEOUT, threads=None)
        log(f"data mesh {cell}: {n} gloo ranks on one card in "
            f"{time.perf_counter() - t0:.1f} s (spawn and draws included); coordinates "
            f"(data, expert) {[r['coords'] for r in ranks]}")
        for job in jobs:
            model, spec, batch = job
            name = data_job_name(cell, job)
            want = ref[job]
            for r, res in enumerate(ranks):
                got = res[job]
                worst = 0.0
                for i in want["greedy"]:
                    agree = same_or_near_tie(want["teach"][i], want["toks"][i],
                                             got["toks"][i], f"{name}, rank {r}, request {i}")
                    if agree == len(got["toks"][i]) and len(got["toks"][i]) != len(
                            want["toks"][i]):
                        failed.append(f"{name}, rank {r}: request {i} has "
                                      f"{len(got['toks'][i])} tokens")
                    a = np.asarray(got["lps"][i][:agree])
                    b = np.asarray(want["lps"][i][:agree])
                    worst = max(worst, float(np.abs(a - b).max()) if agree else 0.0)
                n_tok = sum(len(t) for t in got["toks"])
                wall, (cs, cn) = got["wall"], got["coll"]
                log(f"{name}, rank {r} (slots {got['slots']}): {n_tok} tokens in "
                    f"{wall:.3f} s ({n_tok / wall:.2f} tok/s; the ranks time-share the "
                    f"card), collectives {cn} calls, {cs:.3f} s ({100 * cs / wall:.1f}% of "
                    f"the wall; the card synced around each); greedy log-probs vs the "
                    f"unsharded run's max abs err {worst:.3e} (tolerance {SERVE_TOL}); peak "
                    f"device memory {got['peak'] / 2**30:.2f} GiB, resident "
                    f"{got['resident'] / 2**30:.2f} GiB; prefix cache {got['prefix']}, "
                    f"spec {got['spec']}; launches "
                    f"{ {k: v for k, v in got['launched'].items() if v} }")
                if not worst <= SERVE_TOL:
                    failed.append(f"{name}, rank {r}: log-probs off the unsharded run's")
                if cell == "data=2":
                    # the greedy requests; the sampled one draws under each
                    # data shard's folded key, as the JAX mesh scheduler does
                    same = all(got["toks"][i] == want["toks"][i]
                               and got["lps"][i] == want["lps"][i] for i in want["greedy"])
                    log(f"{name}, rank {r}: greedy requests {want['greedy']}' tokens and "
                        f"log-probs bit-equal to the unsharded batch-{batch} scheduler's: "
                        f"{same} (max abs log-prob diff {worst:.3e})")
                    if not same:
                        failed.append(f"{name}, rank {r}: greedy tokens or log-probs not "
                                      f"bit-equal to the unsharded scheduler's")
                if not all(np.isfinite(lp).all() and max(lp, default=0.0) <= 0.0
                           for lp in got["lps"]):
                    failed.append(f"{name}, rank {r}: a log-prob is not finite or above 0")
                if got["toks"] != ranks[0][job]["toks"] or got["lps"] != ranks[0][job]["lps"]:
                    failed.append(f"{name}: rank {r}'s tokens or log-probs differ from "
                                  f"rank 0's")
                missing = [k for k in DATA_KERNELS[job] if got["launched"][k] == 0]
                if missing:
                    failed.append(f"{name}, rank {r}: never launched {missing}")
                if spec is None and model == "v3" and got["prefix"]["hits"] < 1:
                    failed.append(f"{name}, rank {r}: no prefix-cache hit")
                if spec is not None and got["spec"]["dispatches"] < 1:
                    failed.append(f"{name}, rank {r}: no speculation dispatch")
            log(f"{name}: rank 0's tokens {ranks[0][job]['toks']}")
            runs[name] = ranks[0][job]["launched"]
    log(f"data mesh phase: {time.perf_counter() - t_phase:.1f} s ({card_line()})")
    if failed:
        raise RuntimeError("data mesh: " + "; ".join(failed))


DECODE_WALL_STEPS = 20


def decode_step_walls(params, cfg, batches=(4, 8)):
    """The median wall ms of DECODE_WALL_STEPS decode steps (forward_decode,
    the card synchronized around each) over B fresh rows at positions 300,
    350, ... for each B of ``batches``."""
    from deepseek_tpu_torch.models.deepseek import forward_decode
    from deepseek_tpu_torch.models.kvcache import init_cache

    out = {}
    for B in batches:
        cache = init_cache(cfg, batch=B, device="cuda")
        tok = torch.full((B, 1), 7, dtype=torch.int64, device="cuda")
        pos = 300 + 50 * np.arange(B)
        walls = []
        with torch.inference_mode():
            for i in range(DECODE_WALL_STEPS + 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                forward_decode(params, cache, tok, pos + i, cfg)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        out[B] = 1e3 * float(np.median(walls[2:]))
        del cache
    return out


def data_kernel_entries(entries):
    """The kernels at a data shard's shapes on the V3-width packed Q3_K draw
    (the rows a rank holds of the serving batch of 4 at data=2), each
    against its plain version on the card: K5's packed matvec at 2 rows,
    K2's packed body over 2 tokens' 16 routed pairs, K3 at 2 rows each at
    its own kv_len, K10 in verify mode over 2 chunks with per-row starts.
    Tolerance 1e-4 of max|ref|."""
    from deepseek_tpu_torch.ops.kernels.attention import (
        mla_decode_attn, mla_decode_attn_plain)
    from deepseek_tpu_torch.ops.kernels.prefill_attn import (
        mla_prefill_attn, mla_prefill_attn_plain)
    from deepseek_tpu_torch.ops.kernels.qmm import (
        qmm, qmm_experts, qmm_experts_plain, qmm_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 61)
    params, cfg = mesh_model("v3")
    emit = make_emit(entries, "data=2 v3 serving")
    emit_spec = make_emit(entries, "data=2 v3 serving ngram")
    csrc, qpy = "deepseek_tpu_torch/csrc/", "deepseek_tpu/ops/pallas/qmm.py:"
    dense, moe = params.layers[0], params.layers[cfg.n_layers - 1]
    H, R, P, S = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.kv_window
    for label, qt in (("wkvq", dense.wkvq), ("wcr", dense.wcr), ("wo", dense.wo),
                      ("w13 (dense)", dense.w13), ("lm_head", params.lm_head)):
        d, n = qt.shape
        x = torch.randn((2, n), generator=gen, device="cuda")
        emit(f"K5 qmm Q3_K packed {label} (a data=2 rank's rows) 2x{d}x{n}",
             lambda: qmm(qt, x), lambda: qmm_plain(qt, x), 1e-4,
             nbytes(x) + qt.nbytes_active + 4 * 2 * d, 2.0 * 2 * d * n,
             csrc + "packed_mv.cu", qpy + "312 (qmm, _q3k_body :368)", "K5-packed")
    E, k = cfg.n_routed_experts, cfg.n_active_routed
    ids = torch.stack([torch.randperm(E, generator=gen, device="cuda")[:k]
                       for _ in range(2)]).reshape(-1).sort().values
    u = int(ids.unique().numel())
    for label, qt in (("w13 (MoE)", moe.w13), ("w2 (MoE)", moe.w2)):
        n_tab, d, n = qt.shape
        x = torch.randn((ids.numel(), n), generator=gen, device="cuda")
        emit(f"K2 qmm_experts Q3_K packed {label} (a data=2 rank's 2 tokens: "
             f"{ids.numel()} pairs over {u} experts) {d}x{n}",
             lambda: qmm_experts(qt, ids, x), lambda: qmm_experts_plain(qt, ids, x), 1e-4,
             nbytes(x) + qt.nbytes_active / n_tab * u + 4 * d * ids.numel(),
             2.0 * ids.numel() * d * n, csrc + "packed_mv.cu",
             qpy + "566 (qmm_experts, _q3k_body :368, pallas_call :710)", "K2-packed")
    del params, dense, moe
    torch.cuda.empty_cache()
    kv = [45, 424]                     # two slots' lengths (a short and a long prompt)
    qc = torch.randn((2, H, R), generator=gen, device="cuda")
    qr = torch.randn((2, H, P), generator=gen, device="cuda")
    ckv = torch.randn((2, S, R), generator=gen, device="cuda").to(torch.bfloat16)
    kr = torch.randn((2, S, P), generator=gen, device="cuda").to(torch.bfloat16)
    kl = torch.tensor(kv, device="cuda", dtype=torch.int32)
    scale = cfg.attn_softmax_scale()
    dmask = torch.arange(S, device="cuda")[None] < kl[:, None]
    q_s = torch.cat([qc, qr], -1)[:, :, None].to(torch.bfloat16)
    k_s = torch.cat([ckv, kr], -1)[:, None].expand(2, H, S, R + P)
    v_s = ckv[:, None].expand(2, H, S, R)
    emit(f"K3 mla_decode_attn bf16 cache (a data=2 rank's 2 rows, kv_len {kv}) S={S} H={H}",
         lambda: mla_decode_attn(qc, qr, ckv, kr, kl, scale),
         lambda: mla_decode_attn_plain(qc, qr, ckv, kr, kl, scale), 1e-4,
         sum(kv) * (R + P) * 2 + nbytes(qc, qr) + 4 * 2 * H * R,
         2.0 * H * sum(kv) * (2 * R + P), csrc + "prefill_attn.cu",
         "deepseek_tpu/ops/pallas/attention.py:170 (mla_decode_attn, pallas_call :221)",
         "K3", library=lambda: torch.nn.functional.scaled_dot_product_attention(
             q_s, k_s, v_s, attn_mask=dmask[:, None, None], scale=scale))
    T, starts = 5, [40, 419]
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    qc = torch.randn((2, T, H, R), generator=gen, device="cuda") * 0.3
    qr = torch.randn((2, T, H, P), generator=gen, device="cuda") * 0.3
    seen = sum(s + T for s in starts)
    vmask = (torch.arange(S, device="cuda")[None, None]
             <= st[:, None, None] + torch.arange(T, device="cuda")[None, :, None])
    q_v = torch.cat([qc, qr], -1).transpose(1, 2).to(torch.bfloat16).contiguous()
    e = emit_spec(f"K10 mla_prefill_attn per-row starts {starts} (a data=2 rank's 2 verify "
                  f"chunks of {T} rows) S={S} H={H}",
                  lambda: mla_prefill_attn(qc, qr, ckv, kr, st, 0, scale),
                  lambda: mla_prefill_attn_plain(qc, qr, ckv, kr, st, 0, scale), 1e-4,
                  seen * (R + P) * 2 + nbytes(qc, qr) + 4 * 2 * T * H * R,
                  2.0 * T * H * seen * (2 * R + P), csrc + "prefill_attn.cu",
                  "deepseek_tpu/models/deepseek.py:1024-1035 (verify mode; the JAX package "
                  "runs it in XLA, attention.py:213; K10: attention.py:644, pallas_call :707)",
                  "K10-rows", library=lambda: torch.nn.functional.scaled_dot_product_attention(
                      q_v, k_s, v_s, attn_mask=vmask[:, None], scale=scale))
    e["scalar_ms"] = time_ms(lambda: mla_prefill_attn(qc, qr, ckv, kr, max(starts), 0, scale))
    log(f"  {e['name']}: the scalar form at start {max(starts)} {e['scalar_ms']:.4f} ms")
    del ckv, kr, k_s, v_s, q_v
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: pipeline stages
# ---------------------------------------------------------------------------

PP_DECODE = 16             # teacher-forced decode steps after the prompt
PP_MICRO_PROMPT = 64       # the microbatched cell: 4 rows of this many tokens
PP_MICRO_STEPS = 8
PP_INT8_TOKENS = 40        # the 3-stage cell: past the tiny model's 32-slot window
PP_TOL = 1e-3              # of max|logit|, f32 compute


def pp_path(pp, prompt, forced):
    """A pipeline's prefill of ``prompt`` in chunks of 256 then the decode
    steps fed ``forced``: the logits rows ((steps + 1, V) f32 CPU) and the
    prefill and decode walls."""
    rows = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, len(prompt), 256):
        last = i + 256 >= len(prompt)
        lg = pp.prefill(torch.tensor([prompt[i:i + 256]], device="cuda"), i,
                        "last" if last else "none")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for s, t in enumerate(forced):
        rows.append(lg[0].float().cpu())
        lg = pp.decode_step(torch.tensor([[t]], device="cuda"), len(prompt) + s)
    rows.append(lg[0].float().cpu())
    torch.cuda.synchronize()
    return torch.stack(rows), (t1 - t0, time.perf_counter() - t1)


def pp_rank(rank, world, forced):
    """One rank of 2 stages x tensor=2: the V3 draw, the Pipeline (its
    stage's layers cut to its tensor slice, the whole draw freed), the
    prompt and the forced steps with the collectives (the stage's
    all-reduces, the hop and the logits' all-reduce) timed."""
    from deepseek_tpu_torch.parallel.pipeline import Pipeline

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    counts, clock = counters(), CollectiveClock()
    torch.cuda.reset_peak_memory_stats()
    params, cfg = mesh_model("v3")
    pp = Pipeline(cfg, params, n_stages=2, batch=1, mesh_shape={"tensor": 2})
    del params
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    prompt, _ = seq_inputs(cfg, "v3")
    st = pp.stages[pp.stage]
    clock.reset()
    reset(counts)
    rows, walls = pp_path(pp, prompt, forced)
    return dict(rows=rows, walls=walls, coll=(clock.seconds, clock.calls),
                launched=read(counts), peak=torch.cuda.max_memory_allocated(),
                resident=resident, stage=pp.stage,
                holds=dict(layers=(st.lo, st.hi), wo_cols=st.params.layers[0].wo.shape[-1]))


def pipeline_phase(counts, runs):
    """Pipeline stages at DeepSeek-V3's widths: the 4-layer packed Q3_K draw
    of the mesh phase (f32 compute, bf16 cache, no factor weights) runs its
    512-token prompt in 2 chunks and PP_DECODE greedy steps unsharded; a
    2-stage Pipeline in this process (both stages on the card) runs the
    same path fed the greedy tokens (logits within PP_TOL of max|logit|);
    at B = 4 (4 prompts of PP_MICRO_PROMPT tokens) decode_microbatched in 2
    microbatches against decode_step (the same logits; the walls logged,
    nothing claimed: one card, one stream); 2 stages x tensor=2 over 4 gloo
    ranks against the unsharded run (the same bits on every rank; each
    rank's walls, time in collectives, peak and resident memory); then 3
    stages over an int8 cache on a tiny 3-layer packed Q3_K checkpoint
    against its Engine, decoding past the window."""
    from deepseek_tpu_torch.engine import Engine
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.parallel.launch import launch
    from deepseek_tpu_torch.parallel.pipeline import Pipeline
    from deepseek_tpu_torch.parallel.spmd import NULL_CTX

    t_phase = time.perf_counter()
    failed = []
    params, cfg = mesh_model("v3")
    prompt, _ = seq_inputs(cfg, "v3")
    want, forced, _, walls1 = seq_path(params, cfg, prompt, None, NULL_CTX,
                                       init_cache(cfg, device="cuda"), counts,
                                       steps=PP_DECODE)
    scale = float(want.abs().max())

    def held(label, rows):
        err = float((rows - want).abs().max())
        ok = bool(torch.isfinite(rows).all()) and err <= PP_TOL * scale
        log(f"{label}: logits vs unsharded max abs err {err:.3e} ({err / scale:.2e} of "
            f"max|logit| {scale:.3f}; tolerance {PP_TOL:g}), equal bits: "
            f"{torch.equal(rows, want)}")
        if not ok:
            failed.append(f"{label}: logits disagree with the unsharded run")

    pp = Pipeline(cfg, params, n_stages=2, batch=1)
    (rows, walls), launched = drive(
        counts, ("K10", "K5r-packed", "K6-packed", "K3", "K5-packed", "K2-packed"),
        "pipeline 2 stages (one process)", lambda: pp_path(pp, prompt, forced))
    runs["pipeline 2 stages"] = launched
    held("pipeline 2 stages (one process)", rows)
    log(f"pipeline 2 stages (one process): prefill / decode wall {walls[0]:.3f} / "
        f"{walls[1]:.3f} s (unsharded {walls1[0]:.3f} / {walls1[1]:.3f})")
    del pp
    # microbatched decode at B = 4 against the straight-through step
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 67)
    rows4 = torch.randint(3, cfg.vocab_size, (4, PP_MICRO_PROMPT + PP_MICRO_STEPS),
                          generator=gen, device="cuda")
    out, wall = {}, {}
    for mode in ("decode_step", "decode_microbatched"):
        pp = Pipeline(cfg, params, n_stages=2, batch=4)
        pp.prefill(rows4[:, :PP_MICRO_PROMPT], 0, "none")
        lg, t = [], 0.0
        reset(counts)
        for s in range(PP_MICRO_STEPS):
            tok = rows4[:, PP_MICRO_PROMPT + s:PP_MICRO_PROMPT + s + 1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = (pp.decode_step(tok, PP_MICRO_PROMPT + s) if mode == "decode_step" else
                 pp.decode_microbatched(tok, PP_MICRO_PROMPT + s, n_micro=2))
            torch.cuda.synchronize()
            t += time.perf_counter() - t0
            lg.append(y.float().cpu())
        runs[f"pipeline {mode}"] = read(counts)
        out[mode], wall[mode] = torch.stack(lg), t / PP_MICRO_STEPS
        if mode == "decode_microbatched" and pp.stages[0].cache is not None:
            failed.append("pipeline: the microbatch caches did not persist")
        del pp
    err = float((out["decode_microbatched"] - out["decode_step"]).abs().max())
    sc4 = float(out["decode_step"].abs().max())
    log(f"pipeline B = 4, {PP_MICRO_STEPS} steps: decode_microbatched (2 microbatches) vs "
        f"decode_step max abs err {err:.3e} ({err / sc4:.2e} of max|logit|), equal bits "
        f"{torch.equal(out['decode_microbatched'], out['decode_step'])}; a step's wall "
        f"{wall['decode_step'] * 1e3:.3f} ms straight through, "
        f"{wall['decode_microbatched'] * 1e3:.3f} ms microbatched (one card, one stream: "
        f"nothing overlaps)")
    if not err <= PP_TOL * sc4:
        failed.append("pipeline: decode_microbatched disagrees with decode_step")
    del params
    torch.cuda.empty_cache()
    # 2 stages x tensor=2 over 4 gloo ranks
    t0 = time.perf_counter()
    ranks = launch(pp_rank, 4, forced, backend="gloo", timeout=SEQ_TIMEOUT, threads=None)
    log(f"pipeline 2 stages x tensor=2: 4 gloo ranks on one card in "
        f"{time.perf_counter() - t0:.1f} s (spawn and draws included)")
    for r, got in enumerate(ranks):
        label = f"pipeline 2 stages x tensor=2, rank {r} (stage {got['stage']}, {got['holds']})"
        held(label, got["rows"])
        wall = sum(got["walls"])
        log(f"{label}: prefill / decode wall {got['walls'][0]:.3f} / {got['walls'][1]:.3f} "
            f"s; collectives {got['coll'][1]} calls, {got['coll'][0]:.3f} s "
            f"({100 * got['coll'][0] / wall:.1f}% of the wall; the card synced around "
            f"each); peak device memory {got['peak'] / 2**30:.2f} GiB (the whole draw "
            f"before the cut), resident {got['resident'] / 2**30:.2f} GiB; launches "
            f"{ {k: v for k, v in got['launched'].items() if v} }")
        if r and not torch.equal(got["rows"], ranks[0]["rows"]):
            failed.append(f"pipeline 2 x tensor=2: rank {r}'s logits differ from rank 0's")
        stage_kernels = ("K10", "K5r-packed", "K3", "K5-packed") + (
            ("K6-packed", "K2-packed") if got["stage"] == 1 else ())
        missing = [k for k in stage_kernels if got["launched"][k] == 0]
        if missing:
            failed.append(f"pipeline 2 x tensor=2, rank {r}: never launched {missing}")
    runs["pipeline 2 stages x tensor=2"] = ranks[-1]["launched"]
    # 3 stages over an int8 cache on a tiny 3-layer checkpoint
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    ck = os.path.join(root, "chip_smoke_q3_k_3_layers")
    write_tiny_checkpoint(ck, np.random.default_rng(SEED + 71), n_layers=3)
    eng = Engine(ck, device="cuda", seed=SEED, kv_cache_dtype="int8")
    toks = [int(v) for v in np.random.default_rng(SEED + 73).integers(3, 512,
                                                                       PP_INT8_TOKENS)]
    cache = eng.new_cache()
    want8 = torch.stack([eng.step(cache, t, pos)[0].float() for pos, t in enumerate(toks)])
    pp = Pipeline(eng.cfg, eng.params, n_stages=3, batch=1)
    got8, launched = drive(
        counts, ("K3-int8", "K5-packed", "K2-packed"), "pipeline 3 stages int8",
        lambda: torch.stack([pp.decode_step(torch.tensor([[t]], device="cuda"), pos)[0].float()
                             for pos, t in enumerate(toks)]))
    runs["pipeline 3 stages int8"] = launched
    worst, scale8 = float((got8 - want8).abs().max()), float(want8.abs().max())
    log(f"pipeline 3 stages, int8 cache, tiny 3-layer packed Q3_K ({eng.cfg.kv_window}-slot "
        f"window, {PP_INT8_TOKENS} steps): stages {[(s.lo, s.hi) for s in pp.stages]}, "
        f"logits vs the Engine max abs err {worst:.3e} ({worst / scale8:.2e} of "
        f"max|logit|)")
    if not (bool(torch.isfinite(got8).all()) and worst <= PP_TOL * scale8):
        failed.append("pipeline 3 stages int8: logits disagree with the Engine's")
    del eng, pp, cache
    torch.cuda.empty_cache()
    log(f"pipeline phase: {time.perf_counter() - t_phase:.1f} s ({card_line()})")
    if failed:
        raise RuntimeError("pipeline: " + "; ".join(failed))


# ---------------------------------------------------------------------------
# phase 7: the CLI as a user runs it, and single-sequence speculation
# ---------------------------------------------------------------------------

CLI_TIMEOUT = 600          # seconds a CLI subprocess may take
CLI_NEW = 32               # tokens a CLI completion generates
CLI_PROMPT = ("The quick brown fox jumps over the lazy dog. The quick brown fox "
              "jumps over the lazy dog. The quick brown fox")
SPEC_K = 4                 # the CLI's default --spec-k
SPEC_CALLS = 2             # fused calls (4 rounds each) a V3-width maker runs
# an HF-convention chat template, as the converter embeds tokenizer_config.json's
CHAT_TEMPLATE = ("{{ bos_token }}{% for m in messages %}<|{{ m.role }}|>{{ m.content }}"
                 "{{ eos_token if m.role == 'assistant' }}\n{% endfor %}"
                 "{% if add_generation_prompt %}<|assistant|>{% endif %}")
CHAT_TURNS = ("hello", "and how are you?")


def v2_lite_cli_config(n_layers: int, **overrides):
    """DeepSeek-V2-Lite's published widths as the converter writes them by
    default (decompressed MHA: V2-Lite has no query LoRA, which absorbed MLA
    needs, convert.py:67) in F8E5M2 with 128x128 blocks (its FFN widths 1408
    and 10944 are no multiples of the 256-column K-quant superblock, so no
    Q2_K/Q3_K form of it exists); compute and cache dtypes are the CLI's
    defaults (float32, float16: they are not checkpoint metadata)."""
    from deepseek_tpu_torch.config import QuantKind
    from deepseek_tpu_torch.models.testing import deepseek_v2_lite_proportions
    return deepseek_v2_lite_proportions(
        n_layers=n_layers, weight_quant=QuantKind.F8E5M2, block_size=(128, 128),
        compute_dtype="float32", kv_cache_dtype="float16", **overrides)


def write_fp8_model(path: str, cfg, seed: int, device: str, draft_path=None) -> int:
    """A random F8E5M2 MHA checkpoint of ``cfg`` in the converter's tensor
    layout (``model.layers.{l}.attn.wq`` etc., each weight with its 128x128
    ``.scale`` grid, partial at ragged edges; every expert its own draw),
    values drawn on ``device`` from ``seed`` and written with the port's
    codec, with a byte-fallback tokenizer of the full vocabulary and a chat
    template. With ``draft_path`` a 1-layer draft is written there too: the
    same embedding, lm_head and layer 0. Returns the checkpoint's bytes."""
    from deepseek_tpu_torch.utils.codec import _DTYPE_TO_NP

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    b0, b1 = cfg.block_size
    f8 = _DTYPE_TO_NP["F8_E5M2"]

    def fp8(name, *shape):
        *lead, rows, cols = shape
        data = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) \
            .to(torch.float8_e5m2).view(torch.uint8)
        sc = torch.rand((*lead, -(-rows // b0), -(-cols // b1)), generator=gen,
                        device=device) * 0.015 + 0.005
        return {f"{name}.weight": data.cpu().numpy().view(f8),
                f"{name}.scale": sc.cpu().numpy()}

    def f32(*shape, scale=0.1, base=1.0):
        return (base + torch.randn(shape, generator=gen, device=device) * scale) \
            .cpu().numpy()

    c = cfg
    H, R, P, Dv = c.n_heads, c.kv_lora_rank, c.qk_rope_head_dim, c.v_head_dim
    E, m, ns = c.n_routed_experts, c.moe_intermediate_size, c.n_shared_experts
    t = {"model.norm.weight": f32(c.dim)}
    t.update(fp8("model.embed", c.vocab_size, c.dim))
    t.update(fp8("model.output", c.vocab_size, c.dim))
    for l in range(c.n_layers):
        p = f"model.layers.{l}"
        t.update({f"{p}.attn.norm.weight": f32(c.dim), f"{p}.mlp.norm.weight": f32(c.dim),
                  f"{p}.attn.kv_a_norm.weight": f32(R)})
        t.update(fp8(f"{p}.attn.wq", H * c.head_dim, c.dim))
        t.update(fp8(f"{p}.attn.wkv_a", R + P, c.dim))
        t.update(fp8(f"{p}.attn.wkv_b", H * (c.qk_nope_head_dim + Dv), R))
        t.update(fp8(f"{p}.attn.wo", c.dim, H * Dv))
        if c.is_moe_layer(l):
            t[f"{p}.moegate.weight"] = f32(E, c.dim, scale=0.05, base=0.0)
            for k, shape in (("mlp.w1", (E, m, c.dim)), ("mlp.w3", (E, m, c.dim)),
                             ("mlp.w2", (E, c.dim, m)), ("shared_mlp.w1", (ns * m, c.dim)),
                             ("shared_mlp.w3", (ns * m, c.dim)),
                             ("shared_mlp.w2", (c.dim, ns * m))):
                t.update(fp8(f"{p}.{k}", *shape))
        else:
            for k, shape in (("w1", (c.hidden_dim, c.dim)), ("w3", (c.hidden_dim, c.dim)),
                             ("w2", (c.dim, c.hidden_dim))):
                t.update(fp8(f"{p}.mlp.{k}", *shape))
    save_tiny(path, c, t, metadata=dict(chat_template=CHAT_TEMPLATE,
                                        chat_bos_token="<s>", chat_eos_token="</s>"))
    if draft_path is not None:
        keep = {k: v for k, v in t.items()
                if not k.startswith("model.layers.") or k.startswith("model.layers.0.")}
        keep.pop("tokenizer.tokens")
        save_tiny(draft_path, dataclasses.replace(c, n_layers=1), keep)
    return sum(v.nbytes for v in t.values())


def run_cli(args, label, stdin=None, device="cuda"):
    """``python -m deepseek_tpu_torch`` as a user runs it, from the root of
    the checkout; a non-zero exit fails the run. Returns its stdout."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    if device != "cuda":
        args = [*args, "--device", device]
    res = subprocess.run([sys.executable, "-m", "deepseek_tpu_torch", *args], cwd=root,
                         env=env, input=stdin, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"CLI {label} exited {res.returncode}: "
                           f"{res.stderr[-3000:]}\n{res.stdout[-2000:]}")
    lines = [ln for ln in res.stdout.splitlines()
             if re.search(r"speculative:|throughput:|perplexity:|tokens$|prompt:|passkey:",
                          ln)]
    log(f"CLI {label}: rc 0 in {dt:.1f} s; " + " | ".join(ln.strip() for ln in lines))
    return res.stdout


def cli_texts(out):
    """The generated texts of a CLI run's completions."""
    return re.findall(r"Model bits per weight: [^\n]*\n(.*?)\nGeneration stats:", out,
                      re.S)


def texts_of(eng, prompt, run):
    """``run(on_token)`` -> tokens; returns (tokens, the text the CLI prints
    for them: each piece decoded on its own)."""
    pieces = []
    out, _ = run(lambda tok, piece: pieces.append(piece.decode("utf-8", errors="replace")))
    return out, "".join(pieces)


def same_or_near_tie(ref_logits, want, got, label, rel=1e-3):
    """Greedy tokens of another route (speculation, another process) against
    the plain route's: equal, or first apart at a near tie (the two tokens'
    logits within ``rel`` of the logit scale in the plain route's
    teacher-forced logits ``ref_logits[i]``, row i choosing token i), which
    two summation orders may break either way. Returns how many tokens
    agree."""
    n = min(len(want), len(got))
    for i in range(n):
        if want[i] != got[i]:
            lg = ref_logits[i]
            tol = rel * float(np.abs(lg).max())
            gap = float(lg[want[i]] - lg[got[i]])
            if gap > tol:
                raise RuntimeError(f"{label}: token {i} is {got[i]}, plain greedy says "
                                   f"{want[i]} (logit gap {gap:.3e} > {tol:.3e})")
            log(f"{label}: apart from plain greedy at token {i}, a near tie "
                f"(gap {gap:.3e} <= {tol:.3e}); the {i} before agree")
            return i
    return n


def teacher_logits(eng, prompt, tokens, donor=None, reused=0):
    """The engine's logits choosing each of ``tokens`` after ``prompt`` on
    generate's schedule (prefill, then decode steps). With ``donor`` the
    prompt is hydrated as the serving scheduler admits it after a prefix
    hit of ``reused`` tokens: the donor's prompt first (its admission wrote
    the rows that the prefix cache keeps), then the prompt from ``reused``
    on."""
    cache = eng.new_cache()
    if donor is not None:
        eng.hydrate(cache, donor)
        _, logits, _, pos = eng.hydrate(cache, prompt[reused:], reused)
    else:
        _, logits, _, pos = eng.hydrate(cache, prompt)
    rows = [logits]
    for t in tokens[:-1]:
        rows.append(eng.step(cache, t, pos)[0].float().cpu().numpy())
        pos += 1
    return rows


def cli_phase(counts, runs, device="cuda", cfg=None):
    """The port's CLI at DeepSeek-V2-Lite's widths (``v2_lite_cli_config``,
    cut to 2 layers: one dense, one MoE), as subprocesses on the card:
    completion at -t 0, -t 0.8 and with --kv-dtype int8, perplexity over the
    wikitext fixture (-w), passkey (-n 64 -l 10: ~5.9k tokens, past the
    4096-slot window), interactive and chat (two turns) from stdin,
    --ngram-spec and --draft (a 1-layer draft of the same widths). The
    greedy texts must equal the same routes' in process
    (Engine(device="cuda").generate; the chat turns rendered by
    Engine.render_chat), the speculative ones plain greedy's, the
    perplexity the in-process Engine.perplexity's within 1e-3 relative; the
    in-process runs count the launches. -m chat renders through jinja2:
    where it does not import, chat is logged as not driven
    (tests/test_torch_cli.py holds it on the CPU against the JAX CLI).
    ``device`` and ``cfg`` rehearse the phase on the CPU at a small size."""
    from deepseek_tpu_torch.engine import Engine

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    ck, dr = os.path.join(root, "v2lite_fp8"), os.path.join(root, "draft")
    cfg = cfg or v2_lite_cli_config(n_layers=2)
    cli = lambda args, label, stdin=None: run_cli(args, label, stdin, device)
    t0 = time.perf_counter()
    size = write_fp8_model(ck, cfg, SEED + 41, device, draft_path=dr)
    log(f"CLI: random F8E5M2 DeepSeek-V2-Lite-width checkpoint (MHA, 2 layers, vocab "
        f"{cfg.vocab_size}), {size / 1e9:.3f} GB, and its 1-layer draft written in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        import jinja2  # noqa: F401  (-m chat renders its template through it)
        chat = cli([ck, "-m", "chat", "-n", "8", "-t", "0"], "chat",
                   stdin="\n".join(CHAT_TURNS) + "\n\n")
    except ImportError:
        chat = None
        log("CLI: -m chat not driven: jinja2 does not import here; "
            "tests/test_torch_cli.py holds it on the CPU")
    base = [ck, "-i", CLI_PROMPT, "-n", str(CLI_NEW)]
    plain = cli([*base, "-t", "0"], "completion -t 0")
    cli([*base, "-t", "0.8", "--seed", "7"], "completion -t 0.8")
    cli([*base, "-t", "0", "--kv-dtype", "int8"], "completion --kv-dtype int8")
    ngram = cli([*base, "-t", "0", "--ngram-spec"], "completion --ngram-spec")
    draft = cli([*base, "-t", "0", "--draft", dr], "completion --draft")
    ppl_out = cli([ck, "-m", "perplexity", "-w"], "perplexity -w")
    cli([ck, "-m", "passkey", "-n", "64", "-l", "10", "--seed", "3"], "passkey")
    inter = cli([ck, "-m", "interactive", "--seed", "5"], "interactive",
                    stdin=f'c -i "{CLI_PROMPT}" -n 8 -t 0\np -i "{CLI_PROMPT}"\n'
                          'k -n 8 -l 2\nh\nq\n')

    eng = Engine(ck, device=device, seed=SEED)
    deng = Engine(dr, device=device, seed=SEED)
    prompt = eng.tokenizer.encode(CLI_PROMPT, bos=True)
    (want, text), runs["CLI plain"] = drive(
        counts, ("K5", "K5r", "K2-fp8", "K6-fp8", "K8", "K9"), "CLI in process, generate",
        lambda: texts_of(eng, prompt, lambda cb: eng.generate(
            prompt, CLI_NEW, temperature=0.0, on_token=cb)))
    if cli_texts(plain) != [text]:
        raise RuntimeError(f"CLI greedy text {cli_texts(plain)!r} is not the in-process "
                           f"generate's {text!r}")
    ref = teacher_logits(eng, prompt, want)
    for label, out, route, expect in (
            ("--ngram-spec", ngram, lambda cb: eng.generate_ngram(
                prompt, CLI_NEW, temperature=0.0, spec_k=SPEC_K, on_token=cb),
             ("K5r", "K2-fp8", "K9")),
            ("--draft", draft, lambda cb: eng.generate_speculative(
                prompt, deng, CLI_NEW, temperature=0.0, spec_k=SPEC_K, on_token=cb),
             ("K5", "K5r", "K2-fp8", "K8", "K9"))):
        (got, gtext), runs[f"CLI {label}"] = drive(
            counts, expect, f"CLI in process, {label}",
            lambda route=route: texts_of(eng, prompt, route))
        if cli_texts(out) != [gtext]:
            raise RuntimeError(f"CLI {label} text {cli_texts(out)!r} is not the "
                               f"in-process run's {gtext!r}")
        same_or_near_tie(ref, want, got, f"CLI {label}")
    t1 = time.perf_counter()
    serve_cli_phase(counts, runs, ck, eng, prompt, want, ref, device)
    log(f"CLI -m serve phase: {time.perf_counter() - t1:.1f} s")
    ppl, err, n = eng.perplexity(
        np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "deepseek_tpu_torch", "fixtures", "wikitext_v2.npy")
                ).tolist()[:cfg.max_seq_len])
    (got_ppl, got_err), = [(float(a), float(b)) for a, b in re.findall(
        r"perplexity: ([0-9.e+-]+) ± ([0-9.e+-]+)", ppl_out)]
    log(f"CLI perplexity -w: {got_ppl} ± {got_err} over {n + 1} tokens; in process "
        f"{ppl} ± {err}")
    if not abs(got_ppl - ppl) <= 1e-3 * ppl:
        raise RuntimeError("CLI perplexity disagrees with Engine.perplexity")
    if len(cli_texts(inter)) != 1 or "perplexity:" not in inter or "Passkey test" not in inter:
        raise RuntimeError("CLI interactive: a mode did not run")
    if chat is not None:
        # the CLI's turns: the conversation rendered, generated to 8 tokens
        # (eos not printed), the reply appended as the assistant's message
        msgs, want = [], ""
        for line in CHAT_TURNS:
            msgs.append({"role": "user", "content": line})
            toks = eng.tokenizer.encode(eng.render_chat(msgs), bos=False)
            pieces = []
            eng.generate(toks, 8, temperature=0.0, on_token=lambda t, p: None
                         if eng.tokenizer.is_eos_or_eot(t) else pieces.append(p))
            want += "user> " + "".join(p.decode("utf-8", errors="replace")
                                       for p in pieces) + "\n"
            msgs.append({"role": "assistant",
                         "content": b"".join(pieces).decode("utf-8", errors="replace")})
        if want not in chat:
            raise RuntimeError(f"CLI chat printed {chat[-600:]!r}, in process {want!r}")
        log(f"CLI chat: {len(CHAT_TURNS)} turns, the in-process turns' text")
    del eng, deng
    if device == "cuda":
        torch.cuda.empty_cache()


def mtp_cli_phase(counts, runs, device="cuda"):
    """Single-sequence MTP speculation at a small size: a tiny random
    DeepSeek-V3-arch packed Q3_K checkpoint (absorbed MLA, R = 512) with an
    MTP layer, through ``python -m deepseek_tpu_torch --mtp-spec`` on the
    card (the packed runtime, the CLI's default), whose text must equal the
    same route in process; that route's greedy tokens are held against
    Engine(device="cpu").generate (near ties allowed as check_greedy
    allows them)."""
    from deepseek_tpu_torch.engine import Engine

    rng = np.random.default_rng(SEED + 43)
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_mtp")
    shutil.rmtree(tmp, ignore_errors=True)
    write_tiny_checkpoint(tmp, rng, max_seq_len=256, window=128, mtp=True)
    out = run_cli([tmp, "-i", "hello world", "-n", "40", "-t", "0", "--mtp-spec"],
                  "completion --mtp-spec (tiny V3 Q3_K)", device=device)
    eng = Engine(tmp, device=device, seed=SEED)
    ref = Engine(tmp, device="cpu", seed=SEED)
    if eng.params.mtp is None:
        raise RuntimeError("the MTP layer did not load")
    prompt = eng.tokenizer.encode("hello world", bos=True)
    (got, text), runs["MTP CLI"] = drive(
        counts, ("K5-packed", "K5r-packed", "K2-packed", "K3", "K10"),
        "MTP in process, generate_mtp",
        lambda: texts_of(eng, prompt, lambda cb: eng.generate_mtp(
            prompt, 40, temperature=0.0, spec_k=SPEC_K, on_token=cb)))
    if cli_texts(out) != [text]:
        raise RuntimeError(f"CLI --mtp-spec text {cli_texts(out)!r} is not the "
                           f"in-process run's {text!r}")
    want, _ = ref.generate(prompt, 40, temperature=0.0)
    check_greedy(ref, prompt, got, "MTP CLI vs CPU")
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), len(got))
    log(f"MTP CLI: {len(got)} tokens, each the CPU Engine's greedy choice after the "
        f"same tokens; the first {n} equal its plain greedy run's")


def emitted(drafts_r, nacc_r, next_r):
    """The tokens a fused call emits: per round drafts[:n_acc], then next."""
    toks = []
    for d, na, nx in zip(drafts_r.tolist(), nacc_r.tolist(), next_r.tolist()):
        toks += d[:na] + [nx]
    return toks


def spec_rounds_phase(params, cfg, counts, runs, label="V3 packed Q3_K"):
    """The three speculation makers at DeepSeek-V3's widths on the 4-layer
    packed Q3_K draw with a random MTP layer (float32 compute, so that the
    verify chunk's and decode's sums agree to near ties; without the factor
    weights, so prefill runs K10): the draft model is the same draw's first
    layer. Each maker runs SPEC_CALLS fused calls of 4 rounds greedily from
    a 64-token prompt of a 16-token pattern; the emitted tokens must equal
    plain greedy decode. The target drafting for itself must have every
    draft accepted. One call of each is driven with the launch counts
    (K5 row-tiled for the 5-row verify chunk, K2, K3, K10), and each call
    timed beside plain decode steps."""
    from deepseek_tpu_torch.engine import hydrate_cache
    from deepseek_tpu_torch.models.deepseek import forward_decode, forward_prefill
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.models.mtp import init_mtp_cache, mtp_forward
    from deepseek_tpu_torch.ops import prng
    from deepseek_tpu_torch.speculative import (
        make_mtp_spec_rounds, make_ngram_spec_rounds, make_spec_rounds)

    dev = params.final_norm.device
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    strip = lambda lp: dataclasses.replace(lp, wq_b=None, wkv_b=None)
    params = dataclasses.replace(
        params, layers=[strip(lp) for lp in params.layers],
        mtp=dataclasses.replace(params.mtp, block=strip(params.mtp.block)))
    draft = dataclasses.replace(params, layers=params.layers[:1], mtp=None)
    cfg_d = dataclasses.replace(cfg, n_layers=1)
    rng = np.random.default_rng(SEED + 47)
    prompt = [int(v) for v in rng.integers(3, cfg.vocab_size, 16)] * 4
    n_plain = SPEC_CALLS * 4 * (SPEC_K + 1) + 1
    tok = lambda t: torch.full((1, 1), int(t), dtype=torch.int64, device=dev)

    with torch.inference_mode():
        cache = init_cache(cfg, device=dev)
        _, logits, _, pos = hydrate_cache(params, cfg, cache, prompt)
        plain, ref = [int(logits.argmax())], [logits]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_plain - 1):
            lg = forward_decode(params, cache, tok(plain[-1]), pos + i, cfg)[0]
            ref.append(lg.float().cpu().numpy())
            plain.append(int(ref[-1].argmax()))
        plain_s = (time.perf_counter() - t0) / (n_plain - 1)
    log(f"{label} speculation: plain greedy decode {plain_s * 1e3:.2f} ms a token "
        f"({1 / plain_s:.2f} tok/s, float32 compute), {n_plain} tokens")

    def run(name, setup, call, expect):
        state = setup()
        got, times, acc = [plain[0]], [], 0
        key = prng.PRNGKey(SEED)
        for c in range(SPEC_CALLS):
            key, sub = prng.split(key)
            if c == 0:
                res, runs[f"{label} {name} rounds"] = drive(
                    counts, expect, f"{label} {name}: one call of 4 rounds",
                    lambda: call(state, got, sub))
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = call(state, got, sub)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            drafts_r, nacc_r, next_r = res
            acc += int(nacc_r.sum())
            got += emitted(drafts_r, nacc_r, next_r)
        n = same_or_near_tie(ref, plain, got, f"{label} {name}")
        rounds = 4 * SPEC_CALLS
        log(f"{label} {name}: {len(got) - 1} tokens in {rounds} rounds, acceptance "
            f"{acc}/{rounds * SPEC_K} = {acc / (rounds * SPEC_K):.3f}, {n} equal to plain "
            f"greedy; the timed call {times[-1] * 1e3:.1f} ms "
            f"({times[-1] * 1e3 / 4:.1f} ms a round, "
            f"{(len(got) - 1) / SPEC_CALLS / times[-1]:.2f} tok/s on average over its "
            f"tokens; plain decode {1 / plain_s:.2f} tok/s)")
        return acc

    def hydrated():
        with torch.inference_mode():
            c = init_cache(cfg, device=dev)
            _, _, _, p = hydrate_cache(params, cfg, c, prompt, want_last_logits=False)
        return {"cache": c, "pos": p}

    def draft_setup(dp, dcfg):
        st = hydrated()
        st.update(dp=dp, dcache=init_cache(dcfg, device=dev),
                  fn=make_spec_rounds(cfg, dcfg, SPEC_K, 4, greedy=True))
        hydrate_cache(dp, dcfg, st["dcache"], prompt, want_last_logits=False)
        return st

    def draft_call(st, got, key):
        d, na, nx, st["cache"], st["dcache"] = st["fn"](
            params, st["dp"], st["cache"], st["dcache"], tok(got[-1]),
            st["pos"] + len(got) - 1, key, 0.0, 1.0)
        return d, na, nx

    def ngram_setup():
        st = hydrated()
        H = cfg.kv_window
        hist = torch.zeros((1, H), dtype=torch.int64, device=dev)
        seq = prompt + [plain[0]]
        hist[0, :len(seq)] = torch.tensor(seq, device=dev)
        st.update(hist=hist, hlen=len(seq),
                  fn=make_ngram_spec_rounds(cfg, SPEC_K, 4, hist_len=H, greedy=True))
        return st

    def ngram_call(st, got, key):
        d, na, nx, _, st["cache"], st["hist"], st["hlen"] = st["fn"](
            params, st["cache"], st["hist"], st["hlen"], tok(got[-1]),
            st["pos"] + len(got) - 1, key, 0.0, 1.0)
        return d, na, nx

    def mtp_setup():
        with torch.inference_mode():
            c = init_cache(cfg, device=dev)
            _, h = forward_prefill(params, c, torch.tensor([prompt], device=dev), 0, cfg,
                                   "none", with_hidden=True)
            cm = init_mtp_cache(cfg, device=dev)
            pairs = torch.tensor([prompt[1:] + [plain[0]]], device=dev)
            mtp_forward(params, cm, pairs, h.float(), 0, cfg, prefill=True)
        return {"cache": c, "pos": len(prompt), "cm": cm, "h": h[:, -1:].float(),
                "fn": make_mtp_spec_rounds(cfg, SPEC_K, 4, greedy=True)}

    def mtp_call(st, got, key):
        d, na, nx, st["h"], st["cache"], st["cm"] = st["fn"](
            params, st["cache"], st["cm"], tok(got[-1]), st["h"],
            st["pos"] + len(got) - 1, key, 0.0, 1.0)
        return d, na, nx

    run("draft model (1 layer)", lambda: draft_setup(draft, cfg_d), draft_call,
        ("K5-packed", "K5r-packed", "K2-packed", "K3", "K10"))
    # the target as its own draft: every draft is accepted, so the rounds
    # emit drafts as well as the bonus tokens
    acc = run("draft model (the target itself)", lambda: draft_setup(params, cfg),
              draft_call, ("K5-packed", "K5r-packed", "K2-packed", "K3", "K10"))
    if acc < SPEC_CALLS * 4 * SPEC_K:
        raise RuntimeError(f"{label}: the target drafting for itself had {acc} of "
                           f"{SPEC_CALLS * 4 * SPEC_K} drafts accepted")
    run("n-gram", ngram_setup, ngram_call, ("K5r-packed", "K2-packed", "K10"))
    run("MTP", mtp_setup, mtp_call, ("K5-packed", "K5r-packed", "K2-packed", "K3", "K10"))


# ---------------------------------------------------------------------------
# batched decode and continuous-batching serving
# ---------------------------------------------------------------------------

SERVE_NEW = 24             # tokens each V3 serving request generates
SERVE_LENS = (20, 140, 300, 600, 64, 400, 210, 520)   # prompt lengths
SERVE_SHARED = 128         # the prefix two requests share
SERVE_TOL = 1e-3           # logprobs against the teacher-forced log-softmax


def params_engine(params, cfg, seed=SEED):
    """An Engine over in-memory params (a random draw has no .dseek):
    Engine.from_params with a byte-fallback tokenizer of the config's
    vocabulary (save_tiny's)."""
    from deepseek_tpu_torch.engine import Engine
    from deepseek_tpu_torch.tokenizer import Tokenizer

    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{i:02X}>".encode() for i in range(256)]
    vocab += [f"tok{i}".encode() for i in range(len(vocab), cfg.vocab_size)]
    return Engine.from_params(params, cfg, Tokenizer(vocab, bos_id=1, eos_id=2), seed=seed,
                              prefill_chunk=256, decode_block=32)


def joined_text(eng, prompt, toks) -> bytes:
    """The bytes of ``toks`` after ``prompt``, as the scheduler joins them."""
    out, prev = b"", prompt[-1]
    for t in toks:
        out += eng.tokenizer.decode_one(prev, t)
        prev = t
    return out


def logprobs_of(rows, toks):
    """The log-softmax of each of ``toks`` in its logits row (float64)."""
    out = []
    for lg, t in zip(rows, toks):
        z = np.asarray(lg, np.float64)
        m = z.max()
        out.append(float(z[t] - m - np.log(np.exp(z - m).sum())))
    return np.asarray(out)


def serving_requests(eng, rng):
    """SERVE_LENS prompts (admissions of up to 3 prefill chunks); requests 1
    and 5 share a SERVE_SHARED-token prefix; requests 0, 2, 4 and 6 repeat a
    16-token pattern (prompt lookup has something to find). Requests 2 and
    6 sample at 0.8, request 3 at 0.8 with top_k 1 (greedy), the rest are
    greedy; request 7 has a stop string (set by the caller)."""
    from deepseek_tpu_torch.serving import Request

    V = eng.cfg.vocab_size
    shared = [int(v) for v in rng.integers(3, V, SERVE_SHARED)]
    prompts = []
    for i, n in enumerate(SERVE_LENS):
        if i in (1, 5):
            p = shared + [int(v) for v in rng.integers(3, V, n - SERVE_SHARED)]
        elif i % 2 == 0:
            p = ([int(v) for v in rng.integers(3, V, 16)] * (n // 16 + 1))[:n]
        else:
            p = [int(v) for v in rng.integers(3, V, n)]
        prompts.append(p)
    temps = [0.8 if i in (2, 3, 6) else 0.0 for i in range(len(prompts))]
    reqs = []
    for i, (p, t) in enumerate(zip(prompts, temps)):
        reqs.append(Request(prompt_tokens=p, max_new_tokens=SERVE_NEW, temperature=t,
                            top_p=0.95, top_k=1 if i == 3 else 0, logprobs=True))
    return reqs


def fresh(reqs):
    """The same requests, unserved."""
    import copy
    out = []
    for r in reqs:
        c = copy.copy(r)
        c.out_tokens, c.out_logprobs, c.out_bytes = [], [], b""
        c.done = c.stop_hit = False
        c._held = b""
        out.append(c)
    return out


def serve_all(eng, reqs, **kw):
    """A BatchScheduler over ``reqs``: (scheduler, finished requests in
    submission order, wall seconds)."""
    from deepseek_tpu_torch.serving import BatchScheduler

    sched = BatchScheduler(eng, **kw)
    for r in reqs:
        sched.submit(r)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = sched.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return sched, done, time.perf_counter() - t0


def profile_block(sched, label):
    """(wall ms, device-busy ms, idle share) of one decode step of the
    scheduler's batch: a warm-up block, then a timed block and a profiled
    one of the same positions and slots; device busy is the sum of the
    profiler's CUDA kernel times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepseek_tpu_torch.ops import prng

    B, blk = sched.batch, sched.block
    live = np.array([r is not None for r in sched.slots])
    if not live.any():
        live[:] = True
    temps = np.zeros(B, np.float32)
    ones = np.ones(B, np.float32)
    zeros = np.zeros(B, np.float32)
    loop = sched._loop_for(blk)
    tok = torch.from_numpy(sched.cur.reshape(-1, 1).copy()).to("cuda")
    pos = sched.pos.copy()

    def run():
        with torch.inference_mode():
            loop(sched.params, sched.cache, tok, pos, prng.PRNGKey(SEED), temps, ones,
                 live, zeros, zeros)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / blk
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total", 0.0) or 0.0
               for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA) / 1e3 / blk
    idle = max(0.0, 1 - busy / wall)
    log(f"{label}: a decode step of the batch of {B} ({int(live.sum())} live): wall "
        f"{wall:.3f} ms, device busy {busy:.3f} ms, idle share {idle:.3f}")
    return wall, busy, idle


def sync_debug_serving_block(sched, label):
    """One decode block of the scheduler's loop with per-slot sampling
    arrays (greedy, sampled, top-k and min-p rows) and an active mask with a
    dead row, under torch.cuda.set_sync_debug_mode("error")."""
    from deepseek_tpu_torch.ops import prng

    B = sched.batch
    loop = sched._loop_for()
    rows = (np.array([0.0, 0.8, 0.8, 1.0][:B], np.float32),
            np.array([0.95, 0.9, 1.0, 0.95][:B], np.float32),
            np.array([0.0, 0.0, 20.0, 0.0][:B], np.float32),
            np.array([0.0, 0.0, 0.0, 0.05][:B], np.float32))
    active = np.array([True, True, False, True][:B])
    tok = torch.full((B, 1), 5, dtype=torch.int64, device="cuda")
    pos = np.array([3, 40, 0, 17][:B])
    with torch.inference_mode():
        loop(sched.params, sched.cache, tok, pos, prng.PRNGKey(SEED), *rows[:2], active,
             *rows[2:])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = loop(sched.params, sched.cache, tok, pos, prng.PRNGKey(SEED + 1),
                       *rows[:2], active, *rows[2:])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    toks, logits = out[0], out[1]
    if toks.shape != (B, sched.block) or not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{label}: the serving block under sync debug mode: bad output")
    log(f"{label}: a {sched.block}-step serving block (per-slot sampling arrays, an "
        f"active mask with a dead row, logprobs) ran under set_sync_debug_mode('error')")


def serving_phase(params, cfg, counts, runs, label="V3 packed Q3_K"):
    """Continuous batching at DeepSeek-V3's widths: the 4-layer packed Q3_K
    draw with its MTP layer, without the factor weights (a random draw's
    wq_b/wkv_b are not the factors of its absorbed weights, so a hybrid
    prefill and a decode step would compute other functions, and MTP
    serving's seed step rewrites the last prompt row in decode mode), so
    admission chunks and verify chunks run K10 (the latter with per-row
    starts); f32 compute,
    through an Engine over the in-memory params (``params_engine``). Eight
    requests (``serving_requests``) through BatchScheduler(batch_size=4,
    logprobs=True, prefix_cache_mb=64): every greedy request's tokens are
    the same prompt's run alone (Engine.generate) or first apart at a near
    tie; the stop request's text is the alone run's cut before its stop
    string; every request's log-probabilities are the log-softmax of its
    single-sequence teacher-forced logits (``teacher_logits``: Engine.step,
    a batch of 1; request 5 on the schedule of its prefix hit) within
    SERVE_TOL: the decode step is batch-invariant, so the row served in a
    batch of 4 computes the bits of the sequence decoded alone
    (scripts/torch_batch_invariance.py holds it op by op); the
    prefix-sharing request hits the prefix cache. Then spec="ngram" and
    spec="mtp" serving of the same
    requests: greedy slots equal plain serving's (near ties allowed). The
    aggregate tok/s at batch 1 and 4, a decode step's wall and device-busy
    time at B = 1 and 4, and a serving block under sync debug mode.
    Returns (the batch-4 scheduler, its Engine) for the kernel entries."""
    from deepseek_tpu_torch.serving import BatchScheduler

    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    strip = lambda lp: dataclasses.replace(lp, wq_b=None, wkv_b=None)
    params = dataclasses.replace(
        params, layers=[strip(lp) for lp in params.layers],
        mtp=dataclasses.replace(params.mtp, block=strip(params.mtp.block)))
    t0 = time.perf_counter()
    eng = params_engine(params, cfg)
    rng = np.random.default_rng(SEED + 53)
    reqs = serving_requests(eng, rng)
    greedy = [i for i, r in enumerate(reqs) if r.temperature == 0.0 or r.top_k == 1]
    # each greedy request alone (generate's schedule) and its teacher logits
    alone, ref = {}, {}
    for i in greedy:
        alone[i] = eng.generate(reqs[i].prompt_tokens, SERVE_NEW, temperature=0.0)[0]
        ref[i] = teacher_logits(eng, reqs[i].prompt_tokens, alone[i])
    text7 = joined_text(eng, reqs[7].prompt_tokens, alone[7])
    at = next((j for j in range(len(text7) // 3, len(text7) - 4)
               if all(32 < c < 127 for c in text7[j:j + 4])), None)
    stop = text7[at:at + 4].decode() if at is not None else None
    reqs[7].stop = [stop] if stop else None
    log(f"{label} serving: {len(reqs)} requests, prompts {list(SERVE_LENS)} tokens, "
        f"{SERVE_NEW} new each, greedy {greedy}, request 7's stop {stop!r}; the alone "
        f"runs and their teacher logits in {time.perf_counter() - t0:.1f} s")

    (sched, done, wall4), runs[f"{label} serving"] = drive(
        counts, ("K5-packed", "K5r-packed", "K2-packed", "K6-packed", "K3", "K10"),
        f"{label} serving, batch 4",
        lambda: serve_all(eng, fresh(reqs), batch_size=4, logprobs=True,
                          prefix_cache_mb=64))
    n_tok = sum(len(r.out_tokens) for r in done)
    log(f"{label} serving, batch 4: {n_tok} tokens in {wall4:.2f} s = "
        f"{n_tok / wall4:.2f} tok/s aggregate (admissions included); prefix cache "
        f"{sched.prefix_cache.stats}")
    for i in greedy:
        got = done[i].out_tokens
        n = same_or_near_tie(ref[i], alone[i], got, f"{label} serving request {i}")
        if i == 7 and stop:
            want = text7[:text7.find(stop.encode())]
            if n == len(got) and not (done[i].stop_hit and done[i].out_bytes == want):
                raise RuntimeError(f"{label} serving: the stop request's text "
                                   f"{done[i].out_bytes!r} is not {want!r}")
        elif n == len(got) and len(got) != len(alone[i]):
            raise RuntimeError(f"{label} serving request {i}: {len(got)} tokens, alone "
                               f"{len(alone[i])}")
    if sched.prefix_cache.stats["hits"] < 1:
        raise RuntimeError(f"{label} serving: the shared prefix never hit the prefix cache")
    # the logprobs against the single-sequence teacher, which admits request
    # 5 as the scheduler did: request 1's prompt, then its own from the
    # shared prefix on (the prefix cache restores request 1's rows)
    st = sched.prefix_cache.stats
    if (st["hits"], st["tokens_reused"]) != (1, SERVE_SHARED):
        raise RuntimeError(f"{label} serving: prefix cache {st}, the teacher expects "
                           f"one hit of {SERVE_SHARED} tokens (request 5)")
    worst, scale = 0.0, 0.0
    for r in done:
        i = r.request_id
        hit = dict(donor=reqs[1].prompt_tokens, reused=SERVE_SHARED) if i == 5 else {}
        rows = (ref[i] if i in ref and not hit and alone[i] == r.out_tokens
                else teacher_logits(eng, r.prompt_tokens, r.out_tokens, **hit))
        want = logprobs_of(rows, r.out_tokens)
        got = np.asarray(r.out_logprobs)
        err = float(np.abs(got - want).max())
        if not err <= SERVE_TOL:
            log(f"{label} serving request {i}: logprobs {r.out_logprobs}, teacher-forced "
                f"{want.tolist()}")
        worst = max(worst, err)
        scale = max(scale, max(float(np.abs(lg).max()) for lg in rows))
    log(f"{label} serving: logprobs against the single-sequence teacher-forced "
        f"log-softmax: max abs err {worst:.3e} (tolerance {SERVE_TOL}; logit scale "
        f"{scale:.1f})")
    if not worst <= SERVE_TOL:
        raise RuntimeError(f"{label} serving: logprobs disagree with the teacher-forced "
                           "log-softmax")

    _, done1, wall1 = serve_all(eng, fresh(reqs), batch_size=1, logprobs=True,
                                prefix_cache_mb=64)
    n1 = sum(len(r.out_tokens) for r in done1)
    log(f"{label} serving, batch 1: {n1} tokens in {wall1:.2f} s = {n1 / wall1:.2f} tok/s "
        f"aggregate; batch 4: {n_tok / wall4:.2f} tok/s ({card_line()})")
    for i in greedy:
        same_or_near_tie(ref[i], alone[i], done1[i].out_tokens,
                         f"{label} serving batch 1, request {i}")
    for spec in ("ngram", "mtp"):
        (ssched, sdone, swall), runs[f"{label} serving {spec}"] = drive(
            counts, ("K10", "K10-rows", "K5r-packed", "K2-packed"),
            f"{label} serving, spec={spec}",
            lambda: serve_all(eng, fresh(reqs), batch_size=4, logprobs=True,
                              prefix_cache_mb=64, spec=spec))
        ns = sum(len(r.out_tokens) for r in sdone)
        st = ssched.spec_stats
        log(f"{label} serving, spec={spec}: {ns} tokens in {swall:.2f} s = "
            f"{ns / swall:.2f} tok/s aggregate, {st}, acceptance "
            f"{st['accepted'] / max(1, st['drafted']):.3f}")
        for i in greedy:
            same_or_near_tie(ref[i], alone[i], sdone[i].out_tokens,
                             f"{label} serving spec={spec}, request {i}")

    step = {}
    for B in (1, 4):
        s = BatchScheduler(eng, batch_size=B, logprobs=True)
        for r in fresh(reqs)[:B]:
            r.max_new_tokens, r.stop = 1 << 20, None    # every slot stays live
            s.submit(r)
        while s.queue or s.pending is not None:   # the admissions
            s.step()
        step[B] = profile_block(s, f"{label} serving")
        del s
    log(f"{label} serving: decode step wall / device busy / idle share, B = 1: "
        f"{step[1][0]:.3f} / {step[1][1]:.3f} ms / {step[1][2]:.3f}; B = 4: "
        f"{step[4][0]:.3f} / {step[4][1]:.3f} ms / {step[4][2]:.3f} ({card_line()})")
    sync_debug_serving_block(sched, label)
    log(f"{label} serving phase: {time.perf_counter() - t0:.1f} s")
    return sched, eng


def serving_kernel_entries(sched, cfg, entries, path, spec_path):
    """The kernels at the serving batch's shapes on the V3-width packed Q3_K
    draw: K5's packed matvec at B = 4 and its tile GEMM at B = 8 on the
    attention and dense projections and the lm_head, K1 (nibble, the same
    w13 converted) at 4 and 8 rows; K2's packed body over 4 tokens' 8 routed
    experts each (32 pairs, sorted, experts repeated across tokens); K3 at B
    = 4 with unequal kv_len; K10 with per-row starts (4 verify chunks of
    5 rows at unequal starts, the spec rounds' shape) beside the scalar
    form at the largest start (``scalar_ms``); K9 with per-row starts at
    V2-Lite's widths (the MHA verify chunks). Tolerance 1e-4 of max|ref|."""
    from deepseek_tpu_torch.ops.kernels.attention import (
        mla_decode_attn, mla_decode_attn_plain)
    from deepseek_tpu_torch.ops.kernels.prefill_attn import (
        mha_prefill_attn, mha_prefill_attn_plain, mla_prefill_attn, mla_prefill_attn_plain)
    from deepseek_tpu_torch.ops.kernels.qmm import (
        qmm, qmm_experts, qmm_experts_plain, qmm_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 57)
    emit, emit_spec = make_emit(entries, path), make_emit(entries, spec_path)
    emit_nib = make_emit(entries)
    emit_k9 = make_emit(entries, "CLI serve spec in process")
    params = sched.params
    dense, moe = params.layers[0], params.layers[cfg.n_layers - 1]
    H, R, P = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    k5 = "deepseek_tpu/ops/pallas/qmm.py:312 (qmm, _q3k_body :368)"
    for label, qt in (("wkvq", dense.wkvq), ("wcr", dense.wcr), ("wo", dense.wo),
                      ("w13 (dense)", dense.w13), ("lm_head", params.lm_head)):
        d, n = qt.shape
        for rows in (4, 8):
            x = torch.randn((rows, n), generator=gen, device="cuda")
            tiled = rows > 4
            emit(f"K5 qmm Q3_K packed {label} (serving batch) {rows}x{d}x{n}",
                 lambda: qmm(qt, x), lambda: qmm_plain(qt, x), 1e-4,
                 nbytes(x) + qt.nbytes_active + 4 * rows * d, 2.0 * rows * d * n,
                 "deepseek_tpu_torch/csrc/" + ("qmm_tiles.cu" if tiled else "packed_mv.cu"),
                 k5, "K5r-packed" if tiled else "K5-packed")
            if label == "w13 (dense)":
                nib = packed_to_nibble(qt)
                emit_nib(f"K1 qmm Q3_K nibble (the same w13, converted; serving batch) "
                     f"{rows}x{d}x{n}",
                     lambda: qmm(nib, x), lambda: qmm_plain(nib, x), 1e-4,
                     nbytes(x, nib.p, nib.a, nib.c) + 4 * rows * d, 2.0 * rows * d * n,
                     "deepseek_tpu_torch/csrc/" + ("qmm_tiles.cu" if tiled
                                                   else "nibble_mv.cu"),
                     "deepseek_tpu/ops/pallas/qmm.py:312 (qmm, _knib_body :206)",
                     "K1r" if tiled else "K1")
                del nib
    # K2: 4 tokens' 8 routed experts each, the pair list sorted by expert
    E = cfg.n_routed_experts
    ids = torch.stack([torch.randperm(E, generator=gen, device="cuda")[:cfg.n_active_routed]
                       for _ in range(4)]).reshape(-1).sort().values
    u = int(ids.unique().numel())
    for label, qt in (("w13 (MoE)", moe.w13), ("w2 (MoE)", moe.w2)):
        n_tab, d, n = qt.shape
        x = torch.randn((ids.numel(), n), generator=gen, device="cuda")
        emit(f"K2 qmm_experts Q3_K packed {label} (serving batch 4: {ids.numel()} pairs "
             f"over {u} experts) {d}x{n}",
             lambda: qmm_experts(qt, ids, x), lambda: qmm_experts_plain(qt, ids, x), 1e-4,
             nbytes(x) + qt.nbytes_active / n_tab * u + 4 * d * ids.numel(),
             2.0 * ids.numel() * d * n, "deepseek_tpu_torch/csrc/packed_mv.cu",
             "deepseek_tpu/ops/pallas/qmm.py:566 (qmm_experts, _q3k_body :368)",
             "K2-packed")
    S, dt = cfg.kv_window, sched.cache.ckv.dtype
    kv = [1, 37, 2500, S]
    qc = torch.randn((4, H, R), generator=gen, device="cuda")
    qr = torch.randn((4, H, P), generator=gen, device="cuda")
    ckv = torch.randn((4, S, R), generator=gen, device="cuda").to(dt)
    kr = torch.randn((4, S, P), generator=gen, device="cuda").to(dt)
    kl = torch.tensor(kv, device="cuda", dtype=torch.int32)
    scale = cfg.attn_softmax_scale()
    # the library yardstick: SDPA over the latent rows seen by every head,
    # each row's live prefix by a per-row mask
    dmask = torch.arange(S, device="cuda")[None] < kl[:, None]
    k_s = torch.cat([ckv, kr], -1)[:, None].expand(4, H, S, R + P)
    v_s = ckv[:, None].expand(4, H, S, R)
    q_s = torch.cat([qc, qr], -1)[:, :, None].to(dt)
    emit(f"K3 mla_decode_attn (serving batch 4, kv_len {kv}) H={H}",
         lambda: mla_decode_attn(qc, qr, ckv, kr, kl, scale),
         lambda: mla_decode_attn_plain(qc, qr, ckv, kr, kl, scale), 1e-4,
         sum(kv) * (R + P) * ckv.element_size() + nbytes(qc, qr) + 16 * H * R,
         2.0 * H * sum(kv) * (2 * R + P), "deepseek_tpu_torch/csrc/prefill_attn.cu",
         "deepseek_tpu/ops/pallas/attention.py:170 (mla_decode_attn, pallas_call :221)",
         "K3", library=lambda: torch.nn.functional.scaled_dot_product_attention(
             q_s, k_s, v_s, attn_mask=dmask[:, None, None], scale=scale))
    T, starts = 5, [600, 37, 2400, 4000]
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    qc = torch.randn((4, T, H, R), generator=gen, device="cuda") * 0.3
    qr = torch.randn((4, T, H, P), generator=gen, device="cuda") * 0.3
    seen = sum(s + T for s in starts)
    vmask = (torch.arange(S, device="cuda")[None, None]
             <= st[:, None, None] + torch.arange(T, device="cuda")[None, :, None])
    q_v = torch.cat([qc, qr], -1).transpose(1, 2).to(dt).contiguous()
    e = emit_spec(f"K10 mla_prefill_attn per-row starts {starts} (4 verify chunks of {T} "
                  f"rows) S={S} H={H}",
                  lambda: mla_prefill_attn(qc, qr, ckv, kr, st, 0, scale),
                  lambda: mla_prefill_attn_plain(qc, qr, ckv, kr, st, 0, scale), 1e-4,
                  seen * (R + P) * ckv.element_size() + nbytes(qc, qr) + 4 * 4 * T * H * R,
                  2.0 * T * H * seen * (2 * R + P), "deepseek_tpu_torch/csrc/prefill_attn.cu",
                  "deepseek_tpu/models/deepseek.py:1024-1035 (verify mode; the JAX package "
                  "runs it in XLA, attention.py:213; K10: attention.py:644, pallas_call :707)",
                  "K10-rows", library=lambda: torch.nn.functional.scaled_dot_product_attention(
                      q_v, k_s, v_s, attn_mask=vmask[:, None], scale=scale))
    e["scalar_ms"] = time_ms(lambda: mla_prefill_attn(qc, qr, ckv, kr, max(starts), 0, scale))
    log(f"  {e['name']}: the scalar form at start {max(starts)} {e['scalar_ms']:.4f} ms")
    del ckv, kr, k_s, v_s, q_v
    # K9 at V2-Lite's MHA widths (16 heads, 192/128) over an f16 window
    from deepseek_tpu_torch.models.testing import deepseek_v2_lite_proportions
    v2 = deepseek_v2_lite_proportions()
    Hm, Dh, Dv, Sm = v2.n_heads, v2.head_dim, v2.v_head_dim, v2.kv_window
    q = torch.randn((4, T, Hm, Dh), generator=gen, device="cuda") * 0.3
    k = (torch.randn((4, Sm, Hm, Dh), generator=gen, device="cuda") * 0.3).half()
    v = (torch.randn((4, Sm, Hm, Dv), generator=gen, device="cuda") * 0.3).half()
    sc = 1.0 / math.sqrt(Dh)
    seen = sum(s + T for s in starts)
    mmask = (torch.arange(Sm, device="cuda")[None, None]
             <= st[:, None, None] + torch.arange(T, device="cuda")[None, :, None])
    q_m, k_m, v_m = (t.transpose(1, 2).half().contiguous() for t in (q, k, v))
    e = emit_k9(f"K9 mha_prefill_attn per-row starts {starts} (V2-Lite widths, f16, 4 "
                  f"verify chunks of {T} rows) S={Sm} H={Hm}",
                  lambda: mha_prefill_attn(q, k, v, st, 0, sc),
                  lambda: mha_prefill_attn_plain(q, k, v, st, 0, sc), 1e-4,
                  seen * Hm * (Dh + Dv) * 2 + nbytes(q) + 4 * 4 * T * Hm * Dv,
                  2.0 * T * Hm * seen * (Dh + Dv), "deepseek_tpu_torch/csrc/prefill_attn.cu",
                  "deepseek_tpu/models/deepseek.py:548-578 (MHA verify mode in XLA; K9: "
                  "attention.py:481, pallas_call :543)", "K9-rows",
                  library=lambda: torch.nn.functional.scaled_dot_product_attention(
                      q_m, k_m, v_m, attn_mask=mmask[:, None], scale=sc))
    e["scalar_ms"] = time_ms(lambda: mha_prefill_attn(q, k, v, max(starts), 0, sc))
    log(f"  {e['name']}: the scalar form at start {max(starts)} {e['scalar_ms']:.4f} ms")
    del q, k, v, q_m, k_m, v_m


def tiny_serving_phase(counts, runs, device="cuda"):
    """Continuous batching on a tiny packed Q3_K .dseek (V3 routing, R 512)
    through BatchScheduler on the card and on the CPU (the plain versions):
    5 requests through 2 slots sampled at temperature 0.8 (top_p 0.95),
    with logprobs and the prefix cache; every token must be the CPU
    scheduler's, the log-probabilities within 1e-3."""
    from deepseek_tpu_torch.engine import Engine
    from deepseek_tpu_torch.serving import Request

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 59)
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_serve")
    shutil.rmtree(tmp, ignore_errors=True)
    write_tiny_checkpoint(tmp, rng, max_seq_len=256, window=128)
    base = [int(v) for v in rng.integers(3, 512, 70)]
    prompts = [base + [int(v) for v in rng.integers(3, 512, n)] for n in (5, 40, 1, 90, 12)]

    def run(dev):
        eng = Engine(tmp, device=dev, seed=SEED)
        reqs = [Request(prompt_tokens=p, max_new_tokens=20, temperature=0.8, top_p=0.95,
                        logprobs=True) for p in prompts]
        return serve_all(eng, reqs, batch_size=2, logprobs=True, prefix_cache_mb=8,
                         prefix_block=32)

    (_, got, _), runs["tiny serving"] = drive(
        counts, ("K5-packed", "K5r-packed", "K2-packed", "K3", "K10"),
        "tiny packed Q3_K serving on the card", lambda: run(device))
    _, want, _ = run("cpu")
    same_tokens([r.out_tokens for r in got], [r.out_tokens for r in want],
                "tiny packed Q3_K serving, 5 requests through 2 slots at 0.8")
    err = max(float(np.abs(np.asarray(a.out_logprobs) - b.out_logprobs).max())
              for a, b in zip(got, want))
    log(f"tiny serving: logprobs card vs CPU max abs err {err:.3e} (tolerance 1e-3); "
        f"{time.perf_counter() - t0:.1f} s")
    if not err <= 1e-3:
        raise RuntimeError("tiny serving: logprobs disagree with the CPU scheduler")


def free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(url, payload=None, timeout=CLI_TIMEOUT):
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
    return body if payload is not None and payload.get("stream") else json.loads(body)


def serve_cli_phase(counts, runs, ck, eng, prompt, want, ref, device="cuda"):
    """``python -m deepseek_tpu_torch <ckpt> -m serve --batch 4`` on the CLI
    phase's V2-Lite-width F8E5M2 checkpoint, a subprocess on a free
    loopback port: GET /health, then 4 concurrent POST /v1/completions of
    the CLI's prompt (streamed; with a stop string; with logprobs; at 0.8
    with top_k 1), whose greedy tokens must be the in-process greedy run's
    (which gave the CLI's text; near ties allowed) and whose texts the
    joined text of those tokens (the stop one cut before its stop string).
    Then a --serve-spec server, one greedy request. Each server is stopped
    when done. In process, a spec="ngram" scheduler over the same Engine
    drives K9's per-row starts (MHA verify chunks)."""
    import threading

    from deepseek_tpu_torch.serving import BatchScheduler, Request

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    text = joined_text(eng, prompt, want).decode("utf-8", errors="replace")
    at = next((j for j in range(len(text) // 3, len(text) - 3)
               if text[j:j + 3].isascii() and text[j:j + 3].isprintable()), None)
    stop = text[at:at + 3] if at is not None else None
    for spec in (None, "ngram"):
        t0 = time.perf_counter()
        port = free_port()
        url = f"http://127.0.0.1:{port}"
        args = [sys.executable, "-m", "deepseek_tpu_torch", ck, "-m", "serve", "--port",
                str(port), "--batch", "4", "--device", device]
        if spec:
            args.append("--serve-spec")
        logf = open(os.path.join(os.path.dirname(ck), f"serve_{spec or 'plain'}.log"), "w+")
        proc = subprocess.Popen(args, cwd=root, env=env, stdout=logf,
                                stderr=subprocess.STDOUT, text=True)
        try:
            health = None
            while time.perf_counter() - t0 < CLI_TIMEOUT:
                if proc.poll() is not None:
                    break
                try:
                    health = http_json(url + "/health", timeout=5)
                    break
                except OSError:
                    time.sleep(1)
            if health is None or health.get("status") != "ok":
                logf.seek(0)
                raise RuntimeError(f"-m serve did not come up: {logf.read()[-3000:]}")
            log(f"-m serve{' --serve-spec' if spec else ''}: /health after "
                f"{time.perf_counter() - t0:.1f} s: {health}")
            base = {"prompt": CLI_PROMPT, "max_tokens": CLI_NEW, "temperature": 0.0}
            payloads = ([dict(base, stream=True), dict(base, stop=stop),
                         dict(base, logprobs=True), dict(base, temperature=0.8, top_k=1)]
                        if spec is None else [dict(base, logprobs=True)])
            out = [None] * len(payloads)
            t1 = time.perf_counter()

            def go(i):
                out[i] = http_json(url + "/v1/completions", payloads[i])

            threads = [threading.Thread(target=go, args=(i,)) for i in range(len(payloads))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(CLI_TIMEOUT)
            dt = time.perf_counter() - t1
            if any(o is None for o in out):
                raise RuntimeError("-m serve: a request got no answer")
            for i, (p, o) in enumerate(zip(payloads, out)):
                name = f"-m serve{' --serve-spec' if spec else ''} request {i}"
                if p.get("stream"):
                    lines = [ln for ln in o.decode().splitlines() if ln.startswith("data: ")]
                    if lines[-1] != "data: [DONE]":
                        raise RuntimeError(f"{name}: the stream did not end with [DONE]")
                    got_text = "".join(json.loads(ln[6:])["text"] for ln in lines[:-1])
                    if got_text != text:
                        raise RuntimeError(f"{name}: streamed text {got_text!r}, greedy "
                                           f"{text!r}")
                    continue
                n = same_or_near_tie(ref, want, o["tokens"], name)
                if n < len(want):
                    continue
                if p.get("stop"):
                    wtext = text[:text.find(stop)]
                    if o["text"] != wtext or o["finish_reason"] != "stop":
                        raise RuntimeError(f"{name}: stop {stop!r} gave {o['text']!r}, "
                                           f"want {wtext!r}")
                elif o["text"] != text:
                    raise RuntimeError(f"{name}: text {o['text']!r}, greedy {text!r}")
                if p.get("logprobs") and not (len(o["logprobs"]) == len(o["tokens"])
                                              and all(x <= 0 for x in o["logprobs"])):
                    raise RuntimeError(f"{name}: bad logprobs")
            health = http_json(url + "/health", timeout=60)
            log(f"-m serve{' --serve-spec' if spec else ''}: {len(payloads)} concurrent "
                f"completions in {dt:.2f} s, greedy text the CLI's; /health {health}")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            logf.close()
    # in process: MHA verify chunks (K9 with per-row starts)
    reqs = [Request(prompt_tokens=list(prompt), max_new_tokens=CLI_NEW, temperature=0.0)
            for _ in range(2)]
    (sched, done, wall), runs["CLI serve spec in process"] = drive(
        counts, ("K9-rows", "K9", "K8", "K5", "K5r", "K2-fp8"),
        "V2-Lite-width F8E5M2, spec='ngram' serving in process",
        lambda: serve_all(eng, reqs, batch_size=4, spec="ngram"))
    for r in done:
        same_or_near_tie(ref, want, r.out_tokens, "in-process spec='ngram' serving")
    log(f"V2-Lite-width spec serving in process: {sched.spec_stats}, {wall:.2f} s")


# ---------------------------------------------------------------------------
# verify chunks: batch invariance and their time, the parent's route beside
# the invariant one
# ---------------------------------------------------------------------------

VERIFY_STARTS = (140, 600, 37, 1100)   # 4 sequences' chunk starts
VERIFY_T = 5                           # spec_k 4
VERIFY_REPS = 20
VERIFY_T_LONG = 17                     # spec_k 16: 136 pairs a sequence at 8 experts


def clone_rows(caches, seqs):
    """A fresh batch cache holding the 1-row caches ``seqs``."""
    c0 = caches[0]
    return dataclasses.replace(c0, **{
        f.name: torch.cat([getattr(caches[i], f.name) for i in seqs], dim=1)
        for f in dataclasses.fields(c0) if isinstance(getattr(c0, f.name), torch.Tensor)})


@contextlib.contextmanager
def parent_verify_route(max_start):
    """The verify route as the parent commit ran it: no verify_chunk (the
    matvec at up to 4 rows, the tile GEMM's wide tiles past 16 rows, the
    pair list or the grouped products by the batch's pairs, the router
    product padded to 16 rows only, one wv einsum) and K10's splits sized
    by B and the largest start."""
    import deepseek_tpu_torch.models.deepseek as model
    import deepseek_tpu_torch.ops.kernels.prefill_attn as pa
    real = pa.prefill_splits

    def old(B, T, H, S, q_pos0, cache_pos0, mqa, per_row=False):
        return real(B, T, H, S, max_start if per_row else q_pos0, cache_pos0, mqa)
    saved = model.verify_chunk, pa.prefill_splits
    model.verify_chunk, pa.prefill_splits = contextlib.nullcontext, old
    try:
        yield
    finally:
        model.verify_chunk, pa.prefill_splits = saved


@contextlib.contextmanager
def parent_grouped_route():
    """Verify chunks past PAIR_PREFILL_MAX_PAIRS pairs a sequence as the
    parent commit ran them: one counting sort over every sequence's pairs,
    whose tiles mix sequences."""
    import deepseek_tpu_torch.models.deepseek as model
    saved = model._grouped_ffn

    def one_sort(t13, t1, t2, t3, xb, weights, idx, cfg, ctx, ovf):
        return model.grouped_expert_ffn(t1, t2, t3, xb, weights, idx, cfg.act, w13=t13,
                                        ctx=ctx, ovf=ovf)
    model._grouped_ffn = one_sort
    try:
        yield
    finally:
        model._grouped_ffn = saved


def verify_chunk_phase(counts, runs):
    """The V3-width packed Q3_K draw cut to 4 layers (f32 compute, bf16
    cache, absorbed prefill), 4 sequences hydrated to VERIFY_STARTS; a
    verify chunk (forward_prefill with per-row starts, spec_k 4: 5 rows a
    sequence, logits of every row) over the first B = 1, 2 and 4 of them:
    each sequence's rows must have the bits of its chunk verified alone
    (B = 1). Each (route, B) is timed in calls of its own (wall with the
    card synchronized, the mean of VERIFY_REPS), on the invariant route
    and on the parent's (``parent_verify_route``), in the order parent,
    new, new, parent; the parent's rows are compared too (a control: they
    differ from the rows alone at B = 4). Then spec_k 16 (VERIFY_T_LONG
    rows a sequence, past PAIR_PREFILL_MAX_PAIRS pairs: the grouped
    products, K6, one sequence's tiles at a time) at B = 1, 2 and 4, on
    this draw and on the same widths in packed Q2_K: the rows must be the
    rows alone bit for bit; the parent's one sort over all the pairs
    (``parent_grouped_route``) is compared too."""
    from deepseek_tpu_torch.engine import hydrate_cache
    from deepseek_tpu_torch.models.deepseek import forward_prefill
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.models.testing import random_fused_params

    t_phase = time.perf_counter()
    params, cfg = mesh_model("v3")
    gen = torch.Generator().manual_seed(SEED + 71)
    caches = []
    for s in VERIFY_STARTS:
        c = init_cache(cfg, device="cuda")
        hydrate_cache(params, cfg, c, torch.randint(3, cfg.vocab_size, (s,),
                                                    generator=gen).tolist(),
                      want_last_logits=False)
        caches.append(c)
    tok = torch.randint(3, cfg.vocab_size, (4, VERIFY_T), generator=gen).cuda()
    tok_long = torch.randint(3, cfg.vocab_size, (4, VERIFY_T_LONG), generator=gen).cuda()
    starts = np.array(VERIFY_STARTS)

    def chunk(seqs, tok=tok):
        cache = clone_rows(caches, seqs)
        with torch.inference_mode():
            return forward_prefill(params, cache, tok[list(seqs)], starts[list(seqs)], cfg,
                                   logits_mode="all")

    def timed(B):
        chunk(range(B))                           # warm
        walls = []
        for _ in range(VERIFY_REPS):
            cache = clone_rows(caches, range(B))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                forward_prefill(params, cache, tok[:B], starts[:B], cfg, logits_mode="all")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return round(1e3 * float(np.median(walls)), 3)

    times, failed = {}, []
    for route in ("parent", "new", "new", "parent"):
        ctx = parent_verify_route(max(VERIFY_STARTS)) if route == "parent" \
            else contextlib.nullcontext()
        with ctx:
            alone = [chunk([b])[0] for b in range(4)]
            for B in (2, 4):
                got = chunk(range(B))
                diff = max(float((got[b] - alone[b]).abs().max()) for b in range(B))
                equal = all(torch.equal(got[b], alone[b]) for b in range(B))
                log(f"verify chunk, {route} route, B={B} x {VERIFY_T} rows: each "
                    f"sequence's rows bit-equal to its chunk alone: {equal} (max abs diff "
                    f"{diff:.3e})")
                if route == "new" and not equal:
                    failed.append(f"B={B}: rows differ from the rows alone by {diff:.3e}")
            for B in (1, 2, 4):
                times.setdefault((route, B), []).append(timed(B))
    for B in (1, 2, 4):
        log(f"verify chunk B={B} x {VERIFY_T} rows (spec_k 4, V3-width packed Q3_K, 4 "
            f"layers), median wall ms of {VERIFY_REPS} calls, in the order parent, new, new, "
            f"parent: parent route {times[('parent', B)]}, invariant route "
            f"{times[('new', B)]} ({card_line()})")
    _, runs["verify chunk"] = drive(counts, ("K10-rows", "K5r-packed", "K2-packed"),
                                    "verify chunk, B=4", lambda: chunk(range(4)))
    _, runs["verify chunk spec_k 16"] = drive(
        counts, ("K10-rows", "K5r-packed", "K6-packed"), "verify chunk spec_k 16, B=4",
        lambda: chunk(range(4), tok_long))
    # spec_k 16 on this draw (its chunks' pairs spread over ~256 experts, so
    # a tile rarely holds more than 16 rows) and on the same widths in Q2_K
    # (whose random planes route every token to the same 8 experts: at B = 4
    # a tile holds 68 rows of 4 sequences, at MMA width 128 against 32 alone)
    for quant in ("q3_k", "q2_k"):
        if quant == "q2_k":
            del params
            torch.cuda.empty_cache()
            params = random_fused_params(cfg, "q2_k", seed=SEED, device="cuda")
            g2 = torch.Generator().manual_seed(SEED + 71)
            for c, s in zip(caches, VERIFY_STARTS):
                hydrate_cache(params, cfg, c, torch.randint(3, cfg.vocab_size, (s,),
                                                            generator=g2).tolist(),
                              want_last_logits=False)
        for route in ("parent", "new"):
            with parent_grouped_route() if route == "parent" else contextlib.nullcontext():
                alone = [chunk([b], tok_long)[0] for b in range(4)]
                for B in (1, 2, 4):
                    got = chunk(range(B), tok_long)
                    diff = max(float((got[b] - alone[b]).abs().max()) for b in range(B))
                    equal = all(torch.equal(got[b], alone[b]) for b in range(B))
                    log(f"verify chunk spec_k 16 ({quant}), {route} route, B={B} x "
                        f"{VERIFY_T_LONG} rows: each sequence's rows bit-equal to its chunk "
                        f"alone: {equal} (max abs diff {diff:.3e})")
                    if route == "new" and not equal:
                        failed.append(f"spec_k 16 ({quant}), B={B}: rows differ from the "
                                      f"rows alone by {diff:.3e}")
    del params, caches
    torch.cuda.empty_cache()
    log(f"verify chunk phase: {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise RuntimeError("verify chunks not batch invariant: " + "; ".join(failed))


# ---------------------------------------------------------------------------
# phase 12b: independent processes over TCP (the multi-process launcher)
# ---------------------------------------------------------------------------

MULTIHOST_TIMEOUT = 10       # the missing-peer run's rendezvous timeout, seconds
MULTIHOST_BOUND = 60         # seconds in which that run must have failed


def multihost_phase(device="cuda"):
    """Two independent ``scripts/torch_launch_multihost.py`` processes (no
    common parent group: they meet over tcp://127.0.0.1:<free port>, gloo),
    each running the CLI on the card on a tiny packed Q3_K ``.dseek``
    (``-m completion -t 0 -n 16``): each must print the completion of the
    single-process CLI. Beside them, process 0 of another group alone, its
    peer never started, with ``--timeout`` MULTIHOST_TIMEOUT: it must exit
    non-zero within MULTIHOST_BOUND seconds. The four processes run at
    once. ``device`` rehearses the phase on the CPU."""
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    ck = os.path.join(root, "build", "chip_smoke_multihost")
    shutil.rmtree(ck, ignore_errors=True)
    write_tiny_checkpoint(ck, np.random.default_rng(SEED + 83), max_seq_len=256, window=128)
    args = [ck, "-m", "completion", "-i", "Processes meet over TCP", "-n", "16", "-t", "0",
            "--device", device]
    # four interpreters at once: one host thread each, so that none waits
    # on another's spinning OpenMP threads
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    launcher = [sys.executable, os.path.join(root, "scripts", "torch_launch_multihost.py")]

    def start(cmd):
        return subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def ranks(port, n, pids, timeout):
        return [start([*launcher, "--coord", f"127.0.0.1:{port}", "--nprocs", str(n),
                       "--pid", str(pid), "--timeout", str(timeout), *args])
                for pid in pids]

    t0 = time.perf_counter()
    procs = ([start([sys.executable, "-m", "deepseek_tpu_torch", *args])]
             + ranks(free_port(), 2, (0, 1), 120)
             + ranks(free_port(), 2, (0,), MULTIHOST_TIMEOUT))
    outs, ended = [None] * 4, [0.0] * 4
    try:
        # the lone process first, so that its time is its own
        for i, bound in ((3, MULTIHOST_BOUND), (0, CLI_TIMEOUT), (1, CLI_TIMEOUT),
                         (2, CLI_TIMEOUT)):
            outs[i] = procs[i].communicate(
                timeout=max(1.0, bound - (time.perf_counter() - t0)))
            ended[i] = time.perf_counter() - t0
    except subprocess.TimeoutExpired:
        raise RuntimeError("multihost: a process of the phase outlasted its bound") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    (alone, alone_err), *rank_outs, (_, solo_err) = outs
    want = cli_texts(alone)
    failed = []
    if procs[0].returncode != 0 or len(want) != 1 or not want[0].strip():
        failed.append(f"the one-process CLI: rc {procs[0].returncode}, printed {want!r}; "
                      f"stderr {alone_err[-1500:]}")
    log(f"multihost reference, one process: rc {procs[0].returncode} in {ended[0]:.1f} s")
    for pid, (p, (out, err)) in enumerate(zip(procs[1:3], rank_outs)):
        got = cli_texts(out)
        joined = f"[multihost] process {pid}/2" in err
        log(f"multihost: process {pid} of 2 rc {p.returncode} in {ended[pid + 1]:.1f} s, "
            f"joined: {joined}, completion equal to the one-process CLI's: {got == want}")
        if p.returncode != 0 or not joined or got != want:
            failed.append(f"process {pid}: rc {p.returncode}, joined {joined}, printed "
                          f"{got!r} against {want!r}; stderr {err[-1500:]}")
    solo = procs[3]
    log(f"multihost: process 0 of 2 alone (--timeout {MULTIHOST_TIMEOUT}): rc "
        f"{solo.returncode} after {ended[3]:.1f} s; {solo_err.strip().splitlines()[-1:]}")
    if solo.returncode == 0 or ended[3] >= MULTIHOST_BOUND:
        failed.append(f"the missing peer: rc {solo.returncode} after {ended[3]:.1f} s")
    shutil.rmtree(ck, ignore_errors=True)
    log(f"multihost phase: {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise RuntimeError("multihost: " + "; ".join(failed))


# ---------------------------------------------------------------------------
# phase 13: conversion (HF -> .dseek) with the port's converter
# ---------------------------------------------------------------------------

CONVERT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_convert")
CONVERT_TIMEOUT = 600        # seconds for one converter subprocess
V3_CONVERT_PROMPT = 512      # the converted V3 cut: hydrated prompt and decode steps
V3_CONVERT_DECODE = 16
V3_CPU_PROMPT = 32           # the shorter run held against the CPU Engine
V3_CPU_STEPS = 1
V2_CONVERT_PROMPT = 300      # the converted V2-Lite cuts against the CPU Engine
V2_CONVERT_STEPS = 8


def hf_config_of(dim, hidden, layers, heads, vocab, q_lora, kv_lora, nope, rope, v_dim,
                 first_dense, n_experts, n_active, moe_inter, n_shared, v3,
                 n_group=1, topk_group=1, mscale=1.0, init=0.1):
    """An HF DeepSeek config.json (the layout of tests/util_hf.py)."""
    return {
        "architectures": ["DeepseekV3ForCausalLM" if v3 else "DeepseekV2ForCausalLM"],
        "hidden_size": dim, "intermediate_size": hidden, "num_hidden_layers": layers,
        "num_attention_heads": heads, "vocab_size": vocab,
        "bos_token_id": 0 if v3 else 100000, "eos_token_id": 1 if v3 else 100001,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "hidden_act": "silu",
        "first_k_dense_replace": first_dense, "kv_lora_rank": kv_lora,
        "q_lora_rank": q_lora or None, "qk_nope_head_dim": nope,
        "qk_rope_head_dim": rope, "v_head_dim": v_dim, "n_shared_experts": n_shared,
        "n_routed_experts": n_experts, "num_experts_per_tok": n_active,
        "moe_intermediate_size": moe_inter,
        "routed_scaling_factor": 2.5 if v3 else 1.0, "n_group": n_group,
        "norm_topk_prob": v3, "scoring_func": "sigmoid" if v3 else "softmax",
        "topk_group": topk_group, "topk_method": "noaux_tc" if v3 else "greedy",
        "tie_word_embeddings": False, "initializer_range": init,
        "rope_scaling": {"type": "yarn", "beta_fast": 32, "beta_slow": 1, "factor": 40,
                         "mscale": mscale, "mscale_all_dim": mscale,
                         "original_max_position_embeddings": 4096},
    }


def hf_tensor_specs(cfg, mtp=False):
    """(name, shape, kind) of every tensor of an HF DeepSeek checkpoint:
    kind "w" (a projection, scaled N(0, 1)), "norm" (1 + 0.1 N(0, 1)),
    "emb" (an embedding or head), "gate" (the router and its bias)."""
    dim, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v_dim = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q_lora, kv_lora = cfg["q_lora_rank"] or 0, cfg["kv_lora_rank"]
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], dim), "emb"),
           ("model.norm.weight", (dim,), "norm"),
           ("lm_head.weight", (cfg["vocab_size"], dim), "emb")]
    for layer in range(cfg["num_hidden_layers"] + (1 if mtp else 0)):
        p = f"model.layers.{layer}"
        if mtp and layer == cfg["num_hidden_layers"]:
            out += [(f"{p}.enorm.weight", (dim,), "norm"), (f"{p}.hnorm.weight", (dim,), "norm"),
                    (f"{p}.eh_proj.weight", (dim, 2 * dim), "w"),
                    (f"{p}.shared_head.norm.weight", (dim,), "norm")]
        out += [(f"{p}.input_layernorm.weight", (dim,), "norm"),
                (f"{p}.post_attention_layernorm.weight", (dim,), "norm"),
                (f"{p}.self_attn.kv_a_proj_with_mqa.weight", (kv_lora + rope, dim), "w"),
                (f"{p}.self_attn.kv_a_layernorm.weight", (kv_lora,), "norm"),
                (f"{p}.self_attn.kv_b_proj.weight", (H * (nope + v_dim), kv_lora), "w"),
                (f"{p}.self_attn.o_proj.weight", (dim, H * v_dim), "w")]
        if q_lora:
            out += [(f"{p}.self_attn.q_a_proj.weight", (q_lora, dim), "w"),
                    (f"{p}.self_attn.q_a_layernorm.weight", (q_lora,), "norm"),
                    (f"{p}.self_attn.q_b_proj.weight", (H * (nope + rope), q_lora), "w")]
        else:
            out += [(f"{p}.self_attn.q_proj.weight", (H * (nope + rope), dim), "w")]
        if layer < cfg["first_k_dense_replace"]:
            m = cfg["intermediate_size"]
            out += [(f"{p}.mlp.gate_proj.weight", (m, dim), "w"),
                    (f"{p}.mlp.down_proj.weight", (dim, m), "w"),
                    (f"{p}.mlp.up_proj.weight", (m, dim), "w")]
            continue
        E, m = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        out += [(f"{p}.mlp.gate.weight", (E, dim), "gate")]
        if cfg["architectures"][0] == "DeepseekV3ForCausalLM":
            out += [(f"{p}.mlp.gate.e_score_correction_bias", (E,), "gate")]
        for e in range(E):
            out += [(f"{p}.mlp.experts.{e}.gate_proj.weight", (m, dim), "w"),
                    (f"{p}.mlp.experts.{e}.down_proj.weight", (dim, m), "w"),
                    (f"{p}.mlp.experts.{e}.up_proj.weight", (m, dim), "w")]
        sm = cfg["n_shared_experts"] * m
        out += [(f"{p}.mlp.shared_experts.gate_proj.weight", (sm, dim), "w"),
                (f"{p}.mlp.shared_experts.down_proj.weight", (dim, sm), "w"),
                (f"{p}.mlp.shared_experts.up_proj.weight", (sm, dim), "w")]
    return out


def write_safetensors(path, tensors):
    """A safetensors file written tensor by tensor: ``tensors`` is a list of
    (name, dtype string, shape, make) where make() returns the tensor's
    bytes as a numpy array, called once when its turn comes (so a file of
    several GB never sits in host memory)."""
    header, off = {}, 0
    size = {"F32": 4, "BF16": 2, "F8_E4M3": 1}
    for name, dt, shape, _ in tensors:
        n = math.prod(shape) * size[dt]
        header[name] = {"dtype": dt, "shape": list(shape), "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for name, dt, shape, make in tensors:
            a = np.ascontiguousarray(make())
            if a.nbytes != header[name]["data_offsets"][1] - header[name]["data_offsets"][0]:
                raise RuntimeError(f"{name}: {a.nbytes} bytes for {dt} {shape}")
            a.tofile(f)


def write_hf_dir(path, cfg, tokenizer, seed, form="F32", fp8_block=(128, 128),
                 mtp=False, n_files=1, tokenizer_config=None, device="cuda"):
    """An HF checkpoint directory (config.json, tokenizer_config.json,
    tokenizer.json, *.safetensors) of random weights drawn on the card from
    ``seed``: ``form`` "F32" (every tensor f32, as tests/util_hf.py), "BF16"
    (DeepSeek-V2-Lite's release) or "FP8" (DeepSeek-V3's: the projections
    F8_E4M3 with a float32 ``weight_scale_inv`` grid of ``fp8_block``
    blocks, scale = block amax / 448, every other tensor BF16). The
    projections, embedding and head are N(0, initializer_range) (the HF
    init), the norms 1 + 0.1 N(0, 1). Returns the bytes of the safetensors
    written."""
    os.makedirs(path, exist_ok=True)
    cfg = dict(cfg)
    if form == "FP8":
        cfg["quantization_config"] = {"quant_method": "fp8", "activation_scheme": "dynamic",
                                      "fmt": "e4m3", "weight_block_size": list(fp8_block)}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"model_max_length": 4096, **(tokenizer_config or {})}, f)
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(tokenizer, f)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def values(shape, kind):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        if kind == "norm":
            return 1.0 + 0.1 * x
        return x * cfg["initializer_range"]

    def host(t, dt):
        if dt == "F32":
            return t.float().cpu().numpy()
        if dt == "BF16":
            return t.to(torch.bfloat16).view(torch.int16).cpu().numpy()
        return t.view(torch.uint8).cpu().numpy()

    specs = []
    for name, shape, kind in hf_tensor_specs(cfg, mtp):
        if form == "F32":
            specs.append((name, "F32", shape, lambda s=shape, k=kind: host(values(s, k), "F32")))
        elif form == "BF16" or kind != "w" or len(shape) != 2:
            specs.append((name, "BF16", shape, lambda s=shape, k=kind: host(values(s, k), "BF16")))
        else:
            b0, b1 = fp8_block
            grid = (-(-shape[0] // b0), -(-shape[1] // b1))
            made = {}

            def fp8(s=shape, g=grid, made=made):
                w = values(s, "w")
                wp = torch.zeros((g[0] * b0, g[1] * b1), device=device)
                wp[:s[0], :s[1]] = w
                amax = wp.reshape(g[0], b0, g[1], b1).abs().amax(dim=(1, 3))
                sc = torch.clamp(amax, min=1e-12) / 448.0
                full = sc.repeat_interleave(b0, 0)[:s[0]].repeat_interleave(b1, 1)[:, :s[1]]
                made["scale"] = sc
                return host((w / full).to(torch.float8_e4m3fn), "F8")

            specs.append((name, "F8_E4M3", shape, fp8))
            specs.append((name.replace(".weight", ".weight_scale_inv"), "F32", grid,
                          lambda m=made: host(m.pop("scale"), "F32")))
    per = -(-len(specs) // n_files)
    total = 0
    for i in range(n_files):
        part = specs[i * per:(i + 1) * per]
        fn = os.path.join(path, "model.safetensors" if n_files == 1
                          else f"model-{i + 1:05d}-of-{n_files:05d}.safetensors")
        write_safetensors(fn, part)
        total += os.path.getsize(fn)
    return total


def params_to(params, device):
    """A copy of the model's weights (every plane of every layer) on
    ``device``."""
    from deepseek_tpu_torch.quant.qtensor import PlainTensor

    def move(t):
        if t is None or isinstance(t, (bool, int, float, str, tuple)):
            return t
        if isinstance(t, torch.Tensor):
            return t.to(device)
        if isinstance(t, list):
            return [move(x) for x in t]
        if isinstance(t, PlainTensor):
            return PlainTensor(data=move(t.data))
        if hasattr(t, "map"):
            return t.map(move)
        return dataclasses.replace(t, **{f.name: move(getattr(t, f.name))
                                         for f in dataclasses.fields(t)})
    return move(params)


def set_hf_config(path, **kw):
    """Rewrite keys of an HF directory's config.json (the full model's
    layer count over a directory that holds the first layers only)."""
    fn = os.path.join(path, "config.json")
    with open(fn) as f:
        cfg = json.load(f)
    cfg.update(kw)
    with open(fn, "w") as f:
        json.dump(cfg, f)


def byte_tokenizer(vocab_size):
    """A SentencePiece-style tokenizer.json with byte fallback (the layout
    of tests/util_hf.py): <unk> <s> </s>, the 256 byte tokens, then words."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for i in range(256):
        vocab[f"<0x{i:02X}>"] = 3 + i
    for i, piece in enumerate(["▁hello", "▁world", "he", "ll", "o"]):
        vocab[piece] = 259 + i
    for i in range(len(vocab), vocab_size):
        vocab[f"tok{i}"] = i
    return {"model": {"vocab": vocab, "byte_fallback": True}, "added_tokens": []}


def gpt2_tokenizer(vocab_size, seed):
    """A GPT-2 byte-level tokenizer.json of ``vocab_size`` tokens (DeepSeek-V3's
    kind): the two special tokens (ids 0 and 1), every single byte, then
    distinct random pieces of 2-7 bytes, each written in the GPT-2
    byte-to-unicode alphabet."""
    from deepseek_tpu_torch.convert import gpt2_bytes_to_unicode

    enc = gpt2_bytes_to_unicode()
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b" abcdefghijklmnopqrstuvwxyz,.etaoinshr", dtype=np.uint8)
    vocab = {"".join(enc[b] for b in bytes([i])): 2 + i for i in range(256)}
    while len(vocab) < vocab_size - 2:
        n = int(rng.integers(2, 8))
        piece = "".join(enc[int(b)] for b in rng.choice(alphabet, n))
        vocab.setdefault(piece, len(vocab) + 2)
    return {"model": {"vocab": vocab}, "added_tokens": [
        {"id": 0, "content": "<｜begin▁of▁sentence｜>"},
        {"id": 1, "content": "<｜end▁of▁sentence｜>"}]}


def run_converter(out, hf, flags, label):
    """``python -m deepseek_tpu_torch.convert OUT HF FLAGS`` as a user runs it
    (on the card: the default device), inside a wrapper process that
    reports the converter's peak RSS (getrusage(RUSAGE_CHILDREN), the
    wrapper's only child). Returns (seconds, peak RSS bytes, stdout)."""
    wrap = ("import resource, subprocess, sys; "
            "r = subprocess.run([sys.executable, '-m', 'deepseek_tpu_torch.convert', "
            "*sys.argv[1:]]); "
            "print('PEAK_RSS_KB', resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss); "
            "sys.exit(r.returncode)")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", wrap, out, hf, *flags],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=CONVERT_TIMEOUT)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"{label}: converter rc {res.returncode}:\n{res.stdout[-3000:]}"
                           f"\n{res.stderr[-3000:]}")
    peak = int(re.search(r"PEAK_RSS_KB (\d+)", res.stdout).group(1)) * 1024
    return secs, peak, res.stdout


def same_but_wc(a_dir, b_dir, label):
    """Two conversions: the same metadata and every tensor byte for byte
    but attn.wc (and its scale); returns the wc tensors' names."""
    from deepseek_tpu_torch.utils.codec import load_checkpoint

    a, b = load_checkpoint(a_dir), load_checkpoint(b_dir)
    if a.metadata != b.metadata or set(a.tensors) != set(b.tensors):
        raise RuntimeError(f"{label}: metadata or tensor names differ")
    wc = {n for n in a.tensors if ".attn.wc." in n}
    for name in a.tensors:
        if name in wc:
            continue
        x, y = a.tensors[name], b.tensors[name]
        if (x.dtype_str, x.shape) != (y.dtype_str, y.shape) or not np.array_equal(
                np.asarray(x.array).view(np.uint8), np.asarray(y.array).view(np.uint8)):
            raise RuntimeError(f"{label}: {name} differs between the card's and the "
                               f"CPU's conversion")
    return sorted(wc)


def wc_error(a_dir, b_dir):
    """max |dequant(wc_a) - dequant(wc_b)| over the layers' attn.wc, and
    the largest |wc| (both on the dequantized f32 weights)."""
    from deepseek_tpu_torch.engine import Engine
    from deepseek_tpu_torch.models.loader import unfuse_projections

    err = scale = 0.0
    ea = Engine(a_dir, device="cpu", load_mtp=False)
    eb = Engine(b_dir, device="cpu", load_mtp=False)
    pa = unfuse_projections(ea.params, ea.cfg)
    pb = unfuse_projections(eb.params, eb.cfg)
    for la, lb in zip(pa.layers, pb.layers):
        if la.wc is None:
            continue
        wa, wb = la.wc.dequant(torch.float32), lb.wc.dequant(torch.float32)
        err = max(err, float((wa - wb).abs().max()))
        scale = max(scale, float(wa.abs().max()))
    return err, scale


def tiny_convert_phase(counts, runs):
    """(a) Three tiny HF directories written with the port's codec's layout
    (tests/util_hf.py): DeepSeek-V2 MHA at the default fp16; V3 with an MTP
    layer at --mla --quant q3_k; an HF-FP8 input (F8_E4M3 + BF16) at
    --quant f8e5m2. Each through ``python -m deepseek_tpu_torch.convert``
    on the card (three subprocesses at once) and in process with
    device="cpu": byte-equal but attn.wc (its dequantized weights within
    1e-2 of their scale: an f16 or e5m2 rounding tie, or a K-quant
    sub-block's grid); Engine(device="cuda") on each checkpoint gives the
    CPU Engine's greedy tokens."""
    from deepseek_tpu_torch.convert import convert
    from deepseek_tpu_torch.engine import Engine

    small = dict(dim=256, hidden=512, layers=2, heads=2, vocab=1024, q_lora=256,
                 kv_lora=512, nope=128, rope=64, v_dim=128, first_dense=1, n_experts=8,
                 n_active=2, moe_inter=256, n_shared=1)
    cases = {
        "V2 MHA fp16": (hf_config_of(**small, v3=False), "F32", False, []),
        "V3 MTP q3_k --mla": (hf_config_of(**small, v3=True, n_group=2), "F32", True,
                              ["--mla", "--quant", "q3_k"]),
        "HF-FP8 f8e5m2": (hf_config_of(**small, v3=True, n_group=2), "FP8", False,
                          ["--quant", "f8e5m2", "--mla"]),
    }
    t_phase = time.perf_counter()
    procs = {}
    for i, (label, (cfg, form, mtp, flags)) in enumerate(cases.items()):
        root = os.path.join(CONVERT_DIR, f"tiny{i}")
        shutil.rmtree(root, ignore_errors=True)
        write_hf_dir(os.path.join(root, "hf"), cfg, byte_tokenizer(cfg["vocab_size"]),
                     SEED + 80 + i, form=form, fp8_block=(128, 128), mtp=mtp,
                     n_files=2 if i == 0 else 1,
                     tokenizer_config={"chat_template": "{{ messages }}"} if mtp else None)
        procs[label] = (root, subprocess.Popen(
            [sys.executable, "-m", "deepseek_tpu_torch.convert", os.path.join(root, "card"),
             os.path.join(root, "hf"), *flags],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for label, (cfg, form, mtp, flags) in cases.items():
        root, proc = procs[label]
        t0 = time.perf_counter()
        kw = dict(quant=flags[flags.index("--quant") + 1] if "--quant" in flags else "fp16",
                  use_mla="--mla" in flags)
        convert(os.path.join(root, "hf"), os.path.join(root, "cpu"), device="cpu", **kw)
        t_cpu = time.perf_counter() - t0
        out, _ = proc.communicate(timeout=CONVERT_TIMEOUT)
        if proc.returncode != 0:
            raise RuntimeError(f"tiny conversion {label}: rc {proc.returncode}\n{out[-3000:]}")
        wc = same_but_wc(os.path.join(root, "card"), os.path.join(root, "cpu"), label)
        err, scale = wc_error(os.path.join(root, "card"), os.path.join(root, "cpu")) \
            if wc else (0.0, 1.0)
        log(f"tiny conversion {label}: card subprocess and CPU ({t_cpu:.1f} s in process) "
            f"byte-equal but {len(wc)} attn.wc tensors (dequantized max abs diff "
            f"{err:.3e}, scale {scale:.3e}); {out.strip().splitlines()[0]}")
        if err > 1e-2 * scale:
            raise RuntimeError(f"tiny conversion {label}: attn.wc off by {err:.3e}")
        ck = os.path.join(root, "card")
        prompt = [1, 259, 260, 40, 7, 99, 3, 17]
        (got, _), launched = drive(counts, (), f"tiny conversion {label}: Engine on the card",
                                   lambda: Engine(ck, device="cuda", seed=0).generate(
                                       prompt, num_steps=8, temperature=0.0))
        want, _ = Engine(ck, device="cpu", seed=0).generate(prompt, num_steps=8,
                                                            temperature=0.0)
        same_tokens(got, want, f"tiny conversion {label}: greedy tokens")
        runs[f"tiny conversion {label}"] = launched
    log(f"tiny conversion: {time.perf_counter() - t_phase:.1f} s")


def v3_convert_phase(counts, runs):
    """(b) DeepSeek-V3's published widths (config.json of
    deepseek-ai/DeepSeek-V3) cut to its first 2 layers (both dense, as
    first_k_dense_replace = 3 makes them): F8_E4M3 projections with
    128x128 weight_scale_inv grids, BF16 embedding, head and norms, a
    GPT-2-byte tokenizer.json of 129280 tokens; ~3.0 B parameters, ~4.9 GB
    of safetensors. ``--mla --quant q2_k --n-layers 2`` through the native
    encoder (a converter subprocess on the card); then Engine(device=
    "cuda") hydrates a 512-token prompt and decodes 16 greedy tokens; a
    32-token prompt and 2 steps against the CPU Engine (logits within 1e-3
    of their scale), under a debug capture on each side (max_err by name);
    the native tokenizer against the Python one at that vocabulary."""
    import copy

    from deepseek_tpu_torch.engine import Engine
    from deepseek_tpu_torch.native import kquant_native, tokenizer_native
    from deepseek_tpu_torch.utils import debug

    if not (kquant_native.available() and tokenizer_native.available()):
        raise RuntimeError(f"native libraries did not build: K-quant "
                           f"{kquant_native.build_error()}, tokenizer "
                           f"{tokenizer_native.build_error()}")
    t_phase = time.perf_counter()
    root = os.path.join(CONVERT_DIR, "v3")
    shutil.rmtree(root, ignore_errors=True)
    cfg = hf_config_of(dim=7168, hidden=18432, layers=61, heads=128, vocab=129280,
                       q_lora=1536, kv_lora=512, nope=128, rope=64, v_dim=128,
                       first_dense=3, n_experts=256, n_active=8, moe_inter=2048,
                       n_shared=1, v3=True, n_group=8, topk_group=4, init=0.006)
    written = dict(cfg, num_hidden_layers=2)     # the cut: layers 0 and 1 only
    t0 = time.perf_counter()
    tok = gpt2_tokenizer(cfg["vocab_size"], SEED + 90)
    in_bytes = write_hf_dir(os.path.join(root, "hf"), written, tok, SEED + 91, form="FP8",
                            n_files=2)
    set_hf_config(os.path.join(root, "hf"), num_hidden_layers=cfg["num_hidden_layers"])
    n_params = sum(math.prod(s) for _, s, _ in hf_tensor_specs(written))
    log(f"V3 conversion: HF input written in {time.perf_counter() - t0:.1f} s: "
        f"{n_params / 1e9:.3f} B parameters, {in_bytes / 1e9:.3f} GB of safetensors")
    out = os.path.join(root, "dseek")
    secs, peak, stdout = run_converter(out, os.path.join(root, "hf"),
                                       ["--mla", "--quant", "q2_k", "--n-layers", "2"],
                                       "V3 conversion")
    out_bytes = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    log(f"V3 conversion: --mla --quant q2_k --n-layers 2 on the card in {secs:.1f} s "
        f"({n_params / secs / 1e6:.1f} M weights/s), converter peak RSS "
        f"{peak / 1e9:.3f} GB beside {in_bytes / 1e9:.3f} GB of input, "
        f"{out_bytes / 1e9:.3f} GB written; {stdout.strip().splitlines()[0]} "
        f"({card_line()})")
    if "K-quant encoder: native" not in stdout:
        raise RuntimeError("V3 conversion: the converter did not use the native encoder")
    shutil.rmtree(os.path.join(root, "hf"))
    gen = torch.Generator().manual_seed(SEED + 92)
    eng = Engine(out, device="cuda", seed=0)
    prompt = torch.randint(2, cfg["vocab_size"], (V3_CONVERT_PROMPT,), generator=gen).tolist()
    (toks, _), launched = drive(
        counts, ("K9", "K5r-packed", "K5-packed", "K3"),
        "V3 conversion: Engine on the card",
        lambda: eng.generate(prompt, num_steps=V3_CONVERT_DECODE, temperature=0.0))
    runs["V3 conversion"] = launched
    log(f"V3 conversion: {V3_CONVERT_PROMPT}-token prompt, {V3_CONVERT_DECODE} greedy "
        f"tokens {toks}")
    short = prompt[:V3_CPU_PROMPT]
    # the CPU Engine over the card Engine's loaded weights (a second load
    # would repack every plane again on the host)
    ref = Engine.from_params(params_to(eng.params, "cpu"), eng.cfg, eng.tokenizer, seed=0,
                             prefill_chunk=V3_CPU_PROMPT)
    eng.prefill_chunk = V3_CPU_PROMPT
    caps, logits = {}, {}
    for name, e in (("card", eng), ("CPU", ref)):
        t0 = time.perf_counter()
        cache = e.new_cache()
        with debug.debug_capture() as cap:
            _, last, _, pos = e.hydrate(cache, short)
        rows = [np.asarray(last, np.float32).reshape(-1)]
        for i in range(V3_CPU_STEPS):
            t = int(np.argmax(logits["card"][i])) if name == "CPU" else int(np.argmax(rows[-1]))
            rows.append(e.step(cache, t, pos + i)[0].float().cpu().numpy())
        caps[name], logits[name] = cap, np.stack(rows)
        log(f"V3 conversion: {name} run of {V3_CPU_PROMPT} tokens + {V3_CPU_STEPS} steps "
            f"in {time.perf_counter() - t0:.1f} s")
    scale = float(np.abs(logits["CPU"]).max())
    err = float(np.abs(logits["card"] - logits["CPU"]).max())
    errs = caps["card"].max_err(caps["CPU"])
    log(f"V3 conversion: card vs CPU Engine logits max abs err {err:.3e} (tolerance "
        f"{1e-3 * scale:.3e}); debug capture max_err by name "
        f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} }")
    if not (np.isfinite(logits["card"]).all() and err <= 1e-3 * scale):
        raise RuntimeError("V3 conversion: the card's logits disagree with the CPU Engine's")
    if set(errs) != set(caps["CPU"].tensors) or not errs:
        raise RuntimeError("V3 conversion: the two captures hold other names")
    text = ("DeepSeek-V3 converted on the card: the quick brown fox jumps over the lazy "
            "dog, 0123456789 " * 40 + "héllo wörld 中文 ✓")
    tk = eng.tokenizer
    py = copy.copy(tk)
    py._native = None
    if tk._native is None or tk.encode(text, bos=True) != py.encode(text, bos=True):
        raise RuntimeError("V3 conversion: the native tokenizer disagrees with the Python one")
    log(f"V3 conversion: the native tokenizer encodes {len(text.encode())} bytes as the "
        f"Python one does ({len(tk.encode(text))} tokens of a {tk.vocab_size}-token vocab)")
    del eng, ref
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    log(f"V3 conversion phase: {time.perf_counter() - t_phase:.1f} s")


def v2_convert_phase(counts, runs):
    """(c) DeepSeek-V2-Lite's published widths (config.json of
    deepseek-ai/DeepSeek-V2-Lite) cut to 2 layers (the dense one and one
    MoE layer of 64 routed + 2 shared experts), BF16 as released, ~1.1 B
    parameters: converted on the card in process at the default (fp16,
    MHA) and at --quant f8e5m2 --bsize 128; Engine(device="cuda") on each
    against the CPU Engine over a 300-token prompt and 8 greedy steps
    (logits within 1e-3 of their scale). Its FFN widths (1408, 10944) are
    no multiples of 256, so no K-quant form exists: the converter raises."""
    from deepseek_tpu_torch.convert import convert
    from deepseek_tpu_torch.engine import Engine

    t_phase = time.perf_counter()
    root = os.path.join(CONVERT_DIR, "v2")
    shutil.rmtree(root, ignore_errors=True)
    cfg = hf_config_of(dim=2048, hidden=10944, layers=27, heads=16, vocab=102400,
                       q_lora=0, kv_lora=512, nope=128, rope=64, v_dim=128, first_dense=1,
                       n_experts=64, n_active=6, moe_inter=1408, n_shared=2, v3=False,
                       mscale=0.707, init=0.02)
    written = dict(cfg, num_hidden_layers=2)
    hf = os.path.join(root, "hf")
    tok = byte_tokenizer(cfg["vocab_size"])
    in_bytes = write_hf_dir(hf, written, tok, SEED + 95, form="BF16")
    set_hf_config(hf, num_hidden_layers=cfg["num_hidden_layers"])
    n_params = sum(math.prod(s) for _, s, _ in hf_tensor_specs(written))
    gen = torch.Generator().manual_seed(SEED + 96)
    prompt = torch.randint(3, cfg["vocab_size"], (V2_CONVERT_PROMPT,), generator=gen).tolist()
    for label, kw in (("fp16 MHA", {}), ("f8e5m2 --bsize 128", dict(quant="f8e5m2",
                                                                   bsize=128))):
        out = os.path.join(root, label.split()[0])
        t0 = time.perf_counter()
        convert(hf, out, n_layers=2, device="cuda", **kw)
        secs = time.perf_counter() - t0
        out_bytes = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
        log(f"V2-Lite conversion {label}: {n_params / 1e9:.3f} B parameters "
            f"({in_bytes / 1e9:.3f} GB BF16) in {secs:.1f} s on the card in process "
            f"({n_params / secs / 1e6:.1f} M weights/s), {out_bytes / 1e9:.3f} GB written")
        eng = Engine(out, device="cuda", seed=0, decode_block=1)
        ref = Engine(out, device="cpu", seed=0, decode_block=1)
        rows = {}
        for name, e in (("card", eng), ("CPU", ref)):
            def run(e=e, name=name):
                cache = e.new_cache()
                _, last, _, pos = e.hydrate(cache, prompt)
                out_rows = [np.asarray(last, np.float32).reshape(-1)]
                for i in range(V2_CONVERT_STEPS):
                    src = rows["card"] if name == "CPU" else out_rows
                    t = int(np.argmax(src[i]))
                    out_rows.append(e.step(cache, t, pos + i)[0].float().cpu().numpy())
                return np.stack(out_rows)
            if name == "card":
                rows[name], runs[f"V2-Lite conversion {label}"] = drive(
                    counts, ("K9", "K8"), f"V2-Lite conversion {label}: Engine on the card",
                    run)
            else:
                rows[name] = run()
        scale = float(np.abs(rows["CPU"]).max())
        err = float(np.abs(rows["card"] - rows["CPU"]).max())
        log(f"V2-Lite conversion {label}: card vs CPU Engine over {V2_CONVERT_PROMPT} "
            f"tokens and {V2_CONVERT_STEPS} steps, logits max abs err {err:.3e} "
            f"(tolerance {1e-3 * scale:.3e})")
        if not (np.isfinite(rows["card"]).all() and err <= 1e-3 * scale):
            raise RuntimeError(f"V2-Lite conversion {label}: logits disagree with the CPU")
        del eng, ref
        torch.cuda.empty_cache()
    try:
        convert(hf, os.path.join(root, "q2_k"), quant="q2_k", n_layers=2, device="cuda")
    except ValueError as exc:
        log(f"V2-Lite conversion --quant q2_k raises, as the JAX converter does: {exc}")
    else:
        raise RuntimeError("V2-Lite conversion --quant q2_k did not raise")
    shutil.rmtree(root)
    log(f"V2-Lite conversion phase: {time.perf_counter() - t_phase:.1f} s")


def conversion_phase(counts, runs):
    """Phase 13: the converter, (a) tiny directories, (b) V3's widths to
    Q2_K, (c) V2-Lite's widths to fp16 and f8e5m2; prints its seconds."""
    t0 = time.perf_counter()
    os.makedirs(CONVERT_DIR, exist_ok=True)
    try:
        tiny_convert_phase(counts, runs)
        v3_convert_phase(counts, runs)
        v2_convert_phase(counts, runs)
    finally:
        shutil.rmtree(CONVERT_DIR, ignore_errors=True)
    log(f"conversion phase: {time.perf_counter() - t0:.1f} s ({card_line()})")


def spilling_kernels(logs, names):
    """The entry functions among ``names`` (substrings of the mangled
    names) whose ptxas -v lines report spill stores or loads."""
    bad, fn = [], None
    for text in logs.values():
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
            elif "spill stores" in line and fn and any(k in fn for k in names):
                stores, loads = (int(w) for w in re.findall(r"(\d+) bytes spill", line))
                if stores or loads:
                    bad.append(fn)
    return bad


def counters():
    from deepseek_tpu_torch.ops.kernels.attention import (
        mha_decode_attn, mla_decode_attn)
    from deepseek_tpu_torch.ops.kernels.prefill_attn import (
        mha_prefill_attn, mla_prefill_attn)
    from deepseek_tpu_torch.ops.kernels.qmm import (
        gmm, qmm, qmm_experts, qmm_experts_fp, qmm_experts_fp8,
        qmm_experts_packed, qmm_experts_turbo, qmm_fp, qmm_fp8, qmm_fp8_rows,
        qmm_grouped, qmm_grouped_fp8, qmm_grouped_packed, qmm_grouped_turbo,
        qmm_packed, qmm_packed_rows, qmm_rows, qmm_turbo, qmm_turbo_rows,
        qmm_expert_ffn)
    return {"K1": qmm, "K1r": qmm_rows, "K2": qmm_experts, "K2f": qmm_experts_fp,
            "K3": mla_decode_attn, "K4": qmm_fp, "K6": qmm_grouped,
            "K8": mha_decode_attn, "K9": mha_prefill_attn,
            "K10": mla_prefill_attn, "K11": gmm, "K5": qmm_fp8,
            "K5r": qmm_fp8_rows, "K2-fp8": qmm_experts_fp8,
            "K6-fp8": qmm_grouped_fp8, "K5-packed": qmm_packed,
            "K5r-packed": qmm_packed_rows, "K2-packed": qmm_experts_packed,
            "K6-packed": qmm_grouped_packed, "K5-turbo": qmm_turbo,
            "K5r-turbo": qmm_turbo_rows, "K2-turbo": qmm_experts_turbo,
            "K6-turbo": qmm_grouped_turbo,
            # the int8-cache bodies count apart from the float ones
            "K3-int8": mla_decode_attn.int8, "K8-int8": mha_decode_attn.int8,
            "K9-int8": mha_prefill_attn.int8, "K10-int8": mla_prefill_attn.int8,
            # among the float ones, the bodies over f16 and f32 caches
            "K9-f16": mha_prefill_attn.f16, "K9-f32": mha_prefill_attn.f32,
            "K10-f16": mla_prefill_attn.f16, "K10-f32": mla_prefill_attn.f32,
            "K3-f16": mla_decode_attn.f16, "K3-f32": mla_decode_attn.f32,
            # the fused expert FFN, and the bodies that take h permuted
            "K7": qmm_expert_ffn, "K2-xperm": qmm_experts.prepermuted,
            "K6-xperm": qmm_grouped.prepermuted,
            # the partials bodies of the seq axis (float cache, int8 cache)
            "K3-part": mla_decode_attn.partials,
            "K3-part-int8": mla_decode_attn.partials.int8,
            "K8-part": mha_decode_attn.partials,
            "K8-part-int8": mha_decode_attn.partials.int8,
            "K9-part": mha_prefill_attn.partials,
            "K9-part-int8": mha_prefill_attn.partials.int8,
            "K10-part": mla_prefill_attn.partials,
            "K10-part-int8": mla_prefill_attn.partials.int8,
            # the launches with per-row chunk starts (verify mode)
            "K9-rows": mha_prefill_attn.per_row, "K10-rows": mla_prefill_attn.per_row}


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
    if os.environ.pop("DSEEK_FUSED_FFN", None) is not None:
        log("DSEEK_FUSED_FFN cleared: the fused FFN phase sets it for its own loads")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = t0 = time.perf_counter()
    # a fresh build, so that ptxas reports on every kernel of this checkout
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(build.SIGNATURES)}")
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"  ptxas {name}: {line.strip()}")
    spills = spilling_kernels(build.BUILD_LOGS, ("tile_gemm_kernel", "plain_matvec_kernel",
                                                 "fp8_mv_kernel"))
    if spills:
        raise RuntimeError(f"these instantiations spill: {spills}")
    time_ms.flush = torch.empty(128 * 2**20, dtype=torch.float32, device="cuda")
    counts = counters()
    runs = {"entry point": entry_point_phase(counts),
            "bf16 entry point": bf16_entry_point_phase(counts),
            "MHA entry point": mha_entry_point_phase(counts),
            "fp8 entry point": fp8_entry_point_phase(counts),
            "packed Q3_K entry point": kquant_entry_point_phase(counts, "q3_k",
                                                                sampled=True),
            "packed Q2_K entry point": kquant_entry_point_phase(counts, "q2_k"),
            "turbo Q3_K entry point": kquant_entry_point_phase(counts, "q3_k", "turbo"),
            "turbo Q2_K entry point": kquant_entry_point_phase(counts, "q2_k", "turbo"),
            "packed Q3_K entry point, int8 cache": kquant_entry_point_phase(
                counts, "q3_k", sampled=True, kv="int8"),
            "packed Q3_K entry point, float32 cache": kquant_entry_point_phase(
                counts, "q3_k", kv="float32"),
            "MHA entry point, int8 cache": mha_entry_point_phase(counts, kv="int8"),
            "fused FFN entry point": fused_entry_point_phase(counts)}
    # the CLI as a user runs it (subprocesses) at V2-Lite's widths, and MTP
    # speculation through it on a tiny V3-arch checkpoint
    cli_phase(counts, runs)
    mtp_cli_phase(counts, runs)
    tiny_serving_phase(counts, runs)

    cfg = deepseek_v3_proportions(n_layers=4)
    t0 = time.perf_counter()
    params = random_fused_params(cfg, "q3_k_nibble", seed=SEED, device="cuda",
                                 factors=True)
    torch.cuda.synchronize()
    log(f"full width: random nibble model (with wq_b/wkv_b) built on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    runs["full-width decode"], _ = full_width_phase(params, cfg, counts)
    runs["full-width prefill"], _ = prefill_phase(params, cfg, counts)

    log("kernels (each against its plain version on the card):")
    entries = []
    kernel_phase(params, cfg, entries)
    permuted_phase(params, cfg, counts, entries, runs)
    del params
    torch.cuda.empty_cache()

    # the same model in the packed Q3_K and Q2_K layouts (the default
    # K-quant runtime): decode, prefill, then the packed bodies at its shapes
    for quant in ("q3_k", "q2_k"):
        label = f"packed {quant.upper()}"
        t0 = time.perf_counter()
        params = random_fused_params(cfg, quant, seed=SEED, device="cuda", factors=True,
                                     mtp=quant == "q3_k")
        torch.cuda.synchronize()
        log(f"full width: random {label} model (with wq_b/wkv_b), "
            f"{weight_bytes(params) / 1e9:.3f} GB of planes and scales, built on "
            f"the card in {time.perf_counter() - t0:.1f} s")
        dec, pre = f"full-width {label} decode", f"full-width {label} prefill"
        runs[dec], _ = full_width_phase(params, cfg, counts, label,
                                        ("K5-packed", "K2-packed", "K3"))
        runs[pre], _ = prefill_phase(
            params, cfg, counts, label, ("K5-packed", "K5r-packed", "K2-packed",
                                         "K3", "K6-packed", "K9", "K10"))
        if quant == "q3_k":
            decode_block_phase(params, cfg, label)
            int8_cache_phase(params, cfg, counts, label, runs)
            spec_rounds_phase(params, cfg, counts, runs)
            sched, _ = serving_phase(params, cfg, counts, runs)
            log(f"kernels at the serving batch's shapes, {label} (each against its plain "
                f"version on the card):")
            serving_kernel_entries(sched, cfg, entries, f"V3 {label} serving",
                                   f"V3 {label} serving ngram")
            del sched
        log(f"kernels, {label} (each against its plain version on the card):")
        packed_kernel_entries(params, cfg, quant, entries, dec, pre)
        del params
        torch.cuda.empty_cache()

    # the same draws converted to the int8 turbo layout (Q2_K turbo folds
    # the shared expert into its tables): decode, prefill, then the turbo
    # bodies at its shapes beside packed and nibble K5/K1 on one w13
    for quant in ("q3_k", "q2_k"):
        label = f"turbo {quant.upper()}"
        t0 = time.perf_counter()
        params = random_fused_params(cfg, quant + "_turbo", seed=SEED, device="cuda",
                                     factors=True)
        torch.cuda.synchronize()
        log(f"full width: random {label} model (with wq_b/wkv_b), "
            f"{weight_bytes(params) / 1e9:.3f} GB of planes and scales, built on "
            f"the card in {time.perf_counter() - t0:.1f} s")
        dec, pre = f"full-width {label} decode", f"full-width {label} prefill"
        runs[dec], _ = full_width_phase(params, cfg, counts, label,
                                        ("K5-turbo", "K2-turbo", "K3"))
        runs[pre], _ = prefill_phase(
            params, cfg, counts, label, ("K5-turbo", "K5r-turbo", "K2-turbo",
                                         "K3", "K6-turbo", "K9", "K10"))
        log(f"kernels, {label} (each against its plain version on the card):")
        turbo_kernel_entries(params, cfg, quant, entries, dec, pre)
        del params
        torch.cuda.empty_cache()

    runs["V2-Lite"], v2_params, v2_cfg, rates = v2_lite_phase(counts)
    runs["V2-Lite int8"], rates8 = v2_lite_run(
        "V2-Lite int8 cache", v2_params, dataclasses.replace(v2_cfg, kv_cache_dtype="int8"),
        counts, ("K9-int8", "K11"), ("K2f", "K4", "K8-int8"))
    log(f"V2-Lite, one call: prefill {rates[0]:.1f} tok/s with the {v2_cfg.kv_cache_dtype} "
        f"cache, {rates8[0]:.1f} with the int8 cache; decode {rates[1]:.2f} / "
        f"{rates8[1]:.2f} tok/s")
    runs["window edge"] = cpu_cut_phase(
        "window edge", v2_params, v2_cfg, counts, v2_cfg.kv_window,
        ("K8", "K9", "K9-f16", "K11", "K4", "K2f"))
    runs["window edge int8"] = cpu_cut_phase(
        "window edge, int8 cache", v2_params, v2_cfg, counts, v2_cfg.kv_window,
        ("K8-int8", "K9-int8", "K11", "K4", "K2f"), kv_cache_dtype="int8")
    del v2_params
    torch.cuda.empty_cache()
    runs["V2-Lite fp8"], v2_params, v2_cfg = v2_lite_fp8_phase(counts)
    runs["V2-Lite fp8 cut"] = cpu_cut_phase(
        "V2-Lite fp8 cut", v2_params, v2_cfg, counts, FP8_CUT_PROMPT,
        ("K5", "K5r", "K2-fp8", "K6-fp8", "K8", "K9"))
    del v2_params
    torch.cuda.empty_cache()
    # the seq mesh axis: two ranks share the card (the parent holds no model)
    seq_phase(counts, runs)
    log("kernels, the partials bodies at the shards' shapes (each against its "
        "plain version on the card):")
    partials_kernel_entries(entries)
    # the tensor and expert axes: ranks share the card (the parent holds no
    # model), then each kernel at the local shapes of the mesh paths
    mesh_phase(counts, runs)
    log("kernels at the mesh ranks' local shapes (each against its plain version "
        "on the card):")
    mesh_kernel_entries(entries)
    session_phase(counts, runs)
    # the data axis: continuous batching over data meshes (ranks share the
    # card; the parent holds no model), then the kernels at a data shard's
    # shapes; then pipeline stages
    data_serving_phase(counts, runs)
    verify_chunk_phase(counts, runs)
    log("kernels at a data shard's shapes (each against its plain version on the card):")
    data_kernel_entries(entries)
    pipeline_phase(counts, runs)
    multihost_phase()
    conversion_phase(counts, runs)
    # each kernel's launches come from the run of the path it serves
    path_of = {"K1": "full-width decode", "K2": "full-width decode",
               "K3": "full-width decode", "K1r": "full-width prefill",
               "K6": "full-width prefill", "K9": "full-width prefill",
               "K10": "full-width prefill", "K2f": "bf16 entry point",
               "K11": "bf16 entry point", "K4": "V2-Lite", "K8": "V2-Lite",
               "K5": "V2-Lite fp8", "K5r": "V2-Lite fp8",
               "K2-fp8": "V2-Lite fp8", "K6-fp8": "V2-Lite fp8",
               "K3-int8": "full-width packed Q3_K int8 decode",
               "K10-int8": "full-width packed Q3_K int8 prefill",
               "K8-int8": "V2-Lite int8", "K9-int8": "V2-Lite int8",
               # the two-term bodies: the paths that run them (f32 compute
               # casts the hybrid prefill's keys and values to f32; the
               # Engine's default cache is f16)
               "K9-f32": "bf16 entry point", "K9-f16": "window edge",
               "K10-f16": "entry point", "K3-f16": "entry point",
               "K10-f32": "packed Q3_K entry point, float32 cache",
               "K3-f32": "packed Q3_K entry point, float32 cache"}
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    return finish(card, entries, runs, path_of)


def finish(card, entries, runs, path_of) -> int:
    """Each entry's launches from the run of the path it serves, then the
    kernels line, the card line and the result line."""
    for e in entries:
        kernel, path = e.pop("kernel"), e.pop("path")
        e["launches"] = runs[path or path_of[kernel]][kernel]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
