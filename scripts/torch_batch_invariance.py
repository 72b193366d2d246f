"""Batch invariance of the port's decode step on one NVIDIA GPU.

A serving batch decodes a sequence in one row of a batch of B beside other
live sequences; the single-sequence route (Engine.generate, Engine.step)
decodes it alone. This script builds DeepSeek-V3's widths (4 layers, the
packed Q3_K random draw, f32 compute, no factor weights: chip_smoke.py's
serving model), hydrates four prompts into 1-row caches, merges them into a
batch of 4, and then

1. holds single ops at the batch's shapes against the same row alone:
   rmsnorm (of the q_a slice of wkvq and of a hidden row), K3 (mla_decode_attn) on the same query
   and cache rows, the MoE router product, the combine of 8 pairs and
   log_softmax, each as row 0 of a batch of 4 against a batch of 1
   (bit-equal or the max abs difference);
2. traces one decode step of the batch: each module function of
   models/deepseek.py that it calls (``TRACED``) is called again on its
   arguments' first rows, and the ops whose row 0 differs from that are
   named with their count of such calls and the max abs difference;
3. decodes ``--steps`` greedy steps both ways (row 0 fed the alone run's
   tokens, the other rows their own) and prints, each step, the max
   |logits difference| over the logit scale and the difference of the
   fed token's log-softmax; the same alone twice (run-to-run); and the
   MoE routing of row 0 (whether its experts ever differ, and the least
   gap between the 8th and 9th biased score);

as the package is and with each batch-dependent behaviour it had before
(``RESTORE``: monkeypatches, undone after) restored. Prints one JSON line
with the readings last.

    python scripts/torch_batch_invariance.py [--steps 24]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 0
PROMPTS = (140, 300, 64, 20)       # row 0 takes the first


def log(*a):
    print(*a, flush=True)


def row_diff(a, b):
    """(bit-equal, max abs difference) of two tensors or tuples of them."""
    if isinstance(a, tuple):
        eq = all(row_diff(x, y)[0] for x, y in zip(a, b))
        return eq, max(row_diff(x, y)[1] for x, y in zip(a, b))
    if a.dtype in (torch.int64, torch.int32, torch.bool):
        return torch.equal(a, b), float((a != b).sum())
    return torch.equal(a, b), float((a.float() - b.float()).abs().max())


def clone_cache(cache):
    return dataclasses.replace(cache, **{
        f.name: getattr(cache, f.name).clone() for f in dataclasses.fields(cache)
        if isinstance(getattr(cache, f.name), torch.Tensor)})


# ---------------------------------------------------------------------------
# variants: each restores one batch-dependent behaviour the decode step had
# before it was made batch-invariant (a context that patches the package
# and undoes it)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def batch_rows_rmsnorm():
    """rmsnorm reducing the call's own rows (torch's threads per row then
    follow the row count)."""
    from deepseek_tpu_torch.models import deepseek as ds

    def rmsnorm(x, weight, eps):
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        return (y * weight.float()).to(x.dtype)
    return patched(ds, "rmsnorm", rmsnorm)


def k3_batch_splits():
    """K3's spans as the batch's blocks fill the SMs (fewer, longer spans
    for a larger batch)."""
    from deepseek_tpu_torch.ops.kernels import attention as at

    def splits(B, H, S):
        blocks = B * -(-H // at._DECODE_ROWS)
        chunks = -(-S // at._DECODE_SPAN_ALIGN)
        n = max(1, min(-(-at._DECODE_FILL_BLOCKS // blocks), chunks,
                       at._MAX_DECODE_SPLITS))
        span = -(-chunks // n) * at._DECODE_SPAN_ALIGN
        return -(-S // span), span
    return patched(at, "mla_decode_splits", splits)


def batch_rows_router():
    """The router product at the call's own row count."""
    from deepseek_tpu_torch.models import deepseek as ds
    return patched(ds, "_router_logits",
                   lambda xb, gate: torch.matmul(xb.float(), gate.float().t()))


def index_add_combine():
    """The pairs' outputs added into their tokens' rows by index_add_
    (atomic adds in the sorted pairs' order)."""
    from deepseek_tpu_torch.models import deepseek as ds

    def combine(per, weights, pair, n_tokens, k):
        out = per.new_zeros((n_tokens, per.shape[-1]))
        return out.index_add_(0, pair // k, per * weights[:, None])
    return patched(ds, "combine_pairs", combine)


RESTORE = {"rmsnorm at the batch's rows": batch_rows_rmsnorm,
           "K3 spans of the batch": k3_batch_splits,
           "router product at the batch's rows": batch_rows_router,
           "index_add_ combine": index_add_combine}
VARIANTS = {"as is": [], **{k: [v] for k, v in RESTORE.items()},
            "all four restored": list(RESTORE.values())}


@contextlib.contextmanager
def variant(name):
    with contextlib.ExitStack() as st:
        for make in VARIANTS[name]:
            st.enter_context(make())
        yield


# ---------------------------------------------------------------------------
# 1. single ops
# ---------------------------------------------------------------------------

def op_checks(params, cfg, gen):
    from deepseek_tpu_torch.models import deepseek as ds
    from deepseek_tpu_torch.ops.kernels.attention import mla_decode_attn

    out = {}
    H, R, P, S = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.kv_window
    qc = torch.randn((4, H, R), generator=gen, device="cuda")
    qr = torch.randn((4, H, P), generator=gen, device="cuda")
    ckv = torch.randn((4, S, R), generator=gen, device="cuda")
    kr = torch.randn((4, S, P), generator=gen, device="cuda")
    kl = torch.tensor([300, 37, 2500, S], dtype=torch.int32, device="cuda")
    sc = cfg.attn_softmax_scale()
    moe = params.layers[cfg.n_layers - 1]
    x = torch.randn((4, 1, cfg.dim), generator=gen, device="cuda")
    wide = torch.randn((4, 1, 2112), generator=gen, device="cuda")
    w = torch.rand(1536, generator=gen, device="cuda")
    wd = torch.rand(cfg.dim, generator=gen, device="cuda")
    k, E = cfg.n_active_routed, cfg.n_routed_experts
    ids = torch.stack([torch.randperm(E, generator=gen, device="cuda")[:k]
                       for _ in range(4)])
    wts = torch.rand((4, k), generator=gen, device="cuda")
    per = torch.randn((4 * k, cfg.dim), generator=gen, device="cuda")

    def pairs(B):
        from deepseek_tpu_torch.ops.matmul import dispatch_pairs
        e, wt, _, pair = dispatch_pairs(ids[:B], wts[:B])
        # each pair's output row is the one its (token, slot) owns
        return e, wt, pair, per[:B * k][pair]
    for name in ("as is", *RESTORE):
        with variant(name):
            r1 = ds.rmsnorm(wide[:1, :, 576:], w, 1e-6)[0]
            r4 = ds.rmsnorm(wide[:, :, 576:], w, 1e-6)[0]
            h1 = ds.rmsnorm(x[:1], wd, 1e-6)[0]
            h4 = ds.rmsnorm(x, wd, 1e-6)[0]
            a = mla_decode_attn(qc[:1], qr[:1], ckv[:1], kr[:1], kl[:1], sc)[0]
            b = mla_decode_attn(qc, qr, ckv, kr, kl, sc)[0]
            g1 = ds._router_logits(x[:1], moe.moegate)[0]
            g4 = ds._router_logits(x, moe.moegate)[0]
            _, wt1, p1, v1 = pairs(1)
            _, wt4, p4, v4 = pairs(4)
            c1 = ds.combine_pairs(v1, wt1, p1, 1, k)[0]
            c4 = ds.combine_pairs(v4, wt4, p4, 4, k)[0]
        out[f"[{name}] rmsnorm of the q_a slice"] = row_diff(r1, r4)
        out[f"[{name}] rmsnorm of a hidden row"] = row_diff(h1, h4)
        out[f"[{name}] K3"] = row_diff(a, b)
        out[f"[{name}] router product"] = row_diff(g1, g4)
        out[f"[{name}] combine of 8 pairs"] = row_diff(c1, c4)
    z = torch.randn((4, cfg.vocab_size), generator=gen, device="cuda") * 30
    out["log_softmax"] = row_diff(torch.log_softmax(z[:1], -1)[0],
                                  torch.log_softmax(z, -1)[0])
    for key, (eq, d) in out.items():
        log(f"op, row 0 of 4 against alone: {key}: "
            f"{'bit-equal' if eq else f'max abs diff {d:.3e}'}")
    return {key: d for key, (eq, d) in out.items()}


# ---------------------------------------------------------------------------
# 2. the op trace of one step
# ---------------------------------------------------------------------------

TRACED = ("embed_lookup", "rmsnorm", "qmatmul", "apply_rope", "mla_decode_attn",
          "per_head_up", "_router_logits", "moe_gate", "_pair_ffn")


def first_row(a, B):
    """An argument of a batch call cut to its first row (the decode
    step of that sequence alone: no live mask)."""
    from deepseek_tpu_torch.ops.matmul import LiveRows
    if isinstance(a, LiveRows):
        return None
    if isinstance(a, torch.Tensor) and a.dim() > 0 and a.shape[0] == B:
        return a[:1]
    return a


def trace_step(params, cfg, cache, tok, pos, label):
    """One decode step of the batch with each TRACED function of
    models/deepseek.py also called on its arguments' first rows: the ops
    whose row-0 output differs from the same row alone, with the count
    of such calls and the max abs difference."""
    from deepseek_tpu_torch.models import deepseek as ds

    B = tok.shape[0]
    found, calls = {}, {}

    def row0(t):
        if isinstance(t, tuple):
            return tuple(row0(u) for u in t)
        return t[:1]

    def wrap(name, fn):
        def w(*a, **kw):
            y = fn(*a, **kw)
            y1 = fn(*[first_row(v, B) for v in a],
                    **{k: first_row(v, B) for k, v in kw.items()})
            eq, d = row_diff(row0(y), y1)
            calls[name] = calls.get(name, 0) + 1
            if not eq:
                n, m = found.get(name, (0, 0.0))
                found[name] = (n + 1, max(m, d))
            return y
        return w

    with contextlib.ExitStack() as st:
        for name in TRACED:
            st.enter_context(patched(ds, name, wrap(name, getattr(ds, name))))
        with torch.inference_mode():
            ds.forward_decode(params, clone_cache(cache), tok, pos, cfg,
                              active=np.ones(B, bool))
    log(f"trace [{label}]: ops whose row 0 in the batch of {B} differs from the row "
        f"alone on the same inputs: " + (", ".join(
            f"{k} ({n} of {calls[k]} calls, max abs diff {m:.3e})"
            for k, (n, m) in found.items()) or "none") +
        f"; calls {calls}")
    return {k: {"calls": n, "of": calls[k], "max_abs_diff": m}
            for k, (n, m) in found.items()}


# ---------------------------------------------------------------------------
# 3. greedy steps, alone and in the batch
# ---------------------------------------------------------------------------

def gate_watch(cfg, store):
    """moe_gate recording row 0's experts and its 8th-9th biased gap."""
    from deepseek_tpu_torch.models import deepseek as ds
    orig = ds.moe_gate
    k = cfg.n_active_routed

    def g(logits, bias, c):
        w, idx = orig(logits, bias, c)
        s = torch.sigmoid(logits[0, -1].float()) + (bias.float() if bias is not None else 0)
        top = torch.topk(s, k + 1).values
        store.append((idx[0, -1].sort().values.clone(), float(top[k - 1] - top[k])))
        return w, idx
    return patched(ds, "moe_gate", g)


def greedy_pair(params, cfg, alone, batch, first, pos, steps):
    """Row 0 decoded alone and in the batch for ``steps`` greedy steps,
    both fed the alone run's tokens: (rel diffs, logprob diffs, routing)."""
    from deepseek_tpu_torch.models.deepseek import forward_decode

    B = batch.batch
    c1, cB = clone_cache(alone), clone_cache(batch)
    t1 = torch.tensor([[first[0]]], device="cuda")
    tB = torch.tensor([[t] for t in first], device="cuda")
    p = pos.copy()
    rel, lp, g1, gB = [], [], [], []
    with torch.inference_mode():
        for _ in range(steps):
            with gate_watch(cfg, g1):
                l1 = forward_decode(params, c1, t1, int(p[0]), cfg)
            with gate_watch(cfg, gB):
                lB = forward_decode(params, cB, tB, p, cfg, active=np.ones(B, bool))
            nxt = l1[0].argmax()
            scale = float(l1.abs().max())
            rel.append(float((l1[0] - lB[0]).abs().max()) / scale)
            s1 = torch.log_softmax(l1[0].double(), -1)[nxt]
            sB = torch.log_softmax(lB[0].double(), -1)[nxt]
            lp.append(abs(float(s1 - sB)))
            t1 = nxt.reshape(1, 1)
            tB = lB.argmax(-1, keepdim=True)
            tB[0, 0] = nxt
            p += 1
    same = all(torch.equal(a[0], b[0]) for a, b in zip(g1, gB))
    gap = min(a[1] for a in g1)
    return rel, lp, same, gap


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_batch_invariance: no CUDA GPU visible", file=sys.stderr)
        return 2
    from deepseek_tpu_torch.engine import hydrate_cache
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.models.testing import (
        deepseek_v3_proportions, random_fused_params)
    from deepseek_tpu_torch.serving import merge_row

    torch.backends.cuda.matmul.allow_tf32 = False
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(deepseek_v3_proportions(n_layers=4), compute_dtype="float32")
    params = random_fused_params(cfg, "q3_k", seed=SEED, device="cuda")
    log(f"V3 widths, 4 layers, packed Q3_K, f32 compute: built in "
        f"{time.perf_counter() - t0:.1f} s; cache dtype "
        f"{init_cache(cfg, device='cuda').ckv.dtype}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    res = {"card": card, "ops": op_checks(params, cfg, gen)}

    rng = np.random.default_rng(SEED + 2)
    subs, first, pos = [], [], []
    for n in PROMPTS:
        prompt = [int(v) for v in rng.integers(3, cfg.vocab_size, n)]
        c = init_cache(cfg, device="cuda")
        c, logits, _, p = hydrate_cache(params, cfg, c, prompt)
        subs.append(c)
        first.append(int(np.argmax(logits)))
        pos.append(p)
    batch = init_cache(cfg, batch=len(PROMPTS), device="cuda")
    for i, c in enumerate(subs):
        merge_row(batch, c, i)
    pos = np.array(pos, np.int64)
    toks = torch.tensor([[t] for t in first], device="cuda")
    res["trace"], res["steps"] = {}, {}
    for name in VARIANTS:
        with variant(name):
            res["trace"][name] = trace_step(params, cfg, batch, toks, pos, name)
            rel, lp, same, gap = greedy_pair(params, cfg, subs[0], batch, first, pos,
                                             args.steps)
        log(f"steps [{name}]: max |logits diff| / scale by step "
            f"{[f'{r:.1e}' for r in rel]}; logprob diff max {max(lp):.3e}; row 0's "
            f"experts {'the same' if same else 'differ'} alone and in the batch; least "
            f"8th-9th biased gap {gap:.3e}")
        res["steps"][name] = {"rel": rel, "logprob_max": max(lp), "same_experts": same,
                              "gap": gap}
    # run to run: alone twice
    rel, lp, _, _ = greedy_pair(params, cfg, subs[0], clone_cache(subs[0]), first[:1],
                                pos[:1], args.steps)
    log(f"steps [alone twice]: max rel {max(rel):.1e}, logprob diff max {max(lp):.3e}")
    res["alone_twice"] = {"rel_max": max(rel), "logprob_max": max(lp)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
