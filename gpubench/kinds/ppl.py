"""Perplexity scoring through ``Engine.perplexity``: documents of random
token ids, one KV window each, back to back.

Traffic keys: ``doc_tokens``, ``prefill_chunk``, ``trace_seconds`` (how long
the traced run profiles whole documents right after its window)
and ``check_docs`` (documents the reference scores after the window).
The window runs whole documents: it closes when the first document to end
after ``--seconds`` ends, and the rate is over all of it. The router log
(``trace.RouteLog``) keeps every chunk's experts, for the reference's ties
and the traced run's distinct experts.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from gpubench import stats, work
from gpubench.trace import Profile, RouteLog, span

FIRST_ID = 259


def make_doc(seed: int, i: int, n: int, vocab: int):
    """Document i of the seed's stream (i = -1: the warm-up document)."""
    rng = np.random.default_rng([int(seed), 3, i + 1])
    return rng.integers(FIRST_ID, vocab, n).tolist()


def doc_routes(routes: RouteLog, j: int, n: int, n_moe: int, chunk: int) -> np.ndarray:
    """The program's experts (n, MoE layers, k) over document j of the
    window (-1 where none was logged): its calls in order, a chunk's MoE
    layers one after another."""
    calls = [c for c, (_, _, _, tag) in enumerate(routes.calls) if tag == ("doc", j)]
    k = routes.calls[calls[0]][2] if calls else 1
    out = np.full((n, n_moe, k), -1, dtype=np.int64)
    for ci, c in enumerate(calls):
        pos0 = (ci // n_moe) * chunk
        e = routes.experts(c)[:max(0, n - pos0)]
        out[pos0:pos0 + len(e), ci % n_moe] = e
    return out


def run(ctx) -> dict:
    from gpubench.model import port_engine

    tr, dev = ctx.traffic, ctx.device
    n = tr["doc_tokens"]
    eng, cfg = port_engine(ctx.spec, ctx.seed, dev, tr["prefill_chunk"], times=ctx.setup)
    ctx.mark("weights_and_engine")
    captured = []
    hydrate = eng.hydrate

    def capture(*args, **kw):
        out = hydrate(*args, **kw)
        captured.append(out[2])
        return out
    eng.hydrate = capture
    eng.perplexity(make_doc(ctx.seed, -1, n, cfg.vocab_size))      # every shape once
    captured.clear()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctx.mark("warmup")

    docs = []
    shapes = work.Shapes.of(ctx.spec)
    n_moe = len(shapes.moe_layers)
    routes = RouteLog(dev).install()
    prof = Profile() if ctx.trace else None
    t0 = time.perf_counter()
    i, ends = 0, []
    while time.perf_counter() < t0 + ctx.seconds:
        doc = make_doc(ctx.seed, i, n, cfg.vocab_size)
        routes.tag = ("doc", i)
        ppl, err, scored = eng.perplexity(doc)
        docs.append((doc, ppl, scored))
        ends.append(time.perf_counter())
        i += 1
    t1 = time.perf_counter()
    record = {"platform": dev.type}
    if prof:
        # whole documents right after the window, under the profiler; the
        # router log gives the distinct experts of each chunk
        c0 = len(routes.calls)
        prof.start()
        traced_docs, t = 0, time.perf_counter()
        while traced_docs == 0 or time.perf_counter() < t + tr["trace_seconds"]:
            routes.tag = ("traced", traced_docs)
            with span("perplexity_doc", True):
                eng.perplexity(make_doc(ctx.seed, i + traced_docs, n, cfg.vocab_size))
            traced_docs += 1
        prof.stop()
        distinct = [routes.distinct(c) for c in range(c0, len(routes.calls))]
        C = tr["prefill_chunk"]
        least, g = 0.0, 0
        for _ in range(traced_docs):
            for pos0 in range(0, n, C):
                r = min(C, n - pos0)
                d = distinct[g:g + n_moe]
                g += n_moe
                f, b = work.step_work(shapes, r, pos0 + r, r * pos0 + r * (r + 1) // 2, d, r)
                least += work.least_seconds(f, b)
        summary = prof.summary(ctx.log)
        record.update(trace=summary, least_s=least)
        ctx.log(f"traced {summary['window_s']:.3f} s, {traced_docs} documents; distinct routed "
                f"experts a MoE layer a chunk: mean {np.mean(distinct[:g]) if g else float('nan'):.1f}")
    tokens = len(docs) * n
    ctx.log(f"window {t1 - t0:.3f} s, {len(docs)} documents of {n} tokens, "
            f"perplexity of the first {docs[0][1] if docs else None}")
    metrics = {"prefill_tok_s": stats.rate(tokens, t1 - t0)}
    half = len(docs) // 2
    if half:
        ctx.log(f"prefill_tok_s over the window's halves {stats.rate(half * n, ends[half - 1] - t0)}"
                f" / {stats.rate((len(docs) - half) * n, t1 - ends[half - 1])}")
    lps = captured
    failed = sum(1 for (doc, ppl, scored), lp in zip(docs, lps)
                 if scored != n - 1 or lp is None or not np.all(np.isfinite(lp[:n - 1])))
    peak = ctx.memory_peak()

    rng = np.random.default_rng([int(ctx.seed), 4])
    pick = sorted(rng.choice(len(docs), size=min(len(docs), tr["check_docs"]), replace=False))
    scored = [(docs[j][0], np.asarray(lps[j][:n - 1], dtype=np.float64),
               doc_routes(routes, j, n, n_moe, tr["prefill_chunk"])) for j in pick]
    routes.uninstall()
    del eng, captured, lps, docs, routes
    gc.collect()
    ctx.free()
    return {"metrics": metrics, "record": record, "t0": t0, "attempted": i, "failed": failed,
            "memory_peak_bytes": peak, "scored": scored}
