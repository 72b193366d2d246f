"""Continuous-batching serving through ``BatchScheduler.submit``/``step`` on
``Engine.from_params``: a closed loop of clients, each sending its next
request when the previous one completes.

Traffic keys: ``slots`` (the batch), ``clients``, ``prefill_chunk``,
``decode_block``, ``prefix_cache_mb``, ``prompt_tokens`` / ``output_tokens``
({"lo", "hi"}: log-uniform), ``mix`` (requests a round: every round holds the
same lengths, each at the same evenly spaced quantile, in an order drawn from
the seed, so every seed offers the same work), ``greedy_share``,
``temperature``, ``top_p``, ``lead_in_steps`` (scheduler steps run before the
window opens, so that it opens on a full batch), ``trace_seconds`` (how long
the traced run profiles steps right after its window) and ``check_requests``
(finished requests the reference scores after the window, the longest among
them).

Every run logs the experts the router chose for every row of every call
(``trace.RouteLog``), tagged with the request and positions, so that the
reference can follow the program's choice where the top-k is a rounding tie
(``reference/forward.py``); the traced run counts from the same log the
distinct experts each step read. A position the log misses fails the run
(``check.ROUTING``).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import List, Optional

import numpy as np
import torch

from gpubench import stats, work
from gpubench.trace import Profile, RouteLog, span

FIRST_ID = 259            # prompt ids above the special and byte tokens
POOL = 2048               # requests drawn a run: a window completes ~150 at most


@dataclasses.dataclass
class Rec:
    """One request's timeline on the host clock."""
    prompt: List[int]
    max_new: int
    greedy: bool
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    t_done: Optional[float] = None
    n_tokens: int = 0
    req: object = None


def quantile_lengths(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths log-uniform over [lo, hi], at evenly spaced quantiles."""
    q = (np.arange(n) + 0.5) / n
    return np.round(lo * (hi / lo) ** q).astype(np.int64)


def make_requests(traffic: dict, seed: int, vocab: int, n: int) -> List[Rec]:
    """The first n requests of the seed's stream: rounds of ``mix``
    requests, each round every prompt length, output length and sampling
    mode of the mix once, in orders drawn from the seed."""
    rng = np.random.default_rng([int(seed), 1])
    mix = traffic["mix"]
    pl = quantile_lengths(traffic["prompt_tokens"]["lo"], traffic["prompt_tokens"]["hi"], mix)
    ol = quantile_lengths(traffic["output_tokens"]["lo"], traffic["output_tokens"]["hi"], mix)
    greedy = np.arange(mix) < round(traffic["greedy_share"] * mix)
    out = []
    while len(out) < n:
        for p, o, g in zip(rng.permutation(pl), rng.permutation(ol), rng.permutation(greedy)):
            toks = rng.integers(FIRST_ID, vocab, int(p)).tolist()
            out.append(Rec(prompt=toks, max_new=int(o), greedy=bool(g)))
    return out[:n]


class Clock:
    """Token timestamps and the window's output count (and the count of its
    first half, ``half`` being the time it ends)."""

    def __init__(self):
        self.open = False
        self.window_tokens = self.half_tokens = 0
        self.half = 0.0

    def tap(self, rec: Rec):
        def on_token(token, piece):
            t = time.perf_counter()
            if rec.t_first is None:
                rec.t_first = t
            rec.t_last = t
            rec.n_tokens += 1
            if self.open:
                self.window_tokens += 1
                self.half_tokens += t < self.half
        return on_token


def run(ctx) -> dict:
    from deepseek_tpu_torch.serving import BatchScheduler, Request
    from gpubench.model import port_engine

    tr, dev = ctx.traffic, ctx.device
    eng, cfg = port_engine(ctx.spec, ctx.seed, dev, tr["prefill_chunk"], times=ctx.setup)
    ctx.mark("weights_and_engine")
    sched = BatchScheduler(eng, batch_size=tr["slots"], decode_block=tr["decode_block"],
                           prefix_cache_mb=tr["prefix_cache_mb"], logprobs=True)
    sched.warmup()
    hooks = _Hooks(ctx, sched, cfg)
    ctx.mark("warmup")

    pool = make_requests(tr, ctx.seed, cfg.vocab_size, POOL)
    nxt = iter(pool)
    clock = Clock()
    live: List[Rec] = []
    done: List[Rec] = []

    def submit():
        rec = next(nxt)
        rec.req = Request(prompt_tokens=rec.prompt, max_new_tokens=rec.max_new,
                          temperature=0.0 if rec.greedy else tr["temperature"],
                          top_p=tr["top_p"], logprobs=True)
        rec.req.on_token = clock.tap(rec)
        rec.t_submit = time.perf_counter()
        sched.submit(rec.req)
        live.append(rec)

    def reap():
        """Completed requests out, each client's next request in."""
        for rec in [r for r in live if r.req.done]:
            rec.t_done = rec.t_last
            live.remove(rec)
            done.append(rec)
            submit()

    for _ in range(tr["clients"]):
        submit()
    for _ in range(tr["lead_in_steps"]):
        sched.step()
        reap()
    ctx.mark("lead_in")

    occupancy = []
    t0 = time.perf_counter()
    clock.half = t0 + ctx.seconds / 2
    clock.open = hooks.timing = True
    while time.perf_counter() < t0 + ctx.seconds:
        sched.step()
        occupancy.append(sum(s is not None for s in sched.slots) / sched.batch)
        reap()
    t1 = time.perf_counter()
    clock.open = hooks.timing = False
    record = {"slot_occupancy": occupancy}
    if ctx.trace:
        record.update(enqueue_s=hooks.enqueue_s, enqueue_steps=hooks.enqueue_steps,
                      platform=dev.type)

        def step():
            with span("scheduler_step", True):
                sched.step()
            reap()
        record.update(hooks.profile(step, tr["trace_seconds"]))

    ttft = stats.ttft_ms(done + live, t0, t1)
    ctx.log(f"ttft ms mean {stats.mean(ttft)}; out_tok_s over the window's halves "
            f"{stats.rate(clock.half_tokens, clock.half - t0)} / "
            f"{stats.rate(clock.window_tokens - clock.half_tokens, t1 - clock.half)}")
    tpot = stats.tpot_ms(done, t0, t1)
    in_window = [r for r in done if t0 <= r.t_done <= t1]
    ctx.log(f"window {t1 - t0:.3f} s, {len(occupancy)} scheduler steps, {clock.window_tokens} "
            f"output tokens, {len(in_window)} requests completed, {len(ttft)} first tokens "
            f"(samples: tpot {len(tpot)}, ttft {len(ttft)})")
    metrics = {"out_tok_s": stats.rate(clock.window_tokens, t1 - t0),
               "tpot_p90_ms": stats.percentile(tpot, 90),
               "ttft_p90_ms": stats.percentile(ttft, 90)}
    ctx.log(f"tpot ms p50 {stats.percentile(tpot, 50)} p90 {metrics['tpot_p90_ms']}; "
            f"ttft ms p50 {stats.percentile(ttft, 50)} p90 {metrics['ttft_p90_ms']}")
    attempted = len(in_window) + len(live)
    failed = sum(1 for r in in_window
                 if r.n_tokens != r.max_new or len(r.req.out_logprobs) != r.n_tokens)
    peak = ctx.memory_peak()

    # the check: a sample of the window's finished requests, drawn from the
    # seed with the longest among them, against the reference
    rng = np.random.default_rng([int(ctx.seed), 2])
    pick = sorted(in_window, key=lambda r: -r.n_tokens)[:1]
    rest = [r for r in in_window if r not in pick]
    if rest:
        k = min(len(rest), tr["check_requests"] - 1)
        pick += [rest[i] for i in rng.choice(len(rest), size=k, replace=False)]
    served = [(r.prompt, r.req.out_tokens[:r.n_tokens], r.req.out_logprobs[:r.n_tokens],
               r.greedy, hooks.routes_of(r.req.request_id, len(r.prompt) + r.n_tokens - 1))
              for r in pick]
    hooks.close()
    del sched, eng, live, done, pool, in_window, pick, rest, nxt, hooks
    gc.collect()
    ctx.free()
    return {"metrics": metrics, "record": record, "t0": t0, "attempted": attempted,
            "failed": failed, "memory_peak_bytes": peak, "served": served}


class _Hooks:
    """Wrappers around the scheduler's admission call and its decode block,
    installed after the warm-up: they tag the router log (``RouteLog``) with
    the rows' requests and positions, and time each decode block's call on
    the host (until it returns, before the tokens' read-back) while
    ``timing`` is on, which is the measured window. The profiler of the
    traced run then covers ``trace_seconds`` of steps run right after the
    window, at the same load (its start and its reading cost the window
    nothing), with a span around each admission and decode block, and the
    work of every step it covers is counted."""

    def __init__(self, ctx, sched, cfg):
        self.ctx, self.sched = ctx, sched
        self.shapes = work.Shapes.of(ctx.spec)
        self.n_moe = len(self.shapes.moe_layers)
        self.routes = RouteLog(ctx.device).install()
        self.blocks = []                # (request id a row, pos0, act, steps)
        self.profiling = self.timing = False
        self.steps = []                 # (kind, first call, last call, info) while profiling
        self.enqueue_s = 0.0
        self.enqueue_steps = 0
        adv, loop_for = sched._advance_pending, sched._loop_for
        self._restore = (adv, loop_for)

        def admission():
            p = sched.pending
            fed0, n, c0 = p.fed, len(p.req.prompt_tokens), len(self.routes.calls)
            self.routes.tag = ("admit", p.req.request_id, fed0)
            with span("admission", self.profiling):
                adv()
            self.routes.tag = None
            if self.profiling:
                self.steps.append(("admit", c0, len(self.routes.calls),
                                   (fed0, p.fed - fed0, p.fed == n)))
        sched._advance_pending = admission

        def wrapped_loop_for(block=None):
            fn = loop_for(block)
            blk = block or sched.block

            def loop(params, cache, tok, pos0, key, temps, topps, act, *rest):
                ids = [None if r is None else r.request_id for r in sched.slots]
                self.blocks.append((ids, np.array(pos0), np.array(act, dtype=bool), blk))
                self.routes.tag = ("decode", len(self.blocks) - 1)
                c0 = len(self.routes.calls)
                t = time.perf_counter()
                with span("decode_block", self.profiling):
                    out = fn(params, cache, tok, pos0, key, temps, topps, act, *rest)
                if self.timing:
                    self.enqueue_s += time.perf_counter() - t
                    self.enqueue_steps += blk
                self.routes.tag = None
                if self.profiling:
                    self.steps.append(("decode", c0, len(self.routes.calls),
                                       len(self.blocks) - 1))
                return out
            return loop
        sched._loop_for = wrapped_loop_for

    def routes_of(self, rid: int, length: int) -> np.ndarray:
        """The program's experts (length, MoE layers, k) at positions
        0..length-1 of request ``rid`` (-1 where none was logged)."""
        k = self.ctx.spec["num_experts_per_tok"]
        out = np.full((length, self.n_moe, k), -1, dtype=np.int64)
        blocks = {b: ids.index(rid) for b, (ids, *_) in enumerate(self.blocks) if rid in ids}
        seen = {}
        for c, (_, rows, _, tag) in enumerate(self.routes.calls):
            if tag is None:
                continue
            if tag[0] == "admit" and tag[1] == rid:
                li = seen.get(tag, 0)
                seen[tag] = li + 1
                fed0 = tag[2]
                e = self.routes.experts(c)[:max(0, min(rows, length - fed0))]
                out[fed0:fed0 + len(e), li] = e
            elif tag[0] == "decode" and tag[1] in blocks:
                ci = seen.get(tag, 0)
                seen[tag] = ci + 1
                row = blocks[tag[1]]
                _, pos0, act, _ = self.blocks[tag[1]]
                pos = int(pos0[row]) + ci // self.n_moe
                if act[row] and pos < length:
                    out[pos, ci % self.n_moe] = self.routes.experts(c)[row]
        return out

    def profile(self, step, seconds: float) -> dict:
        """Run ``step`` under the profiler for ``seconds``; the trace's
        summary and the least time its steps need (``work.py``)."""
        prof = Profile()
        prof.start()
        self.profiling = True
        t = time.perf_counter()
        while time.perf_counter() < t + seconds:
            step()
        prof.stop()
        self.profiling = False
        least, per_step = 0.0, []
        sh, rl = self.shapes, self.routes
        for kind, c0, c1, info in self.steps:
            if kind == "admit":
                pos0, r, final = info
                d = [rl.distinct(c) for c in range(c0, c1)]
                f, b = work.step_work(sh, r, pos0 + r, r * pos0 + r * (r + 1) // 2, d,
                                      1 if final else 0)
                least += work.least_seconds(f, b)
                continue
            _, pos0, act, blk = self.blocks[info]
            n = int(act.sum())
            base = int(pos0[act].sum())
            for j in range(blk):
                d = [rl.distinct(c, act) for c in range(c0 + j * self.n_moe,
                                                         min(c1, c0 + (j + 1) * self.n_moe))]
                kv = base + n * (j + 1)
                f, b = work.step_work(sh, n, kv, kv, d, n)
                least += work.least_seconds(f, b)
                per_step.append(sum(d) / max(1, self.n_moe))
        summary = prof.summary(self.ctx.log)
        self.ctx.log(f"traced {summary['window_s']:.3f} s after the window: {len(self.steps)} "
                     f"calls, busy {summary['busy_s']:.4f} s; distinct routed experts a MoE "
                     f"layer a decode step: mean "
                     f"{np.mean(per_step) if per_step else float('nan'):.1f} over "
                     f"{len(per_step)} steps")
        return {"trace": summary, "least_s": least}

    def close(self) -> None:
        self.routes.uninstall()
        self.sched._advance_pending, self.sched._loop_for = self._restore
