"""The port's spans and its routing record, on the CPU at a tiny size.

- Under a CPU ``torch.profiler`` a scheduler step with an admission and a
  decode block emits every span of ``utils/profiling.py::span``'s layer
  boundaries, nested as they are in the code; a speculating scheduler
  emits ``serve.spec_round``; a prefill chunk (pair and grouped MoE paths)
  its own ``layer.*`` and ``moe.*`` spans.
- With no profiler and ``DSEEK_PROFILE`` off nothing constructs a
  ``record_function``; tokens and log-probabilities are the same bits with
  the profiler recording and without it.
- ``BatchScheduler(record_routes=True).routes`` and the perplexity record
  equal, at every position, what a wrapper around ``deepseek.moe_gate``
  logs (the benchmark's ``RouteLog`` way of reading the routing).

The model is ``models/testing.py``'s random plain-weight V2-Lite layout at
toy widths: 3 layers, the last two MoE (8 experts, k = 2, the shared
experts folded into the tables), f32 compute.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepseek_tpu_torch.engine import Engine, hydrate_cache
from deepseek_tpu_torch.models import deepseek
from deepseek_tpu_torch.models.deepseek import forward_prefill, make_decode_loop
from deepseek_tpu_torch.models.kvcache import init_cache
from deepseek_tpu_torch.models.testing import (
    deepseek_v2_lite_proportions, random_plain_params,
)
from deepseek_tpu_torch.parallel.spmd import SpmdCtx
from deepseek_tpu_torch.serving import BatchScheduler, Request
from deepseek_tpu_torch.tokenizer import Tokenizer
from deepseek_tpu_torch.utils import profiling
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CFG = deepseek_v2_lite_proportions(
    n_layers=3, dim=128, hidden_dim=128, n_heads=2, vocab_size=300, max_seq_len=128,
    n_routed_experts=8, n_active_routed=2, moe_intermediate_size=128, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    rs_original_max_position_embeddings=128, compute_dtype="float32",
    kv_cache_dtype="float32")
N_MOE, K = 2, 2
CHUNK, BLOCK = 4, 4
SERVE = ("serve.step", "serve.admit", "serve.decode_block", "serve.emit")
MODEL = ("model.decode_step", "model.prefill_chunk", "model.logits", "layer.attn",
         "layer.ffn", "moe.route", "moe.dispatch", "moe.experts", "sample")
# (prompt length, new tokens): prompts over several admission chunks, and
# outputs that end inside a decode block
REQS = [(5, 6), (9, 3), (3, 8), (7, 7)]


@pytest.fixture(scope="module")
def params():
    return random_plain_params(CFG, torch.float32, seed=3, device="cpu")


def _engine(params) -> Engine:
    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{i:02X}>".encode() for i in range(256)]
    vocab += [f"t{i}".encode() for i in range(len(vocab), CFG.vocab_size)]
    return Engine.from_params(params, CFG, Tokenizer(vocab, bos_id=1, eos_id=-1), seed=5,
                              prefill_chunk=CHUNK)


def _requests(reqs=REQS):
    rng = np.random.default_rng(0)
    return [Request(prompt_tokens=rng.integers(259, CFG.vocab_size, p).tolist(),
                    max_new_tokens=n, temperature=0.8 if i % 2 else 0.0, logprobs=True)
            for i, (p, n) in enumerate(reqs)]


def _user_ranges(prof) -> set:
    """The program's spans that were user ranges (which would take the
    kernels launched inside them from a user range around them)."""
    return {e.name for e in prof.events()
            if e.is_user_annotation and e.name in SERVE + MODEL + ("serve.spec_round",)}


def _spans(prof) -> dict:
    """name -> [(start, end)] of every program span in a CPU trace."""
    out = {}
    for e in prof.events():
        if e.name in SERVE + MODEL + ("serve.spec_round",):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _inside(spans: dict, inner: str, *outer: str) -> bool:
    """Every range of ``inner`` lies within a range of one of ``outer``."""
    around = [r for o in outer for r in spans.get(o, [])]
    return all(any(a <= s and e <= b for a, b in around) for s, e in spans[inner])


def test_a_scheduler_step_emits_every_span_nested(params):
    sched = BatchScheduler(_engine(params), batch_size=3, decode_block=BLOCK, logprobs=True)
    sched.submit(_requests([(3, 8)])[0])          # one chunk: admitted and decoded at once
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sched.step()
    sp = _spans(prof)
    assert set(sp) == set(SERVE + MODEL)
    assert len(sp["model.decode_step"]) == len(sp["sample"]) == BLOCK
    assert len(sp["layer.attn"]) == len(sp["layer.ffn"]) == CFG.n_layers * (BLOCK + 1)
    assert len(sp["moe.route"]) == len(sp["moe.dispatch"]) == N_MOE * (BLOCK + 1)
    for name in ("moe.route", "moe.dispatch", "moe.experts"):
        assert _inside(sp, name, "layer.ffn")
    for name in ("layer.attn", "layer.ffn", "model.logits"):
        assert _inside(sp, name, "model.decode_step", "model.prefill_chunk")
    assert _inside(sp, "sample", "model.decode_step")
    assert _inside(sp, "model.decode_step", "serve.decode_block")
    assert _inside(sp, "model.prefill_chunk", "serve.admit")
    for name in ("serve.admit", "serve.decode_block", "serve.emit"):
        assert _inside(sp, name, "serve.step")
    # the decode steps' own MoE spans
    in_steps = [r for r in sp["moe.route"]
                if any(a <= r[0] and r[1] <= b for a, b in sp["model.decode_step"])]
    assert len(in_steps) == N_MOE * BLOCK
    # host ranges only: a benchmark's user range around them keeps its kernels
    assert _user_ranges(prof) == set()


def test_a_speculation_dispatch_is_a_span(params):
    sched = BatchScheduler(_engine(params), batch_size=2, decode_block=BLOCK, spec="ngram",
                           spec_k=2, spec_rounds=1)
    sched.submit(_requests([(3, 12)])[0])
    sched.step()                                  # admitted, then a first dispatch
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sched.step()
    sp = _spans(prof)
    assert "serve.spec_round" in sp and "serve.decode_block" not in sp
    assert _inside(sp, "serve.spec_round", "serve.step")
    assert _inside(sp, "model.prefill_chunk", "serve.spec_round")


@pytest.mark.parametrize("T", [CHUNK, 80])       # the pair list; the grouped products
def test_a_prefill_chunk_emits_its_own_spans(params, T):
    toks = torch.randint(259, CFG.vocab_size, (1, T), generator=torch.Generator().manual_seed(T))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        forward_prefill(params, init_cache(CFG, batch=1, device="cpu"), toks, 0, CFG)
    sp = _spans(prof)
    assert len(sp["model.prefill_chunk"]) == 1
    assert len(sp["layer.attn"]) == len(sp["layer.ffn"]) == CFG.n_layers
    assert len(sp["moe.route"]) == len(sp["moe.dispatch"]) == N_MOE
    for name in ("layer.attn", "layer.ffn", "model.logits"):
        assert _inside(sp, name, "model.prefill_chunk")
    for name in ("moe.route", "moe.dispatch", "moe.experts"):
        assert _inside(sp, name, "layer.ffn")
    assert _user_ranges(prof) == set()


def _counting(real):
    """A range class like ``real`` that counts its constructions in
    ``made[0]``."""
    made = [0]

    class Counting:
        def __init__(self, name, *a, **k):
            made[0] += 1
            self.rf = real(name, *a, **k)

        def __enter__(self):
            return self.rf.__enter__()

        def __exit__(self, *exc):
            return self.rf.__exit__(*exc)
    return Counting, made


def test_no_range_without_a_profiler(params, monkeypatch):
    monkeypatch.setattr(profiling, "_enabled", False)
    user, n_user = _counting(torch.profiler.record_function)
    host, n_host = _counting(torch._C._profiler._RecordFunctionFast)
    monkeypatch.setattr(torch.profiler, "record_function", user)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", host)
    eng = _engine(params)
    sched = BatchScheduler(eng, batch_size=3, decode_block=BLOCK, logprobs=True)
    for r in _requests()[:2]:
        sched.submit(r)
    for _ in range(3):
        sched.step()
    eng.perplexity(list(range(259, 269)))
    assert n_user[0] == n_host[0] == 0
    with profile(activities=[ProfilerActivity.CPU]):
        sched.step()
    assert n_host[0] > 0                          # the control: a profiler makes them


def _serve(params, recording: bool):
    sched = BatchScheduler(_engine(params), batch_size=3, decode_block=BLOCK, logprobs=True)
    reqs = _requests()
    for r in reqs:
        sched.submit(r)
    if recording:
        with profile(activities=[ProfilerActivity.CPU]):
            sched.run()
    else:
        sched.run()
    return [(r.out_tokens, r.out_logprobs) for r in reqs]


def test_the_profiler_changes_no_bit(params):
    assert _serve(params, True) == _serve(params, False)


class _GateLog:
    """A wrapper around ``deepseek.moe_gate`` that logs each call's experts
    under the tag its caller set."""

    def __init__(self, monkeypatch):
        self.calls, self.tag = [], None
        orig = deepseek.moe_gate

        def logged(logits, bias, cfg):
            w, idx = orig(logits, bias, cfg)
            self.calls.append((self.tag, idx.clone()))
            return w, idx
        monkeypatch.setattr(deepseek, "moe_gate", logged)

    def tag_scheduler(self, sched):
        """Tag each admission chunk (request, first position) and decode
        block (each row's live request, the rows' positions)."""
        adv, loop_for = sched._advance_pending, sched._loop_for

        def admission():
            p = sched.pending
            self.tag = ("admit", p.req.request_id, p.fed)
            adv()
            self.tag = None

        def tagged_loop_for(block=None):
            fn = loop_for(block)

            def loop(params, cache, tok, pos0, *rest):
                ids = [None if r is None or r.done else r.request_id for r in sched.slots]
                self.tag = ("decode", len(self.calls), ids, np.array(pos0))
                out = fn(params, cache, tok, pos0, *rest)
                self.tag = None
                return out
            return loop
        sched._advance_pending = admission
        sched._loop_for = tagged_loop_for

    def request(self, rid: int, n_prompt: int, length: int) -> np.ndarray:
        """(length, N_MOE, K) experts of request ``rid`` (a prompt of
        ``n_prompt`` tokens: the rows past it pad a short chunk), -1 where
        none."""
        out = np.full((length, N_MOE, K), -1, np.int64)
        seen = {}
        for tag, idx in self.calls:
            if tag is None:
                continue
            key = tag if tag[0] == "admit" else tag[:2]
            c = seen[key] = seen.get(key, -1) + 1
            if tag[0] == "admit" and tag[1] == rid:
                e = idx[0, :n_prompt - tag[2]].numpy()
                out[tag[2]:tag[2] + len(e), c] = e
            elif tag[0] == "decode" and rid in tag[2]:
                row = tag[2].index(rid)
                pos = int(tag[3][row]) + c // N_MOE
                if pos < length:
                    out[pos, c % N_MOE] = idx[row, 0].numpy()
        return out


def test_the_scheduler_record_is_the_gate_s(params, monkeypatch):
    log = _GateLog(monkeypatch)
    sched = BatchScheduler(_engine(params), batch_size=3, decode_block=BLOCK, logprobs=True,
                           record_routes=True)
    log.tag_scheduler(sched)
    reqs = _requests()
    for r in reqs:
        sched.submit(r)
    sched.run()
    past_end = 0
    for r in reqs:
        length = len(r.prompt_tokens) + len(r.out_tokens) - 1
        want = log.request(r.request_id, len(r.prompt_tokens), length)
        got = sched.routes(r.request_id)
        assert (want >= 0).all()
        assert got.dtype == np.int16 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        past_end += (len(r.out_tokens) - 1) % BLOCK != 0
        with pytest.raises(KeyError):
            sched.routes(r.request_id)            # read once, then gone
    assert past_end == len(reqs) >= 3
    assert max(len(r.prompt_tokens) for r in reqs) > CHUNK


@pytest.mark.parametrize("n", [10, 130])          # inside the window; past it (decode steps)
def test_the_perplexity_record_is_the_gate_s(params, monkeypatch, n):
    log = _GateLog(monkeypatch)
    log.tag = ("doc",)
    rec = []
    toks = np.random.default_rng(n).integers(259, CFG.vocab_size, n).tolist()
    _engine(params).perplexity(toks, routes=rec)
    got = torch.cat(rec).numpy()
    assert got.dtype == np.int16 and got.shape == (n, N_MOE, K)
    want = np.full((n, N_MOE, K), -1, np.int64)
    pos = 0
    for c in range(0, len(log.calls), N_MOE):
        for layer in range(N_MOE):
            e = log.calls[c + layer][1][0].numpy()[:n - pos]
            want[pos:pos + len(e), layer] = e
        pos += len(e)
    assert pos == n
    np.testing.assert_array_equal(got, want)


def test_the_decode_block_returns_its_routes(params):
    loop = make_decode_loop(CFG, BLOCK, with_routes=True)
    cache = init_cache(CFG, batch=2, device="cpu")
    out = loop(params, cache, torch.tensor([[260], [270]]), np.array([0, 3]),
               np.array([0, 7], np.uint32), 0.0, 1.0)
    routes = out[-2]
    assert routes.shape == (2, BLOCK, N_MOE, K) and routes.dtype == torch.int16
    assert ((routes >= 0) & (routes < CFG.n_routed_experts)).all()


def test_the_record_is_single_device_plain_serving(params):
    with pytest.raises(ValueError):
        make_decode_loop(CFG, BLOCK, mesh=object(), with_routes=True)
    with pytest.raises(ValueError):
        BatchScheduler(_engine(params), mesh=object(), record_routes=True)
    with pytest.raises(ValueError):
        BatchScheduler(_engine(params), spec="ngram", record_routes=True)
    with pytest.raises(ValueError):
        hydrate_cache(params, CFG, init_cache(CFG, batch=1, device="cpu"), [260, 261],
                      routes=[], ctx=SpmdCtx(sp=2))
