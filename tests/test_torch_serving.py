"""The port's batched decode and continuous batching against the JAX package.

- ``forward_prefill``'s verify mode (per-row chunk starts) against the JAX
  ``_forward_impl`` with pos0 (B,): logits and caches, for absorbed MLA,
  hybrid MLA (whose verify chunks stay absorbed), MHA and the int8 cache,
  within 1e-4 of the logit scale; then a decode step from the verified
  cache. The K9/K10 plain versions with per-row starts against the JAX
  jnp verify attention (1e-5 of the output scale).
- ``BatchScheduler`` against the JAX ``BatchScheduler`` on the tiny
  checkpoints of ``tests/test_serving.py``: the same requests give the
  same tokens at temperature 0 and 0.8 (log-probabilities within 1e-3);
  then the port's own scheduler: greedy slots equal ``Engine.generate``,
  the prefix cache (hits, evictions that keep chain roots, int8 rows),
  stop hold-back, logprobs against teacher-forced rescoring, n-gram and
  MTP speculative serving greedy equal to plain serving, idle-block
  escalation, and the three JAX faults not copied.

The port runs its plain versions on the CPU, in f32 compute.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu import convert as cv
from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu.models import deepseek as jax_dsk
from deepseek_tpu.models.kvcache import init_cache as jax_cache
from deepseek_tpu.models.testing import random_params
from deepseek_tpu.ops import attention as jax_attn
from deepseek_tpu.serving import BatchScheduler as JaxScheduler
from deepseek_tpu.serving import Request as JaxRequest
from deepseek_tpu.utils import codec
from deepseek_tpu_torch.config import ModelConfig
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.models.deepseek import forward_decode, forward_prefill
from deepseek_tpu_torch.models.kvcache import init_cache
from deepseek_tpu_torch.models.loader import params_from_reference
from deepseek_tpu_torch.ops.kernels.prefill_attn import (
    mha_prefill_attn, mha_prefill_attn_plain, mla_prefill_attn, mla_prefill_attn_plain,
)
from deepseek_tpu_torch.parallel.mesh import Mesh
from deepseek_tpu_torch.serving import BatchScheduler, PrefixCache, Request
from tests.test_torch_kv_int8 import _assert_caches_match
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir
from tests.util_tinymodel import (
    tiny_checkpoint_tensors, tiny_config, tiny_metadata, tiny_weights,
)

PROMPTS = ["hello", "hello world", "abc", "xyz test", "q"]
LENS = [3, 6, 4, 5, 2]


def _write(d, window, max_seq_len):
    cfg = tiny_config(use_mla=True, vocab_size=300, max_seq_len=max_seq_len,
                      rs_original_max_position_embeddings=window)
    codec.save_checkpoint(str(d), [tiny_checkpoint_tensors(cfg, tiny_weights(cfg, 55))],
                          tiny_metadata(cfg))
    return str(d)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """tests/test_serving.py's module checkpoint: a 32-slot window."""
    return _write(tmp_path_factory.mktemp("srv"), 32, 128)


@pytest.fixture(scope="module")
def engine(ckpt):
    return Engine(ckpt, seed=0, prefill_chunk=8, decode_block=1, device="cpu")


@pytest.fixture(scope="module")
def spec_dir(tmp_path_factory):
    """A 128-slot window, so that fused speculation rounds have room."""
    return _write(tmp_path_factory.mktemp("srvspec"), 128, 256)


@pytest.fixture(scope="module")
def engine_spec(spec_dir):
    return Engine(spec_dir, seed=0, prefill_chunk=8, decode_block=1, device="cpu")


@pytest.fixture(scope="module")
def engine_mtp(tmp_path_factory):
    """tests/test_serving.py's MTP checkpoint (converted, 128-slot window)."""
    cfg = hf_config(dim=64, hidden=96, q_lora=48, kv_lora=32, nope=16, rope=16,
                    v_dim=16, layers=2, vocab=300)
    cfg["rope_scaling"]["original_max_position_embeddings"] = 128
    d = str(tmp_path_factory.mktemp("srvmtp"))
    write_hf_dir(os.path.join(d, "hf"), cfg, hf_weights(cfg, seed=9, scale=0.15, mtp=True))
    cv.convert(os.path.join(d, "hf"), os.path.join(d, "ck"), quant="fp32", use_mla=True)
    return Engine(os.path.join(d, "ck"), seed=0, prefill_chunk=8, decode_block=1,
                  device="cpu")


def _enc(eng, text):
    return eng.tokenizer.encode(text, bos=True)


def _serve(eng, reqs, **kw):
    sched = BatchScheduler(eng, **kw)
    for r in reqs:
        sched.submit(r)
    return sched, sched.run()


# ---------------------------------------------------------------------------
# verify mode
# ---------------------------------------------------------------------------

def _strip(params):
    return dataclasses.replace(params, layers=[
        dataclasses.replace(lp, wq_b=None, wkv_b=None) for lp in params.layers])


def _jax_merge(full, part, b):
    import jax
    return jax.tree.map(lambda f, p: None if f is None else f.at[:, b].set(p[:, 0]),
                        full, part, is_leaf=lambda x: x is None)


def _merge(full, part, b):
    for f in dataclasses.fields(full):
        t = getattr(full, f.name)
        if t is not None:
            t[:, b] = getattr(part, f.name)[:, 0]


def _assert_float_caches(jc, c, tol=1e-4):
    """f16 rows within 1e-4 of their scale, or one f16 step apart (2^-10
    relative: an f32 value at a rounding boundary may round to either
    neighbour)."""
    for f in dataclasses.fields(c):
        t = getattr(c, f.name)
        if t is None:
            continue
        want = np.asarray(getattr(jc, f.name), np.float32)
        np.testing.assert_allclose(t.float().numpy(), want, rtol=2.0 ** -10,
                                   atol=tol * np.abs(want).max(), err_msg=f.name)


@pytest.mark.parametrize("kind", ["mla", "hybrid", "mha", "int8"])
def test_verify_mode_matches_jax(kind):
    """Three rows with 5/9/7-token histories, then one 4-token verify chunk
    at each row's own start: the port's logits within 1e-4 of the logit
    scale of the JAX verify forward's, the caches after it alike (int8 rows
    one count apart at most, as tests/test_torch_kv_int8.py holds them), and
    a decode step at per-row positions from the verified caches likewise.
    The hybrid checkpoint keeps wq_b/wkv_b: the history prefills in
    decompressed head space, the verify chunk stays absorbed in both."""
    kv = "int8" if kind == "int8" else "float16"
    jcfg = tiny_config(use_mla=kind != "mha", vocab_size=300, max_seq_len=64,
                       rs_original_max_position_embeddings=32, kv_cache_dtype=kv)
    jparams = random_params(jcfg, 0)
    if kind in ("mla", "int8"):
        jparams = _strip(jparams)
    params = params_from_reference(jparams)
    cfg = ModelConfig.from_metadata(tiny_metadata(jcfg), kv_cache_dtype=kv)
    fwd = jax_dsk.make_forward(jcfg, prefill=True, logits_mode="all", jit=False)
    dec = jax_dsk.make_forward(jcfg, prefill=False, logits_mode="last", jit=False)
    rng = np.random.default_rng(0)
    B, T, lens = 3, 4, [5, 9, 7]
    hist = [rng.integers(1, 300, size=n) for n in lens]
    chunks = rng.integers(1, 300, size=(B, T))
    nxt = rng.integers(1, 300, size=(B, 1))

    jc, c = jax_cache(jcfg, batch=B), init_cache(cfg, batch=B)
    with torch.inference_mode():
        for b in range(B):
            _, j1 = fwd(jparams, jax_cache(jcfg, batch=1),
                        jnp.asarray(hist[b][None], jnp.int32), 0)
            jc = _jax_merge(jc, j1, b)
            c1 = init_cache(cfg)
            forward_prefill(params, c1, torch.from_numpy(hist[b][None]), 0, cfg, "none")
            _merge(c, c1, b)
        want, jc = fwd(jparams, jc, jnp.asarray(chunks, jnp.int32),
                       jnp.asarray(lens, jnp.int32))
        got = forward_prefill(params, c, torch.from_numpy(chunks), np.array(lens), cfg,
                              "all")
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
        (_assert_caches_match if kind == "int8" else _assert_float_caches)(jc, c)
        pos = np.array(lens) + T
        want, _ = dec(jparams, jc, jnp.asarray(nxt, jnp.int32), jnp.asarray(pos, jnp.int32))
        got = forward_decode(params, c, torch.from_numpy(nxt), pos, cfg)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_verify_mode_guards_the_window_and_the_seq_axis(engine):
    from deepseek_tpu_torch.parallel.spmd import NULL_CTX

    cfg, params = engine.cfg, engine.params
    tok = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="window"):
        forward_prefill(params, init_cache(cfg, batch=2), tok, np.array([0, cfg.kv_window - 2]),
                        cfg)
    with pytest.raises(ValueError, match="one chunk start per row"):
        forward_prefill(params, init_cache(cfg, batch=2), tok, np.array([0, 1, 2]), cfg)
    with pytest.raises(ValueError, match="seq"):
        forward_prefill(params, init_cache(cfg, batch=2), tok, np.array([1, 2]), cfg,
                        ctx=dataclasses.replace(NULL_CTX, cp=True))


def _rnd(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("wrapper", [False, True])
def test_prefill_plain_per_row_starts_match_jax(wrapper):
    """K9's and K10's plain versions (and their wrappers on CPU tensors)
    with a (B,) start vector against the JAX jnp attention with (B,T)
    positions (``ops/attention.py``'s verify form): 1e-5 of the scale."""
    B, T, S, H, Dh, Dv, R, P = 3, 4, 24, 2, 12, 8, 16, 4
    starts = np.array([0, 11, 20])
    pos_vec = jnp.asarray(starts[:, None] + np.arange(T), jnp.int32)
    cache_pos = jnp.arange(S, dtype=jnp.int32)
    q, k, v = _rnd((B, T, H, Dh), 1), _rnd((B, S, H, Dh), 2), _rnd((B, S, H, Dv), 3)
    t = torch.from_numpy
    row = t(starts.astype(np.int32))
    mha = mha_prefill_attn if wrapper else mha_prefill_attn_plain
    got = mha(t(q), t(k), t(v), row, 0, 0.3)
    want = np.asarray(jax_attn.prefill_attn_mha(jnp.asarray(q), jnp.asarray(k),
                                                 jnp.asarray(v), pos_vec, cache_pos,
                                                 softmax_scale=0.3))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    qc, qr = _rnd((B, T, H, R), 4), _rnd((B, T, H, P), 5)
    ckv, kr = _rnd((B, S, R), 6), _rnd((B, S, P), 7)
    mla = mla_prefill_attn if wrapper else mla_prefill_attn_plain
    got = mla(t(qc), t(qr), t(ckv), t(kr), row, 0, 0.3)
    want = np.asarray(jax_attn.prefill_attn_mla(
        jnp.asarray(qc), jnp.asarray(qr), jnp.asarray(ckv), jnp.asarray(kr), pos_vec,
        cache_pos, R + P, softmax_scale=0.3))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the scheduler against the JAX scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_scheduler_matches_jax(ckpt, engine, temperature):
    """Five requests through two slots (slot reuse, per-slot positions) with
    logprobs: the JAX scheduler's tokens, and its log-probabilities within
    1e-3. At 0.8 the first token comes from each Engine's host sampler at
    seed 0 and the rest from the decode block's threefry keys."""
    jeng = JaxEngine(ckpt, seed=0, prefill_chunk=8, decode_block=1)
    port_eng = Engine(ckpt, seed=0, prefill_chunk=8, decode_block=1, device="cpu")
    jsched = JaxScheduler(jeng, batch_size=2, logprobs=True)
    for p, n in zip(PROMPTS, LENS):
        jsched.submit(JaxRequest(prompt_tokens=_enc(jeng, p), max_new_tokens=n,
                                 temperature=temperature, logprobs=True))
    want = jsched.run()
    _, got = _serve(port_eng, [Request(prompt_tokens=_enc(port_eng, p), max_new_tokens=n,
                                       temperature=temperature, logprobs=True)
                               for p, n in zip(PROMPTS, LENS)],
                    batch_size=2, logprobs=True)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs, rtol=0, atol=1e-3)
        assert g.out_bytes == w.out_bytes


def test_continuous_batching_matches_individual(engine):
    want = [engine.generate(_enc(engine, p), num_steps=n, temperature=0.0)[0]
            for p, n in zip(PROMPTS, LENS)]
    _, got = _serve(engine, [Request(prompt_tokens=_enc(engine, p), max_new_tokens=n,
                                     temperature=0.0) for p, n in zip(PROMPTS, LENS)],
                    batch_size=2)
    assert [r.out_tokens for r in got] == want


def test_warmup_leaves_outputs_unchanged(engine):
    prompts = ["hello world", "abc"]
    want = [engine.generate(_enc(engine, p), num_steps=4, temperature=0.0)[0]
            for p in prompts]
    sched = BatchScheduler(engine, batch_size=2, prefix_cache_mb=1)
    sched.warmup()
    assert set(sched._loops) == {sched.block}     # one block per block length
    for p in prompts:
        sched.submit(Request(prompt_tokens=_enc(engine, p), max_new_tokens=4,
                             temperature=0.0))
    assert [r.out_tokens for r in sched.run()] == want


def test_engine_from_params_serves_as_loaded(engine):
    """An Engine over in-memory weights (Engine.from_params, the route of a
    random draw without a .dseek) generates and serves what the loaded
    Engine does."""
    eng = Engine.from_params(engine.params, engine.cfg, engine.tokenizer, seed=0,
                             prefill_chunk=8, decode_block=1)
    assert eng.device == engine.device and eng.chat_template is None
    prompt = _enc(engine, "hello world")
    want = engine.generate(prompt, num_steps=5, temperature=0.0)[0]
    assert eng.generate(prompt, num_steps=5, temperature=0.0)[0] == want
    _, got = _serve(eng, [Request(prompt_tokens=prompt, max_new_tokens=5,
                                  temperature=0.0)], batch_size=2)
    assert got[0].out_tokens == want


def test_scheduler_streams_tokens(engine):
    got = []
    _, fin = _serve(engine, [Request(prompt_tokens=_enc(engine, "hi"), max_new_tokens=3,
                                     temperature=0.0,
                                     on_token=lambda t, piece: got.append((t, piece)))],
                    batch_size=1)
    assert [t for t, _ in got] == fin[0].out_tokens
    assert all(isinstance(p, bytes) for _, p in got)


def test_admission_chunks_interleave_with_decode(engine):
    """A prompt past the 32-slot window hydrates one bounded chunk a step
    while the running sequence keeps decoding, and still gives its own
    greedy run's tokens."""
    a_tokens = []
    sched = BatchScheduler(engine, batch_size=2, decode_block=1)
    sched.submit(Request(prompt_tokens=_enc(engine, "hello"), max_new_tokens=40,
                         temperature=0.0, on_token=lambda t, b: a_tokens.append(t)))
    sched.step()
    assert len(a_tokens) >= 1
    long_prompt = _enc(engine, "word " * 40)
    assert len(long_prompt) > engine.cfg.kv_window
    want, _ = engine.generate(long_prompt, num_steps=3, temperature=0.0)
    req = Request(prompt_tokens=long_prompt, max_new_tokens=3, temperature=0.0)
    sched.submit(req)
    progress = []
    while (sched.pending is not None or sched.queue) and len(progress) < 100:
        before = len(a_tokens)
        sched.step()
        progress.append(len(a_tokens) - before)
    assert len(progress) >= 3 and sum(progress) >= 3
    sched.run()
    assert req.out_tokens == want


def _greedy_text(eng, prompt, n):
    toks, _ = eng.generate(prompt, num_steps=n, temperature=0.0)
    prev, out = prompt[-1], b""
    for t in toks:
        out += eng.tokenizer.decode_one(prev, t)
        prev = t
    return toks, out


def test_stop_sequence_truncates_and_holds_back(engine):
    """A stop string taken from the middle of the greedy text: out_bytes
    ends before it, nothing of it is streamed, and generation stops."""
    prompt = _enc(engine, "hello world")
    toks, text = _greedy_text(engine, prompt, 12)
    at = next(i for i in range(4, len(text) - 3) if all(32 < c < 127 for c in text[i:i + 3]))
    stop = text[at:at + 3].decode()
    cut = text.find(stop.encode())
    streamed = []
    _, fin = _serve(engine, [Request(prompt_tokens=prompt, max_new_tokens=12,
                                     temperature=0.0, stop=[stop],
                                     on_token=lambda t, b: streamed.append(b))],
                    batch_size=1)
    r = fin[0]
    assert r.stop_hit and r.done
    assert r.out_bytes == text[:cut]
    assert b"".join(streamed) == text[:cut]
    assert r.out_tokens == toks[:len(r.out_tokens)]


def test_stop_not_hit_flushes_heldback_tail(engine):
    prompt = _enc(engine, "abc")
    toks, text = _greedy_text(engine, prompt, 6)
    # a stop string that begins with the text's last character: held
    # back, then flushed when the request ends without a hit
    assert 32 < text[-1] < 127
    stop = text[-1:].decode() + "\x01"
    streamed = []
    _, fin = _serve(engine, [Request(prompt_tokens=prompt, max_new_tokens=6,
                                     temperature=0.0, stop=[stop],
                                     on_token=lambda t, b: streamed.append(b))],
                    batch_size=1)
    assert not fin[0].stop_hit
    assert fin[0].out_bytes == text == b"".join(streamed)


def test_per_slot_top_k_one_is_greedy(engine):
    prompts = ["hello", "abc xyz"]
    want = [engine.generate(_enc(engine, p), num_steps=5, temperature=0.0)[0]
            for p in prompts]
    _, got = _serve(engine, [
        Request(prompt_tokens=_enc(engine, prompts[0]), max_new_tokens=5,
                temperature=0.9, top_k=1),
        Request(prompt_tokens=_enc(engine, prompts[1]), max_new_tokens=5,
                temperature=0.0)], batch_size=2)
    assert [r.out_tokens for r in got] == want


def test_logprobs_match_rescoring(engine):
    """Each emitted token's log-probability equals the log-softmax of the
    teacher-forced logits after the same tokens, within 1e-4."""
    prompt = _enc(engine, "hello world")
    _, fin = _serve(engine, [Request(prompt_tokens=prompt, max_new_tokens=6,
                                     temperature=0.8, logprobs=True)],
                    batch_size=2, logprobs=True)
    r = fin[0]
    seq = prompt + r.out_tokens
    _, _, lp, _ = engine.hydrate(engine.new_cache(), seq, 0, want_last_logits=False,
                                 target_tokens=seq[1:] + [0])
    want = lp[len(prompt) - 1:len(seq) - 1]
    np.testing.assert_allclose(r.out_logprobs, want, rtol=0, atol=1e-4)


def test_logprobs_off_leaves_requests_empty(engine):
    _, fin = _serve(engine, [Request(prompt_tokens=_enc(engine, "hi"), max_new_tokens=3,
                                     temperature=0.0, logprobs=True)], batch_size=1)
    assert fin[0].out_logprobs == []


# ---------------------------------------------------------------------------
# prefix cache
# ---------------------------------------------------------------------------

def test_prefix_cache_exact_and_hits(engine):
    """Requests sharing a 16-token prefix: the second and third restore it
    (hits, tokens reused) and give the uncached greedy tokens."""
    base = _enc(engine, "shared system prompt!")[:17]
    prompts = [base + _enc(engine, s)[1:] for s in ("a", "bc", "xyz")]
    want = [engine.generate(p, num_steps=4, temperature=0.0)[0] for p in prompts]
    sched, got = _serve(engine, [Request(prompt_tokens=p, max_new_tokens=4,
                                         temperature=0.0) for p in prompts],
                        batch_size=1, prefix_cache_mb=1, prefix_block=8)
    assert [r.out_tokens for r in got] == want
    st = sched.prefix_cache.stats
    assert st["hits"] >= 2 and st["tokens_reused"] >= 32 and st["blocks"] >= 2


def test_prefix_cache_eviction_keeps_chain_roots(engine):
    """Under a budget of a few blocks, insertion ages a chain deepest first:
    eviction trims the tail and block 0 of the newest chain survives."""
    pc = PrefixCache(block_tokens=4, budget_mb=0)
    cache = engine.new_cache()
    toks = list(range(3, 20))
    engine.hydrate(cache, toks, 0, want_last_logits=False)
    frag_bytes = sum(t.numel() * t.element_size()
                     for t in pc._slice(cache, 0).values())
    pc.budget = 2 * frag_bytes
    pc.insert(toks, cache)
    keys = list(pc._store)
    assert len(keys) == 2
    root = np.asarray(toks[:4], np.int32).tobytes()
    assert root in pc._store                      # the chain's root survives
    reused, frags = pc.match(toks + [1])
    assert reused == 8 and len(frags) == 2


def test_prefix_cache_eviction_keeps_correctness(engine):
    base = _enc(engine, "shared prefix text")[:13]
    prompts = [base + [40 + i] for i in range(4)]
    want = [engine.generate(p, num_steps=3, temperature=0.0)[0] for p in prompts]
    _, got = _serve(engine, [Request(prompt_tokens=p, max_new_tokens=3, temperature=0.0)
                             for p in prompts],
                    batch_size=2, prefix_cache_mb=0.002, prefix_block=4)
    assert [r.out_tokens for r in got] == want


def test_prefix_cache_skips_past_window_prompts(engine):
    long_prompt = _enc(engine, "word " * 40)
    sched, _ = _serve(engine, [Request(prompt_tokens=long_prompt, max_new_tokens=2,
                                       temperature=0.0)],
                      batch_size=1, prefix_cache_mb=1, prefix_block=8)
    assert sched.prefix_cache.stats["blocks"] == 0


def test_prefix_cache_int8_kv(ckpt):
    """int8 rows, their scales and the sinks' float masters restore exactly:
    prefix-cached greedy tokens equal uncached ones."""
    eng = Engine(ckpt, seed=0, prefill_chunk=8, decode_block=1, device="cpu",
                 kv_cache_dtype="int8")
    base = _enc(eng, "shared system prompt!")[:17]
    prompts = [base + [50], base + [60, 61]]
    want = [eng.generate(p, num_steps=4, temperature=0.0)[0] for p in prompts]
    sched, got = _serve(eng, [Request(prompt_tokens=p, max_new_tokens=4, temperature=0.0)
                              for p in prompts],
                        batch_size=1, prefix_cache_mb=1, prefix_block=8)
    assert [r.out_tokens for r in got] == want
    assert sched.prefix_cache.stats["hits"] == 1


# ---------------------------------------------------------------------------
# speculative serving
# ---------------------------------------------------------------------------

def _spec_requests(eng, temperature=0.0):
    texts = ("ab ab ab ab ab", "xyz xyz xyz", "q")
    return [Request(prompt_tokens=_enc(eng, t), max_new_tokens=n, temperature=temperature)
            for t, n in zip(texts, (20, 14, 9))]


def test_spec_ngram_serving_greedy_matches_plain(engine_spec):
    _, want = _serve(engine_spec, _spec_requests(engine_spec), batch_size=2)
    sched, got = _serve(engine_spec, _spec_requests(engine_spec), batch_size=2,
                        spec="ngram", spec_k=3)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert sched.spec_stats["dispatches"] >= 1 and sched.spec_stats["rounds"] >= 3


def test_spec_ngram_serving_matches_jax_sampled(spec_dir, engine_spec):
    """At 0.8 the batched n-gram rounds draw the JAX rounds' keys: the JAX
    scheduler's tokens and speculation counts."""
    jeng = JaxEngine(spec_dir, seed=0, prefill_chunk=8, decode_block=1)
    jsched = JaxScheduler(jeng, batch_size=2, spec="ngram", spec_k=3)
    for r in _spec_requests(engine_spec, 0.8):
        jsched.submit(JaxRequest(prompt_tokens=r.prompt_tokens,
                                 max_new_tokens=r.max_new_tokens, temperature=0.8))
    want = [r.out_tokens for r in jsched.run()]
    sched, got = _serve(engine_spec, _spec_requests(engine_spec, 0.8), batch_size=2,
                        spec="ngram", spec_k=3)
    assert [r.out_tokens for r in got] == want
    assert sched.spec_stats == jsched.spec_stats


def test_spec_serving_window_fallback(engine):
    """In a 32-slot window the spans rarely fit: plain blocks take over and
    the tokens stay plain serving's."""
    reqs = lambda: [Request(prompt_tokens=_enc(engine, "ab ab ab ab"), max_new_tokens=24,
                            temperature=0.0)]
    _, want = _serve(engine, reqs(), batch_size=1)
    _, got = _serve(engine, reqs(), batch_size=1, spec="ngram", spec_k=3)
    assert got[0].out_tokens == want[0].out_tokens


def test_spec_serving_with_logprobs_and_prefix_cache(engine_spec):
    reqs = lambda: [Request(prompt_tokens=r.prompt_tokens, max_new_tokens=r.max_new_tokens,
                            temperature=0.0, logprobs=True)
                    for r in _spec_requests(engine_spec)]
    _, want = _serve(engine_spec, reqs(), batch_size=2, logprobs=True)
    _, got = _serve(engine_spec, reqs(), batch_size=2, logprobs=True, spec="ngram",
                    spec_k=3, prefix_cache_mb=1, prefix_block=4)
    # the verify chunk's log-probabilities against the decode steps': 1e-3
    # (the two forwards sum in other orders over the f16 cache)
    for g, w in zip(got, want):
        assert g.out_tokens == w.out_tokens
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs, rtol=0, atol=1e-3)


def test_spec_mtp_serving_greedy_matches_plain(engine_mtp):
    prompts = [_enc(engine_mtp, t) for t in ("ab", "ba xy", "q")]
    reqs = lambda lp=False: [Request(prompt_tokens=p, max_new_tokens=n, temperature=0.0,
                                     logprobs=lp)
                             for p, n in zip(prompts, (16, 12, 10))]
    _, want = _serve(engine_mtp, reqs(True), batch_size=2, logprobs=True)
    sched, got = _serve(engine_mtp, reqs(True), batch_size=2, spec="mtp", spec_k=2,
                        logprobs=True)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    for g, w in zip(got, want):      # verify chunks against decode steps
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs, rtol=0, atol=1e-3)
    assert sched.spec_stats["dispatches"] >= 1


def test_spec_mtp_serving_sampled_runs(engine_mtp):
    sched, got = _serve(engine_mtp, [Request(prompt_tokens=_enc(engine_mtp, "ab"),
                                             max_new_tokens=10, temperature=0.8)],
                        batch_size=2, spec="mtp", spec_k=2)
    assert len(got[0].out_tokens) == 10 and sched.spec_stats["dispatches"] >= 1


def test_spec_rejects_bad_combos(engine):
    with pytest.raises(ValueError, match="unknown spec"):
        BatchScheduler(engine, spec="bogus")
    with pytest.raises(ValueError, match="MTP module"):
        BatchScheduler(engine, spec="mtp")
    with pytest.raises(ValueError, match="verify mode excludes 'seq'"):
        BatchScheduler(engine, batch_size=2, spec="ngram", mesh=Mesh(data=2, seq=2))
    with pytest.raises(ValueError, match="split over the data axis"):
        BatchScheduler(engine, batch_size=3, mesh=Mesh(data=2))


def test_mtp_drafter_refed_after_plain_blocks(engine_mtp):
    """Not copied from serving.py:697: a plain block in MTP serving writes
    its (token, hidden) pairs into the drafter cache, so the rows a probe
    drafts over after backoff are those of a direct MTP verify-mode write
    of the same pairs."""
    from deepseek_tpu_torch.models.mtp import init_mtp_cache, mtp_forward

    eng = engine_mtp
    sched = BatchScheduler(eng, batch_size=2, spec="mtp", spec_k=2, decode_block=4)
    sched._spec_plain_left = 10              # a backoff: plain blocks only
    sched.submit(Request(prompt_tokens=_enc(eng, "ab"), max_new_tokens=9,
                         temperature=0.0))
    sched.step()                             # admission + one plain block
    req = sched.slots[0]
    n_prompt = len(req.prompt_tokens)
    fed = req.out_tokens[:5]                 # tokens fed at n_prompt-1 .. +3
    cm = init_mtp_cache(eng.cfg, batch=1)
    with torch.inference_mode():
        c = eng.new_cache()
        _, h = forward_prefill(eng.params, c, torch.tensor([req.prompt_tokens]), 0,
                               eng.cfg, "none", with_hidden=True)
        hs = []
        for j, t in enumerate(fed[:4]):
            _, hj = forward_decode(eng.params, c, torch.tensor([[t]]), n_prompt + j,
                                   eng.cfg, with_hidden=True)
            hs.append(hj)
        mtp_forward(eng.params, cm, torch.tensor([fed[1:5]]), torch.cat(hs, 1).float(),
                    n_prompt, eng.cfg, prefill=True)
    lo, hi = n_prompt, n_prompt + 4
    for f in ("ckv", "krope"):
        want = getattr(cm, f)[:, 0, lo:hi].float()
        got = getattr(sched._cm, f)[:, 0, lo:hi].float()
        assert float(want.abs().max()) > 0
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-3 * float(want.abs().max()))


def test_spec_stats_stop_at_a_finished_slot(engine_spec):
    """Not copied from serving.py:763: a slot that finishes inside a
    dispatch adds no later rounds, and the slots are counted before the
    emission (the acceptance average stays within [0, 1])."""
    sched = BatchScheduler(engine_spec, batch_size=1, spec="ngram", spec_k=3,
                           spec_rounds=3)
    sched.submit(Request(prompt_tokens=_enc(engine_spec, "ab ab ab ab ab"),
                         max_new_tokens=2, temperature=0.0))
    sched.step()                             # admission: one token
    sched.step()                             # one dispatch: the request ends
    assert sched.slots[0].done
    assert sched.spec_stats["dispatches"] == 1
    assert 1 <= sched.spec_stats["rounds"] < 3
    assert 0.0 <= sched._spec_alpha_ema <= 1.0


def test_idle_block_escalation_matches_plain(engine):
    prompts = ["hello", "abc"]
    want = [engine.generate(_enc(engine, p), num_steps=20, temperature=0.0)[0]
            for p in prompts]
    sched, got = _serve(engine, [Request(prompt_tokens=_enc(engine, p), max_new_tokens=20,
                                         temperature=0.0) for p in prompts],
                        batch_size=2, decode_block=2, idle_block=8)
    assert [r.out_tokens for r in got] == want
    assert 8 in sched._loops                 # the escalated block ran
