"""The port's continuous batching and batched n-gram speculation over a
device mesh (``BatchScheduler(mesh=)``) against the JAX package.

The scheduler runs SPMD, one on every gloo rank (``parallel/launch.py``),
each rank holding its slices of the weights and its data shard's rows of
the batch's cache; the JAX scheduler is one controller over a virtual
device mesh.

- ``tests/test_serving.py::test_scheduler_dp_sharded_matches_unsharded``'s
  setup at data=2 x expert=2 x tensor=2 (eight ranks), with logprobs and a
  prefix cache: every rank's requests carry the unsharded JAX scheduler's
  greedy tokens and its log-probabilities within 1e-3, the prefix cache
  hits as JAX's does, and the ranks' outputs are bit-equal.
- The same at seq=2: the unsharded JAX scheduler's tokens, log-probs and
  prefix-cache statistics, each rank's prefix blocks holding its slots.
- At temperature 0.8 at data=2: the JAX data=2 mesh scheduler's tokens
  (the decode blocks' keys folded with the data index).
- ``test_spec_serving_dp_mesh_matches_unsharded``'s setup, spec="ngram"
  at data=2 x tensor=2: the unsharded JAX spec scheduler's greedy tokens,
  the fused rounds dispatched, the ranks bit-equal.
- spec="ngram" at 0.8 over data=2: the JAX data=2 mesh spec scheduler's
  tokens (the rounds' keys folded with the data index).
- The JAX refusals: spec="ngram" over a seq axis, spec="mtp" over any
  mesh (the scheduler and the MTP maker), a batch the data axis does not
  divide.

The ranks import this module to find their bodies, so it imports JAX only
inside the functions that build the reference.
"""

import os

import numpy as np
import pytest

from deepseek_tpu_torch.parallel.launch import launch
from deepseek_tpu_torch.parallel.mesh import Mesh, make_mesh
from deepseek_tpu_torch.serving import BatchScheduler, Request
from tests.test_torch_threads import one_torch_thread  # noqa: F401

PROMPTS = ["hello", "abc xyz", "q", "hello world, hello"]
LENS = [5, 4, 3, 6]
SPEC_N = 10


def _write(d, window, max_seq_len):
    from deepseek_tpu.utils import codec
    from tests.util_tinymodel import (
        tiny_checkpoint_tensors, tiny_config, tiny_metadata, tiny_weights)
    cfg = tiny_config(use_mla=True, vocab_size=300, max_seq_len=max_seq_len,
                      rs_original_max_position_embeddings=window)
    codec.save_checkpoint(str(d), [tiny_checkpoint_tensors(cfg, tiny_weights(cfg, 55))],
                          tiny_metadata(cfg))
    return str(d)


def _engine(ckpt):
    from deepseek_tpu_torch.engine import Engine
    return Engine(ckpt, seed=0, prefill_chunk=8, decode_block=1, device="cpu")


def _requests(tok, temperature, logprobs=False):
    return [dict(prompt_tokens=tok.encode(p, bos=True), max_new_tokens=n,
                 temperature=temperature, logprobs=logprobs) for p, n in zip(PROMPTS, LENS)]


def _serve(sched, reqs, cls):
    out = [cls(**r) for r in reqs]
    for r in out:
        sched.submit(r)
    sched.run()
    return out


def _token_requests(prompts, temperature, kw):
    return [dict(prompt_tokens=list(p), max_new_tokens=SPEC_N, temperature=temperature,
                 logprobs=kw.get("logprobs", False)) for p in prompts]


def _spec_prompts(ckpt):
    """test_spec_serving_dp_mesh_matches_unsharded's prompts: a seed text
    and its greedy continuation cut at 32 and 24 tokens."""
    from deepseek_tpu.engine import Engine as JaxEngine
    jeng = JaxEngine(ckpt, seed=0, prefill_chunk=8, decode_block=1)
    seed = jeng.tokenizer.encode("ab ab ab", bos=True)
    cont, _ = jeng.generate(seed, num_steps=48, temperature=0.0)
    return jeng, [seed + cont[:32], seed + cont[:24]]


def _rank_serve(rank, world, shape, ckpt, temperature, kw, prompts=None):
    """One rank's scheduler over ``shape``: the PROMPTS requests (or
    ``prompts``, token lists of SPEC_N new tokens each) -> (tokens,
    logprobs, bytes) of each, spec and prefix statistics."""
    mesh = make_mesh(**shape)
    eng = _engine(ckpt)
    sched = BatchScheduler(eng, mesh=mesh, **kw)
    if prompts is None:
        reqs = _serve(sched, _requests(eng.tokenizer, temperature, kw.get("logprobs", False)),
                      Request)
    else:
        reqs = _serve(sched, _token_requests(prompts, temperature, kw), Request)
    return dict(out=[(r.out_tokens, r.out_logprobs, r.out_bytes) for r in reqs],
                spec=dict(sched.spec_stats),
                prefix=None if sched.prefix_cache is None else sched.prefix_cache.stats,
                rows=(sched._rows.start, sched._rows.stop), cache_rows=sched.cache.batch)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return {"plain": _write(tmp_path_factory.mktemp("srvmesh"), 32, 128),
            "spec": _write(tmp_path_factory.mktemp("srvmeshspec"), 128, 256)}


PLAIN_KW = dict(batch_size=2, decode_block=2, logprobs=True, prefix_cache_mb=8.0,
                prefix_block=4)


def _jax_serve(ckpt, temperature, mesh_shape=None, **kw):
    from deepseek_tpu.engine import Engine as JaxEngine
    from deepseek_tpu.serving import BatchScheduler as JaxScheduler
    from deepseek_tpu.serving import Request as JaxRequest
    jeng = JaxEngine(ckpt, seed=0, prefill_chunk=8, decode_block=1)
    mesh = None
    if mesh_shape is not None:
        from deepseek_tpu.parallel import make_mesh as jax_mesh
        mesh = jax_mesh(**mesh_shape)
    sched = JaxScheduler(jeng, mesh=mesh, **kw)
    reqs = _serve(sched, _requests(jeng.tokenizer, temperature, kw.get("logprobs", False)),
                  JaxRequest)
    return reqs, sched


def _assert_ranks_equal(ranks):
    for res in ranks[1:]:
        assert res["out"] == ranks[0]["out"]
        assert res["spec"] == ranks[0]["spec"] and res["prefix"] == ranks[0]["prefix"]


def test_scheduler_dp_ep_tp_matches_jax(ckpts):
    """data=2 x expert=2 x tensor=2, eight ranks: four greedy requests
    through two slots (slot reuse, admissions between decode blocks, a
    shared prefix) give the unsharded JAX scheduler's tokens, bytes and
    log-probabilities (1e-3); rank r holds batch row r // 4 only."""
    want, jsched = _jax_serve(ckpts["plain"], 0.0, **PLAIN_KW)
    ranks = launch(_rank_serve, 8, dict(data=2, expert=2, tensor=2), ckpts["plain"], 0.0,
                   PLAIN_KW, timeout=600)
    _assert_ranks_equal(ranks)
    for r, res in enumerate(ranks):
        assert res["rows"] == (r // 4, r // 4 + 1) and res["cache_rows"] == 1
    got = ranks[0]["out"]
    assert [g[0] for g in got] == [w.out_tokens for w in want]
    assert [g[2] for g in got] == [w.out_bytes for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[1], w.out_logprobs, rtol=0, atol=1e-3)
    assert ranks[0]["prefix"]["hits"] == jsched.prefix_cache.stats["hits"] >= 1


def test_scheduler_seq2_prefix_cache_matches_jax(ckpts):
    """Plain serving over seq=2 (each rank holds 16 of the 32 ring slots):
    A shares 8 tokens with B and C, B 24 with C, so that C's prefix hit
    restores A's first two blocks and B's next four, on both ranks; the
    unsharded JAX scheduler's tokens and log-probs, and its prefix-cache
    statistics, bytes included, on both ranks (a block keeps each rank's
    part of its slots and counts the whole block's bytes)."""
    from deepseek_tpu.engine import Engine as JaxEngine
    from deepseek_tpu.serving import BatchScheduler as JaxScheduler
    from deepseek_tpu.serving import Request as JaxRequest
    jeng = JaxEngine(ckpts["plain"], seed=0, prefill_chunk=8, decode_block=1)
    shared = jeng.tokenizer.encode("hello world, hello worl", bos=True)
    assert len(shared) == 24
    prompts = [shared[:8] + jeng.tokenizer.encode("x" * 16)] + [
        shared + jeng.tokenizer.encode(t) for t in ("d", "d!")]
    jsched = JaxScheduler(jeng, **PLAIN_KW)
    want = _serve(jsched, _token_requests(prompts, 0.0, PLAIN_KW), JaxRequest)
    ranks = launch(_rank_serve, 2, dict(seq=2), ckpts["plain"], 0.0, PLAIN_KW, prompts,
                   timeout=600)
    _assert_ranks_equal(ranks)
    got = ranks[0]["out"]
    assert [g[0] for g in got] == [w.out_tokens for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[1], w.out_logprobs, rtol=0, atol=1e-3)
    assert ranks[0]["prefix"] == jsched.prefix_cache.stats
    assert ranks[0]["prefix"]["hits"] == 2 and ranks[0]["prefix"]["tokens_reused"] == 8 + 24


def test_scheduler_data2_sampled_matches_jax_mesh(ckpts):
    """At 0.8 over data=2: the JAX data=2 mesh scheduler's tokens, each
    data shard sampling under its folded key; the two ranks bit-equal."""
    kw = dict(batch_size=2, decode_block=2)
    want, _ = _jax_serve(ckpts["plain"], 0.8, dict(data=2), **kw)
    ranks = launch(_rank_serve, 2, dict(data=2), ckpts["plain"], 0.8, kw, timeout=600)
    _assert_ranks_equal(ranks)
    assert [g[0] for g in ranks[0]["out"]] == [w.out_tokens for w in want]


def test_spec_serving_dp_tp_matches_jax(ckpts):
    """spec="ngram" at data=2 x tensor=2: the unsharded JAX spec
    scheduler's greedy tokens and speculation counts; the rounds ran."""
    from deepseek_tpu.serving import BatchScheduler as JaxScheduler
    from deepseek_tpu.serving import Request as JaxRequest
    jeng, prompts = _spec_prompts(ckpts["spec"])
    kw = dict(batch_size=2, spec="ngram", spec_k=4, spec_rounds=2)
    jsched = JaxScheduler(jeng, **kw)
    want = _serve(jsched, _token_requests(prompts, 0.0, kw), JaxRequest)
    ranks = launch(_rank_serve, 4, dict(data=2, tensor=2), ckpts["spec"], 0.0, kw, prompts,
                   timeout=600)
    _assert_ranks_equal(ranks)
    assert [g[0] for g in ranks[0]["out"]] == [w.out_tokens for w in want]
    assert ranks[0]["spec"]["dispatches"] >= 1
    assert ranks[0]["spec"] == jsched.spec_stats


def test_spec_serving_data2_sampled_matches_jax_mesh(ckpts):
    """spec="ngram" at 0.8 over data=2: the JAX data=2 mesh spec
    scheduler's tokens and dispatches (each data shard's rounds accept
    under its folded key)."""
    from deepseek_tpu.parallel import make_mesh as jax_mesh
    from deepseek_tpu.serving import BatchScheduler as JaxScheduler
    from deepseek_tpu.serving import Request as JaxRequest
    jeng, prompts = _spec_prompts(ckpts["spec"])
    kw = dict(batch_size=2, spec="ngram", spec_k=4, spec_rounds=2)
    jsched = JaxScheduler(jeng, mesh=jax_mesh(data=2), **kw)
    want = _serve(jsched, _token_requests(prompts, 0.8, kw), JaxRequest)
    ranks = launch(_rank_serve, 2, dict(data=2), ckpts["spec"], 0.8, kw, prompts, timeout=600)
    _assert_ranks_equal(ranks)
    assert [g[0] for g in ranks[0]["out"]] == [w.out_tokens for w in want]
    # the rounds and drafts counted differ where a slot finishes inside a
    # dispatch: the JAX fault of serving.py:763, not copied
    assert ranks[0]["spec"]["dispatches"] == jsched.spec_stats["dispatches"] >= 1


def test_mesh_refusals(ckpts, tmp_path):
    """The JAX scheduler's refusals: n-gram speculation over a seq axis
    (verify mode excludes it), MTP speculation over any mesh (its drafter
    is single-chip; the maker refuses too), and a batch that the data axis
    does not divide."""
    from deepseek_tpu import convert as cv
    from deepseek_tpu_torch.engine import Engine
    from deepseek_tpu_torch.speculative import make_batched_mtp_spec_rounds
    from tests.util_hf import hf_config, hf_weights, write_hf_dir
    eng = _engine(ckpts["spec"])
    with pytest.raises(ValueError, match="verify mode excludes 'seq'"):
        BatchScheduler(eng, batch_size=2, spec="ngram", mesh=Mesh(data=2, seq=2))
    with pytest.raises(ValueError, match="split over the data axis"):
        BatchScheduler(eng, batch_size=3, mesh=Mesh(data=2))
    cfg = hf_config(dim=64, hidden=96, q_lora=48, kv_lora=32, nope=16, rope=16,
                    v_dim=16, layers=2, vocab=300)
    write_hf_dir(os.path.join(tmp_path, "hf"), cfg, hf_weights(cfg, seed=9, mtp=True))
    cv.convert(os.path.join(tmp_path, "hf"), os.path.join(tmp_path, "ck"), quant="fp32",
               use_mla=True)
    mtp = Engine(os.path.join(tmp_path, "ck"), seed=0, device="cpu")
    with pytest.raises(ValueError, match="single-chip"):
        BatchScheduler(mtp, batch_size=2, spec="mtp", mesh=Mesh(data=2))
    with pytest.raises(ValueError, match="single-chip"):
        make_batched_mtp_spec_rounds(mtp.cfg, 2, 2, mesh=Mesh(data=2))
    BatchScheduler(mtp, batch_size=2, spec="mtp")          # single-device: accepted
