"""The port's single-sequence speculation (``Engine.generate_speculative``,
``Engine.generate_ngram``, ``speculative.py``) against the port's own
greedy ``generate`` and against the JAX Engine.

The target and the draft are the tiny absorbed-MLA checkpoints of
``tests/test_speculative.py`` (a 48-slot window, a draft of other weights
and depth). Greedy speculation must give ``generate``'s tokens exactly;
at temperature 0.8 the port draws the JAX Engine's keys, so the tokens and
the ``spec_*`` counts must equal the JAX Engine's at the same seed. The
port runs its plain versions on the CPU.
"""

import numpy as np
import pytest
import torch

from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu.utils import codec
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.ops import prng
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_tinymodel import (
    tiny_checkpoint_tensors, tiny_config, tiny_metadata, tiny_weights,
)


def _ckpt(tmp_path_factory, name, seed, **cfg_kw):
    d = tmp_path_factory.mktemp(name)
    kw = dict(use_mla=True, vocab_size=300, max_seq_len=128,
              rs_original_max_position_embeddings=48)
    kw.update(cfg_kw)
    cfg = tiny_config(**kw)
    codec.save_checkpoint(
        str(d), [tiny_checkpoint_tensors(cfg, tiny_weights(cfg, seed))],
        tiny_metadata(cfg))
    return str(d)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return dict(tgt=_ckpt(tmp_path_factory, "tgt", 42),
                drf=_ckpt(tmp_path_factory, "drf", 7, n_layers=2),
                echo=_ckpt(tmp_path_factory, "ngr", 42, max_seq_len=256,
                           rs_original_max_position_embeddings=128))


def _pair(path, seed=0):
    return (Engine(path, seed=seed, prefill_chunk=8, device="cpu"),
            JaxEngine(path, seed=seed, prefill_chunk=8))


def _stats(st):
    return (st.spec_rounds, st.spec_drafted, st.spec_accepted, st.generated_tokens)


@pytest.mark.parametrize("steps,spec_k", [(24, 3), (60, 4)])
def test_speculative_greedy_matches_generate_and_jax(dirs, steps, spec_k):
    """24 tokens stay in the fused rounds and the stepwise loop; 60 cross
    the 48-slot window into plain decode steps."""
    tgt, jtgt = _pair(dirs["tgt"])
    drf, jdrf = _pair(dirs["drf"])
    prompt = tgt.tokenizer.encode("ab", bos=True)
    want, _ = tgt.generate(prompt, num_steps=steps, temperature=0.0)
    got, st = tgt.generate_speculative(prompt, drf, num_steps=steps,
                                       temperature=0.0, spec_k=spec_k)
    jgot, jst = jtgt.generate_speculative(prompt, jdrf, num_steps=steps,
                                          temperature=0.0, spec_k=spec_k)
    assert got == want == jgot
    assert _stats(st) == _stats(jst)
    assert st.spec_rounds >= 4


def test_speculative_self_draft_accepts_everything(dirs):
    tgt, _ = _pair(dirs["tgt"])
    prompt = tgt.tokenizer.encode("ba", bos=True)
    want, _ = tgt.generate(prompt, num_steps=12, temperature=0.0)
    got, st = tgt.generate_speculative(prompt, tgt, num_steps=12,
                                       temperature=0.0, spec_k=4)
    assert got == want
    assert st.spec_accepted == st.spec_drafted > 0
    assert st.acceptance_rate == 1.0


@pytest.mark.parametrize("steps", [10, 40])
def test_speculative_sampled_matches_jax(dirs, steps):
    """Temperature 0.8: the fused rounds' device draws (and, at 40 tokens,
    the stepwise loop's host draws and the past-window steps) give the JAX
    Engine's tokens and counts at the same seed."""
    tgt, jtgt = _pair(dirs["tgt"], seed=5)
    drf, jdrf = _pair(dirs["drf"], seed=5)
    prompt = tgt.tokenizer.encode("ab", bos=True)
    got, st = tgt.generate_speculative(prompt, drf, num_steps=steps,
                                       temperature=0.8, top_p=0.9, spec_k=3)
    jgot, jst = jtgt.generate_speculative(prompt, jdrf, num_steps=steps,
                                          temperature=0.8, top_p=0.9, spec_k=3)
    assert got == jgot
    assert _stats(st) == _stats(jst)


@pytest.mark.parametrize("text", ["ab ab ab ab", "xyzq"])
def test_ngram_greedy_matches_generate_and_jax(dirs, text):
    """A repetitive prompt (the matcher fires) and a fresh one (all-miss
    rounds, then the dry back-off to plain blocks)."""
    tgt, jtgt = _pair(dirs["tgt"])
    prompt = tgt.tokenizer.encode(text, bos=True)
    want, _ = tgt.generate(prompt, num_steps=24, temperature=0.0)
    got, st = tgt.generate_ngram(prompt, num_steps=24, temperature=0.0, spec_k=3)
    jgot, jst = jtgt.generate_ngram(prompt, num_steps=24, temperature=0.0, spec_k=3)
    assert got == want == jgot
    assert _stats(st) == _stats(jst)
    assert st.spec_rounds >= 1


def test_ngram_sampled_matches_jax(dirs):
    tgt, jtgt = _pair(dirs["tgt"], seed=11)
    prompt = tgt.tokenizer.encode("ab ab ab ab", bos=True)
    got, st = tgt.generate_ngram(prompt, num_steps=30, temperature=0.8,
                                 top_p=0.9, spec_k=3)
    jgot, jst = jtgt.generate_ngram(prompt, num_steps=30, temperature=0.8,
                                    top_p=0.9, spec_k=3)
    assert got == jgot
    assert _stats(st) == _stats(jst)


def test_ngram_accepts_on_context_echo(dirs):
    """A prompt that holds the model's own greedy cycle: the lookup drafts
    what the target emits, and the output is still plain decode's
    (``test_speculative.py::test_ngram_accepts_on_context_echo``)."""
    eng, jeng = _pair(dirs["echo"])
    prompt = eng.tokenizer.encode("ab ab ab", bos=True)
    want, _ = eng.generate(prompt, num_steps=48, temperature=0.0)
    p2 = prompt + want[:32]
    want2, _ = eng.generate(p2, num_steps=16, temperature=0.0)
    got, st = eng.generate_ngram(p2, num_steps=16, temperature=0.0, spec_k=4)
    jgot, jst = jeng.generate_ngram(p2, num_steps=16, temperature=0.0, spec_k=4)
    assert got == want2 == jgot
    assert _stats(st) == _stats(jst)
    assert st.spec_accepted > 0
    assert st.spec_rounds < len(got)


def test_split_and_uniform_match_jax():
    """``prng.split(key, 3)`` and ``uniform(minval=0)``, the draws of the
    acceptance rule, against ``jax.random``."""
    import jax

    key = jax.random.PRNGKey(1234)
    want = np.asarray(jax.random.split(key, 3))
    got = np.stack(prng.split(prng.PRNGKey(1234), 3))
    np.testing.assert_array_equal(got, want)
    u = prng.uniform(got[0], (7,), minval=0.0).numpy()
    np.testing.assert_array_equal(u, np.asarray(jax.random.uniform(want[0], (7,))))


def test_accept_matches_jax_accept():
    """``speculative._accept`` against the JAX ``_accept`` on random
    distributions, several keys: the same n_acc and next token."""
    import jax.numpy as jnp
    from deepseek_tpu.speculative import _accept as jax_accept
    from deepseek_tpu_torch.speculative import _accept

    rng = np.random.default_rng(0)
    k, V = 4, 50
    for trial in range(8):
        ps = rng.dirichlet(np.full(V, 0.3), size=k + 1).astype(np.float32)
        qs = rng.dirichlet(np.full(V, 0.3), size=k).astype(np.float32)
        drafts = rng.integers(0, V, size=k)
        drafts[:trial % k] = ps[:trial % k].argmax(-1)     # some accepts
        key = prng.split(prng.PRNGKey(trial))[1]
        n, nxt = _accept(torch.from_numpy(ps), torch.from_numpy(qs),
                         torch.from_numpy(drafts), k, key)
        jn, jnxt = jax_accept(jnp.asarray(ps), jnp.asarray(qs),
                              jnp.asarray(drafts, jnp.int32), k, jnp.asarray(key))
        assert (int(n), int(nxt)) == (int(jn), int(jnxt))


def test_accept_pointmass_matches_jax():
    """``_accept_pointmass`` (the batched n-gram rule) against the JAX
    function on random (B, k+1, V) distributions, several keys, one-hot
    rows (temperature 0) among them: the same n_acc and next tokens."""
    import jax.numpy as jnp
    from deepseek_tpu.speculative import _accept_pointmass as jax_pointmass
    from deepseek_tpu_torch.speculative import _accept_pointmass

    rng = np.random.default_rng(1)
    B, k, V = 3, 4, 50
    for trial in range(8):
        ps = rng.dirichlet(np.full(V, 0.3), size=(B, k + 1)).astype(np.float32)
        ps[0] = np.eye(V, dtype=np.float32)[ps[0].argmax(-1)]      # a greedy row
        drafts = rng.integers(0, V, size=(B, k))
        drafts[:, :trial % k] = ps[:, :trial % k].argmax(-1)
        key = prng.split(prng.PRNGKey(trial))[1]
        n, nxt = _accept_pointmass(torch.from_numpy(ps), torch.from_numpy(drafts), k, key)
        jn, jnxt = jax_pointmass(jnp.asarray(ps), jnp.asarray(drafts, jnp.int32), k,
                                 jnp.asarray(key))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_batched_ngram_rounds_match_jax(dirs, temperature):
    """``make_batched_ngram_spec_rounds`` against the JAX maker on the echo
    checkpoint: three rows with their own histories (an echo, a short one,
    a dead row) at per-row positions, per-row sampling parameters (row 0
    greedy either way), 3 rounds of 4 drafts with logprobs: the same
    drafts, accepted counts, next tokens, matches and history, the
    log-probabilities within 1e-3."""
    import jax.numpy as jnp
    from deepseek_tpu.models import init_cache as jax_cache
    from deepseek_tpu.models import make_forward
    from deepseek_tpu.speculative import make_batched_ngram_spec_rounds as jax_maker
    from deepseek_tpu_torch.models.deepseek import forward_prefill
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.speculative import make_batched_ngram_spec_rounds

    eng, jeng = _pair(dirs["echo"])
    cfg, H = eng.cfg, eng.cfg.kv_window
    rng = np.random.default_rng(8)
    pattern = list(rng.integers(3, 300, size=6))
    seqs = [pattern * 3, list(rng.integers(3, 300, size=9)), list(rng.integers(3, 300, 12))]
    pos = np.array([len(s) - 1 for s in seqs])
    hist = np.zeros((3, H), np.int64)
    for b, s in enumerate(seqs):
        hist[b, :len(s)] = s
    width = max(len(s) for s in seqs)
    prompt = np.stack([np.pad(s, (0, width - len(s))) for s in seqs])
    tok = np.array([[s[-1]] for s in seqs])
    temps = np.array([0.0, temperature, temperature], np.float32)
    topp = np.array([0.95, 0.9, 1.0], np.float32)
    topk = np.array([0.0, 5.0, 0.0], np.float32)
    minp = np.array([0.0, 0.0, 0.03], np.float32)
    active = np.array([True, True, False])
    key = prng.split(prng.PRNGKey(4))[1]
    _, jc = make_forward(jeng.cfg, prefill=True, logits_mode="none")(
        jeng.params, jax_cache(jeng.cfg, batch=3), jnp.asarray(prompt, jnp.int32), 0)
    want = jax_maker(jeng.cfg, 4, 3, hist_len=H, with_logprobs=True)(
        jeng.params, jc, jnp.asarray(hist, jnp.int32), jnp.asarray(tok, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(key), jnp.asarray(temps), jnp.asarray(topp),
        jnp.asarray(active), jnp.asarray(topk), jnp.asarray(minp))
    with torch.inference_mode():
        tc = init_cache(cfg, batch=3)
        forward_prefill(eng.params, tc, torch.from_numpy(prompt), 0, cfg, "none")
        got = make_batched_ngram_spec_rounds(cfg, 4, 3, hist_len=H, with_logprobs=True)(
            eng.params, tc, torch.from_numpy(hist), torch.from_numpy(tok), pos, key, temps,
            topp, active, topk, minp)
    for g, w in zip(got[:4], want[:4]):              # drafts, n_acc, next, matched
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(np.asarray(want[3])[0, 0])           # the echo row matched
    np.testing.assert_allclose(got[4].numpy()[:, :2], np.asarray(want[4])[:, :2], rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(got[-1].numpy()[:2], np.asarray(want[-1])[:2])
