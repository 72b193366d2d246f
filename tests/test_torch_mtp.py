"""The port's MTP layer (``models/mtp.py``, ``ModelParams.mtp``) and MTP
self-speculation (``Engine.generate_mtp``) against the JAX package.

The checkpoint is ``tests/test_mtp.py``'s: a converted fp32 absorbed-MLA
V2-style model with DeepSeek-V3's extra MTP layer. The MTP forward and the
main forwards' hidden states are held against ``make_mtp_forward`` and
``_forward_impl(with_hidden=True)`` on the same weights; greedy
``generate_mtp`` must give ``generate``'s tokens, sampled the JAX Engine's
at the same seed. The port runs its plain versions on the CPU.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu import convert as cv
from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu.models import init_cache as jax_cache
from deepseek_tpu.models import make_forward
from deepseek_tpu.models.mtp import init_mtp_cache as jax_mtp_cache
from deepseek_tpu.models.mtp import make_mtp_forward
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.models.deepseek import forward_decode, forward_prefill
from deepseek_tpu_torch.models.kvcache import init_cache
from deepseek_tpu_torch.models.mtp import init_mtp_cache, mtp_forward
from deepseek_tpu_torch.ops import prng
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir

_CFG = dict(dim=64, hidden=96, q_lora=48, kv_lora=32, nope=16, rope=16, v_dim=16,
            layers=2, vocab=300)


def _convert(root, mtp: bool, seed: int) -> str:
    cfg = hf_config(**_CFG)
    hf_dir = os.path.join(root, "hf")
    write_hf_dir(hf_dir, cfg, hf_weights(cfg, seed=seed, scale=0.15, mtp=mtp))
    out = os.path.join(root, "ck")
    cv.convert(hf_dir, out, quant="fp32", use_mla=True)
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _convert(str(tmp_path_factory.mktemp("mtp")), True, 9)


@pytest.fixture(scope="module")
def engines(ckpt):
    return (Engine(ckpt, seed=0, prefill_chunk=8, device="cpu"),
            JaxEngine(ckpt, seed=0, prefill_chunk=8))


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= tol * scale


def test_mtp_params_loaded(engines, ckpt, tmp_path):
    eng, _ = engines
    mp = eng.params.mtp
    assert mp is not None
    assert mp.eh_proj.shape == (eng.cfg.dim, 2 * eng.cfg.dim)
    assert mp.block.wkvq is not None and mp.block.moegate is not None
    assert Engine(ckpt, device="cpu", load_mtp=False).params.mtp is None
    plain = _convert(str(tmp_path), False, 10)
    assert Engine(plain, device="cpu").params.mtp is None


def test_mtp_forward_matches_jax(engines):
    """Prefill of 6 (token, hidden) pairs at position 0, then decode steps
    at 6 and 7: logits and the MTP hidden state within 1e-4 of scale."""
    eng, jeng = engines
    cfg = eng.cfg
    rng = np.random.default_rng(3)
    toks = rng.integers(3, cfg.vocab_size, size=(1, 8))
    h = rng.standard_normal((1, 8, cfg.dim)).astype(np.float32)
    pre, step = (make_mtp_forward(jeng.cfg, prefill=p, jit=False) for p in (True, False))
    jc = jax_mtp_cache(jeng.cfg)
    tc = init_mtp_cache(cfg)
    jl, jh, jc = pre(jeng.params, jc, jnp.asarray(toks[:, :6], jnp.int32),
                     jnp.asarray(h[:, :6]), 0)
    tl, th, tc = mtp_forward(eng.params, tc, torch.from_numpy(toks[:, :6]),
                             torch.from_numpy(h[:, :6]), 0, cfg, prefill=True)
    _close(tl, jl)
    _close(th, jh)
    for p in (6, 7):
        jl, jh, jc = step(jeng.params, jc, jnp.asarray(toks[:, p:p + 1], jnp.int32),
                          jnp.asarray(h[:, p:p + 1]), p)
        tl, th, tc = mtp_forward(eng.params, tc, torch.from_numpy(toks[:, p:p + 1]),
                                 torch.from_numpy(h[:, p:p + 1]), p, cfg, prefill=False)
        _close(tl, jl)
        _close(th, jh)


def test_mtp_verify_mode_raises(engines):
    """The MTP verify mode (``_mtp_impl`` with pos0 (B,), ``mtp.py:63-70``)
    against the JAX one: after a 6-pair prefill of three rows, 3 pairs a
    row at per-row starts 6/2/4 give the JAX logits and MTP hidden states
    within 1e-4 of their scale and the same cache, and a decode step at
    per-row positions after them likewise. A start past the window raises,
    as the JAX caller's guard does."""
    eng, jeng = engines
    cfg = eng.cfg
    rng = np.random.default_rng(4)
    toks = rng.integers(3, cfg.vocab_size, size=(3, 10))
    h = rng.standard_normal((3, 10, cfg.dim)).astype(np.float32)
    pre, step = (make_mtp_forward(jeng.cfg, prefill=p, jit=False) for p in (True, False))
    starts = np.array([6, 2, 4])
    jc, tc = jax_mtp_cache(jeng.cfg, batch=3), init_mtp_cache(cfg, batch=3)
    _, _, jc = pre(jeng.params, jc, jnp.asarray(toks[:, :6], jnp.int32), jnp.asarray(h[:, :6]), 0)
    mtp_forward(eng.params, tc, torch.from_numpy(toks[:, :6]), torch.from_numpy(h[:, :6]), 0,
                cfg, prefill=True)
    jl, jh, jc = pre(jeng.params, jc, jnp.asarray(toks[:, 6:9], jnp.int32),
                     jnp.asarray(h[:, 6:9]), jnp.asarray(starts, jnp.int32))
    tl, th, tc = mtp_forward(eng.params, tc, torch.from_numpy(toks[:, 6:9]),
                             torch.from_numpy(h[:, 6:9]), starts, cfg, prefill=True)
    _close(tl, jl)
    _close(th, jh)
    for f in ("ckv", "krope"):
        _close(getattr(tc, f).float(), np.asarray(getattr(jc, f), np.float32), tol=1e-3)
    jl, jh, _ = step(jeng.params, jc, jnp.asarray(toks[:, 9:], jnp.int32),
                     jnp.asarray(h[:, 9:]), jnp.asarray(starts + 3, jnp.int32))
    tl, th, _ = mtp_forward(eng.params, tc, torch.from_numpy(toks[:, 9:]),
                            torch.from_numpy(h[:, 9:]), starts + 3, cfg, prefill=False)
    _close(tl, jl)
    _close(th, jh)
    with pytest.raises(ValueError, match="window"):
        mtp_forward(eng.params, tc, torch.from_numpy(toks[:, 6:9]), torch.from_numpy(h[:, 6:9]),
                    np.array([0, cfg.kv_window - 2, 0]), cfg, prefill=True)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_batched_mtp_rounds_match_jax(engines, temperature):
    """``make_batched_mtp_spec_rounds`` against the JAX maker: three rows
    after a shared 10-token prefill, at per-row positions 10/7/9, per-row
    sampling parameters (row 0 greedy at 0 and 0.8 alike) and row 2 dead;
    3 rounds of 2 drafts with logprobs. The same drafts, accepted counts
    and next tokens, the log-probabilities within 1e-3 and the hidden
    states within 1e-3 of their scale."""
    from deepseek_tpu.speculative import make_batched_mtp_spec_rounds as jax_maker
    from deepseek_tpu_torch.speculative import make_batched_mtp_spec_rounds

    eng, jeng = engines
    cfg = eng.cfg
    rng = np.random.default_rng(6)
    prompt = rng.integers(3, cfg.vocab_size, size=(3, 10))
    tok = rng.integers(3, cfg.vocab_size, size=(3, 1))
    h = rng.standard_normal((3, 1, cfg.dim)).astype(np.float32)
    pos = np.array([10, 7, 9])
    temps = np.array([0.0, temperature, temperature], np.float32)
    topp = np.array([0.95, 0.9, 1.0], np.float32)
    topk = np.array([0.0, 0.0, 6.0], np.float32)
    minp = np.array([0.0, 0.02, 0.0], np.float32)
    active = np.array([True, True, False])
    key = prng.split(prng.PRNGKey(2))[1]
    fwd = make_forward(jeng.cfg, prefill=True, logits_mode="none")
    _, jc = fwd(jeng.params, jax_cache(jeng.cfg, batch=3), jnp.asarray(prompt, jnp.int32), 0)
    want = jax_maker(jeng.cfg, 2, 3, with_logprobs=True)(
        jeng.params, jc, jax_mtp_cache(jeng.cfg, batch=3), jnp.asarray(tok, jnp.int32),
        jnp.asarray(h), jnp.asarray(pos, jnp.int32), jnp.asarray(key), jnp.asarray(temps),
        jnp.asarray(topp), jnp.asarray(active), jnp.asarray(topk), jnp.asarray(minp))
    with torch.inference_mode():
        tc = init_cache(cfg, batch=3)
        forward_prefill(eng.params, tc, torch.from_numpy(prompt), 0, cfg, "none")
        got = make_batched_mtp_spec_rounds(cfg, 2, 3, with_logprobs=True)(
            eng.params, tc, init_mtp_cache(cfg, batch=3), torch.from_numpy(tok),
            torch.from_numpy(h), pos, key, temps, topp, active, topk, minp)
    for g, w in zip(got[:3], want[:3]):              # drafts, n_acc, next
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    live = active[None, :]
    np.testing.assert_allclose(got[3].numpy()[:, live[0]], np.asarray(want[3])[:, live[0]],
                               rtol=0, atol=1e-3)
    _close(got[4][live[0]], np.asarray(want[4])[live[0]], tol=1e-3)
def test_forward_hidden_matches_jax(engines):
    """``forward_prefill``/``forward_decode(with_hidden=True)`` against
    ``_forward_impl(with_hidden=True)``: a 5-token chunk, then a step."""
    eng, jeng = engines
    cfg = eng.cfg
    toks = np.array([[1, 40, 41, 42, 43, 44]])
    jpre = make_forward(jeng.cfg, prefill=True, logits_mode="all", jit=False,
                        with_hidden=True)
    jdec = make_forward(jeng.cfg, prefill=False, logits_mode="last", jit=False,
                        with_hidden=True)
    jc = jax_cache(jeng.cfg)
    jl, jh, jc = jpre(jeng.params, jc, jnp.asarray(toks[:, :5], jnp.int32), 0)
    tc = init_cache(cfg)
    tl, th = forward_prefill(eng.params, tc, torch.from_numpy(toks[:, :5]), 0, cfg,
                             "all", with_hidden=True)
    _close(tl, jl)
    _close(th, jh)
    _, th_none = forward_prefill(eng.params, init_cache(cfg),
                                 torch.from_numpy(toks[:, :5]), 0, cfg, "none",
                                 with_hidden=True)
    _close(th_none, jh)
    jl, jh, _ = jdec(jeng.params, jc, jnp.asarray(toks[:, 5:], jnp.int32), 5)
    tl, th = forward_decode(eng.params, tc, torch.from_numpy(toks[:, 5:]), 5, cfg,
                            with_hidden=True)
    _close(tl, jl)
    _close(th, jh)


@pytest.mark.parametrize("spec_k,text", [(2, "ab"), (4, "ba")])
def test_mtp_greedy_matches_generate(engines, spec_k, text):
    """Past the 24-slot window too: fused rounds, the stepwise loop and
    plain steps."""
    eng, _ = engines
    prompt = eng.tokenizer.encode(text, bos=True)
    want, _ = eng.generate(prompt, num_steps=30, temperature=0.0)
    got, st = eng.generate_mtp(prompt, num_steps=30, temperature=0.0, spec_k=spec_k)
    assert got == want
    assert st.spec_rounds >= 4


def test_mtp_sampled_matches_jax(ckpt):
    eng = Engine(ckpt, seed=3, prefill_chunk=8, device="cpu")
    jeng = JaxEngine(ckpt, seed=3, prefill_chunk=8)
    prompt = eng.tokenizer.encode("ab", bos=True)
    got, st = eng.generate_mtp(prompt, num_steps=24, temperature=0.8, top_p=0.9,
                               spec_k=2)
    jgot, jst = jeng.generate_mtp(prompt, num_steps=24, temperature=0.8, top_p=0.9,
                                  spec_k=2)
    assert got == jgot
    assert (st.spec_rounds, st.spec_drafted, st.spec_accepted) == \
        (jst.spec_rounds, jst.spec_drafted, jst.spec_accepted)
    assert st.spec_accepted > 0


def test_mtp_int8_cache(ckpt):
    """The int8 cache (the MTP cache int8 too, with its sinks' float
    masters): greedy generate_mtp gives generate's tokens past the window,
    and the JAX Engine's."""
    eng = Engine(ckpt, seed=0, prefill_chunk=8, device="cpu", kv_cache_dtype="int8")
    jeng = JaxEngine(ckpt, seed=0, prefill_chunk=8, kv_cache_dtype="int8")
    assert init_mtp_cache(eng.cfg).quantized
    prompt = eng.tokenizer.encode("ab", bos=True)
    want, _ = eng.generate(prompt, num_steps=30, temperature=0.0)
    got, _ = eng.generate_mtp(prompt, num_steps=30, temperature=0.0, spec_k=2)
    jgot, _ = jeng.generate_mtp(prompt, num_steps=30, temperature=0.0, spec_k=2)
    assert got == want == jgot
