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
    eng, _ = engines
    cfg = eng.cfg
    with pytest.raises(NotImplementedError, match="item 12"):
        mtp_forward(eng.params, init_mtp_cache(cfg), torch.zeros((2, 3), dtype=torch.int64),
                    torch.zeros((2, 3, cfg.dim)), torch.tensor([0, 4]), cfg, prefill=True)


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
