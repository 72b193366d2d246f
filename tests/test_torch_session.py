"""``Engine.save_session`` / ``load_session`` of the port against the JAX
Engine's (``deepseek_tpu/engine.py:252-317``).

A 2-layer MoE checkpoint converted from a fake HF directory, absorbed MLA
(latent rows and, in int8, ``sink_krope``) and decompressed MHA (per-head
rows and ``sink_k``), with a 12-slot window: the prompt and the decode
steps before the save run past it, so the ring has wrapped and the sinks
re-rotated. Over bf16 (the codec's raw 16-bit words), f16 and int8 caches:

- a session saved by the port and reloaded in a fresh port Engine holds
  every field bit for bit, the int8 scales and sink masters included, and
  resumed greedy decoding gives the uninterrupted run's tokens;
- a session saved by the port loads in the JAX Engine, and one saved by
  the JAX Engine in the port, each field bit for bit, and both packages
  resume from it to the same next-step logits (within 1e-3 of their
  scale) and greedy tokens (or near-ties within that tolerance);
- a session from another window or cache dtype raises ValueError, as the
  JAX Engine does (``tests/test_engine.py:153-195``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from deepseek_tpu_torch.engine import Engine
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CONTEXT = 12
N_BEFORE, N_AFTER = 4, 6       # greedy steps before the save and after the load
KVS = ("bfloat16", "float16", "int8")


@pytest.fixture(scope="module", params=["mla", "mha"])
def ckpt(request, tmp_path_factory):
    from deepseek_tpu import convert as cv
    from tests.util_hf import hf_config, hf_weights, write_hf_dir
    kind = request.param
    cfg = hf_config(dim=64, hidden=96, q_lora=32 if kind == "mla" else 0, kv_lora=32,
                    nope=16, rope=8, v_dim=16, moe_inter=24, layers=2, vocab=300,
                    n_experts=4, n_active=2)
    root = str(tmp_path_factory.mktemp(f"session-{kind}"))
    hf_dir = os.path.join(root, "hf")
    write_hf_dir(hf_dir, cfg, hf_weights(cfg, seed=61, scale=0.1))
    out = os.path.join(root, "ck")
    cv.convert(hf_dir, out, use_mla=kind == "mla")
    return dict(dir=out, kind=kind,
                prompt=np.random.default_rng(62).integers(3, 300, 14).tolist())


def _engine(ckpt, kv, **kw):
    kw.setdefault("context", CONTEXT)
    return Engine(ckpt["dir"], device="cpu", seed=0, prefill_chunk=8, kv_cache_dtype=kv,
                  **kw)


def _jax_engine(ckpt, kv, **kw):
    from deepseek_tpu.engine import Engine as JaxEngine
    kw.setdefault("context", CONTEXT)
    return JaxEngine(ckpt["dir"], seed=0, prefill_chunk=8, kv_cache_dtype=kv,
                     decode_block=1, **kw)


def _greedy(eng, cache, tok, pos, n):
    """n greedy decode steps fed ``tok`` at ``pos``: (tokens, logits)."""
    toks, logits = [], []
    for _ in range(n):
        lg = eng.step(cache, tok, pos)[0].float().numpy()
        logits.append(lg)
        tok, pos = int(np.argmax(lg)), pos + 1
        toks.append(tok)
    return toks, logits


def _hydrated(eng, prompt):
    """The prompt hydrated, then N_BEFORE greedy steps: (cache, next token
    to feed, its position, the tokens so far)."""
    cache, logits, _, pos = eng.hydrate(eng.new_cache(), prompt, 0)
    tok = int(np.argmax(np.asarray(logits).reshape(-1)))
    toks, _ = _greedy(eng, cache, tok, pos, N_BEFORE)
    return cache, toks[-1], pos + N_BEFORE, [tok] + toks


def _bits(x) -> np.ndarray:
    """Any cache array (a torch tensor or a numpy/JAX array, bf16 included)
    as raw bits."""
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same_cache(got, want):
    """Every field of two caches (either package's) equal bit for bit."""
    names = sorted(f.name for f in dataclasses.fields(got))
    assert names == sorted(f.name for f in dataclasses.fields(want))
    for f in names:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a, b = _bits(a), _bits(b)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def _same_or_near_tie(logits, want, got):
    for lg, w, g in zip(logits, want, got):
        if w != g:
            assert lg[w] - lg[g] <= 1e-3 * np.abs(lg).max()
            return


@pytest.mark.parametrize("kv", KVS)
def test_port_session_resumes_like_the_uninterrupted_run(ckpt, kv, tmp_path):
    eng = _engine(ckpt, kv)
    cache, tok, pos, so_far = _hydrated(eng, ckpt["prompt"])
    assert pos > CONTEXT                       # the ring has wrapped
    path = str(tmp_path / "session.dseek")
    eng.save_session(path, cache, pos, tokens=ckpt["prompt"] + so_far)
    want, _ = _greedy(eng, cache, tok, pos, N_AFTER)

    fresh = _engine(ckpt, kv)
    loaded, pos2, toks2 = fresh.load_session(path)
    assert pos2 == pos and toks2 == ckpt["prompt"] + so_far
    saved, _, _, _ = _hydrated(eng, ckpt["prompt"])
    _assert_same_cache(loaded, saved)
    assert loaded.quantized == (kv == "int8")
    assert all(t.device == fresh.device for t in
               (getattr(loaded, f.name) for f in dataclasses.fields(loaded))
               if t is not None)
    got, _ = _greedy(fresh, loaded, toks2[-1], pos2, N_AFTER)
    assert got == want


@pytest.mark.parametrize("kv", KVS)
def test_port_session_loads_in_jax(ckpt, kv, tmp_path):
    import jax.numpy as jnp
    eng = _engine(ckpt, kv)
    cache, tok, pos, so_far = _hydrated(eng, ckpt["prompt"])
    path = str(tmp_path / "port.dseek")
    eng.save_session(path, cache, pos, tokens=so_far)
    jeng = _jax_engine(ckpt, kv)
    jcache, jpos, jtoks = jeng.load_session(path)
    assert jpos == pos and jtoks == so_far
    _assert_same_cache(jcache, cache)

    step = jeng.fwd(False, "last")
    jt, jlog = tok, []
    for i in range(N_AFTER):
        lg, jcache = step(jeng.params, jcache, jnp.asarray([[jt]], jnp.int32), pos + i)
        jlog.append(np.asarray(lg[0]))
        jt = int(np.argmax(jlog[-1]))
    want = [int(np.argmax(l)) for l in jlog]
    got, plog = _greedy(eng, cache, tok, pos, N_AFTER)
    np.testing.assert_allclose(plog[0], jlog[0], rtol=0, atol=1e-3 * np.abs(jlog[0]).max())
    _same_or_near_tie(jlog, want, got)


@pytest.mark.parametrize("kv", KVS)
def test_jax_session_loads_in_port(ckpt, kv, tmp_path):
    import jax.numpy as jnp
    jeng = _jax_engine(ckpt, kv)
    jcache, logits, _, pos = jeng.hydrate(jeng.new_cache(), ckpt["prompt"], 0)
    step = jeng.fwd(False, "last")
    tok = int(np.argmax(np.asarray(logits).reshape(-1)))
    for _ in range(N_BEFORE):
        lg, jcache = step(jeng.params, jcache, jnp.asarray([[tok]], jnp.int32), pos)
        tok, pos = int(np.argmax(np.asarray(lg[0]))), pos + 1
    path = str(tmp_path / "jax.dseek")
    jeng.save_session(path, jcache, pos, tokens=[tok])

    eng = _engine(ckpt, kv)
    cache, pos2, toks = eng.load_session(path)
    assert pos2 == pos and toks == [tok]
    _assert_same_cache(cache, jcache)
    jt, jlog = tok, []
    for i in range(N_AFTER):
        lg, jcache = step(jeng.params, jcache, jnp.asarray([[jt]], jnp.int32), pos + i)
        jlog.append(np.asarray(lg[0]))
        jt = int(np.argmax(jlog[-1]))
    got, plog = _greedy(eng, cache, tok, pos, N_AFTER)
    np.testing.assert_allclose(plog[0], jlog[0], rtol=0, atol=1e-3 * np.abs(jlog[0]).max())
    _same_or_near_tie(jlog, [int(np.argmax(l)) for l in jlog], got)


def test_incompatible_session_raises(ckpt, tmp_path):
    """Another window or another cache dtype: ValueError naming the
    differing keys, in the port as in the JAX Engine."""
    eng = _engine(ckpt, "int8")
    cache, tok, pos, _ = _hydrated(eng, ckpt["prompt"])
    path = str(tmp_path / "s.dseek")
    eng.save_session(path, cache, pos)
    for other in (_engine(ckpt, "int8", context=16), _engine(ckpt, "bfloat16")):
        with pytest.raises(ValueError, match="incompatible"):
            other.load_session(path)
    with pytest.raises(ValueError, match="incompatible"):
        _jax_engine(ckpt, "int8", context=16).load_session(path)
    assert _engine(ckpt, "int8").load_session(path)[2] is None


def test_session_fingerprint_matches_jax(ckpt):
    """The same metadata strings as the JAX Engine's, key for key."""
    for kv in KVS:
        assert _engine(ckpt, kv)._session_fingerprint() == \
            _jax_engine(ckpt, kv)._session_fingerprint()
    assert Engine._SESSION_FPR_KEYS == tuple(_engine(ckpt, "int8")._session_fingerprint())
