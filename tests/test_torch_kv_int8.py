"""The port's int8 KV cache (``kv_cache_dtype="int8"``) against the JAX
package.

- ``quantize_rows`` / ``dequant_rows`` bit for bit, zero rows included;
  ``init_cache``'s int8 fields, shapes, dtypes and ``nbytes``.
- The plain K3, K8, K9 and K10 with row scales against the Pallas kernels
  in interpret mode (which fold the scales into scores and weights) and
  against the JAX package's XLA route (dequantize, then the jnp einsums).
- ``forward_prefill`` + ``forward_decode`` on converted checkpoints past
  the window's edge (absorbed MLA, hybrid MLA with ``wq_b``/``wkv_b``,
  MHA), the logits after every chunk and step and the cache afterwards;
  the ring and sinks over 64 tokens in an 8-slot window.
- ``Engine(device="cpu", kv_cache_dtype="int8")`` at its defaults against
  the JAX Engine, greedy and sampled; ``params_active_bytes``.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu import convert as cv
from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu.models import init_cache, make_forward
from deepseek_tpu.models.kvcache import dequant_rows as jax_dequant
from deepseek_tpu.models.kvcache import quantize_rows as jax_quantize
from deepseek_tpu.models.loader import load_params
from deepseek_tpu.models.loader import params_active_bytes as jax_active_bytes
from deepseek_tpu.ops import attention as jax_attn
from deepseek_tpu.ops.pallas import attention as jax_pallas
from deepseek_tpu_torch.config import ModelConfig
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.models import deepseek as port_model
from deepseek_tpu_torch.models.deepseek import (
    forward_decode, forward_prefill, make_decode_loop,
)
from deepseek_tpu_torch.models.kvcache import dequant_rows, init_cache as torch_cache
from deepseek_tpu_torch.models.kvcache import quantize_rows
from deepseek_tpu_torch.models.loader import params_active_bytes, params_from_reference
from deepseek_tpu_torch.ops import prng
from deepseek_tpu_torch.ops.kernels.attention import mha_decode_attn, mla_decode_attn
from deepseek_tpu_torch.ops.kernels.prefill_attn import (
    mha_prefill_attn, mla_prefill_attn,
)
from tests.test_model import make_ckptdata
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir
from tests.util_tinymodel import tiny_config, tiny_metadata, tiny_weights

SEED = 0


def _rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def test_quantize_rows_bit_exact():
    """int8 rows and f32 scales equal to the JAX package's bit for bit,
    over rows of every magnitude, exact halves and zero rows."""
    x = _rnd((3, 7, 64), 1) * np.exp(_rnd((3, 7, 1), 2) * 3)
    x[0, 0] = 0.0                                   # a zero row
    x[1, 2, :8] = np.arange(8) - 3.5                # halves of the scale
    x[2, 3] = 1e-30                                 # a scale below 1e-20
    q, s = quantize_rows(torch.from_numpy(x))
    jq, js = jax_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (3, 7)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(dequant_rows(q, s).numpy(),
                                  np.asarray(jax_dequant(jq, js)))
    assert not torch.isnan(dequant_rows(q, s)).any() and not q[0, 0].any()
    raw = torch.ones(2, 3)
    assert dequant_rows(raw, None) is raw


@pytest.mark.parametrize("use_mla", [True, False], ids=["mla", "mha"])
def test_init_cache_int8_matches_jax(use_mla):
    """Every field of the int8 cache has the JAX shape and dtype (None
    where JAX has None); ``nbytes`` counts the rows and scales, not the
    sink masters. Any other unknown dtype raises."""
    jcfg = tiny_config(use_mla=use_mla, kv_cache_dtype="int8")
    cfg = ModelConfig.from_metadata(tiny_metadata(jcfg), kv_cache_dtype="int8")
    jc, c = init_cache(jcfg, batch=2), torch_cache(cfg, batch=2)
    for f in ("k", "v", "ckv", "krope", "k_s", "v_s", "ckv_s", "krope_s",
              "sink_krope", "sink_k"):
        a, b = getattr(jc, f), getattr(c, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert tuple(b.shape) == a.shape, f
            assert str(b.dtype).split(".")[-1] == str(a.dtype), f
            assert not b.any()
    assert c.quantized and jc.quantized and c.nbytes == jc.nbytes
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        torch_cache(dataclasses.replace(cfg, kv_cache_dtype="int4"))


# ---------------------------------------------------------------------------
# the plain versions of K3, K8, K9, K10 with scales
# ---------------------------------------------------------------------------

def _q8(shape, seed):
    """Random rows quantized by the JAX package: (int8, f32 scales)."""
    return jax_quantize(jnp.asarray(_rnd(shape, seed)))


def _close(got, want_pl, want_xla):
    """Against the Pallas kernel (interpret mode), which folds the scales
    into scores and weights and runs its dots in bf16-free f32 but in
    another order: rtol = atol = 2e-3 (as tests/test_kv_int8.py). Against
    the XLA route, the same dequantize-then-einsum formulation: 1e-5 of
    the output's scale."""
    np.testing.assert_allclose(got, want_pl, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, want_xla, rtol=0,
                               atol=1e-5 * np.abs(want_xla).max())


def test_k3_int8_plain_matches_jax():
    B, H, R, P, S = 2, 4, 64, 32, 256
    qc, qr = _rnd((B, H, R), 3), _rnd((B, H, P), 4)
    ckv, cs = _q8((B, S, R), 5)
    kr, rs = _q8((B, S, P), 6)
    kl = np.asarray([100, 256], np.int32)
    scale = 1.0 / math.sqrt(96.0)
    want_pl = jax_pallas.mla_decode_attn(
        jnp.asarray(qc), jnp.asarray(qr), ckv, kr, jnp.asarray(kl), scale,
        ckv_scale=cs, krope_scale=rs, interpret=True)
    want_xla = jax_attn.decode_attn_mla(
        jnp.asarray(qc), jnp.asarray(qr), jax_dequant(ckv, cs), jax_dequant(kr, rs),
        jnp.asarray(kl), 96, softmax_scale=scale)
    got = mla_decode_attn(_t(qc), _t(qr), _t(ckv), _t(kr), _t(kl), scale,
                          ckv_scale=_t(cs), krope_scale=_t(rs))
    _close(got.numpy(), np.asarray(want_pl), np.asarray(want_xla))


def test_k8_int8_plain_matches_jax():
    """Scales in the JAX kernel's head-major (B,H,S) layout, passed to the
    port as the transposed view of the cache's (B,S,H) scales."""
    B, H, Dh, Dv, S = 2, 3, 48, 32, 256
    q = _rnd((B, H, Dh), 7)
    k, ks = _q8((B, S, H, Dh), 8)
    v, vs = _q8((B, S, H, Dv), 9)
    kl = np.asarray([100, 256], np.int32)
    scale = 1.0 / math.sqrt(Dh)
    want_pl = jax_pallas.mha_decode_attn(
        jnp.asarray(q), k, v, jnp.asarray(kl), scale, k_scale=jnp.swapaxes(ks, 1, 2),
        v_scale=jnp.swapaxes(vs, 1, 2), interpret=True)
    want_xla = jax_attn.decode_attn_mha(
        jnp.asarray(q), jax_dequant(k, ks), jax_dequant(v, vs), jnp.asarray(kl),
        softmax_scale=scale)
    got = mha_decode_attn(_t(q), _t(k), _t(v), _t(kl), scale,
                          k_scale=_t(ks).transpose(1, 2), v_scale=_t(vs).transpose(1, 2))
    _close(got.numpy(), np.asarray(want_pl), np.asarray(want_xla))


@pytest.mark.parametrize("S,q_pos0,cache_pos0", [(64, 7, 0), (61, 20, 3)])
def test_k9_int8_plain_matches_jax(S, q_pos0, cache_pos0):
    B, T, H, Dh, Dv = 2, 12, 3, 48, 32
    q = _rnd((B, T, H, Dh), 10, 0.3)
    k, ks = _q8((B, S, H, Dh), 11)
    v, vs = _q8((B, S, H, Dv), 12)
    scale = 1.0 / math.sqrt(Dh)
    want_pl = jax_pallas.mha_prefill_attn(
        jnp.asarray(q), k, v, q_pos0, cache_pos0, scale,
        k_scale=jnp.swapaxes(ks, 1, 2), v_scale=jnp.swapaxes(vs, 1, 2), interpret=True)
    want_xla = jax_attn.prefill_attn_mha(
        jnp.asarray(q), jax_dequant(k, ks), jax_dequant(v, vs),
        q_pos0 + jnp.arange(T), cache_pos0 + jnp.arange(S), softmax_scale=scale)
    got = mha_prefill_attn(_t(q), _t(k), _t(v), q_pos0, cache_pos0, scale,
                           k_scale=_t(ks).transpose(1, 2), v_scale=_t(vs).transpose(1, 2))
    _close(got.numpy(), np.asarray(want_pl), np.asarray(want_xla))


@pytest.mark.parametrize("S,q_pos0,cache_pos0", [(40, 3, 0), (37, 15, 2)])
def test_k10_int8_plain_matches_jax(S, q_pos0, cache_pos0):
    B, T, H, R, P = 2, 10, 4, 32, 16
    qc, qr = _rnd((B, T, H, R), 13, 0.3), _rnd((B, T, H, P), 14, 0.3)
    ckv, cs = _q8((B, S, R), 15)
    kr, rs = _q8((B, S, P), 16)
    scale = 1.0 / math.sqrt(48.0)
    want_pl = jax_pallas.mla_prefill_attn(
        jnp.asarray(qc), jnp.asarray(qr), ckv, kr, q_pos0, cache_pos0, scale,
        ckv_scale=cs, krope_scale=rs, interpret=True)
    want_xla = jax_attn.prefill_attn_mla(
        jnp.asarray(qc), jnp.asarray(qr), jax_dequant(ckv, cs), jax_dequant(kr, rs),
        q_pos0 + jnp.arange(T), cache_pos0 + jnp.arange(S), 48, softmax_scale=scale)
    got = mla_prefill_attn(_t(qc), _t(qr), _t(ckv), _t(kr), q_pos0, cache_pos0, scale,
                           ckv_scale=_t(cs), krope_scale=_t(rs))
    _close(got.numpy(), np.asarray(want_pl), np.asarray(want_xla))


def test_attention_wrappers_reject_partials():
    """The seq-parallel partials are ported (the seq mesh axis): over an
    int8 cache with scales, ``partials=True`` returns the (acc, m, l)
    triple of the JAX ``decode_attn_mla_partial`` over the dequantized
    rows (1e-5 of each term's scale), and over a shard past the live
    prefix the empty triple: acc 0, l 0, m -1e30."""
    B, H, R, P, S = 2, 4, 64, 32, 24
    qc, qr = _rnd((B, H, R), 21), _rnd((B, H, P), 22)
    ckv, cs = _q8((B, S, R), 23)
    kr, rs = _q8((B, S, P), 24)
    kl = np.asarray([17, 0], np.int32)
    scale = 1.0 / math.sqrt(96.0)
    want = jax_attn.decode_attn_mla_partial(
        jnp.asarray(qc), jnp.asarray(qr), jax_dequant(ckv, cs), jax_dequant(kr, rs),
        jnp.asarray(kl), 96, softmax_scale=scale)
    acc, m, l = mla_decode_attn(_t(qc), _t(qr), _t(ckv), _t(kr), _t(kl), scale,
                                ckv_scale=_t(cs), krope_scale=_t(rs), partials=True)
    for g, w in zip((acc, m, l), want):
        w = np.asarray(w)
        np.testing.assert_allclose(g[0].numpy(), w[0], rtol=0, atol=1e-5 * np.abs(w[0]).max())
    assert not acc[1].any() and not l[1].any() and bool((m[1] == -1e30).all())


# ---------------------------------------------------------------------------
# the forward on converted checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """``checkpoints(kind)``: a 2-layer MoE checkpoint converted from a fake
    HF directory, made once a module: absorbed MLA keeping wq_b/wkv_b
    (``convert --mla``, kind "mla") or decompressed MHA (the converter's
    default, "mha"). F16 weights, window 24."""
    made = {}

    def get(kind):
        if kind not in made:
            root = str(tmp_path_factory.mktemp(kind))
            cfg = hf_config(dim=64, hidden=96, q_lora=32, kv_lora=32, nope=16,
                            rope=8, v_dim=16, moe_inter=24, layers=2, vocab=300,
                            n_experts=4, n_active=2)
            hf_dir = os.path.join(root, "hf")
            write_hf_dir(hf_dir, cfg, hf_weights(cfg, seed=81, scale=0.1))
            out = os.path.join(root, "ck")
            cv.convert(hf_dir, out, use_mla=kind == "mla")
            jeng = JaxEngine(out, seed=SEED, kv_cache_dtype="int8")
            eng = Engine(out, device="cpu", seed=SEED, kv_cache_dtype="int8")
            assert eng.cfg.kv_window == jeng.cfg.kv_window == 24
            assert eng.cfg.use_mla == (kind == "mla")
            toks = np.random.default_rng(82).integers(3, 300, 40).tolist()
            made[kind] = dict(dir=out, kind=kind, jeng=jeng, eng=eng, toks=toks)
        return made[kind]
    return get


@pytest.fixture(params=["mla", "mha"])
def ckpt(request, checkpoints):
    return checkpoints(request.param)


def _strip_factors(params):
    return dataclasses.replace(params, layers=[
        dataclasses.replace(lp, wq_b=None, wkv_b=None) for lp in params.layers])


def _assert_caches_match(jc, c):
    """int8 rows equal but for elements one count apart (a row whose f32
    value sits at a rounding boundary). Layer 0's scales and sink masters,
    which depend on no cached int8 element, within 1e-5 of their scale; a
    later layer's within 1e-4: its inputs passed through attention over
    rows in which such an element may sit one count apart (measured: 2.7e-5
    of the scale in layer 1 of the MHA run, after one flipped element of
    layer 0)."""
    for f in ("k", "v", "ckv", "krope"):
        a = getattr(jc, f)
        if a is None:
            continue
        d = np.abs(np.asarray(a, np.int32) - getattr(c, f).numpy().astype(np.int32))
        assert d.max() <= 1, f
        assert (d > 0).mean() <= 0.01, f
    for f in ("k_s", "v_s", "ckv_s", "krope_s", "sink_k", "sink_krope"):
        a = getattr(jc, f)
        if a is None:
            continue
        a, b = np.asarray(a), getattr(c, f).numpy()
        for layers, tol in ((slice(0, 1), 1e-5), (slice(1, None), 1e-4)):
            np.testing.assert_allclose(b[layers], a[layers], rtol=0,
                                       atol=tol * np.abs(a[layers]).max(), err_msg=f)


@pytest.mark.parametrize("kind,factors", [("mla", True), ("mla", False),
                                          ("mha", True)],
                         ids=["hybrid", "absorbed", "mha"])
def test_forward_int8_matches_jax(checkpoints, kind, factors, monkeypatch):
    """Two prefill chunks (9 then 5 tokens, every row's logits), then 26
    decode steps to position 39 of a 24-slot window: the ring wraps and
    the sinks re-rotate from their float masters. Logits within 1e-3 of
    their scale after every chunk and step (the same f32 arithmetic summed
    in other orders, and an element may round to the neighbouring int8
    count); the cache afterwards as ``_assert_caches_match`` says. The
    hybrid MLA prefill launches K9 on the dequantized window, the absorbed
    one K10 with the scales; MHA K9 with the scales."""
    ckpt = checkpoints(kind)
    jeng, eng, toks = ckpt["jeng"], ckpt["eng"], ckpt["toks"]
    jp, tp = jeng.params, eng.params
    if not factors:
        jp, tp = _strip_factors(jp), _strip_factors(tp)
    chunks = (9, 5)
    pre = make_forward(jeng.cfg, prefill=True, logits_mode="all")
    dec = make_forward(jeng.cfg, prefill=False)
    jcache, want, pos = init_cache(jeng.cfg), [], 0
    for T in chunks:
        lg, jcache = pre(jp, jcache, jnp.asarray([toks[pos:pos + T]], jnp.int32), pos)
        want.append(np.asarray(lg[0]))
        pos += T
    for p in range(pos, len(toks)):
        lg, jcache = dec(jp, jcache, jnp.asarray([[toks[p]]], jnp.int32), p)
        want.append(np.asarray(lg))

    calls = {}
    for name in ("mha_prefill_attn", "mla_prefill_attn", "mla_decode_attn",
                 "mha_decode_attn"):
        fn = getattr(port_model, name)
        monkeypatch.setattr(port_model, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls.setdefault(_n, []).append(kw.get("k_scale", kw.get("ckv_scale")))
            or _fn(*a, **kw)))
    cache, got, pos = eng.new_cache(), [], 0
    with torch.inference_mode():
        for T in chunks:
            got.append(forward_prefill(tp, cache, torch.tensor([toks[pos:pos + T]]),
                                       pos, eng.cfg, "all")[0].numpy())
            pos += T
        for p in range(pos, len(toks)):
            got.append(forward_decode(tp, cache, torch.tensor([[toks[p]]]), p,
                                      eng.cfg).numpy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * np.abs(w).max())
    _assert_caches_match(jcache, cache)
    n = len(chunks) * eng.cfg.n_layers
    mla = kind == "mla"
    prefill = "mha_prefill_attn" if (factors or not mla) else "mla_prefill_attn"
    assert set(calls) == {prefill, "mla_decode_attn" if mla else "mha_decode_attn"}
    assert len(calls[prefill]) == n
    # the hybrid prefill attends over the dequantized window: no scales
    assert all((s is None) == (mla and factors) for s in calls[prefill])


def test_ring_and_sinks_int8_match_jax():
    """64 decode steps in an 8-slot window (as tests/test_kv_int8.py): the
    sinks re-rotate 56 times from their float masters. Tolerance 1e-3 of
    the logit scale at every step."""
    jcfg = tiny_config(use_mla=True, rs_original_max_position_embeddings=8,
                       kv_cache_dtype="int8")
    jparams = load_params(make_ckptdata(jcfg, tiny_weights(jcfg, seed=41)), jcfg)
    cfg = ModelConfig.from_metadata(tiny_metadata(jcfg), kv_cache_dtype="int8")
    assert cfg.kv_window == 8
    params = params_from_reference(jparams, "cpu")
    toks = np.random.default_rng(1).integers(3, 60, size=64).tolist()
    step = make_forward(jcfg, prefill=False)
    jcache, cache = init_cache(jcfg), torch_cache(cfg)
    with torch.inference_mode():
        for pos, t in enumerate(toks):
            want, jcache = step(jparams, jcache, jnp.asarray([[t]], jnp.int32), pos)
            got = forward_decode(params, cache, torch.tensor([[t]]), pos, cfg)
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-3 * np.abs(want).max())
    _assert_caches_match(jcache, cache)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_int8_matches_jax(ckpt, temperature):
    """Both Engines at their defaults (decode_block 32, top_p 0.95, seed
    0) with kv_cache_dtype="int8": a 10-token prompt, then 34 tokens in two
    blocks past the 24-slot window's edge. The same tokens."""
    jeng, eng = ckpt["jeng"], ckpt["eng"]
    jeng.sampler.rng = np.random.default_rng(SEED)
    jeng._key = jax.random.PRNGKey(SEED)
    eng.sampler.rng = np.random.default_rng(SEED)
    eng._key = prng.PRNGKey(SEED)
    assert eng.decode_block == jeng.decode_block == 32
    prompt = ckpt["toks"][:10]
    want, _ = jeng.generate(prompt, num_steps=34, temperature=temperature, top_p=0.95)
    got, stats = eng.generate(prompt, num_steps=34, temperature=temperature,
                              top_p=0.95)
    assert got == want and stats.generated_tokens == len(got) > 32


def test_decode_block_int8_does_not_read_back(ckpt, monkeypatch):
    """Inside an int8 decode block no step reads a tensor back to the host
    (quantizing, the scales and the sink masters' updates included): 8
    steps across the window's edge and no .item/.tolist/.cpu/.numpy or
    implicit bool/int/float/index conversion of a tensor."""
    eng = ckpt["eng"]
    cache = eng.new_cache()
    _, _, _, pos = eng.hydrate(cache, ckpt["toks"][:20])
    loop = make_decode_loop(eng.cfg, 8)
    calls = {"host": 0}
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, **kw):
            calls["host"] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, spy)
    toks, logits, _ = loop(eng.params, cache, torch.tensor([[5]]), pos,
                           prng.PRNGKey(3), 0.8, 0.9)
    assert calls["host"] == 0 and toks.shape == (1, 8)
    assert bool(torch.isfinite(logits).all())


def test_active_bytes_int8_match_jax(ckpt):
    """``params_active_bytes`` counts one byte a cached element of an int8
    cache, as the JAX function does (neither counts the scales). The
    absorbed MLA decode never reads wq_b/wkv_b, which the port leaves out
    and the JAX function counts."""
    jeng, eng = ckpt["jeng"], ckpt["eng"]
    for pos in (0, 7, 100):
        want = jax_active_bytes(jeng.params, jeng.cfg, pos)
        if eng.cfg.use_mla:
            want -= sum(lp.wq_b.nbytes_active + lp.wkv_b.nbytes_active
                        for lp in jeng.params.layers)
        assert params_active_bytes(eng.params, eng.cfg, pos) == pytest.approx(
            want, rel=1e-12)
    f16 = dataclasses.replace(eng.cfg, kv_cache_dtype="float16")
    L, kv = eng.cfg.n_layers, min(100 + 1, eng.cfg.kv_window)
    row = (eng.cfg.kv_lora_rank + eng.cfg.qk_rope_head_dim if eng.cfg.use_mla
           else eng.cfg.n_heads * (eng.cfg.head_dim + eng.cfg.v_head_dim))
    assert params_active_bytes(eng.params, f16, 100) - params_active_bytes(
        eng.params, eng.cfg, 100) == L * kv * row
