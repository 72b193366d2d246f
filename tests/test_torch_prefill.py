"""The port's chunked prefill against the JAX package.

- K9/K10: the plain versions against the Pallas ``mha_prefill_attn`` /
  ``mla_prefill_attn`` in interpret mode and the jnp ``prefill_attn_*``,
  with a ragged S, q_pos0 > 0 and a cache_pos0 offset.
- ``forward_prefill``: logits of two chunks (the first large enough for the
  grouped MoE path, the second small enough for the pair path) against
  JAX ``make_forward(prefill=True, logits_mode="all")``, on tiny Q2_K and
  Q3_K nibble checkpoints and a plain F16 MoE checkpoint, with the factor
  weights (decompressed prefill, K9) and without (absorbed prefill, K10).
  The oracle runs both the XLA route and ``kernel_impl="pallas"``
  (interpret).
- ``Engine.hydrate``: against the JAX ``Engine.hydrate`` with the same
  ``prefill_chunk`` and a prompt that crosses the window edge; greedy
  ``generate`` tokens identical.
"""

import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu import convert as cv
from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu.models import init_cache, make_forward
from deepseek_tpu.ops.attention import prefill_attn_mha as jnp_prefill_mha
from deepseek_tpu.ops.attention import prefill_attn_mla as jnp_prefill_mla
from deepseek_tpu.ops.pallas.attention import mha_prefill_attn as jax_mha_prefill
from deepseek_tpu.ops.pallas.attention import mla_prefill_attn as jax_mla_prefill
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.models import deepseek as port_model
from deepseek_tpu_torch.models.deepseek import forward_prefill
from deepseek_tpu_torch.ops.kernels.prefill_attn import (
    mha_prefill_attn, mla_prefill_attn,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir

WINDOW = 96           # kv_window of the checkpoints below
CHUNKS = (70, 20)     # 140 routed pairs (grouped), then 40 (pair path)


def _rnd(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("S,q_pos0,cache_pos0", [(64, 7, 0), (61, 20, 3), (29, 0, 0)])
def test_k9_plain_matches_jax(S, q_pos0, cache_pos0):
    """Tolerance 2e-5: f32 softmax-weighted sums of the same bf16 cache
    values; the Pallas body's online softmax sums in another order."""
    B, T, H, Dh, Dv = 2, 12, 3, 48, 32
    q = _rnd((B, T, H, Dh), 30)
    k = jnp.asarray(_rnd((B, S, H, Dh), 31), jnp.bfloat16)
    v = jnp.asarray(_rnd((B, S, H, Dv), 32), jnp.bfloat16)
    scale = 1.0 / math.sqrt(Dh)
    want_pl = np.asarray(jax_mha_prefill(jnp.asarray(q), k, v, q_pos0, cache_pos0,
                                         scale, interpret=True))
    want_jnp = np.asarray(jnp_prefill_mha(
        jnp.asarray(q), k, v, q_pos0 + jnp.arange(T), cache_pos0 + jnp.arange(S),
        softmax_scale=scale))
    tk = torch.from_numpy(np.array(k.astype(jnp.float32))).to(torch.bfloat16)
    tv = torch.from_numpy(np.array(v.astype(jnp.float32))).to(torch.bfloat16)
    got = mha_prefill_attn(torch.from_numpy(q), tk, tv, q_pos0, cache_pos0,
                           scale).numpy()
    np.testing.assert_allclose(got, want_pl, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_jnp, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S,q_pos0,cache_pos0", [(40, 3, 0), (37, 15, 2)])
def test_k10_plain_matches_jax(S, q_pos0, cache_pos0):
    """Tolerance as K9, over an f16 latent cache."""
    B, T, H, R, P = 2, 10, 4, 32, 16
    qc, qr = _rnd((B, T, H, R), 36), _rnd((B, T, H, P), 37)
    ckv = _rnd((B, S, R), 38).astype(np.float16)
    kr = _rnd((B, S, P), 39).astype(np.float16)
    scale = 1.0 / math.sqrt(48.0)
    args = [jnp.asarray(a) for a in (qc, qr, ckv, kr)]
    want_pl = np.asarray(jax_mla_prefill(*args, q_pos0, cache_pos0, scale,
                                         interpret=True))
    want_jnp = np.asarray(jnp_prefill_mla(
        *args, q_pos0 + jnp.arange(T), cache_pos0 + jnp.arange(S), 48,
        softmax_scale=scale))
    got = mla_prefill_attn(*[torch.from_numpy(a) for a in (qc, qr, ckv, kr)],
                           q_pos0, cache_pos0, scale).numpy()
    np.testing.assert_allclose(got, want_pl, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_jnp, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# whole-model prefill
# ---------------------------------------------------------------------------

_ARCH = {
    "q2_k": dict(arch="DeepseekV2ForCausalLM", topk_method="greedy", scoring="softmax"),
    "q3_k": dict(arch="DeepseekV3ForCausalLM", topk_method="noaux_tc", scoring="sigmoid"),
    "fp16": dict(arch="DeepseekV3ForCausalLM", topk_method="noaux_tc", scoring="sigmoid"),
}


def _checkpoint(root, quant):
    """Tiny MLA+MoE checkpoint whose widths let the grouped MoE path run:
    256 for the nibble tiles, 128 for the plain grouped products."""
    if quant == "fp16":
        dims = dict(dim=128, hidden=128, q_lora=128, kv_lora=128, nope=64,
                    rope=32, v_dim=64, moe_inter=128)
    else:   # K-quant rows need every in-width % 256 == 0
        dims = dict(dim=256, hidden=256, q_lora=256, kv_lora=256, nope=128,
                    rope=64, v_dim=128, moe_inter=256)
    cfg = hf_config(**dims, layers=2, heads=2, vocab=300, n_experts=4,
                    n_active=2, **_ARCH[quant])
    cfg["rope_scaling"]["original_max_position_embeddings"] = 128
    hf_dir = os.path.join(root, "hf")
    write_hf_dir(hf_dir, cfg, hf_weights(cfg, seed=41, scale=0.1))
    out = os.path.join(root, "ck")
    cv.convert(hf_dir, out, quant=quant, use_mla=True)
    return out


@pytest.fixture(scope="module", params=["q2_k", "q3_k", "fp16"])
def ckpt(request, tmp_path_factory):
    quant = request.param
    out = _checkpoint(str(tmp_path_factory.mktemp(quant)), quant)
    jeng = JaxEngine(out, seed=0, context=WINDOW, decode_block=1,
                     kquant_runtime="nibble")
    eng = Engine(out, context=WINDOW, device="cpu", seed=0, kquant_runtime="nibble")
    assert eng.cfg.kv_window == jeng.cfg.kv_window == WINDOW
    toks = np.random.default_rng(43).integers(3, 300, sum(CHUNKS) + 10).tolist()
    return dict(dir=out, quant=quant, jeng=jeng, eng=eng, toks=toks)


def _strip_factors(params):
    return dataclasses.replace(params, layers=[
        dataclasses.replace(lp, wq_b=None, wkv_b=None) for lp in params.layers])


def _jax_chunks(cfg, params, toks):
    fwd = make_forward(cfg, prefill=True, logits_mode="all")
    cache, out, pos = init_cache(cfg), [], 0
    for T in CHUNKS:
        lg, cache = fwd(params, cache, jnp.asarray([toks[pos:pos + T]], jnp.int32), pos)
        out.append(np.asarray(lg[0]))
        pos += T
    return np.concatenate(out)


def _port_chunks(eng, params, toks):
    cache, out, pos = eng.new_cache(), [], 0
    with torch.inference_mode():
        for T in CHUNKS:
            lg = forward_prefill(params, cache, torch.tensor([toks[pos:pos + T]]),
                                 pos, eng.cfg, "all")
            out.append(lg[0].numpy())
            pos += T
    return np.concatenate(out), cache


def _counting(monkeypatch, name, calls):
    fn = getattr(port_model, name)

    def wrapped(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **kw)
    monkeypatch.setattr(port_model, name, wrapped)


@pytest.mark.parametrize("factors", [True, False], ids=["decompressed", "absorbed"])
def test_forward_prefill_matches_jax_xla(ckpt, factors, monkeypatch):
    """Tolerance 1e-3 of the logit scale: the same f32 dequant arithmetic,
    summed in other orders (and a latent may round to the neighbouring f16
    cache value), as tests/test_torch_engine.py. The first chunk's MoE
    layer takes the grouped path, the second's the pair path; the factor
    weights pick the decompressed attention (K9) over the absorbed (K10)."""
    jeng, eng = ckpt["jeng"], ckpt["eng"]
    jp, tp = jeng.params, eng.params
    assert (tp.layers[0].wq_b is not None) and (tp.layers[0].wkv_b is not None)
    if not factors:
        jp, tp = _strip_factors(jp), _strip_factors(tp)
    calls = {}
    for name in ("grouped_expert_ffn", "_pair_ffn", "mha_prefill_attn",
                 "mla_prefill_attn"):
        _counting(monkeypatch, name, calls)
    want = _jax_chunks(jeng.cfg, jp, ckpt["toks"])
    got, _ = _port_chunks(eng, tp, ckpt["toks"])
    n_layers = len(tp.layers)
    assert calls["grouped_expert_ffn"] == 1 and calls["_pair_ffn"] == 1
    attn = "mha_prefill_attn" if factors else "mla_prefill_attn"
    assert calls == {**calls, attn: len(CHUNKS) * n_layers}
    assert ("mla_prefill_attn" if factors else "mha_prefill_attn") not in calls
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("factors", [True, False], ids=["decompressed", "absorbed"])
def test_forward_prefill_matches_jax_pallas(ckpt, factors):
    """The same against the JAX kernel route (Pallas in interpret mode:
    qmm, qmm_grouped / megablox gmm for the first chunk, qmm_experts for the
    second). Tolerance as above."""
    jeng, eng = ckpt["jeng"], ckpt["eng"]
    jp, tp = jeng.params, eng.params
    if not factors:
        jp, tp = _strip_factors(jp), _strip_factors(tp)
    cfg_pl = dataclasses.replace(jeng.cfg, kernel_impl="pallas")
    want = _jax_chunks(cfg_pl, jp, ckpt["toks"])
    got, _ = _port_chunks(eng, tp, ckpt["toks"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())


def test_forward_prefill_batch_matches_jax(ckpt):
    """Two sequences in one chunk (B=2) against the JAX XLA route, with the
    factor weights; tolerance as above."""
    jeng, eng = ckpt["jeng"], ckpt["eng"]
    toks = np.asarray(ckpt["toks"][:2 * 40]).reshape(2, 40)
    fwd = make_forward(jeng.cfg, prefill=True, logits_mode="all")
    want, _ = fwd(jeng.params, init_cache(jeng.cfg, batch=2),
                  jnp.asarray(toks, jnp.int32), 0)
    want = np.asarray(want)
    with torch.inference_mode():
        got = forward_prefill(eng.params, eng.new_cache(batch=2),
                              torch.from_numpy(toks), 0, eng.cfg, "all").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())


def test_prefill_rejects_unported_modes(ckpt):
    """Verify mode (per-row chunk starts) is ported: on each converted
    checkpoint, two rows' 5-token chunks at starts 0 and 30 over a cache of
    a shared 40-token prefill give the JAX verify forward's logits within
    1e-3 of their scale. A chunk past the window is still rejected."""
    eng, jeng = ckpt["eng"], ckpt["jeng"]
    toks = np.asarray(ckpt["toks"][:90]).reshape(2, 45)
    starts = np.array([0, 30])
    fwd = make_forward(jeng.cfg, prefill=True, logits_mode="all")
    _, jc = fwd(jeng.params, init_cache(jeng.cfg, batch=2),
                jnp.asarray(toks[:, :40], jnp.int32), 0)
    want, _ = fwd(jeng.params, jc, jnp.asarray(toks[:, 40:], jnp.int32),
                  jnp.asarray(starts, jnp.int32))
    want = np.asarray(want)
    with torch.inference_mode():
        cache = eng.new_cache(batch=2)
        forward_prefill(eng.params, cache, torch.from_numpy(toks[:, :40]), 0, eng.cfg, "none")
        got = forward_prefill(eng.params, cache, torch.from_numpy(toks[:, 40:]), starts,
                              eng.cfg, "all").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
    tok = torch.tensor([[5, 6]])
    with pytest.raises(ValueError, match="window"):
        forward_prefill(eng.params, eng.new_cache(), tok, WINDOW - 1, eng.cfg)


def test_hydrate_matches_jax_hydrate(ckpt):
    """Chunks of 70: 70, then 26 clamped at the 96-slot window edge, then
    decode steps. Last logits within 1e-3 of the logit scale; collected
    log-softmax rows and target log-probs within 2e-3 of it (a log-softmax
    row moves by at most twice its logits' error)."""
    jeng = ckpt["jeng"]
    jeng.prefill_chunk = 70
    eng = Engine(ckpt["dir"], context=WINDOW, device="cpu", seed=0, prefill_chunk=70,
                 kquant_runtime="nibble")
    toks = ckpt["toks"][:WINDOW + 5]
    _, jlast, jrows, jend = jeng.hydrate(jeng.new_cache(), toks, collect_all_logits=True)
    _, last, rows, end = eng.hydrate(eng.new_cache(), toks, collect_all_logits=True)
    scale = np.abs(jlast).max()
    assert end == jend == len(toks) and rows.shape == jrows.shape
    np.testing.assert_allclose(last, jlast, rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=2e-3 * scale)
    tg = toks[1:] + [0]
    _, _, jlp, _ = jeng.hydrate(jeng.new_cache(), toks, target_tokens=tg,
                                want_last_logits=False)
    _, none, lp, _ = eng.hydrate(eng.new_cache(), toks, target_tokens=tg,
                                 want_last_logits=False)
    assert none is None and lp.shape == jlp.shape == (len(toks),)
    np.testing.assert_allclose(lp, jlp, rtol=0, atol=2e-3 * scale)


def test_generate_tokens_match_jax(ckpt):
    """Greedy tokens after a prompt hydrated by two prefill chunks."""
    jeng = ckpt["jeng"]
    jeng.prefill_chunk = 70
    eng = Engine(ckpt["dir"], context=WINDOW, device="cpu", seed=0, prefill_chunk=70,
                 kquant_runtime="nibble")
    prompt = ckpt["toks"][:80]
    want, _ = jeng.generate(prompt, num_steps=8, temperature=0.0)
    got, stats = eng.generate(prompt, num_steps=8, temperature=0.0)
    assert got == want and stats.prompt_tokens == 80
