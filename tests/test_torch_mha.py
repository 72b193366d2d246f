"""The port's decompressed-MHA path (the converter's default checkpoint)
against the JAX package.

- K8: ``mha_decode_attn``'s plain version against the Pallas kernel in
  interpret mode and the jnp ``decode_attn_mha``.
- K4: ``qmm``'s plain route on an F16 weight of 32 MiB (so the JAX ``qmm``
  really takes its ``_plain_body``) against the Pallas kernel in interpret
  mode.
- ``forward_decode`` / ``forward_prefill`` with ``use_mla=False`` and no
  query LoRA or one of rank 12 (``tests/util_tinymodel.py::tiny_config``),
  decoding past the 16-slot window so the sink keys' rope re-rotates;
  params carried across with ``params_from_reference``.
- ``Engine.hydrate`` / ``generate`` on checkpoints written by
  ``deepseek_tpu.convert.convert`` with its default flags (F16, MHA),
  against the JAX Engine; and ``params_active_bytes`` against the JAX
  function.
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
from deepseek_tpu.models.loader import load_params
from deepseek_tpu.models.loader import params_active_bytes as jax_active_bytes
from deepseek_tpu.ops.attention import decode_attn_mha as jnp_decode_mha
from deepseek_tpu.ops.pallas.attention import mha_decode_attn as jax_mha_decode
from deepseek_tpu.ops.pallas.qmm import qmm as jax_qmm
from deepseek_tpu.quant.qtensor import PlainTensor as JaxPlainTensor
from deepseek_tpu_torch.config import ModelConfig
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.models import deepseek as port_model
from deepseek_tpu_torch.models.deepseek import forward_decode, forward_prefill
from deepseek_tpu_torch.models.kvcache import init_cache as torch_cache
from deepseek_tpu_torch.models.testing import random_plain_params
from deepseek_tpu_torch.models.loader import (
    fuse_projections, params_active_bytes, params_from_reference,
)
from deepseek_tpu_torch.ops.kernels.attention import mha_decode_attn
from deepseek_tpu_torch.ops.kernels.qmm import qmm
from deepseek_tpu_torch.ops.matmul import plain_kernel_route, qmatmul
from deepseek_tpu_torch.quant.qtensor import PlainTensor
from tests.test_model import make_ckptdata
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir
from tests.util_tinymodel import tiny_config, tiny_metadata, tiny_weights


def _rnd(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("B,S,kv_len", [(1, 40, [5]), (2, 40, [13, 40]),
                                        (2, 33, [33, 33])],
                         ids=["short", "ragged", "full"])
def test_k8_plain_matches_jax(B, S, kv_len):
    """Tolerance 2e-5: f32 softmax-weighted sums of the same bf16 cache
    values; the Pallas body's online softmax sums in another order."""
    H, Dh, Dv = 3, 24, 16
    q = _rnd((B, H, Dh), 50)
    k = jnp.asarray(_rnd((B, S, H, Dh), 51), jnp.bfloat16)
    v = jnp.asarray(_rnd((B, S, H, Dv), 52), jnp.bfloat16)
    kl = np.asarray(kv_len, np.int32)
    scale = 1.0 / math.sqrt(Dh)
    want_pl = np.asarray(jax_mha_decode(jnp.asarray(q), k, v, jnp.asarray(kl),
                                        scale, interpret=True))
    want_jnp = np.asarray(jnp_decode_mha(jnp.asarray(q), k, v, jnp.asarray(kl),
                                         softmax_scale=scale))
    tk = torch.from_numpy(np.array(k.astype(jnp.float32))).to(torch.bfloat16)
    tv = torch.from_numpy(np.array(v.astype(jnp.float32))).to(torch.bfloat16)
    got = mha_decode_attn(torch.from_numpy(q), tk, tv, torch.from_numpy(kl),
                          scale).numpy()
    np.testing.assert_allclose(got, want_pl, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_jnp, rtol=2e-5, atol=2e-5)


def test_k8_rejects_unported_operands():
    """The int8 scales are ported (an int8 cache with (B,H,S) scales gives
    the dequantized cache's result), and so are the seq-parallel partials:
    ``partials=True`` returns (acc, m, l) with acc / l the normalized
    output, and the empty triple (acc 0, l 0, m -1e30) for a shard with no
    live slot."""
    g = torch.Generator().manual_seed(0)
    k8 = torch.randint(-127, 128, (1, 4, 2, 8), generator=g, dtype=torch.int8)
    ks = torch.rand((1, 2, 4), generator=g) * 0.01
    q = torch.randn((1, 2, 8), generator=g)
    kf = k8.float() * ks.transpose(1, 2)[..., None]
    out = mha_decode_attn(q, k8, k8, torch.tensor([3]), 0.1, k_scale=ks, v_scale=ks)
    torch.testing.assert_close(out, mha_decode_attn(q, kf, kf, torch.tensor([3]), 0.1),
                               rtol=0, atol=0)
    acc, m, l = mha_decode_attn(q, k8, k8, torch.tensor([3]), 0.1, k_scale=ks,
                                v_scale=ks, partials=True)
    assert acc.shape == (1, 2, 8) and m.shape == l.shape == (1, 2)
    torch.testing.assert_close(acc / l[..., None], out, rtol=1e-6, atol=1e-7)
    acc, m, l = mha_decode_attn(q, kf, kf, torch.tensor([0]), 0.1, partials=True)
    assert not acc.any() and not l.any() and bool((m == -1e30).all())


@pytest.mark.parametrize("B", [1, 8])
def test_k4_plain_matches_jax(B):
    """A 16384x1024 F16 weight is 32 MiB, so the JAX qmm takes its Pallas
    ``_plain_body`` and the port's qmatmul its K4 route. Tolerance 1e-5 of
    the output scale: f32 sums of the same f16-widened products in other
    orders."""
    d, n = 16384, 1024
    w = (np.random.default_rng(60).standard_normal((d, n)) * 0.05).astype(np.float16)
    x = _rnd((B, n), 61, scale=1.0)
    assert w.nbytes == 32 * 2**20
    want = np.asarray(jax_qmm(JaxPlainTensor(data=jnp.asarray(w)), jnp.asarray(x),
                              interpret=True))
    qt = PlainTensor(data=torch.from_numpy(w))
    assert plain_kernel_route(qt, B)
    assert not plain_kernel_route(qt, 9)
    assert not plain_kernel_route(PlainTensor(data=qt.data[:, :512]), B)
    got = qmm(qt, torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(qmatmul(qt, torch.from_numpy(x)).numpy(), got,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the MHA forward on tiny models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[0, 12], ids=["wq", "q_lora"])
def tiny(request):
    """A tiny MHA MoE model (window 16) in both packages, from one set of
    numpy weights: the JAX loader's params, carried to the port."""
    jcfg = tiny_config(use_mla=False, q_lora=request.param)
    jparams = load_params(make_ckptdata(jcfg, tiny_weights(jcfg, seed=70)), jcfg)
    cfg = ModelConfig.from_metadata(tiny_metadata(jcfg))
    assert not cfg.use_mla and cfg.kv_window == jcfg.kv_window == 16
    params = params_from_reference(jparams, "cpu")
    return dict(jcfg=jcfg, jparams=jparams, cfg=cfg, params=params)


def _jax_decode(cfg, params, toks):
    fwd = make_forward(cfg, prefill=False)
    cache, out = init_cache(cfg), []
    for pos, t in enumerate(toks):
        lg, cache = fwd(params, cache, jnp.asarray([[t]], jnp.int32), pos)
        out.append(np.asarray(lg[0]))
    return np.stack(out)


def _port_decode(cfg, params, toks):
    cache, out = torch_cache(cfg), []
    with torch.inference_mode():
        for pos, t in enumerate(toks):
            out.append(forward_decode(params, cache, torch.tensor([[t]]), pos,
                                      cfg)[0].numpy())
    return np.stack(out)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_decode_matches_jax(tiny, impl, monkeypatch):
    """24 teacher-forced steps over the 16-slot window: the ring wraps and
    the sinks' rope parts re-rotate. The oracle runs the XLA route and
    ``kernel_impl="pallas"`` (K8 in interpret mode). The port runs fused
    and unfused params. Tolerance 1e-3 of the logit scale: the same f32
    arithmetic summed in other orders, and a key can round to the
    neighbouring f16 cache value (as tests/test_torch_engine.py)."""
    toks = np.random.default_rng(71).integers(3, 60, 24).tolist()
    jcfg = dataclasses.replace(tiny["jcfg"], kernel_impl=impl)
    want = _jax_decode(jcfg, tiny["jparams"], toks)
    calls = []
    fn = port_model.mha_decode_attn
    monkeypatch.setattr(port_model, "mha_decode_attn",
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    for params in (tiny["params"], fuse_projections(tiny["params"], tiny["cfg"])):
        got = _port_decode(tiny["cfg"], params, toks)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
    assert len(calls) == 2 * len(toks) * tiny["cfg"].n_layers


def test_forward_prefill_matches_jax(tiny, monkeypatch):
    """Two chunks (9 then 5 tokens) with every row's logits, then decode
    steps past the window, against the JAX prefill and decode modes on
    the same cache. Tolerance as the decode test."""
    toks = np.random.default_rng(72).integers(3, 60, 22).tolist()
    chunks = (9, 5)
    jcfg, cfg = tiny["jcfg"], tiny["cfg"]
    pre = make_forward(jcfg, prefill=True, logits_mode="all")
    dec = make_forward(jcfg, prefill=False)
    jcache, want, pos = init_cache(jcfg), [], 0
    for T in chunks:
        lg, jcache = pre(tiny["jparams"], jcache,
                         jnp.asarray([toks[pos:pos + T]], jnp.int32), pos)
        want.append(np.asarray(lg[0]))
        pos += T
    for p in range(pos, len(toks)):
        lg, jcache = dec(tiny["jparams"], jcache, jnp.asarray([[toks[p]]], jnp.int32), p)
        want.append(np.asarray(lg))
    want = np.concatenate(want)

    calls = []
    fn = port_model.mha_prefill_attn
    monkeypatch.setattr(port_model, "mha_prefill_attn",
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    params = fuse_projections(tiny["params"], cfg)
    cache, got, pos = torch_cache(cfg), [], 0
    with torch.inference_mode():
        for T in chunks:
            got.append(forward_prefill(params, cache, torch.tensor([toks[pos:pos + T]]),
                                       pos, cfg, "all")[0].numpy())
            pos += T
        for p in range(pos, len(toks)):
            got.append(forward_decode(params, cache, torch.tensor([[toks[p]]]), p,
                                      cfg).numpy())
    got = np.concatenate(got)
    assert len(calls) == len(chunks) * cfg.n_layers
    assert cache.k.shape == (cfg.n_layers, 1, 16, cfg.n_heads, cfg.head_dim)
    assert cache.ckv is None and cache.krope is None
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
    np.testing.assert_allclose(np.asarray(jcache.v[:, :, :pos]),
                               cache.v[:, :, :pos].float().numpy(), rtol=0, atol=2e-3)


def test_mha_cache_shape_and_bytes(tiny):
    cfg = tiny["cfg"]
    c = torch_cache(cfg, batch=2)
    assert (c.batch, c.window, c.device.type) == (2, 16, "cpu")
    assert c.nbytes == 2 * cfg.n_layers * 2 * 16 * cfg.n_heads * (
        cfg.head_dim + cfg.v_head_dim)
    # int8: a byte an element, an f32 scale a (slot, head) row of k and v
    c8 = torch_cache(dataclasses.replace(cfg, kv_cache_dtype="int8"), batch=2)
    assert c8.quantized and c8.nbytes == 2 * cfg.n_layers * 16 * cfg.n_heads * (
        cfg.head_dim + cfg.v_head_dim + 2 * 4)


# ---------------------------------------------------------------------------
# the Engine on the converter's default checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[0, 32], ids=["wq", "q_lora"])
def default_ckpt(request, tmp_path_factory):
    """``convert(hf_dir, out)`` with its default flags: F16 weights,
    decompressed MHA. Window min(128, 24) = 24 slots."""
    root = str(tmp_path_factory.mktemp(f"mha{request.param}"))
    cfg = hf_config(dim=64, hidden=96, q_lora=request.param, kv_lora=32, nope=16,
                    rope=8, v_dim=16, moe_inter=24, layers=2, vocab=300,
                    n_experts=4, n_active=2)
    hf_dir = os.path.join(root, "hf")
    write_hf_dir(hf_dir, cfg, hf_weights(cfg, seed=73, scale=0.1))
    out = os.path.join(root, "ck")
    cv.convert(hf_dir, out)
    jeng = JaxEngine(out, seed=0, decode_block=1, prefill_chunk=10)
    eng = Engine(out, device="cpu", seed=0, prefill_chunk=10)
    assert not eng.cfg.use_mla and eng.cfg.kv_window == 24
    assert (eng.params.layers[0].wq is None) == (request.param > 0)
    toks = np.random.default_rng(74).integers(3, 300, 30).tolist()
    return dict(dir=out, hf=hf_dir, root=root, jeng=jeng, eng=eng, toks=toks)


def test_engine_hydrate_matches_jax(default_ckpt):
    """Chunks of 10 (10, 10, then 4 clamped at the 24-slot window edge)
    and decode steps past it. Last logits within 1e-3 of the logit scale,
    collected log-softmax rows within 2e-3 (a row moves by at most twice
    its logits' error)."""
    jeng, eng, toks = default_ckpt["jeng"], default_ckpt["eng"], default_ckpt["toks"]
    _, jlast, jrows, jend = jeng.hydrate(jeng.new_cache(), toks, collect_all_logits=True)
    _, last, rows, end = eng.hydrate(eng.new_cache(), toks, collect_all_logits=True)
    scale = np.abs(jlast).max()
    assert end == jend == len(toks) and rows.shape == jrows.shape
    np.testing.assert_allclose(last, jlast, rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=2e-3 * scale)


def test_engine_generate_tokens_match_jax(default_ckpt):
    """Greedy tokens after a 20-token prompt, running past the window."""
    jeng, eng = default_ckpt["jeng"], default_ckpt["eng"]
    prompt = default_ckpt["toks"][:20]
    want, _ = jeng.generate(prompt, num_steps=10, temperature=0.0)
    got, stats = eng.generate(prompt, num_steps=10, temperature=0.0)
    assert got == want and stats.generated_tokens == 10


def test_random_plain_params_layout(default_ckpt):
    """``random_plain_params`` (the card's V2-Lite model) builds the same
    fields and shapes as the port's loader and ``fuse_projections`` give
    the converter's default checkpoint, and the model decodes; with a query
    LoRA it refuses."""
    eng = default_ckpt["eng"]
    if eng.cfg.q_lora_rank > 0:
        with pytest.raises(ValueError, match="query LoRA"):
            random_plain_params(eng.cfg, device="cpu")
        return
    rp = random_plain_params(eng.cfg, torch.float16, seed=0, device="cpu")
    for got, want in zip(rp.layers + [rp], eng.params.layers + [eng.params]):
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name == "layers":
                continue
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert tuple(a.shape) == tuple(b.shape), f.name
                assert a.dtype == b.dtype if isinstance(a, torch.Tensor) \
                    else a.data.dtype == b.data.dtype, f.name
    with torch.inference_mode():
        lg = forward_decode(rp, torch_cache(eng.cfg), torch.tensor([[5]]), 0, eng.cfg)
    assert lg.shape == (1, eng.cfg.vocab_size) and torch.isfinite(lg).all()


def test_active_bytes_match_jax(default_ckpt):
    """``params_active_bytes`` on the MHA model equals the JAX function's
    (weights with wq/wq_b/wkv_b, and every head's key and value a slot).
    With a query LoRA the same HF weights also convert to absorbed MLA;
    there the port leaves out wq_b/wkv_b, which the absorbed decode never
    reads and the JAX function counts."""
    outs = [(default_ckpt["dir"], False)]
    if default_ckpt["eng"].cfg.q_lora_rank > 0:      # convert --mla needs it
        mla = os.path.join(default_ckpt["root"], "mla")
        cv.convert(default_ckpt["hf"], mla, use_mla=True)
        outs.append((mla, True))
    for out, use_mla in outs:
        jeng = JaxEngine(out, seed=0, decode_block=1)
        eng = Engine(out, device="cpu", seed=0)
        assert eng.cfg.use_mla == use_mla
        for pos in (0, 7, 100):
            want = jax_active_bytes(jeng.params, jeng.cfg, pos)
            if use_mla:
                want -= sum(lp.wq_b.nbytes_active + lp.wkv_b.nbytes_active
                            for lp in jeng.params.layers)
            assert params_active_bytes(eng.params, eng.cfg, pos) == pytest.approx(
                want, rel=1e-12)
