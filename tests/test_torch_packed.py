"""The port's packed Q2_K/Q3_K slice (the default K-quant runtime) against
the JAX package.

- Numpy-seeded weights quantized by ``deepseek_tpu.quant.kquant`` and
  repacked by both packages give the same planes bit for bit, the same f32
  dequantization and the same active bytes.
- The plain versions of the packed bodies of K5 (``qmm_packed``, its
  row-tiled route), K2 (``qmm_experts_packed``) and K6
  (``qmm_grouped_packed``) against the Pallas kernels in interpret mode,
  the grouped MoE prefill FFN, ``per_head_up`` and ``embed_lookup``.
- Converted 2-layer Q2_K (V2 greedy routing) and Q3_K (V3 noaux_tc)
  checkpoints loaded with default arguments by both Engines: the same
  packed planes after ``fuse_projections``, teacher-forced decode logits
  through ``params_from_reference``, greedy tokens, active bytes.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu import convert as cv
from deepseek_tpu.config import ActivationType as JaxAct
from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu.models import init_cache, make_forward
from deepseek_tpu.models.loader import params_active_bytes as jax_active_bytes
from deepseek_tpu.models.params import embed_lookup as jax_embed
from deepseek_tpu.ops import matmul as jmm
from deepseek_tpu.ops.pallas.qmm import _perm_x
from deepseek_tpu.ops.pallas.qmm import qmm as jax_qmm
from deepseek_tpu.ops.pallas.qmm import qmm_experts as jax_qmm_experts
from deepseek_tpu.ops.pallas.qmm import qmm_grouped as jax_qmm_grouped
from deepseek_tpu.parallel.spmd import NULL_CTX
from deepseek_tpu.quant import repack
from deepseek_tpu.quant.qtensor import Q2KTensor as JaxQ2K
from deepseek_tpu.quant.qtensor import Q3KTensor as JaxQ3K
from deepseek_tpu_torch.config import ActivationType
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.models import deepseek as port_model
from deepseek_tpu_torch.models.deepseek import forward_decode
from deepseek_tpu_torch.models.kvcache import init_cache as torch_cache
from deepseek_tpu_torch.models.loader import (
    load_params, params_active_bytes, params_from_reference,
)
from deepseek_tpu_torch.models.params import embed_lookup
from deepseek_tpu_torch.models.testing import random_fused_params
from deepseek_tpu_torch.ops import matmul as tmm
from deepseek_tpu_torch.ops.kernels.qmm import (
    ROW_TILE_MIN, qmm, qmm_experts, qmm_experts_packed, qmm_grouped,
    qmm_grouped_packed, qmm_packed, qmm_packed_rows,
)
from deepseek_tpu_torch.quant.qtensor import (
    KNibbleTensor, Q2KTensor, Q3KTensor, rows_to_experts,
)
from deepseek_tpu_torch.quant.repack import repack_q2k, repack_q3k
from tests.test_torch_qmm import _raw, rnd
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir

CONTEXT = 12          # kv_window = min(12, 24): the ring wraps at step 12
N_NEW = 10


def packed_pair(raw, quant, rows, cols):
    """The JAX and the port's packed tensor of the same raw K-quant blocks,
    each repacked by its own package."""
    if quant == "q2_k":
        jt = JaxQ2K(*(jnp.asarray(a) for a in repack.repack_q2k(raw, rows, cols)))
        tt = Q2KTensor(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in repack_q2k(raw, rows, cols)))
    else:
        jt = JaxQ3K(*(jnp.asarray(a) for a in repack.repack_q3k(raw, rows, cols)))
        tt = Q3KTensor(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in repack_q3k(raw, rows, cols)))
    return jt, tt


def _fields(t):
    return [f.name for f in dataclasses.fields(t)]


# ---------------------------------------------------------------------------
# planes, dequantization, the plain versions of the packed bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("shape", [(64, 512), (3, 32, 768)], ids=["2d", "experts"])
def test_packed_planes_and_dequant_match_jax(quant, shape):
    """Every plane equal bit for bit (Q3_K's sc signed int8), the f32
    dequantization equal, the same shape and active bytes."""
    raw = _raw(rnd(shape, seed=1), quant)
    jt, tt = packed_pair(raw, quant, *shape[-2:])
    for f in _fields(tt):
        a, b = getattr(tt, f), np.asarray(getattr(jt, f))
        assert a.numpy().dtype == b.dtype and a.is_contiguous(), f
        np.testing.assert_array_equal(a.numpy(), b)
    assert tt.sc.dtype == torch.int8 if quant == "q3_k" else tt.sm.dtype == torch.uint8
    np.testing.assert_array_equal(tt.dequant(torch.float32).numpy(),
                                  np.asarray(jt.dequant(jnp.float32)))
    assert tt.shape == jt.shape and tt.nbytes_active == jt.nbytes_active


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("B", [1, 3, 130])
def test_k5_packed_plain_matches_pallas(quant, B):
    """K5's packed body against the Pallas qmm in interpret mode at 1, 3 and
    130 rows (past the JAX 128-row batch tile and the port's row-tiled
    threshold). Tolerance 1e-4 of max|out|: f32 products of the same
    dequantized weights, summed in other orders."""
    d, n = 64, 512
    jt, tt = packed_pair(_raw(rnd((d, n), seed=2), quant), quant, d, n)
    x = rnd((B, n), seed=3)
    want = np.asarray(jax_qmm(jt, jnp.asarray(x), interpret=True))
    got = qmm(tt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    route = qmm_packed_rows if B > ROW_TILE_MIN else qmm_packed
    np.testing.assert_array_equal(route(tt, torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_k2_packed_plain_matches_pallas(quant):
    """K2's packed body against the Pallas qmm_experts (interpret): 2 tokens
    x 3 slots over 5 experts, expert 4 repeated. Tolerance as K5."""
    E, m, n = 5, 32, 512
    jt, tt = packed_pair(_raw(rnd((E, m, n), seed=4), quant), quant, m, n)
    idx = np.asarray([[4, 0, 4], [2, 1, 3]], np.int32)
    x = rnd((2, 3, n), seed=5)
    want = np.asarray(jax_qmm_experts(jt, jnp.asarray(idx), jnp.asarray(x),
                                      interpret=True))
    got = qmm_experts(tt, torch.from_numpy(idx), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(
        qmm_experts_packed(tt, torch.from_numpy(idx), torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_k6_packed_plain_matches_pallas(quant):
    """K6's packed body over 4 tiles of 3 experts (one repeated) against the
    Pallas qmm_grouped (interpret), which takes the tiles stride-16
    permuted; the port takes them in natural order. With live-row counts
    the rows past them are zero. Tolerance as K5."""
    E, d, n, G = 3, 64, 256, 4
    jt, tt = packed_pair(_raw(rnd((E, d, n), seed=6), quant), quant, d, n)
    x = rnd((G, 128, n), seed=7)
    te = np.asarray([2, 0, 2, 1], np.int32)
    want = np.asarray(jax_qmm_grouped(jt, jnp.asarray(te), _perm_x(jnp.asarray(x), n),
                                      interpret=True))
    got = qmm_grouped(tt, torch.from_numpy(te), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    rows = torch.tensor([128, 5, 0, 77])
    part = qmm_grouped_packed(tt, torch.from_numpy(te), torch.from_numpy(x), rows).numpy()
    for g, r in enumerate(rows.tolist()):
        np.testing.assert_array_equal(part[g, :r], got[g, :r])
        assert not part[g, r:].any()


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_grouped_ffn_packed_matches_jax(quant):
    """The packed MoE prefill FFN (counting dispatch into 128-row tiles +
    K6's packed body) against the JAX grouped_expert_ffn with qmm_grouped in
    interpret mode: 140 pairs over 4 experts, a fused [w1; w3] table.
    Tolerance 1e-4 of the output scale."""
    E, m, dim, B, T, k = 4, 256, 256, 1, 70, 2
    j13, t13 = packed_pair(_raw(rnd((E, 2 * m, dim), seed=8, scale=0.1), quant),
                           quant, 2 * m, dim)
    j2, t2 = packed_pair(_raw(rnd((E, dim, m), seed=9, scale=0.1), quant), quant, dim, m)
    xb = rnd((B, T, dim), seed=10, scale=0.3)
    rng = np.random.default_rng(11)
    idx = rng.integers(0, E, (B, T, k)).astype(np.int32)
    wts = rng.uniform(size=(B, T, k)).astype(np.float32)
    want = np.asarray(jmm.grouped_expert_ffn(
        None, j2, None, jnp.asarray(xb), jnp.asarray(wts), jnp.asarray(idx),
        JaxAct.SILU, NULL_CTX, interpret=True, w13=j13)[0])
    cfg = dataclasses.make_dataclass("C", ["dim", "moe_intermediate_size"])
    assert tmm.grouped_ffn_supported(cfg(dim, m), t13)
    assert not tmm.grouped_ffn_supported(cfg(dim, 384), t13)
    got = tmm.grouped_expert_ffn(None, t2, None, torch.from_numpy(xb),
                                 torch.from_numpy(wts), torch.from_numpy(idx),
                                 ActivationType.SILU, w13=t13).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_per_head_up_packed_matches_jax(quant, monkeypatch):
    """Absorbed-MLA decode's wv_b product (8 heads, Dv 64, R 256) through
    K2's packed body with idx = head id, against the JAX XLA path
    (dequantize, then the per-head einsum). Tolerance 1e-5 of max|out|."""
    H, Dv, R = 8, 64, 256
    jt, tt = packed_pair(_raw(rnd((H * Dv, R), seed=12), quant), quant, H * Dv, R)
    lat = rnd((2, H, R), seed=13)
    want = np.asarray(jnp.einsum("bhr,hvr->bhv", jnp.asarray(lat),
                                 jt.dequant(jnp.float32).reshape(H, Dv, R)))
    calls = []
    fn = port_model.qmm_experts
    monkeypatch.setattr(port_model, "qmm_experts",
                        lambda qt, *a: calls.append(qt.shape) or fn(qt, *a))
    got = port_model.per_head_up(tt, torch.from_numpy(lat)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert calls == [(H, Dv, R)] and rows_to_experts(tt, H).shape == (H, Dv, R)


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_packed_embed_lookup_matches_jax(quant):
    jt, tt = packed_pair(_raw(rnd((300, 256), seed=14), quant), quant, 300, 256)
    toks = np.array([[0, 129, 299], [5, 128, 127]])
    want = np.asarray(jax_embed(jt, jnp.asarray(toks)))
    got = embed_lookup(tt, torch.from_numpy(toks)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# converted checkpoints at their defaults through both packages
# ---------------------------------------------------------------------------

_ARCH = {
    "q2_k": dict(arch="DeepseekV2ForCausalLM", topk_method="greedy",
                 scoring="softmax"),
    "q3_k": dict(arch="DeepseekV3ForCausalLM", topk_method="noaux_tc",
                 scoring="sigmoid"),
}


@pytest.fixture(scope="module", params=["q2_k", "q3_k"])
def ckpt(request, tmp_path_factory):
    """A converted 2-layer absorbed-MLA MoE checkpoint (dims of
    tests/test_torch_engine.py), loaded by both Engines with default
    arguments: packed planes on both sides. The JAX oracle for the logits
    is greedy decode mode, one token a step."""
    quant = request.param
    cfg = hf_config(dim=256, hidden=256, q_lora=256, kv_lora=256, nope=128,
                    rope=64, v_dim=128, moe_inter=256, layers=2, vocab=300,
                    n_experts=4, n_active=2, **_ARCH[quant])
    root = tmp_path_factory.mktemp(f"packed-{quant}")
    hf_dir = os.path.join(str(root), "hf")
    write_hf_dir(hf_dir, cfg, hf_weights(cfg, seed=31, scale=0.1))
    out = os.path.join(str(root), "ck")
    cv.convert(hf_dir, out, quant=quant, use_mla=True)
    jeng = JaxEngine(out, seed=0, context=CONTEXT, decode_block=1)
    eng = Engine(out, context=CONTEXT, device="cpu", seed=0)
    prompt = jeng.tokenizer.encode("hello world", bos=True)[:6]
    prompt += [7] * (6 - len(prompt))
    fwd = make_forward(jeng.cfg, prefill=False)
    cache = init_cache(jeng.cfg)
    toks, logits = list(prompt), []
    for pos in range(len(prompt) + N_NEW - 1):
        lg, cache = fwd(jeng.params, cache, jnp.asarray([[toks[pos]]], jnp.int32), pos)
        logits.append(np.asarray(lg[0]))
        if pos >= len(prompt) - 1:
            toks.append(int(np.argmax(logits[-1])))
    return dict(dir=out, quant=quant, jeng=jeng, eng=eng, prompt=prompt,
                tokens=toks, logits=np.stack(logits))


def _teacher_forced(params, cfg, tokens, n):
    cache = torch_cache(cfg)
    out = []
    with torch.inference_mode():
        for pos in range(n):
            out.append(forward_decode(params, cache, torch.tensor([[tokens[pos]]]),
                                      pos, cfg)[0].numpy())
    return np.stack(out)


def test_default_runtime_is_packed_like_jax(ckpt):
    """Engine(ckpt) and load_params with no runtime argument keep the
    packed planes, as the JAX Engine(ckpt) does: after fuse_projections the
    same fields are set (the shared expert stays shared_w13/shared_w2: the
    stride-16 planes interleave columns, so it is not folded), each with the
    JAX planes bit for bit; "nibble" still expands them."""
    cls = Q2KTensor if ckpt["quant"] == "q2_k" else Q3KTensor
    jp, tp = ckpt["jeng"].params, ckpt["eng"].params
    seen = 0
    for jl, tl in zip(jp.layers + [jp], tp.layers + [tp]):
        for f in dataclasses.fields(tl):
            if f.name == "layers":
                continue
            a, b = getattr(tl, f.name), getattr(jl, f.name, None)
            assert (a is None) == (b is None), f.name
            if isinstance(a, (Q2KTensor, Q3KTensor)) or type(b).__name__ == cls.__name__:
                assert isinstance(a, cls) and type(b).__name__ == cls.__name__, f.name
                for g in _fields(a):
                    np.testing.assert_array_equal(getattr(a, g).numpy(),
                                                  np.asarray(getattr(b, g)))
                seen += 1
    moe = tp.layers[1]
    assert moe.w13 is not None and moe.shared_w13 is not None and moe.w13s is None
    assert tp.layers[0].wkvq is not None and tp.layers[0].wcr is not None
    assert seen >= 14
    direct = load_params(ckpt["eng"].data, ckpt["eng"].cfg)
    assert isinstance(direct.layers[0].wo, cls)
    nib = load_params(ckpt["eng"].data, ckpt["eng"].cfg, kquant_runtime="nibble")
    assert isinstance(nib.layers[0].wo, KNibbleTensor)


def test_kquant_runtime_values(ckpt):
    """None, "nibble" and "turbo" load (tests/test_torch_turbo.py holds
    turbo against the JAX package); any other value is refused rather than
    read as the default."""
    data, cfg = ckpt["eng"].data, ckpt["eng"].cfg
    turbo = load_params(data, cfg, kquant_runtime="turbo")
    assert type(turbo.layers[0].wo).__name__ == \
        ("Q2KTurboTensor" if ckpt["quant"] == "q2_k" else "Q3KTurboTensor")
    with pytest.raises(ValueError, match="kquant_runtime"):
        load_params(data, cfg, kquant_runtime="packed")


def test_packed_decode_logits_match_jax(ckpt):
    """Teacher-forced decode logits through params_from_reference (packed
    planes carried across) and through the port's own loader, past the
    12-slot window. Tolerance 1e-3 of the logit scale: the same f32
    dequantization summed in other orders, and a latent may round to the
    neighbouring f16 cache value (as tests/test_torch_engine.py)."""
    jeng, eng = ckpt["jeng"], ckpt["eng"]
    params = params_from_reference(jeng.params, "cpu")
    assert isinstance(params.layers[1].w13, (Q2KTensor, Q3KTensor))
    want = ckpt["logits"]
    got = _teacher_forced(params, eng.cfg, ckpt["tokens"], len(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
    own = _teacher_forced(eng.params, eng.cfg, ckpt["tokens"], len(want))
    np.testing.assert_array_equal(own, got)


def test_packed_generate_matches_jax(ckpt):
    """Engine.generate at the defaults of both packages (packed planes; the
    prompt hydrated by prefill, then decode past the window): the same
    greedy tokens, up to N_NEW or an end-of-sequence token."""
    want, _ = ckpt["jeng"].generate(ckpt["prompt"], num_steps=N_NEW, temperature=0.0)
    got, stats = ckpt["eng"].generate(ckpt["prompt"], num_steps=N_NEW, temperature=0.0)
    assert got == want
    assert stats.generated_tokens == len(got) > 0


def test_packed_hydrate_matches_jax(ckpt):
    """Engine.hydrate (one prefill chunk clamped at the 12-slot window, then
    decode steps): last logits within 1e-3 of their scale, log-softmax rows
    within 2e-3 (a row moves by at most twice its logits' error)."""
    jeng, eng = ckpt["jeng"], ckpt["eng"]
    toks = ckpt["tokens"][:14]
    _, jlast, jrows, _ = jeng.hydrate(jeng.new_cache(), toks, collect_all_logits=True)
    _, last, rows, _ = eng.hydrate(eng.new_cache(), toks, collect_all_logits=True)
    scale = np.abs(jlast).max()
    np.testing.assert_allclose(last, jlast, rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=2e-3 * scale)


def test_packed_active_bytes_match_jax(ckpt):
    """params_active_bytes counts the packed planes as the JAX function does
    (on absorbed MLA without wq_b/wkv_b, ROADMAP.md queue 3)."""
    jeng, eng = ckpt["jeng"], ckpt["eng"]
    for pos in (0, 7, 100):
        want = jax_active_bytes(jeng.params, jeng.cfg, pos) - sum(
            lp.wq_b.nbytes_active + lp.wkv_b.nbytes_active for lp in jeng.params.layers)
        assert params_active_bytes(eng.params, eng.cfg, pos) == pytest.approx(want, rel=1e-12)


def test_random_packed_params_layout(ckpt):
    """``random_fused_params(cfg, "q2_k" | "q3_k", factors=True)`` (the
    card's V3-width packed model) builds the fields, plane shapes and dtypes
    that loading and fusing the converter's checkpoint gives, and decodes."""
    eng = ckpt["eng"]
    rp = random_fused_params(eng.cfg, ckpt["quant"], seed=0, device="cpu", factors=True)
    for got, want in zip(rp.layers + [rp], eng.params.layers + [eng.params]):
        for f in dataclasses.fields(got):
            if f.name in ("layers", "embed"):
                continue
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert (a is None) == (b is None), f.name
            if isinstance(b, (Q2KTensor, Q3KTensor)):
                assert type(a) is type(b), f.name
                for g in _fields(a):
                    pa, pb = getattr(a, g), getattr(b, g)
                    assert (pa.shape, pa.dtype) == (pb.shape, pb.dtype), (f.name, g)
            elif b is not None:
                assert tuple(a.shape) == tuple(b.shape), f.name
    with torch.inference_mode():
        lg = forward_decode(rp, torch_cache(eng.cfg), torch.tensor([[5]]), 0, eng.cfg)
    assert lg.shape == (1, eng.cfg.vocab_size) and torch.isfinite(lg).all()
