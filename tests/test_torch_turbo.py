"""The port's turbo K-quant runtime (``kquant_runtime="turbo"``: int8
planes) against the JAX package.

- Numpy-seeded weights quantized by ``deepseek_tpu.quant.kquant``,
  repacked and converted by each package: the turbo planes equal bit for
  bit (Q2_K natural order with bf16 min terms, Q3_K permuted with bf16
  scales), the f32 dequantization equal, 2-D and expert-stacked. Every
  in-features width here has n/16 > 16 groups, so a mixed-up column order
  shows.
- The plain versions of the turbo bodies of K5 (``qmm_turbo``, its
  row-tiled route), K2 (``qmm_experts_turbo``) and K6
  (``qmm_grouped_turbo``) against the Pallas kernels in interpret mode
  (which take Q2_K turbo's group sums s16 over the natural activations and
  Q3_K turbo's activations permuted), the grouped MoE prefill FFN,
  ``per_head_up`` and ``embed_lookup``.
- Converted 2-layer Q2_K (V2 greedy routing) and Q3_K (V3 noaux_tc)
  checkpoints through ``Engine(kquant_runtime="turbo")`` of both packages:
  the same planes after ``fuse_projections`` (Q2_K's shared expert folded
  into the routed tables), teacher-forced decode logits, ``hydrate``,
  greedy tokens, active bytes.
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
from deepseek_tpu.ops.pallas.qmm import _group_sums, _perm_x
from deepseek_tpu.ops.pallas.qmm import qmm as jax_qmm
from deepseek_tpu.ops.pallas.qmm import qmm_experts as jax_qmm_experts
from deepseek_tpu.ops.pallas.qmm import qmm_grouped as jax_qmm_grouped
from deepseek_tpu.parallel.spmd import NULL_CTX
from deepseek_tpu.quant.qtensor import q2k_to_turbo as jax_q2k_to_turbo
from deepseek_tpu.quant.qtensor import q3k_to_turbo as jax_q3k_to_turbo
from deepseek_tpu_torch.config import ActivationType
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.models import deepseek as port_model
from deepseek_tpu_torch.models.deepseek import forward_decode
from deepseek_tpu_torch.models.kvcache import init_cache as torch_cache
from deepseek_tpu_torch.models.loader import params_active_bytes, params_from_reference
from deepseek_tpu_torch.models.params import embed_lookup
from deepseek_tpu_torch.models.testing import random_fused_params
from deepseek_tpu_torch.ops import matmul as tmm
from deepseek_tpu_torch.ops.kernels.qmm import (
    ROW_TILE_MIN, qmm, qmm_experts, qmm_experts_turbo, qmm_grouped,
    qmm_grouped_turbo, qmm_turbo, qmm_turbo_rows,
)
from deepseek_tpu_torch.quant.qtensor import (
    Q2KTurboTensor, Q3KTurboTensor, cols_to_experts, q2k_to_turbo, q3k_to_turbo,
    rows_to_experts,
)
from tests.test_torch_packed import _ARCH, _fields, _teacher_forced, packed_pair
from tests.test_torch_qmm import _raw, rnd
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir

CONTEXT = 12
N_NEW = 10


def turbo_pair(raw, quant, rows, cols):
    """The JAX and the port's turbo tensor of the same raw K-quant blocks,
    each repacked and converted by its own package."""
    jt, tt = packed_pair(raw, quant, rows, cols)
    if quant == "q2_k":
        return jax_q2k_to_turbo(jt), q2k_to_turbo(tt)
    return jax_q3k_to_turbo(jt), q3k_to_turbo(tt)


def _tol(want, rel=1e-4):
    return dict(rtol=0, atol=rel * np.abs(want).max())


# ---------------------------------------------------------------------------
# planes, dequantization, the plain versions of the turbo bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("shape", [(64, 512), (3, 32, 768)], ids=["2d", "experts"])
def test_turbo_planes_and_dequant_match_jax(quant, shape):
    """Every plane equal bit for bit and of the JAX dtype (p int8, Q2_K's d
    f32, bm and a bf16), the f32 dequantization equal, the same shape and
    active bytes."""
    jt, tt = turbo_pair(_raw(rnd(shape, seed=1), quant), quant, *shape[-2:])
    for f in _fields(tt):
        a, b = getattr(tt, f), getattr(jt, f)
        assert str(a.dtype).split(".")[-1] == str(b.dtype) and a.is_contiguous(), f
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), np.asarray(b).view(np.int16)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tt.dequant(torch.float32).numpy(),
                                  np.asarray(jt.dequant(jnp.float32)))
    assert tt.shape == jt.shape and tt.nbytes_active == jt.nbytes_active


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("B", [1, 3, 130])
def test_k5_turbo_plain_matches_pallas(quant, B):
    """K5's turbo body against the Pallas qmm in interpret mode at 1, 3 and
    130 rows (past the JAX 128-row batch tile and the port's row-tiled
    threshold). Tolerance 1e-4 of max|out|: f32 products of the same
    dequantized weights, summed in other orders."""
    d, n = 64, 512
    jt, tt = turbo_pair(_raw(rnd((d, n), seed=2), quant), quant, d, n)
    x = rnd((B, n), seed=3)
    want = np.asarray(jax_qmm(jt, jnp.asarray(x), interpret=True))
    got = qmm(tt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **_tol(want))
    route = qmm_turbo_rows if B > ROW_TILE_MIN else qmm_turbo
    np.testing.assert_array_equal(route(tt, torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_k2_turbo_plain_matches_pallas(quant):
    """K2's turbo body against the Pallas qmm_experts (interpret): 2 tokens
    x 3 slots over 5 experts, expert 4 repeated. Tolerance as K5."""
    E, m, n = 5, 32, 512
    jt, tt = turbo_pair(_raw(rnd((E, m, n), seed=4), quant), quant, m, n)
    idx = np.asarray([[4, 0, 4], [2, 1, 3]], np.int32)
    x = rnd((2, 3, n), seed=5)
    want = np.asarray(jax_qmm_experts(jt, jnp.asarray(idx), jnp.asarray(x),
                                      interpret=True))
    got = qmm_experts(tt, torch.from_numpy(idx), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **_tol(want))
    np.testing.assert_array_equal(
        qmm_experts_turbo(tt, torch.from_numpy(idx), torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_k6_turbo_plain_matches_pallas(quant):
    """K6's turbo body over 4 tiles of 3 experts (one repeated) against the
    Pallas qmm_grouped (interpret), which takes Q2_K turbo's tiles in
    natural order with their group sums and Q3_K turbo's permuted; the port
    takes natural tiles. With live-row counts the rows past them are zero.
    Tolerance as K5."""
    E, d, n, G = 3, 64, 512, 4
    jt, tt = turbo_pair(_raw(rnd((E, d, n), seed=6), quant), quant, d, n)
    x = rnd((G, 128, n), seed=7)
    te = np.asarray([2, 0, 2, 1], np.int32)
    xj = jnp.asarray(x)
    if quant == "q2_k":
        want = jax_qmm_grouped(jt, jnp.asarray(te), xj, interpret=True,
                               s16_tiles=_group_sums(xj, n))
    else:
        want = jax_qmm_grouped(jt, jnp.asarray(te), _perm_x(xj, n), interpret=True)
    want = np.asarray(want)
    got = qmm_grouped(tt, torch.from_numpy(te), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **_tol(want))
    rows = torch.tensor([128, 5, 0, 77])
    part = qmm_grouped_turbo(tt, torch.from_numpy(te), torch.from_numpy(x), rows).numpy()
    for g, r in enumerate(rows.tolist()):
        np.testing.assert_array_equal(part[g, :r], got[g, :r])
        assert not part[g, r:].any()


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_grouped_ffn_turbo_matches_jax(quant):
    """The turbo MoE prefill FFN (counting dispatch into 128-row tiles +
    K6's turbo body) against the JAX grouped_expert_ffn with qmm_grouped in
    interpret mode: 140 pairs over 4 experts, a fused [w1; w3] table, m =
    512 (32 groups). Tolerance 1e-4 of the output scale."""
    E, m, dim, B, T, k = 4, 512, 256, 1, 70, 2
    j13, t13 = turbo_pair(_raw(rnd((E, 2 * m, dim), seed=8, scale=0.1), quant),
                          quant, 2 * m, dim)
    j2, t2 = turbo_pair(_raw(rnd((E, dim, m), seed=9, scale=0.1), quant), quant, dim, m)
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
    np.testing.assert_allclose(got, want, **_tol(want))


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_per_head_up_turbo_matches_jax(quant, monkeypatch):
    """Absorbed-MLA decode's wv_b product (8 heads, Dv 64, R 512) through
    K2's turbo body with idx = head id, against the JAX XLA path
    (dequantize, then the per-head einsum). Tolerance 1e-5 of max|out|."""
    H, Dv, R = 8, 64, 512
    jt, tt = turbo_pair(_raw(rnd((H * Dv, R), seed=12), quant), quant, H * Dv, R)
    lat = rnd((2, H, R), seed=13)
    want = np.asarray(jnp.einsum("bhr,hvr->bhv", jnp.asarray(lat),
                                 jt.dequant(jnp.float32).reshape(H, Dv, R)))
    calls = []
    fn = port_model.qmm_experts
    monkeypatch.setattr(port_model, "qmm_experts",
                        lambda qt, *a: calls.append(type(qt)) or fn(qt, *a))
    got = port_model.per_head_up(tt, torch.from_numpy(lat)).numpy()
    np.testing.assert_allclose(got, want, **_tol(want, 1e-5))
    assert calls == [type(tt)] and rows_to_experts(tt, H).shape == (H, Dv, R)


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_turbo_embed_lookup_matches_jax(quant):
    jt, tt = turbo_pair(_raw(rnd((300, 512), seed=14), quant), quant, 300, 512)
    toks = np.array([[0, 129, 299], [5, 128, 127]])
    want = np.asarray(jax_embed(jt, jnp.asarray(toks)))
    got = embed_lookup(tt, torch.from_numpy(toks)).numpy()
    np.testing.assert_array_equal(got, want)


def test_q2k_turbo_columns_split_into_experts():
    """Q2_K turbo's natural order splits (dim, ns*m) into (ns, dim, m) when
    256 divides m (the shared-expert fold); Q3_K turbo's permuted order
    does not split."""
    j2, t2 = turbo_pair(_raw(rnd((64, 1024), seed=15), "q2_k"), "q2_k", 64, 1024)
    parts = cols_to_experts(t2, 2, 512)
    assert isinstance(parts, Q2KTurboTensor) and parts.shape == (2, 64, 512)
    full = t2.dequant().numpy()
    for e in range(2):
        np.testing.assert_array_equal(parts.map(lambda t: t[e]).dequant().numpy(),
                                      full[:, e * 512:(e + 1) * 512])
    assert cols_to_experts(t2, 4, 256 + 0) is not None
    assert cols_to_experts(t2.map(lambda t: t[:, :768]), 2, 384) is None
    _, t3 = turbo_pair(_raw(rnd((64, 1024), seed=15), "q3_k"), "q3_k", 64, 1024)
    assert cols_to_experts(t3, 2, 512) is None


# ---------------------------------------------------------------------------
# converted checkpoints through Engine(kquant_runtime="turbo")
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["q2_k", "q3_k"])
def ckpt(request, tmp_path_factory):
    """A converted 2-layer absorbed-MLA MoE checkpoint (the dims of
    tests/test_torch_packed.py, moe_inter 256 so that Q2_K turbo folds its
    shared expert) through both Engines with kquant_runtime="turbo". The
    JAX oracle for the logits is greedy decode mode, one token a step."""
    quant = request.param
    cfg = hf_config(dim=256, hidden=256, q_lora=256, kv_lora=256, nope=128,
                    rope=64, v_dim=128, moe_inter=256, layers=2, vocab=300,
                    n_experts=4, n_active=2, **_ARCH[quant])
    root = tmp_path_factory.mktemp(f"turbo-{quant}")
    hf_dir = os.path.join(str(root), "hf")
    write_hf_dir(hf_dir, cfg, hf_weights(cfg, seed=31, scale=0.1))
    out = os.path.join(str(root), "ck")
    cv.convert(hf_dir, out, quant=quant, use_mla=True)
    jeng = JaxEngine(out, seed=0, context=CONTEXT, decode_block=1,
                     kquant_runtime="turbo")
    eng = Engine(out, context=CONTEXT, device="cpu", seed=0, kquant_runtime="turbo")
    prompt = jeng.tokenizer.encode("hello world", bos=True)[:6]
    prompt += [7] * (6 - len(prompt))
    # the logit oracle runs a float32 cache: an f16 cache latent may round
    # to its neighbouring value on one side only (~1e-4 of the logit scale,
    # tests/test_torch_packed.py), which would hide the turbo products'
    # agreement
    cfg32 = dataclasses.replace(jeng.cfg, kv_cache_dtype="float32")
    fwd = make_forward(cfg32, prefill=False)
    cache = init_cache(cfg32)
    toks, logits = list(prompt), []
    for pos in range(len(prompt) + N_NEW - 1):
        lg, cache = fwd(jeng.params, cache, jnp.asarray([[toks[pos]]], jnp.int32), pos)
        logits.append(np.asarray(lg[0]))
        if pos >= len(prompt) - 1:
            toks.append(int(np.argmax(logits[-1])))
    return dict(dir=out, quant=quant, jeng=jeng, eng=eng, prompt=prompt,
                tokens=toks, logits=np.stack(logits))


def test_turbo_load_matches_jax(ckpt):
    """After fuse_projections both Engines hold the same fields, each turbo
    tensor with the JAX planes bit for bit: Q2_K turbo's shared expert
    folded into w13s/w2s (E + 1 experts), Q3_K turbo's kept as
    shared_w13/shared_w2 (its permuted planes interleave columns)."""
    cls = Q2KTurboTensor if ckpt["quant"] == "q2_k" else Q3KTurboTensor
    jp, tp = ckpt["jeng"].params, ckpt["eng"].params
    seen = 0
    for jl, tl in zip(jp.layers + [jp], tp.layers + [tp]):
        for f in dataclasses.fields(tl):
            if f.name == "layers":
                continue
            a, b = getattr(tl, f.name), getattr(jl, f.name, None)
            assert (a is None) == (b is None), f.name
            if isinstance(a, cls) or type(b).__name__ == cls.__name__:
                assert isinstance(a, cls) and type(b).__name__ == cls.__name__, f.name
                for g in _fields(a):
                    pa, pb = getattr(a, g), np.asarray(getattr(b, g))
                    if pa.dtype == torch.bfloat16:
                        pa, pb = pa.view(torch.int16), pb.view(np.int16)
                    np.testing.assert_array_equal(pa.numpy(), pb)
                seen += 1
    moe = tp.layers[1]
    if ckpt["quant"] == "q2_k":
        assert moe.w13s is not None and moe.w13s.shape[0] == 5 and moe.shared_w13 is None
    else:
        assert moe.w13 is not None and moe.shared_w13 is not None and moe.w13s is None
    assert seen >= 12


def test_turbo_decode_logits_match_jax(ckpt):
    """Teacher-forced decode logits through params_from_reference (the
    JAX turbo planes carried across) and through the port's own loader,
    past the 12-slot window, both with a float32 cache, within 1e-4 of the
    logit scale: the same f32 dequantization (bf16 scales on both sides)
    summed in other orders."""
    jeng, eng = ckpt["jeng"], ckpt["eng"]
    params = params_from_reference(jeng.params, "cpu")
    assert isinstance(params.layers[1].wo, (Q2KTurboTensor, Q3KTurboTensor))
    cfg32 = dataclasses.replace(eng.cfg, kv_cache_dtype="float32")
    want = ckpt["logits"]
    got = _teacher_forced(params, cfg32, ckpt["tokens"], len(want))
    np.testing.assert_allclose(got, want, **_tol(want))
    own = _teacher_forced(eng.params, cfg32, ckpt["tokens"], len(want))
    np.testing.assert_array_equal(own, got)


def test_turbo_generate_matches_jax(ckpt):
    """Engine.generate (greedy; the prompt hydrated by prefill, then the
    decode block past the window): the same tokens as the JAX turbo
    Engine."""
    want, _ = ckpt["jeng"].generate(ckpt["prompt"], num_steps=N_NEW, temperature=0.0)
    got, stats = ckpt["eng"].generate(ckpt["prompt"], num_steps=N_NEW, temperature=0.0)
    assert got == want
    assert stats.generated_tokens == len(got) > 0


def test_turbo_hydrate_matches_jax(ckpt):
    """Engine.hydrate (one prefill chunk clamped at the 12-slot window, then
    decode steps): last logits and log-softmax rows within 1e-4 and 2e-4
    of the logit scale."""
    jeng, eng = ckpt["jeng"], ckpt["eng"]
    toks = ckpt["tokens"][:14]
    _, jlast, jrows, _ = jeng.hydrate(jeng.new_cache(), toks, collect_all_logits=True)
    _, last, rows, _ = eng.hydrate(eng.new_cache(), toks, collect_all_logits=True)
    scale = np.abs(jlast).max()
    np.testing.assert_allclose(last, jlast, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=2e-4 * scale)


def test_turbo_active_bytes_match_jax(ckpt):
    """params_active_bytes counts the turbo planes (and Q2_K's folded
    tables) as the JAX function does (on absorbed MLA without wq_b/wkv_b,
    ROADMAP.md queue 3)."""
    jeng, eng = ckpt["jeng"], ckpt["eng"]
    for pos in (0, 7, 100):
        want = jax_active_bytes(jeng.params, jeng.cfg, pos) - sum(
            lp.wq_b.nbytes_active + lp.wkv_b.nbytes_active for lp in jeng.params.layers)
        assert params_active_bytes(eng.params, eng.cfg, pos) == pytest.approx(want, rel=1e-12)


def test_random_turbo_params_layout(ckpt):
    """``random_fused_params(cfg, "q2_k_turbo" | "q3_k_turbo", factors=True)``
    (the card's V3-width turbo models) builds the fields, plane shapes and
    dtypes that loading and fusing the converter's checkpoint in turbo
    gives, and decodes."""
    eng = ckpt["eng"]
    rp = random_fused_params(eng.cfg, ckpt["quant"] + "_turbo", seed=0, device="cpu",
                             factors=True)
    for got, want in zip(rp.layers + [rp], eng.params.layers + [eng.params]):
        for f in dataclasses.fields(got):
            if f.name in ("layers", "embed"):
                continue
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert (a is None) == (b is None), f.name
            if isinstance(b, (Q2KTurboTensor, Q3KTurboTensor)):
                assert type(a) is type(b), f.name
                for g in _fields(a):
                    pa, pb = getattr(a, g), getattr(b, g)
                    assert (pa.shape, pa.dtype) == (pb.shape, pb.dtype), (f.name, g)
            elif b is not None:
                assert tuple(a.shape) == tuple(b.shape), f.name
    with torch.inference_mode():
        lg = forward_decode(rp, torch_cache(eng.cfg), torch.tensor([[5]]), 0, eng.cfg)
    assert lg.shape == (1, eng.cfg.vocab_size) and torch.isfinite(lg).all()
