"""The port's F8E5M2 slice against the JAX package.

- The codec reads and writes F8_E5M2 with and without ``ml_dtypes``.
- ``quant/fp8.py`` and ``Fp8Tensor.dequant`` equal ``deepseek_tpu.quant.fp8``
  and the JAX ``Fp8Tensor.dequant`` bit for bit, ragged grids included.
- The plain versions of the fp8 bodies of K5 (``qmm_fp8``, its row-tiled
  route), K2 (``qmm_experts_fp8``) and K6 (``qmm_grouped_fp8``) against
  the Pallas kernels in interpret mode where their grid divides (the TPU
  kernels assert otherwise), and against the JAX XLA path (dequantize,
  then one product) on ragged grids.
- Checkpoints written by ``deepseek_tpu.convert.convert(quant="f8e5m2")``
  (128x128 blocks, a ragged ``wkv_a``) as the converter's default MHA and
  as absorbed MLA, and a per-tensor (``bsize=0``) one: ``forward_*``,
  ``Engine.hydrate``/``generate``, ``fuse_projections`` and
  ``params_active_bytes`` against the JAX package.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu import convert as cv
from deepseek_tpu.config import ActivationType as JaxAct
from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu.models import init_cache, make_forward
from deepseek_tpu.models.loader import params_active_bytes as jax_active_bytes
from deepseek_tpu.ops import matmul as jmm
from deepseek_tpu.ops.matmul import qmatmul as jax_qmatmul
from deepseek_tpu.ops.pallas.qmm import qmm as jax_qmm
from deepseek_tpu.ops.pallas.qmm import qmm_experts as jax_qmm_experts
from deepseek_tpu.ops.pallas.qmm import qmm_grouped as jax_qmm_grouped
from deepseek_tpu.parallel.spmd import NULL_CTX
from deepseek_tpu.quant import fp8 as jfp8
from deepseek_tpu.quant.qtensor import Fp8Tensor as JaxFp8
from deepseek_tpu.utils import codec as jcodec
from deepseek_tpu_torch.config import ActivationType
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.models import deepseek as port_model
from deepseek_tpu_torch.models.deepseek import forward_decode, forward_prefill
from deepseek_tpu_torch.models.kvcache import init_cache as torch_cache
from deepseek_tpu_torch.models.loader import (
    _to_torch, params_active_bytes, params_from_reference,
)
from deepseek_tpu_torch.models.params import embed_lookup
from deepseek_tpu_torch.models.testing import random_fp8_params
from deepseek_tpu_torch.ops import matmul as tmm
from deepseek_tpu_torch.ops.kernels.qmm import (
    ROW_TILE_MIN, qmm, qmm_experts, qmm_experts_fp8, qmm_fp8, qmm_fp8_rows,
    qmm_grouped, qmm_grouped_fp8,
)
from deepseek_tpu_torch.quant import fp8 as tfp8
from deepseek_tpu_torch.quant.qtensor import Fp8Tensor
from deepseek_tpu_torch.utils import codec as tcodec
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _u8(a) -> np.ndarray:
    """The raw bytes of an fp8 numpy array or torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _quantize(w: np.ndarray, block):
    """The JAX quantizer over a 2-D weight or an expert stack (the
    converter's per-expert grids), as a (JAX, port) Fp8Tensor pair."""
    if block == (0, 0):
        q, s = jfp8.per_tensor_quantize(w)
        if w.ndim == 3:
            s = np.full((w.shape[0], 1, 1), s.item(), np.float32)
    elif w.ndim == 3:
        qs, ss = zip(*(jfp8.blockwise_quantize(e, block) for e in w))
        q, s = np.stack(qs), np.stack(ss)
    else:
        q, s = jfp8.blockwise_quantize(w, block)
    jt = JaxFp8(data=jnp.asarray(q), scale=jnp.asarray(s), block_size=tuple(block))
    tt = Fp8Tensor(data=_to_torch(q), scale=torch.from_numpy(np.array(s, np.float32)),
                   block_size=tuple(block))
    return jt, tt


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None          # import ml_dtypes now raises
import numpy as np, torch
from deepseek_tpu_torch.utils import codec
from deepseek_tpu_torch.models.loader import _to_torch
jdir, pdir = sys.argv[1:3]
assert codec._DTYPE_TO_NP["F8_E5M2"].names == ("f8_e5m2",)
data = codec.load_checkpoint(jdir)
assert data.tensors["w.weight"].dtype_str == "F8_E5M2"
w = _to_torch(data["w.weight"])
assert w.dtype == torch.float8_e5m2 and tuple(w.shape) == (5, 7)
raw = w.view(torch.uint8).numpy().view(codec._DTYPE_TO_NP["F8_E5M2"])
codec.save_checkpoint(pdir, [{"w.weight": raw, "w.scale": data["w.scale"],
                              "u": data["u"]}], data.metadata)
back = codec.load_checkpoint(pdir)
assert back.tensors["w.weight"].dtype_str == "F8_E5M2"
assert back.tensors["u"].dtype_str == "U8"
np.testing.assert_array_equal(_to_torch(back["w.weight"]).view(torch.uint8),
                              w.view(torch.uint8))
print("ok")
"""


def test_codec_fp8_without_ml_dtypes(tmp_path):
    """In an interpreter where ``import ml_dtypes`` fails (as on the card's
    machine), the port reads a JAX-written F8_E5M2 checkpoint as
    torch.float8_e5m2 and writes it back: the shard's bytes equal the JAX
    codec's, and the JAX codec reads the same fp8 values."""
    q, s = jfp8.blockwise_quantize(_rnd((5, 7), 1), (4, 4))
    u = np.arange(6, dtype=np.uint8)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcodec.save_checkpoint(jdir, [{"w.weight": q, "w.scale": s, "u": u}],
                           {"quant": "f8e5m2"})
    res = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, jdir, pdir],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    name = "shard_000.dseek"
    with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(pdir, name), "rb") as b:
        assert a.read() == b.read()
    back = jcodec.load_checkpoint(pdir)
    np.testing.assert_array_equal(_u8(back["w.weight"]), _u8(q))
    # with ml_dtypes present the port's codec names the ml_dtypes array
    assert tcodec.np_to_dtype_str(q.dtype) == "F8_E5M2"
    assert tcodec.np_to_dtype_str(u.dtype) == "U8"
    np.testing.assert_array_equal(_to_torch(q).view(torch.uint8).numpy(), _u8(q))


# ---------------------------------------------------------------------------
# quantization and dequantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,block", [
    ((256, 256), (0, 0)), ((3, 64, 48), (0, 0)), ((256, 256), (128, 128)),
    ((576, 256), (128, 128)), ((320, 200), (128, 128)), ((3, 320, 200), (128, 128)),
    ((2, 96, 80), (32, 64))],
    ids=["per-tensor", "per-tensor-experts", "divisible", "ragged-rows",
         "ragged-both", "ragged-experts", "small-blocks"])
def test_fp8_quantize_and_dequant_match_jax(shape, block):
    """The port's quantizers and Fp8Tensor.dequant equal the JAX package's
    bit for bit."""
    w = _rnd(shape, 2, scale=3.0)
    w[..., 1, 2] = 0.0
    jt, tt = _quantize(w, block)
    mats = [w] if w.ndim == 2 else list(w)
    for i, m in enumerate(mats):
        if block == (0, 0):
            q, s = tfp8.per_tensor_quantize(torch.from_numpy(m))
            jq, js = jfp8.per_tensor_quantize(m)
            back = tfp8.blockwise_dequantize(q, s.reshape(1, 1), m.shape)
            np.testing.assert_array_equal(back.numpy(), jfp8.per_tensor_dequantize(jq, js))
        else:
            q, s = tfp8.blockwise_quantize(torch.from_numpy(m), block)
            jq, js = jfp8.blockwise_quantize(m, block)
            np.testing.assert_array_equal(
                tfp8.blockwise_dequantize(q, s, block).numpy(),
                jfp8.blockwise_dequantize(jq, js, block))
        np.testing.assert_array_equal(_u8(q), _u8(jq))
        np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(tt.dequant(torch.float32).numpy(),
                                  np.asarray(jt.dequant(jnp.float32)))
    assert tt.nbytes_active == jt.nbytes_active and tt.shape == jt.shape


@pytest.mark.parametrize("block", [(0, 0), (128, 128)])
def test_fp8_embed_lookup_matches_jax(block):
    from deepseek_tpu.models.params import embed_lookup as jax_embed
    jt, tt = _quantize(_rnd((300, 192), 3), block)
    toks = np.array([[0, 129, 299], [5, 128, 127]])
    want = np.asarray(jax_embed(jt, jnp.asarray(toks)))
    got = embed_lookup(tt, torch.from_numpy(toks)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the plain versions of the fp8 bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 8, 256])
def test_k5_fp8_plain_matches_pallas(rows):
    """K5's fp8 body on a 128x128-blocked 256x384 weight against the Pallas
    qmm in interpret mode (which needs a dividing grid). Tolerance 1e-4 of
    max|out|: f32 products of the same dequantized weight; the TPU body
    scales each 128-column partial sum instead, so the sums round in
    another order."""
    jt, tt = _quantize(_rnd((256, 384), 4), (128, 128))
    x = _rnd((rows, 384), 5)
    want = np.asarray(jax_qmm(jt, jnp.asarray(x), interpret=True))
    got = qmm(tt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(qmm_fp8(tt, torch.from_numpy(x)).numpy(), got)
    if rows > ROW_TILE_MIN:
        np.testing.assert_array_equal(qmm_fp8_rows(tt, torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("shape", [(576, 256), (256, 448), (320, 200), (100, 2048)],
                         ids=["wkv_a-rows", "cols", "both", "lm_head-like"])
@pytest.mark.parametrize("rows", [1, 40])
def test_k5_fp8_plain_matches_xla_on_ragged_grids(shape, rows):
    """Where the 128x128 grid does not divide the weight the Pallas kernel
    asserts; the JAX package's semantics there are its XLA path
    (qmatmul with impl=None: dequantize, then one f32 product). Tolerance
    1e-5 of max|out|: the same f32 products summed in other orders. The
    port's qmatmul takes K5 (plain version here) for the blockwise weight."""
    jt, tt = _quantize(_rnd(shape, 6), (128, 128))
    x = _rnd((rows, shape[1]), 7)
    want = np.asarray(jax_qmatmul(jt, jnp.asarray(x), impl=None))
    for got in (qmm(tt, torch.from_numpy(x)), tmm.qmatmul(tt, torch.from_numpy(x))):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_per_tensor_qmatmul_matches_jax():
    """A per-tensor weight is dequantized and multiplied (no kernel), as
    the JAX qmm does (qmm.py:407-411)."""
    jt, tt = _quantize(_rnd((96, 128), 8), (0, 0))
    x = _rnd((3, 128), 9)
    want = np.asarray(jax_qmm(jt, jnp.asarray(x), interpret=True))
    got = tmm.qmatmul(tt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert tmm.per_tensor_fp8(tt) and not tmm.grouped_ffn_supported(None, tt)


def test_k2_fp8_plain_matches_pallas():
    """K2's fp8 body against the Pallas qmm_experts (interpret) with (32,
    128) blocks, as tests/test_pallas_qmm.py runs it. Tolerance 1e-4 of
    max|out| (as K5)."""
    E, d, n = 4, 64, 256
    jt, tt = _quantize(_rnd((E, d, n), 10), (32, 128))
    idx = np.array([[2, 1, 2, 0, 3]], np.int32)
    x = _rnd((1, 5, n), 11)
    want = np.asarray(jax_qmm_experts(jt, jnp.asarray(idx), jnp.asarray(x),
                                      interpret=True))[0]
    got = qmm_experts(tt, torch.from_numpy(idx[0]), torch.from_numpy(x[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(
        qmm_experts_fp8(tt, torch.from_numpy(idx[0]), torch.from_numpy(x[0])).numpy(), got)


@pytest.mark.parametrize("block", [(128, 128), (256, 128), (0, 0)],
                         ids=["per-head-blocks", "straddling-blocks", "per-tensor"])
def test_per_head_up_matches_jax_xla(block):
    """Absorbed-MLA decode's wv_b product (16 heads, Dv 128) on the CPU
    against the JAX XLA path (deepseek.py:490-492: dequantize, then the
    per-head einsum). Blocks that split by head take K2's fp8 body (its
    plain version here); 256-row blocks straddle two heads and a per-tensor
    scale has no kernel: both dequantize. Tolerance 1e-5 of max|out|: f32
    sums in other orders."""
    H, Dv, R = 16, 128, 256
    jt, tt = _quantize(_rnd((H * Dv, R), 16), block)
    lat = _rnd((2, H, R), 17)
    want = np.asarray(jnp.einsum("bhr,hvr->bhv", jnp.asarray(lat),
                                 jt.dequant(jnp.float32).reshape(H, Dv, R)))
    got = port_model.per_head_up(tt, torch.from_numpy(lat)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_k6_fp8_plain_matches_pallas():
    """K6's fp8 body over 4 tiles of 3 experts (one repeated) against the
    Pallas qmm_grouped (interpret), with ragged live-row counts: the live
    rows within 1e-4 of max|out|, the rest zero."""
    E, d, n, G = 3, 64, 256, 4
    jt, tt = _quantize(_rnd((E, d, n), 12), (32, 128))
    x = _rnd((G, 128, n), 13)
    te = np.asarray([2, 0, 2, 1], np.int32)
    want = np.asarray(jax_qmm_grouped(jt, jnp.asarray(te), jnp.asarray(x),
                                      interpret=True))
    rows = torch.tensor([128, 5, 0, 77])
    got = qmm_grouped(tt, torch.from_numpy(te), torch.from_numpy(x), rows).numpy()
    tol = 1e-4 * np.abs(want).max()
    for g, r in enumerate(rows.tolist()):
        np.testing.assert_allclose(got[g, :r], want[g, :r], rtol=0, atol=tol)
        assert not got[g, r:].any()
    np.testing.assert_array_equal(
        qmm_grouped_fp8(tt, torch.from_numpy(te), torch.from_numpy(x), rows).numpy(), got)


def test_grouped_ffn_fp8_matches_jax():
    """The MoE prefill FFN over fp8 tables (counting dispatch into 128-row
    tiles + K6's fp8 body) against the JAX grouped_expert_ffn with
    qmm_grouped in interpret mode: 140 pairs over 4 experts, a fused
    [w1; w3] table. Tolerance 1e-4 of the output scale."""
    E, m, dim, B, T, k = 4, 128, 256, 1, 70, 2
    j13, t13 = _quantize(_rnd((E, 2 * m, dim), 14, scale=0.1), (128, 128))
    j2, t2 = _quantize(_rnd((E, dim, m), 15, scale=0.1), (128, 128))
    xb = _rnd((B, T, dim), 16, scale=0.3)
    rng = np.random.default_rng(17)
    idx = rng.integers(0, E, (B, T, k)).astype(np.int32)
    wts = rng.uniform(size=(B, T, k)).astype(np.float32)
    want = np.asarray(jmm.grouped_expert_ffn(
        None, j2, None, jnp.asarray(xb), jnp.asarray(wts), jnp.asarray(idx),
        JaxAct.SILU, NULL_CTX, interpret=True, w13=j13)[0])
    assert tmm.grouped_ffn_supported(dataclasses.make_dataclass(
        "C", ["dim", "moe_intermediate_size"])(dim, m), t13)
    got = tmm.grouped_expert_ffn(None, t2, None, torch.from_numpy(xb),
                                 torch.from_numpy(wts), torch.from_numpy(idx),
                                 ActivationType.SILU, w13=t13).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# converted checkpoints through the forward and the Engine
# ---------------------------------------------------------------------------

def _convert(root, tag, q_lora, seed, **kw):
    cfg = hf_config(dim=256, hidden=256, q_lora=q_lora, kv_lora=256, nope=128,
                    rope=64, v_dim=128, moe_inter=256, layers=2, vocab=300)
    hf_dir = os.path.join(root, f"hf-{tag}")
    write_hf_dir(hf_dir, cfg, hf_weights(cfg, seed=seed, scale=0.1))
    out = os.path.join(root, tag)
    cv.convert(hf_dir, out, quant="f8e5m2", **kw)
    return out


@pytest.fixture(scope="module", params=["mha", "mla"])
def fp8_ckpt(request, tmp_path_factory):
    """``convert(..., quant="f8e5m2", bsize=128)`` of a tiny 2-layer MoE
    (dims of tests/test_convert.py: wkv_a is 320 x 256, a partial last row
    block): the converter's default MHA (``wq``, no query LoRA) or absorbed
    MLA (with the factor weights). Window 24 slots."""
    mla = request.param == "mla"
    out = _convert(str(tmp_path_factory.mktemp(request.param)), request.param,
                   256 if mla else 0, 80, bsize=128, use_mla=mla)
    jeng = JaxEngine(out, seed=0, decode_block=1, prefill_chunk=10)
    eng = Engine(out, device="cpu", seed=0, prefill_chunk=10)
    assert eng.cfg.use_mla == mla and eng.cfg.block_size == (128, 128)
    assert eng.cfg.kv_window == 24
    toks = np.random.default_rng(81).integers(3, 300, 30).tolist()
    return dict(dir=out, jeng=jeng, eng=eng, toks=toks, mla=mla)


def test_fp8_loader_and_fusion_match_jax(fp8_ckpt):
    """The port's load_params + fuse_projections give the JAX package's
    fields: the same fused and unfused pairs (the ragged wkv_a is not
    fused; the shared experts fold into w13s/w2s), the same bytes and
    scale grids."""
    jp, tp = fp8_ckpt["jeng"].params, fp8_ckpt["eng"].params
    for jl, tl in zip(jp.layers + [jp], tp.layers + [tp]):
        for f in dataclasses.fields(tl):
            if f.name == "layers":
                continue
            a, b = getattr(tl, f.name), getattr(jl, f.name, None)
            assert (a is None) == (b is None), f.name
            if isinstance(a, Fp8Tensor):
                assert type(b).__name__ == "Fp8Tensor", f.name
                assert a.block_size == tuple(b.block_size) == (128, 128), f.name
                np.testing.assert_array_equal(_u8(a.data), _u8(b.data))
                np.testing.assert_array_equal(a.scale.numpy(), np.asarray(b.scale))
    moe = tp.layers[1]
    assert moe.w13s is not None and moe.w2s is not None and moe.w1 is None
    assert tp.layers[0].wkv_a is not None and tp.layers[0].wkv_a.shape[0] % 128


def test_fp8_forward_matches_jax(fp8_ckpt, monkeypatch):
    """Prefill chunks of 9 and 5 tokens (every row's logits), then decode
    steps past the 24-slot window, against the JAX XLA path on the same
    params. Tolerance 1e-3 of the logit scale: the same f32 arithmetic
    summed in other orders (the blockwise scales applied to the same
    dequantized weights)."""
    jeng, cfg = fp8_ckpt["jeng"], fp8_ckpt["eng"].cfg
    jcfg = dataclasses.replace(jeng.cfg, kernel_impl="xla")
    toks = fp8_ckpt["toks"]
    chunks = (9, 5)
    pre = make_forward(jcfg, prefill=True, logits_mode="all")
    dec = make_forward(jcfg, prefill=False)
    jcache, want, pos = init_cache(jcfg), [], 0
    for T in chunks:
        lg, jcache = pre(jeng.params, jcache, jnp.asarray([toks[pos:pos + T]], jnp.int32), pos)
        want.append(np.asarray(lg[0]))
        pos += T
    for p in range(pos, len(toks)):
        lg, jcache = dec(jeng.params, jcache, jnp.asarray([[toks[p]]], jnp.int32), p)
        want.append(np.asarray(lg))
    want = np.concatenate(want)

    params = params_from_reference(jeng.params, "cpu")
    calls = []
    fn = port_model.qmm_experts
    monkeypatch.setattr(port_model, "qmm_experts",
                        lambda qt, *a: calls.append(type(qt)) or fn(qt, *a))
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
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
    # every expert-table call takes an fp8 table (K2's fp8 body on the
    # card); absorbed-MLA decode also sends wv_b through it, once a layer
    n_dec = len(toks) - sum(chunks)
    assert set(calls) == {Fp8Tensor}
    assert len(calls) == (2 * (len(chunks) + n_dec)
                          + (cfg.n_layers * n_dec if fp8_ckpt["mla"] else 0))


def test_fp8_engine_matches_jax(fp8_ckpt):
    """Engine.hydrate (chunks of 10, then decode steps past the window):
    last logits within 1e-3 of their scale, log-softmax rows within 2e-3;
    greedy generate gives the JAX Engine's tokens."""
    jeng, eng, toks = fp8_ckpt["jeng"], fp8_ckpt["eng"], fp8_ckpt["toks"]
    _, jlast, jrows, _ = jeng.hydrate(jeng.new_cache(), toks, collect_all_logits=True)
    _, last, rows, _ = eng.hydrate(eng.new_cache(), toks, collect_all_logits=True)
    scale = np.abs(jlast).max()
    np.testing.assert_allclose(last, jlast, rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=2e-3 * scale)
    want, _ = jeng.generate(toks[:20], num_steps=10, temperature=0.0)
    got, _ = eng.generate(toks[:20], num_steps=10, temperature=0.0)
    assert got == want


def test_fp8_active_bytes_match_jax(fp8_ckpt):
    """params_active_bytes counts fp8 weights and their scale grids as the
    JAX function does (on absorbed MLA without wq_b/wkv_b, ROADMAP.md
    queue 3)."""
    jeng, eng = fp8_ckpt["jeng"], fp8_ckpt["eng"]
    for pos in (0, 7, 100):
        want = jax_active_bytes(jeng.params, jeng.cfg, pos)
        if fp8_ckpt["mla"]:
            want -= sum(lp.wq_b.nbytes_active + lp.wkv_b.nbytes_active
                        for lp in jeng.params.layers)
        assert params_active_bytes(eng.params, eng.cfg, pos) == pytest.approx(want, rel=1e-12)


def test_random_fp8_params_layout(fp8_ckpt):
    """``random_fp8_params`` (the card's V2-Lite fp8 model) builds the
    fields, shapes, dtypes and scale grids that loading and fusing the
    converter's checkpoint gives, and the model decodes."""
    eng = fp8_ckpt["eng"]
    rp = random_fp8_params(eng.cfg, seed=0, device="cpu")
    for got, want in zip(rp.layers + [rp], eng.params.layers + [eng.params]):
        for f in dataclasses.fields(got):
            if f.name == "layers":
                continue
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert (a is None) == (b is None), f.name
            if isinstance(b, Fp8Tensor):
                assert (a.shape, a.block_size, tuple(a.scale.shape), a.data.dtype) == \
                    (b.shape, b.block_size, tuple(b.scale.shape), b.data.dtype), f.name
            elif b is not None:
                assert tuple(a.shape) == tuple(b.shape), f.name
    with torch.inference_mode():
        lg = forward_decode(rp, torch_cache(eng.cfg), torch.tensor([[5]]), 0, eng.cfg)
    assert lg.shape == (1, eng.cfg.vocab_size) and torch.isfinite(lg).all()


def test_per_tensor_fp8_engine_matches_jax(tmp_path):
    """A ``bsize=0`` checkpoint (one scalar scale per stored tensor, even an
    expert stack: (E, 1, 1) after loading) runs the JAX non-kernel
    formulations in the port too: projections dequantized, decode experts
    gathered and dequantized, prefill over every expert. Hydrate within
    1e-3 of the logit scale and the JAX Engine's greedy tokens."""
    out = _convert(str(tmp_path), "pt", 256, 82, bsize=0, use_mla=True)
    jeng = JaxEngine(out, seed=0, decode_block=1, prefill_chunk=10)
    eng = Engine(out, device="cpu", seed=0, prefill_chunk=10)
    lp = eng.params.layers[1]
    assert eng.cfg.block_size == (0, 0) and lp.w13s is None and lp.w13 is None
    assert lp.w1.per_tensor and tuple(lp.w1.scale.shape) == (4, 1, 1)
    toks = np.random.default_rng(83).integers(3, 300, 26).tolist()
    _, jlast, _, _ = jeng.hydrate(jeng.new_cache(), toks)
    _, last, _, _ = eng.hydrate(eng.new_cache(), toks)
    np.testing.assert_allclose(last, jlast, rtol=0, atol=1e-3 * np.abs(jlast).max())
    want, _ = jeng.generate(toks[:12], num_steps=8, temperature=0.0)
    got, _ = eng.generate(toks[:12], num_steps=8, temperature=0.0)
    assert got == want
