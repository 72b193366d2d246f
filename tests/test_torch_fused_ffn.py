"""The fused expert FFN path of the port (``DSEEK_FUSED_FFN=1``: row-permuted
nibble [w1;w3] tables, kernel K7 and the prepermuted bodies of K2 and K6)
against the JAX package.

- The row permutation (``loader._rowperm_qt``) bit for bit with the JAX
  one, its undo, and ``KNibbleTensor.dequant`` of a permuted table.
- The plain versions: K7 (``qmm_expert_ffn``) against the JAX kernel in
  interpret mode over Q2_K/Q3_K nibble and SILU/GELU; K2 with
  ``x_prepermuted`` against the JAX qmm_experts; the rp branch of the
  grouped MoE prefill against the JAX ``_quantized_grouped_ffn``.
- A converted Q3_K checkpoint at ``kquant_runtime="nibble"`` through the
  port's Engine on the CPU and the JAX Engine, both with the variable set:
  permuted tables carried across, greedy tokens, perplexity with small
  (pair path) and large (grouped) prefill chunks, K7's plain version in
  decode, and the variable read once, at load.

Nibble planes are drawn with numpy (bf16-exact scales) and handed to both
packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu import convert as cv
from deepseek_tpu.config import ActivationType as JaxAct
from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu.models.loader import _rowperm_qt as jax_rowperm_qt
from deepseek_tpu.ops import matmul as jmm
from deepseek_tpu.ops.pallas.qmm import _perm_x
from deepseek_tpu.ops.pallas.qmm import qmm_expert_ffn as jax_qmm_expert_ffn
from deepseek_tpu.ops.pallas.qmm import qmm_experts as jax_qmm_experts
from deepseek_tpu.parallel.spmd import NULL_CTX
from deepseek_tpu.quant.qtensor import KNibbleTensor as JaxNibble
from deepseek_tpu_torch.config import ActivationType
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.models import deepseek as port_model
from deepseek_tpu_torch.models.loader import (
    _rowperm_qt, params_from_reference, rowperm_expert_w13,
)
from deepseek_tpu_torch.ops import matmul as tmm
from deepseek_tpu_torch.ops.activations import glu_act
from deepseek_tpu_torch.ops.kernels.qmm import (
    expert_ffn_fusable, qmm_expert_ffn, qmm_experts, qmm_grouped,
)
from deepseek_tpu_torch.quant.qtensor import KNibbleTensor, perm_x, unperm_x
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir

ACTS = {"silu": (ActivationType.SILU, JaxAct.SILU),
        "gelu": (ActivationType.GELU, JaxAct.GELU)}


def _bf16_exact(x):
    return (np.asarray(x, np.float32).view(np.uint32) & 0xFFFF0000).view(np.float32)


def nibble_pair(shape, quant, seed):
    """The JAX and the port's nibble table (..., rows, cols) of the same
    random planes: bytes for p, bf16-exact scales a (and Q2_K's min terms
    c) in the ranges of models/testing.py::random_fused_params."""
    rng = np.random.default_rng(seed)
    *lead, rows, cols = shape
    p = rng.integers(0, 256, (*lead, rows, cols // 2), dtype=np.uint8)
    a = _bf16_exact(rng.uniform(0.001, 0.01, (*lead, rows, cols // 16)))
    c = (_bf16_exact(rng.uniform(0.0005, 0.005, (*lead, rows, cols // 16)))
         if quant == "q2_k" else None)
    off = 0 if quant == "q2_k" else 4
    jt = JaxNibble(p=jnp.asarray(p), a=jnp.asarray(a, jnp.bfloat16),
                   c=None if c is None else jnp.asarray(c, jnp.bfloat16), off=off)
    bf = lambda v: torch.from_numpy(v).to(torch.bfloat16)
    tt = KNibbleTensor(p=torch.from_numpy(p), a=bf(a),
                       c=None if c is None else bf(c), off=off)
    return jt, tt


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jbits(a):
    if isinstance(a, torch.Tensor):
        return _bits(a)
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _same_planes(tt, jt):
    assert tt.rowperm == jt.rowperm and tt.off == jt.off
    for f in ("p", "a", "c"):
        a, b = getattr(tt, f), getattr(jt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.is_contiguous(), f
            np.testing.assert_array_equal(_bits(a), _jbits(b), err_msg=f)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_rowperm_planes_match_jax_and_undo(quant):
    """p, a and c permuted bit for bit as the JAX _rowperm_qt does, rowperm
    2, and the undo giving back the natural planes with rowperm 0."""
    jt, tt = nibble_pair((3, 128, 512), quant, seed=1)
    jr, tr = jax_rowperm_qt(jt, 2, undo=False), _rowperm_qt(tt, 2, undo=False)
    _same_planes(tr, jr)
    assert not np.array_equal(tr.p.numpy(), tt.p.numpy())
    back = _rowperm_qt(tr, 2, undo=True)
    _same_planes(back, jax_rowperm_qt(jr, 2, undo=True))
    _same_planes(back, jt)
    assert tr.nbytes_active == tt.nbytes_active == jr.nbytes_active
    assert tr.map(lambda t: t[1:]).rowperm == 2


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_rowperm_dequant_matches_jax(quant):
    """dequant() of a permuted table equals the JAX one and restores the
    natural rows exactly; stored_rows() reads the rows as stored."""
    jt, tt = nibble_pair((2, 256, 256), quant, seed=2)
    jr, tr = jax_rowperm_qt(jt, 2, undo=False), _rowperm_qt(tt, 2, undo=False)
    want = np.asarray(jr.dequant(jnp.float32))
    np.testing.assert_array_equal(tr.dequant(torch.float32).numpy(), want)
    np.testing.assert_array_equal(want, np.asarray(jt.dequant(jnp.float32)))
    stored = tr.stored_rows().dequant(torch.float32)
    np.testing.assert_array_equal(unperm_x(stored.transpose(-1, -2)[..., :128])
                                  .transpose(-1, -2).numpy(), want[:, :128])


def test_perm_x_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 3, 512)).astype(np.float32)
    got = perm_x(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(_perm_x(jnp.asarray(x), 512)))
    np.testing.assert_array_equal(unperm_x(got).numpy(), x)


# ---------------------------------------------------------------------------
# the plain versions of K7 and of K2's and K6's prepermuted bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_k7_plain_matches_pallas_interpret(quant, act, monkeypatch):
    """qmm_expert_ffn's plain version against the JAX qmm_expert_ffn in
    interpret mode (shapes of tests/test_fused_expert_ffn.py: a repeated
    expert, a zero-weight pair, w13 wider than one tile). Tolerance 2e-4,
    as the JAX test's: f32 products of the same planes in other orders."""
    monkeypatch.setenv("DSEEK_FUSED_FFN", "1")
    E, mh, n, d = 3, 1024, 256, 512
    j13, t13 = nibble_pair((E, 2 * mh, n), quant, seed=11)
    j2, t2 = nibble_pair((E, d, mh), quant, seed=12)
    j13, t13 = jax_rowperm_qt(j13, 2, undo=False), _rowperm_qt(t13, 2, undo=False)
    assert expert_ffn_fusable(t13, t2)
    idx = np.array([2, 0, 2, 1], np.int32)
    wts = np.array([0.75, 1.0, 0.0, 0.25], np.float32)
    x = np.random.default_rng(3).standard_normal((1, n)).astype(np.float32)
    ta, ja = ACTS[act]
    want = np.asarray(jax_qmm_expert_ffn(j13, j2, jnp.asarray(idx), jnp.asarray(x),
                                         jnp.asarray(wts), ja, interpret=True))
    got = qmm_expert_ffn(t13, t2, torch.from_numpy(idx), torch.from_numpy(x),
                         torch.from_numpy(wts), ta)
    assert got.shape == (1, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # the same function as the three-step chain over the natural tables
    h2 = qmm_experts(_rowperm_qt(t13, 2, undo=True), torch.from_numpy(idx),
                     torch.from_numpy(x).expand(4, n))
    h = glu_act(h2[:, :mh], h2[:, mh:], ta) * torch.from_numpy(wts)[:, None]
    chain = qmm_experts(t2, torch.from_numpy(idx), h).sum(0, keepdim=True)
    np.testing.assert_allclose(got.numpy(), chain.numpy(), rtol=2e-4, atol=2e-4)


def test_expert_ffn_fusable():
    """Both nibble, w13 permuted in two halves, m2 == 2 mh, mh and n
    multiples of 256; no environment read."""
    _, t13 = nibble_pair((2, 512, 256), "q3_k", seed=4)
    _, t2 = nibble_pair((2, 256, 256), "q3_k", seed=5)
    rp = _rowperm_qt(t13, 2, undo=False)
    os.environ.pop("DSEEK_FUSED_FFN", None)
    assert expert_ffn_fusable(rp, t2)
    assert not expert_ffn_fusable(t13, t2)                  # natural rows
    assert not expert_ffn_fusable(None, t2)
    _, t2_odd = nibble_pair((2, 256, 512), "q3_k", seed=6)  # m2 != 2 mh
    assert not expert_ffn_fusable(rp, t2_odd)
    _, narrow = nibble_pair((2, 256, 256), "q3_k", seed=7)  # mh 128
    _, w2n = nibble_pair((2, 256, 128), "q3_k", seed=8)
    assert not expert_ffn_fusable(_rowperm_qt(narrow, 2, undo=False), w2n)


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_k2_prepermuted_plain_matches_pallas_interpret(quant):
    """qmm_experts(..., x_prepermuted=True) on activations in the stride-16
    order against the JAX qmm_experts with x_prepermuted in interpret
    mode; tolerance 1e-4 as K2's (tests/test_torch_qmm.py)."""
    E, d, n, B, k = 4, 64, 512, 2, 3
    jt, tt = nibble_pair((E, d, n), quant, seed=21)
    idx = np.array([[3, 0, 3], [1, 2, 0]], np.int32)
    x = np.random.default_rng(22).standard_normal((B, k, n)).astype(np.float32)
    xp = np.array(_perm_x(jnp.asarray(x), n))
    want = np.asarray(jax_qmm_experts(jt, jnp.asarray(idx), jnp.asarray(xp),
                                      interpret=True, x_prepermuted=True))
    got = qmm_experts(tt, torch.from_numpy(idx), torch.from_numpy(xp),
                      x_prepermuted=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    natural = qmm_experts(tt, torch.from_numpy(idx), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, natural, rtol=1e-4, atol=1e-4)


def test_prepermuted_chain_matches_natural_chain():
    """K2 over a permuted w13 leaves h permuted per half, and w2 over it
    with x_prepermuted gives the natural chain's result
    (tests/test_fused_expert_ffn.py's chain check, on the port)."""
    E, mh, n, d = 3, 256, 256, 256
    _, w13 = nibble_pair((E, 2 * mh, n), "q3_k", seed=5)
    _, w2 = nibble_pair((E, d, mh), "q3_k", seed=6)
    rp13 = _rowperm_qt(w13, 2, undo=False)
    idx = torch.tensor([1, 2, 0, 1])
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((4, n)).astype(np.float32))
    act = ActivationType.SILU
    h2 = qmm_experts(w13, idx, x)
    want = qmm_experts(w2, idx, glu_act(h2[:, :mh], h2[:, mh:], act))
    h2p = qmm_experts(rp13, idx, x)
    np.testing.assert_array_equal(unperm_x(h2p[:, :mh]).numpy(), h2[:, :mh].numpy())
    got = qmm_experts(w2, idx, glu_act(h2p[:, :mh], h2p[:, mh:], act),
                      x_prepermuted=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_prepermuted_needs_a_nibble_table():
    from deepseek_tpu_torch.quant.qtensor import PlainTensor
    plain = PlainTensor(data=torch.zeros((2, 8, 256)))
    with pytest.raises(ValueError, match="x_prepermuted"):
        qmm_experts(plain, torch.zeros(1, dtype=torch.int64), torch.zeros((1, 256)),
                    x_prepermuted=True)
    with pytest.raises(ValueError, match="x_prepermuted"):
        qmm_grouped(plain, torch.zeros(1, dtype=torch.int64), torch.zeros((1, 128, 256)),
                    x_prepermuted=True)


@pytest.mark.parametrize("quant", ["q2_k", "q3_k"])
def test_grouped_rp_branch_matches_jax(quant):
    """The MoE prefill FFN over a permuted w13 (h stays permuted, K6's
    prepermuted body on w2) against the JAX _quantized_grouped_ffn with
    qmm_grouped in interpret mode, and against the natural tables: 140
    pairs over 4 experts. Tolerance 1e-4 of the output scale, as the
    natural grouped test's."""
    E, m, dim, B, T, k = 4, 256, 256, 1, 70, 2
    j13, t13 = nibble_pair((E, 2 * m, dim), quant, seed=31)
    j2, t2 = nibble_pair((E, dim, m), quant, seed=32)
    rng = np.random.default_rng(33)
    xb = (rng.standard_normal((B, T, dim)) * 0.3).astype(np.float32)
    idx = rng.integers(0, E, (B, T, k)).astype(np.int32)
    wts = rng.uniform(size=(B, T, k)).astype(np.float32)
    want = np.asarray(jmm._quantized_grouped_ffn(
        None, j2, None, jnp.asarray(xb), jnp.asarray(wts), jnp.asarray(idx),
        JaxAct.SILU, NULL_CTX, True, w13=jax_rowperm_qt(j13, 2, undo=False))[0])
    args = (None, t2, None, torch.from_numpy(xb), torch.from_numpy(wts),
            torch.from_numpy(idx), ActivationType.SILU)
    got = tmm._quantized_grouped_ffn(*args, w13=_rowperm_qt(t13, 2, undo=False)).numpy()
    tol = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    natural = tmm._quantized_grouped_ffn(*args, w13=t13).numpy()
    np.testing.assert_allclose(got, natural, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# a converted Q3_K checkpoint through both Engines with the variable set
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A converted 2-layer absorbed-MLA MoE Q3_K checkpoint (widths of
    tests/test_fused_expert_ffn.py, 8 routed experts of which 3 a token,
    a 128-slot window so a 64-token chunk has 192 pairs), and the JAX
    Engine loaded from it at kquant_runtime="nibble" with
    DSEEK_FUSED_FFN=1: its greedy tokens and perplexity (the XLA path,
    which dequantizes the permuted tables)."""
    cfg = hf_config(dim=256, hidden=256, q_lora=256, kv_lora=256, nope=128,
                    rope=64, v_dim=128, moe_inter=256, layers=2, vocab=300,
                    n_experts=8, n_active=3)
    cfg["rope_scaling"]["original_max_position_embeddings"] = 128
    root = tmp_path_factory.mktemp("fused-ffn")
    hf_dir = os.path.join(str(root), "hf")
    write_hf_dir(hf_dir, cfg, hf_weights(cfg, seed=31, scale=0.1))
    out = os.path.join(str(root), "ck")
    cv.convert(hf_dir, out, quant="q3_k", use_mla=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DSEEK_FUSED_FFN", "1")
        jeng = JaxEngine(out, seed=0, prefill_chunk=8, decode_block=1,
                         kquant_runtime="nibble")
        prompt = jeng.tokenizer.encode("hello world", bos=True)
        toks, _ = jeng.generate(prompt, num_steps=6, temperature=0.0)
        ppl = jeng.perplexity(prompt + toks)[0]
    return dict(dir=out, jeng=jeng, prompt=prompt, tokens=toks, ppl=ppl)


def _counting_k7(monkeypatch):
    calls = []
    real = port_model.qmm_expert_ffn

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(port_model, "qmm_expert_ffn", counted)
    return calls


def _perplexity(eng, tokens):
    """Engine.perplexity of the JAX package: exp of the mean negative
    log-probability of tokens[1:] given their prefixes."""
    _, _, lp, _ = eng.hydrate(eng.new_cache(), tokens, want_last_logits=False,
                              target_tokens=list(tokens[1:]) + [0])
    return float(np.exp(-lp[:len(tokens) - 1].mean()))


def _expert_table(params):
    lp = params.layers[1]
    return lp.w13s if lp.w13s is not None else lp.w13


def test_params_from_reference_carries_the_permuted_layout(ckpt, monkeypatch):
    """The JAX Engine's fused, permuted params carried across equal the
    port's own load with the variable set, plane for plane, rowperm 2."""
    monkeypatch.setenv("DSEEK_FUSED_FFN", "1")
    eng = Engine(ckpt["dir"], device="cpu", seed=0, kquant_runtime="nibble")
    carried = params_from_reference(ckpt["jeng"].params)
    for got, own, ref in ((_expert_table(carried), _expert_table(eng.params),
                           _expert_table(ckpt["jeng"].params)),):
        assert got.rowperm == own.rowperm == ref.rowperm == 2
        _same_planes(got, ref)
        _same_planes(own, ref)
    assert carried.layers[1].w2.rowperm == 0
    assert carried.layers[1].shared_w13.rowperm == 0


@pytest.mark.parametrize("prefill_chunk", [8, 64])
def test_engine_matches_jax_engine(ckpt, prefill_chunk, monkeypatch):
    """Engine(kquant_runtime="nibble") on the CPU with DSEEK_FUSED_FFN=1:
    the tables permuted (rowperm 2), the JAX Engine's greedy tokens (the
    default 32-token decode block), K7's plain version in every decode
    step, and the JAX perplexity within rtol 2e-2 (the JAX test's) with
    8-token chunks (24 pairs: K2, then K2's prepermuted body) and 64-token
    chunks (192 pairs: K6, then K6's prepermuted body)."""
    monkeypatch.setenv("DSEEK_FUSED_FFN", "1")
    eng = Engine(ckpt["dir"], device="cpu", seed=0, kquant_runtime="nibble",
                 prefill_chunk=prefill_chunk)
    assert _expert_table(eng.params).rowperm == 2
    calls = _counting_k7(monkeypatch)
    out, _ = eng.generate(ckpt["prompt"], num_steps=6, temperature=0.0)
    assert out == ckpt["tokens"]
    assert len(calls) >= 5, "decode must take the fused expert FFN"
    prepermuted, grouped = [], []
    real_k2, real_grouped = port_model.qmm_experts, tmm._quantized_grouped_ffn
    monkeypatch.setattr(port_model, "qmm_experts", lambda qt, idx, x, x_prepermuted=False:
                        prepermuted.append(x_prepermuted) or real_k2(
                            qt, idx, x, x_prepermuted))
    monkeypatch.setattr(tmm, "_quantized_grouped_ffn", lambda *a, **kw:
                        grouped.append(kw["w13"].rowperm) or real_grouped(*a, **kw))
    np.testing.assert_allclose(_perplexity(eng, ckpt["prompt"] + out), ckpt["ppl"],
                               rtol=2e-2)
    if prefill_chunk == 8:
        assert True in prepermuted and not grouped
    else:
        assert grouped == [2] and not prepermuted


def test_variable_is_read_once_at_load(ckpt, monkeypatch):
    """Clearing the variable after an Engine loaded permuted tables keeps
    K7; setting it after a natural load gives no K7 and no permutation;
    both give the same greedy tokens."""
    monkeypatch.setenv("DSEEK_FUSED_FFN", "1")
    fused = Engine(ckpt["dir"], device="cpu", seed=0, kquant_runtime="nibble")
    monkeypatch.delenv("DSEEK_FUSED_FFN")
    natural = Engine(ckpt["dir"], device="cpu", seed=0, kquant_runtime="nibble")
    calls = _counting_k7(monkeypatch)
    out_f, _ = fused.generate(ckpt["prompt"], num_steps=6, temperature=0.0)
    n_fused = len(calls)
    monkeypatch.setenv("DSEEK_FUSED_FFN", "1")
    out_n, _ = natural.generate(ckpt["prompt"], num_steps=6, temperature=0.0)
    assert n_fused >= 5 and len(calls) == n_fused
    assert _expert_table(natural.params).rowperm == 0
    assert _expert_table(fused.params).rowperm == 2
    assert out_f == out_n == ckpt["tokens"]
    # rowperm_expert_w13 itself reads no variable: it permutes and undoes
    undone = rowperm_expert_w13(fused.params, fused.cfg, undo=True)
    _same_planes(_expert_table(undone), _expert_table(natural.params))
