"""The port's converter (``deepseek_tpu_torch/convert.py``, on the CPU)
against the JAX converter (``deepseek_tpu/convert.py``) on the fake HF
directories of ``tests/util_hf.py``.

Every case converts one HF directory with both and checks:
- the metadata dicts are equal;
- every tensor has the same name, dtype, shape and bytes, except
  ``attn.wc`` and its scale (the absorption product sums in another order
  than ``np.einsum``);
- ``attn.wc`` dequantized is within the stated tolerance of the JAX one;
- the port's CPU Engine on its checkpoint matches the JAX Engine on the
  JAX checkpoint: prompt and decode-step logits within 1e-3 of the logits'
  scale (the decode steps run the absorbed ``wc``).

The cases cover every ``--quant``, ``--mla`` on and off, V2 and V3
architectures, ``--bsize`` 128, 16 and 0, an HF-FP8 input (``F8_E4M3``
linear weights with ``weight_scale_inv`` grids, BF16 elsewhere), a
multi-file input, the ``--n-layers`` cap, the MTP layer, the chat
template and ``--ref-compat-topk``. One conversion runs in a fresh
interpreter with ``ml_dtypes`` hidden, as on the card's machine.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepseek_tpu import convert as jcv
from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu.quant import kquant as jk
from deepseek_tpu.utils import codec as jcodec
from deepseek_tpu_torch import convert as tcv
from deepseek_tpu_torch.engine import Engine
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(dim=64, hidden=96, q_lora=32, kv_lora=32, nope=16, rope=8, v_dim=16,
             moe_inter=32, layers=2, heads=2, vocab=300, n_experts=4, n_active=2)
WIDE = dict(dim=256, hidden=256, q_lora=256, kv_lora=256, nope=128, rope=64, v_dim=128,
            moe_inter=256, layers=2, heads=2, vocab=300, n_experts=4, n_active=2)
V3 = dict(arch="DeepseekV3ForCausalLM", topk_method="noaux_tc", scoring="sigmoid")
TEMPLATE = "{% for m in messages %}<|{{ m.role }}|>{{ m.content }}{% endfor %}"

# id: (hf_config kwargs, write_hf_dir extras, HF-FP8 input block or None,
#      convert kwargs)
CASES = {
    "fp16-mha-v2": (SMALL, {}, None, {}),
    "fp32-mla-v2": (SMALL, {}, None, dict(quant="fp32", use_mla=True)),
    "f8-128-mla-v3": (dict(WIDE, **V3), {}, None, dict(quant="f8e5m2", use_mla=True)),
    "f8-16-mha-multifile": (SMALL, dict(n_files=3), None, dict(quant="f8e5m2", bsize=16)),
    "f8-pertensor-mla": (SMALL, {}, None, dict(quant="f8e5m2", bsize=0, use_mla=True)),
    "q2k-mla-v2": (WIDE, {}, None, dict(quant="q2_k", use_mla=True)),
    "q3k-mha-v3-mtp-chat": (dict(WIDE, **V3), dict(mtp=True, chat=True), None,
                            dict(quant="q3_k")),
    "hffp8-q3k-mla-v3": (dict(WIDE, **V3), dict(mtp=True), (128, 128),
                         dict(quant="q3_k", use_mla=True)),
    "hffp8-f8-mla-v3": (dict(WIDE, **V3), {}, (64, 64),
                        dict(quant="f8e5m2", bsize=128, use_mla=True)),
    "nlayers-refcompat-v3": (dict(SMALL, layers=3, **V3), {}, None,
                             dict(quant="fp16", n_layers=2, ref_compat_topk=True)),
}


def _hf_fp8(wd, block):
    """HF DeepSeek-V3's stored form: the projection weights as F8_E4M3
    with a float32 ``weight_scale_inv`` grid (scale = block amax / 448),
    every other tensor BF16."""
    out, (b0, b1) = {}, block
    for name, w in wd.items():
        if name.endswith("_proj.weight") and w.ndim == 2:
            d, n = w.shape
            g0, g1 = -(-d // b0), -(-n // b1)
            wp = np.zeros((g0 * b0, g1 * b1), np.float32)
            wp[:d, :n] = w
            amax = np.abs(wp.reshape(g0, b0, g1, b1)).max(axis=(1, 3))
            s = np.maximum(amax, 1e-12).astype(np.float32) / np.float32(448.0)
            full = np.repeat(np.repeat(s, b0, 0), b1, 1)[:d, :n]
            out[name] = (w / full).astype(ml_dtypes.float8_e4m3fn)
            out[name.replace(".weight", ".weight_scale_inv")] = s
        else:
            out[name] = w.astype(ml_dtypes.bfloat16)
    return out


def _hf_dir(path, case):
    kw, extra, fp8_block, _ = CASES[case]
    cfg = hf_config(**kw)
    wd = hf_weights(cfg, seed=len(case), scale=0.1, mtp=extra.get("mtp", False))
    if fp8_block:
        cfg["quantization_config"] = {"quant_method": "fp8",
                                      "weight_block_size": list(fp8_block)}
        wd = _hf_fp8(wd, fp8_block)
    tok_cfg = {"chat_template": TEMPLATE, "bos_token": "<s>",
               "eos_token": {"content": "</s>"}} if extra.get("chat") else None
    write_hf_dir(path, cfg, wd, n_files=extra.get("n_files", 1), tokenizer_config=tok_cfg)
    return cfg


@pytest.fixture(scope="module", params=list(CASES))
def converted(request, tmp_path_factory):
    case = request.param
    root = str(tmp_path_factory.mktemp(f"conv-{case}"))
    hf = os.path.join(root, "hf")
    cfg = _hf_dir(hf, case)
    kw = CASES[case][3]
    jdir, tdir = os.path.join(root, "jax"), os.path.join(root, "port")
    jcv.convert(hf, jdir, **kw)
    tcv.convert(hf, tdir, device="cpu", **kw)
    return dict(case=case, hf=hf, cfg=cfg, kw=kw, jax=jdir, port=tdir, root=root)


def _wc_names(data):
    return {n for n in data.tensors if ".attn.wc." in n}


def _raw(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _same_checkpoint(jdir, tdir):
    """Metadata equal, every tensor but attn.wc byte for byte; returns the
    two codec readings."""
    j, t = jcodec.load_checkpoint(jdir), jcodec.load_checkpoint(tdir)
    assert t.metadata == j.metadata
    assert set(t.tensors) == set(j.tensors)
    assert [os.path.basename(f) for f in t.files] == [os.path.basename(f) for f in j.files]
    for name in sorted(set(j.tensors) - _wc_names(j)):
        a, b = j.tensors[name], t.tensors[name]
        assert (b.dtype_str, b.shape) == (a.dtype_str, a.shape), name
        np.testing.assert_array_equal(_raw(b.array), _raw(a.array), err_msg=name)
    return j, t


def _dequant_wc(data, name, md):
    """attn.wc as f32 from any stored form."""
    w = np.asarray(data[name + ".weight"])
    q = md["quant"]
    if q in ("fp32", "fp16"):
        return w.astype(np.float32)
    if q == "f8e5m2":
        s = np.asarray(data[name + ".scale"], np.float32)
        if "quantization_block_size_0" not in md:
            return w.astype(np.float32) * s
        b = int(md["quantization_block_size_0"])
        d, n = w.shape
        return w.astype(np.float32) * np.repeat(np.repeat(s, b, 0), b, 1)[:d, :n]
    rows = w.shape[0]
    cols = w.shape[1] // (jk.Q2K_BLOCK_BYTES if q == "q2_k" else jk.Q3K_BLOCK_BYTES) * 256
    fn = jk.dequantize_q2_k if q == "q2_k" else jk.dequantize_q3_k
    return fn(w, rows, cols)


def test_checkpoint_equals_jax(converted):
    """Metadata, tensor names and every tensor's bytes but attn.wc, and
    attn.wc within the tolerance below."""
    j, t = _same_checkpoint(converted["jax"], converted["port"])
    md = j.metadata
    kw = converted["kw"]
    assert md["quant"] == kw.get("quant", "fp16")
    if kw.get("use_mla"):
        assert _wc_names(j)
        _check_wc(converted, j, t)
    if converted["case"] == "q3k-mha-v3-mtp-chat":
        assert md["chat_template"] == TEMPLATE and md["chat_eos_token"] == "</s>"
        assert "model.mtp.block.mlp.w1.weight" in t.tensors
        assert len(t.files) == 1
    if converted["case"] == "nlayers-refcompat-v3":
        assert md["n_layers"] == "2" and md["topk_method"] == "group_limited_greedy"
        assert "model.layers.2.attn.norm.weight" not in t.tensors


# tolerance of the port's dequantized attn.wc against the JAX one, as a
# fraction of max|wc|: the f32 products differ in their last bits, the
# stored forms by at most one step of their rounding where a product
# sits at a tie: an f16 ulp, an e5m2 step (2 mantissa bits: a quarter of
# the value); a K-quant sub-block may choose another scale, so those are
# held by their error against the exact product instead (below)
WC_TOL = {"fp32": 1e-6, "fp16": 2.0 ** -10, "f8e5m2": 0.25}


def _exact_wc(converted, name, md):
    """attn.wc of one layer from the HF weights in f64 (np.einsum)."""
    hf = converted["hf"]
    weights, _ = jcv._read_safetensors(sorted(
        os.path.join(hf, f) for f in os.listdir(hf) if f.endswith(".safetensors")))
    qc = converted["cfg"].get("quantization_config")
    cv = jcv.Converter(weights, md, "fp32", None,
                       tuple(qc["weight_block_size"]) if qc else None)
    layer = name.split(".attn")[0].replace(
        "model.mtp.block", f"model.layers.{converted['cfg']['num_hidden_layers']}")
    H, nope = int(md["n_heads"]), int(md["qk_nope_head_dim"])
    kv_b = cv.fetch(f"{layer}.self_attn.kv_b_proj.weight").reshape(
        H, -1, int(md["kv_lora_rank"]))
    q_b = cv.fetch(f"{layer}.self_attn.q_b_proj.weight").reshape(
        H, -1, int(md["q_lora_rank"]))
    return np.einsum("hnr,hnq->hrq", kv_b[:, :nope].astype(np.float64),
                     q_b[:, :nope].astype(np.float64))


def _check_wc(converted, j, t):
    """Each absorbed attn.wc of the port's checkpoint against the JAX one."""
    names = sorted({n.rsplit(".", 1)[0] for n in _wc_names(j)})
    md = j.metadata
    for name in names:
        a, b = _dequant_wc(j, name, md), _dequant_wc(t, name, md)
        scale = float(np.abs(a).max())
        if md["quant"] in WC_TOL:
            assert np.abs(a - b).max() <= WC_TOL[md["quant"]] * scale, name
            continue
        # K-quants: the exact absorption product from the HF weights, and
        # each side's error against it
        exact = _exact_wc(converted, name, md).reshape(a.shape)
        err_j = np.sqrt(((a - exact) ** 2).mean())
        err_t = np.sqrt(((b - exact) ** 2).mean())
        assert err_t <= 1.02 * err_j + 1e-7 * scale, (name, err_t, err_j)
        raw_j, raw_t = _raw(j[name + ".weight"]), _raw(t[name + ".weight"])
        assert (raw_j == raw_t).mean() > 0.9, name


def _jax_logits(ckpt, prompt, steps=3, toks=None):
    """The JAX Engine's prompt logits and ``steps`` decode steps fed its own
    argmax, or fed ``toks``; returns (logits, the tokens fed)."""
    eng = JaxEngine(ckpt, seed=0, prefill_chunk=4, decode_block=1)
    cache = eng.new_cache()
    cache, logits, _, pos = eng.hydrate(cache, prompt, 0)
    outs, fed = [np.asarray(logits).reshape(-1)], []
    step = eng.fwd(False, "last")
    for i in range(steps if toks is None else len(toks)):
        fed.append(int(np.argmax(outs[-1])) if toks is None else toks[i])
        out, cache = step(eng.params, cache, jnp.asarray([[fed[-1]]], jnp.int32), pos)
        outs.append(np.asarray(out[0]).reshape(-1))
        pos += 1
    return np.stack(outs), fed


def _port_logits(ckpt, prompt, toks):
    eng = Engine(ckpt, device="cpu", seed=0, prefill_chunk=4, decode_block=1)
    cache = eng.new_cache()
    with torch.inference_mode():
        cache, logits, _, pos = eng.hydrate(cache, prompt, 0)
        outs = [np.asarray(logits, np.float32).reshape(-1)]
        for t in toks:
            outs.append(eng.step(cache, t, pos).float().numpy().reshape(-1))
            pos += 1
    return np.stack(outs)


def test_engine_logits_match_jax(converted):
    """The port's CPU Engine on its own checkpoint against the JAX Engine on
    the same checkpoint (which is the JAX converter's but for attn.wc, and
    loads in both packages): a 6-token prompt's prefill and 3 decode steps
    fed the JAX argmax, logits within 1e-3 of their scale. Where attn.wc
    is stored in a float form, the JAX Engine on the JAX checkpoint is held
    to the same tolerance; a K-quant wc is not (a sub-block whose f32
    product sits at a rounding tie may take another 2- or 3-bit grid, and
    the tiny model's logits move by more than 1e-3: the wc test above
    bounds that difference)."""
    prompt = [1, 9, 22, 40, 7, 3]
    want, toks = _jax_logits(converted["port"], prompt)
    got = _port_logits(converted["port"], prompt, toks)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale)
    kquant_wc = converted["kw"].get("use_mla") and \
        converted["kw"].get("quant") in ("q2_k", "q3_k")
    if not kquant_wc:
        own, _ = _jax_logits(converted["jax"], prompt, toks=toks)
        np.testing.assert_allclose(got, own, rtol=0, atol=1e-3 * scale)


_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None          # import ml_dtypes now raises
from deepseek_tpu_torch import convert
from deepseek_tpu_torch.utils import codec
assert codec._DTYPE_TO_NP["F8_E4M3"].names == ("f8_e4m3",)
hf, out = sys.argv[1:3]
convert.convert(hf, out, quant="q3_k", use_mla=True, device="cpu")
print("ok")
"""


def test_convert_without_ml_dtypes(tmp_path):
    """In an interpreter where ``import ml_dtypes`` fails (as on the card's
    machine) the port reads an HF-FP8 input (F8_E4M3 and BF16) as raw bytes
    and writes the JAX converter's checkpoint (but attn.wc)."""
    hf = str(tmp_path / "hf")
    _hf_dir(hf, "hffp8-q3k-mla-v3")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcv.convert(hf, jdir, quant="q3_k", use_mla=True)
    res = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, hf, tdir], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    _same_checkpoint(jdir, tdir)


def test_module_entry_point_and_errors(tmp_path):
    """``python -m deepseek_tpu_torch.convert`` takes the JAX CLI's flags
    plus ``--device``; the card is the default device (no card here: it
    raises), and a K-quant at widths no multiple of 256 raises as the JAX
    converter does."""
    hf = str(tmp_path / "hf")
    _hf_dir(hf, "fp16-mha-v2")
    out = str(tmp_path / "cli")
    res = subprocess.run([sys.executable, "-m", "deepseek_tpu_torch.convert", out, hf,
                          "--quant", "f8e5m2", "--bsize", "16", "--n-layers", "1",
                          "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "K-quant encoder: native" in res.stdout
    jdir = str(tmp_path / "jax")
    jcv.convert(hf, jdir, quant="f8e5m2", bsize=16, n_layers=1)
    _same_checkpoint(jdir, out)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tcv.convert(hf, str(tmp_path / "x"))
    with pytest.raises(ValueError, match="no K-quant form"):
        tcv.convert(hf, str(tmp_path / "q"), quant="q2_k", device="cpu")
    with pytest.raises(AssertionError):
        jcv.convert(hf, str(tmp_path / "jq"), quant="q2_k")


def test_k_quant_row_slices(tmp_path, monkeypatch):
    """The converter encodes a K-quant weight K_QUANT_ROWS rows at a time
    and copies each HF tensor FETCH_BYTES at a time (bounding the host's
    copies); slices of 5 rows and 3000 bytes give the JAX converter's
    checkpoint as whole tensors do."""
    hf = str(tmp_path / "hf")
    _hf_dir(hf, "q2k-mla-v2")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcv.convert(hf, jdir, quant="q2_k", use_mla=True)
    monkeypatch.setattr(tcv, "K_QUANT_ROWS", 5)
    monkeypatch.setattr(tcv, "FETCH_BYTES", 3000)   # HF tensors fetched in row slices too
    tcv.convert(hf, tdir, quant="q2_k", use_mla=True, device="cpu")
    _same_checkpoint(jdir, tdir)
