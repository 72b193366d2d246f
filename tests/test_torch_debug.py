"""The port's activation capture (``deepseek_tpu_torch/utils/debug.py``
and the forward's hooks) against the JAX package's
(``deepseek_tpu/utils/debug.py``, ``make_forward(jit=False)``), on a
converted 2-layer MoE checkpoint (absorbed MLA with its factor weights,
so prefill takes the hybrid head-space branch and decode the absorbed
one):

- a prefill chunk and a decode step capture the same names in both
  packages (``embed``, ``l{i}.attn_norm``, ``l{i}.attn``,
  ``l{i}.ffn_norm``, ``l{i}.ffn``, ``logits``), each within 1e-4 of its
  scale of the JAX value;
- a capture file written by either package loads in the other, with
  ``max_err`` 0 against the capture it came from;
- with no capture active the hooks record nothing.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu import convert as jcv
from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu.models import init_cache as jax_init_cache
from deepseek_tpu.models import make_forward
from deepseek_tpu.utils import debug as jdebug
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.models.deepseek import forward_decode, forward_prefill
from deepseek_tpu_torch.models.kvcache import init_cache
from deepseek_tpu_torch.utils import debug
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir

PROMPT = [1, 9, 22, 40]
NAMES = {"embed", "logits"} | {f"l{i}.{k}" for i in range(2)
                               for k in ("attn_norm", "attn", "ffn_norm", "ffn")}


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("debug"))
    cfg = hf_config(dim=64, hidden=96, q_lora=32, kv_lora=32, nope=16, rope=8, v_dim=16,
                    moe_inter=32, layers=2, vocab=300, n_experts=4, n_active=2)
    write_hf_dir(os.path.join(root, "hf"), cfg, hf_weights(cfg, seed=11, scale=0.1))
    ck = os.path.join(root, "ck")
    jcv.convert(os.path.join(root, "hf"), ck, quant="fp32", use_mla=True)
    jeng = JaxEngine(ck, seed=0, decode_block=1)
    eng = Engine(ck, device="cpu", seed=0, decode_block=1)
    out = {}
    jcache = jax_init_cache(jeng.cfg, 1)
    pre = make_forward(jeng.cfg, prefill=True, logits_mode="last", jit=False)
    dec = make_forward(jeng.cfg, prefill=False, logits_mode="last", jit=False)
    with jdebug.debug_capture() as cap:
        _, jcache = pre(jeng.params, jcache, jnp.asarray([PROMPT], jnp.int32), 0)
    out["jax prefill"] = cap
    with jdebug.debug_capture() as cap:
        dec(jeng.params, jcache, jnp.asarray([[5]], jnp.int32), len(PROMPT))
    out["jax decode"] = cap
    cache = init_cache(eng.cfg, device="cpu")
    with torch.inference_mode():
        with debug.debug_capture() as cap:
            forward_prefill(eng.params, cache, torch.tensor([PROMPT]), 0, eng.cfg)
        out["port prefill"] = cap
        with debug.debug_capture() as cap:
            forward_decode(eng.params, cache, torch.tensor([[5]]), len(PROMPT), eng.cfg)
        out["port decode"] = cap
        assert not debug.capture_active()
        forward_decode(eng.params, cache, torch.tensor([[6]]), len(PROMPT) + 1, eng.cfg)
    out["root"] = root
    return out


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_capture_names_and_values_match_jax(captures, mode):
    j, t = captures[f"jax {mode}"], captures[f"port {mode}"]
    assert set(t.tensors) == set(j.tensors) == NAMES
    for name, want in j.tensors.items():
        got = t.tensors[name]
        assert got.shape == want.shape and got.dtype == np.float32, name
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale, name
    assert t.max_err(j).keys() == j.tensors.keys()


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_capture_files_load_across_packages(captures, mode, tmp_path):
    j, t = captures[f"jax {mode}"], captures[f"port {mode}"]
    jp, tp = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    j.save(jp)
    t.save(tp)
    t_in_jax = jdebug.DebugCapture.load(tp)
    j_in_port = debug.DebugCapture.load(jp)
    assert set(t_in_jax.max_err(t).values()) == {0.0}
    assert set(j_in_port.max_err(j).values()) == {0.0}
    # the cross-package diff is the same whichever package computes it
    assert t_in_jax.max_err(j_in_port) == t.max_err(j)


def test_repeated_names_take_suffixes():
    cap = debug.DebugCapture()
    cap.add("x", torch.ones(2))
    cap.add("x", np.zeros(2))
    assert list(cap.tensors) == ["x", "x#2"]
    assert cap.max_err(cap) == {"x": 0.0, "x#2": 0.0}
    other = debug.DebugCapture()
    other.add("x", np.ones(3))
    assert cap.max_err(other) == {"x": float("inf")}
    debug.dbg("x", torch.ones(1))          # no capture active: nothing kept
    assert not debug.capture_active()
