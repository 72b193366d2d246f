"""Scan-stacked layers: the JAX Engine stacks runs of like layers into one
``lax.scan`` (``scan_layers=True``, or ``"auto"`` at 16 layers and more);
the port accepts the option and runs its layers one after another, which
computes the same function. On a converted 4-layer MoE checkpoint (a
dense layer and three MoE layers, which JAX stacks):

- ``Engine(scan_layers=True)`` and ``"auto"`` of the port give the JAX
  ``Engine(scan_layers=True)``'s prompt and decode logits (1e-3 of their
  scale) and greedy tokens;
- ``params_from_reference`` of the JAX Engine's stacked params unstacks
  them: every tensor of every layer equals its reading of the unstacked
  params, and the forward over it gives the same logits.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from deepseek_tpu import convert as jcv
from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.models.deepseek import forward_prefill
from deepseek_tpu_torch.models.kvcache import init_cache
from deepseek_tpu_torch.models.loader import params_from_reference
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir

PROMPT = [1, 9, 22, 40, 7]
N_NEW = 4


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scan"))
    cfg = hf_config(dim=256, hidden=256, q_lora=256, kv_lora=256, nope=128, rope=64,
                    v_dim=128, moe_inter=256, layers=4, vocab=300, n_experts=4,
                    n_active=2, arch="DeepseekV3ForCausalLM", topk_method="noaux_tc",
                    scoring="sigmoid")
    write_hf_dir(os.path.join(root, "hf"), cfg, hf_weights(cfg, seed=13, scale=0.1))
    out = os.path.join(root, "ck")
    jcv.convert(os.path.join(root, "hf"), out, quant="q3_k", use_mla=True)
    jeng = JaxEngine(out, seed=0, decode_block=1, scan_layers=True)
    kinds = [type(e).__name__ for e in jeng.params.layers]
    assert "StackedLayers" in kinds, kinds
    return dict(dir=out, jeng=jeng)


def _jax_logits(eng, toks):
    import jax.numpy as jnp
    cache = eng.new_cache()
    cache, logits, _, pos = eng.hydrate(cache, PROMPT, 0)
    out, step = [np.asarray(logits).reshape(-1)], eng.fwd(False, "last")
    for t in toks:
        lg, cache = step(eng.params, cache, jnp.asarray([[t]], jnp.int32), pos)
        out.append(np.asarray(lg).reshape(-1))
        pos += 1
    return np.stack(out)


def _port_logits(eng, toks):
    cache = eng.new_cache()
    with torch.inference_mode():
        cache, logits, _, pos = eng.hydrate(cache, PROMPT, 0)
        out = [np.asarray(logits, np.float32).reshape(-1)]
        for t in toks:
            out.append(eng.step(cache, t, pos).float().numpy().reshape(-1))
            pos += 1
    return np.stack(out)


@pytest.mark.parametrize("scan", [True, "auto"])
def test_scan_layers_engine_matches_jax(ckpt, scan):
    jeng = ckpt["jeng"]
    want_toks, _ = jeng.generate(PROMPT, num_steps=N_NEW, temperature=0.0)
    eng = Engine(ckpt["dir"], device="cpu", seed=0, decode_block=1, scan_layers=scan)
    got_toks, _ = eng.generate(PROMPT, num_steps=N_NEW, temperature=0.0)
    assert got_toks == want_toks
    want = _jax_logits(jeng, want_toks[:2])
    got = _port_logits(eng, want_toks[:2])
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale)


def _tensors(params):
    out = {}
    for i, lp in enumerate(params.layers):
        for f in dataclasses.fields(lp):
            v = getattr(lp, f.name)
            if isinstance(v, torch.Tensor):
                out[f"{i}.{f.name}"] = v
            elif v is not None:
                for g in dataclasses.fields(v):
                    t = getattr(v, g.name)
                    if isinstance(t, torch.Tensor):
                        out[f"{i}.{f.name}.{g.name}"] = t
    return out


def test_params_from_reference_unstacks(ckpt):
    jeng = ckpt["jeng"]
    flat = JaxEngine(ckpt["dir"], seed=0, decode_block=1, scan_layers=False)
    assert all(type(e).__name__ == "LayerParams" for e in flat.params.layers)
    stacked = params_from_reference(jeng.params)
    unstacked = params_from_reference(flat.params)
    assert len(stacked.layers) == len(unstacked.layers) == 4
    a, b = _tensors(stacked), _tensors(unstacked)
    assert a.keys() == b.keys() and len(a) > 20
    for k in a:
        assert torch.equal(a[k], b[k]), k
    cfg = Engine(ckpt["dir"], device="cpu", seed=0).cfg
    with torch.inference_mode():
        la = forward_prefill(stacked, init_cache(cfg), torch.tensor([PROMPT]), 0, cfg)
        lb = forward_prefill(unstacked, init_cache(cfg), torch.tensor([PROMPT]), 0, cfg)
    assert torch.equal(la, lb)
