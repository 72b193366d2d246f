"""The port's decode against the JAX package on tiny K-quant checkpoints.

Q2_K and Q3_K MLA+MoE checkpoints are made by ``deepseek_tpu.convert``
from a fake HF directory (the ``test_nibble_runtime_matches_packed_engine``
recipe) and decoded past a shrunk window, so the ring wraps and the sinks
re-rotate. The oracle is JAX decode mode (``make_forward(prefill=False)``)
on the CPU, i.e. the f32 dequant path, and the JAX Engine for hydrate and
generate, which prefill the prompt; the port runs its plain versions on
the CPU. Weights reach the port two ways, ``params_from_reference`` and the
port's own loader, and both must agree.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu import convert as cv
from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu.models import init_cache, make_forward
from deepseek_tpu_torch.config import ModelConfig
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.models.deepseek import forward_decode
from deepseek_tpu_torch.models.kvcache import init_cache as torch_cache
from deepseek_tpu_torch.models.loader import params_from_reference
from deepseek_tpu_torch.quant.qtensor import KNibbleTensor
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir

CONTEXT = 12          # kv_window = min(12, 24): the ring wraps at step 12
N_NEW = 10            # greedy tokens after a 6-token prompt: 16 positions

# V2 greedy softmax routing for Q2_K, V3 noaux_tc sigmoid routing (with the
# e-score bias and interleaved rope) for Q3_K
_ARCH = {
    "q2_k": dict(arch="DeepseekV2ForCausalLM", topk_method="greedy",
                 scoring="softmax"),
    "q3_k": dict(arch="DeepseekV3ForCausalLM", topk_method="noaux_tc",
                 scoring="sigmoid"),
}


@pytest.fixture(scope="module", params=["q2_k", "q3_k"])
def ckpt(request, tmp_path_factory):
    quant = request.param
    cfg = hf_config(dim=256, hidden=256, q_lora=256, kv_lora=256, nope=128,
                    rope=64, v_dim=128, moe_inter=256, layers=2, vocab=300,
                    n_experts=4, n_active=2, **_ARCH[quant])
    root = tmp_path_factory.mktemp(quant)
    hf_dir = os.path.join(str(root), "hf")
    write_hf_dir(hf_dir, cfg, hf_weights(cfg, seed=23, scale=0.1))
    out = os.path.join(str(root), "ck")
    cv.convert(hf_dir, out, quant=quant, use_mla=True)
    jeng = JaxEngine(out, seed=0, context=CONTEXT, decode_block=1,
                     kquant_runtime="nibble")
    prompt = jeng.tokenizer.encode("hello world", bos=True)[:6]
    prompt += [7] * (6 - len(prompt))

    # the JAX oracle: greedy decode, one token per decode-mode step
    fwd = make_forward(jeng.cfg, prefill=False)
    cache = init_cache(jeng.cfg)
    toks, logits = list(prompt), []
    for pos in range(len(prompt) + N_NEW - 1):
        lg, cache = fwd(jeng.params, cache, jnp.asarray([[toks[pos]]], jnp.int32), pos)
        logits.append(np.asarray(lg[0]))
        if pos >= len(prompt) - 1:
            toks.append(int(np.argmax(logits[-1])))
    return dict(dir=out, jeng=jeng, prompt=prompt, tokens=toks,
                logits=np.stack(logits), quant=quant)


def _teacher_forced(params, cfg, tokens, n):
    cache = torch_cache(cfg)
    out = []
    with torch.inference_mode():
        for pos in range(n):
            tok = torch.tensor([[tokens[pos]]])
            out.append(forward_decode(params, cache, tok, pos, cfg)[0].numpy())
    return np.stack(out)


def test_window_wraps(ckpt):
    cfg = ckpt["jeng"].cfg
    assert cfg.kv_window == CONTEXT
    assert len(ckpt["tokens"]) - 1 > cfg.kv_window + 2   # sinks re-rotate


def test_decode_logits_match_jax(ckpt):
    """Per-step logits through params_from_reference. Tolerance: both sides
    compute the same f32 dequant arithmetic, but sums run in other orders,
    and a 1e-7 difference can round a latent to the neighbouring f16 cache
    value (2^-11 relative); 1e-3 of the logit scale bounds that."""
    jeng = ckpt["jeng"]
    cfg = ModelConfig.from_metadata(jeng.data.metadata, context=CONTEXT)
    params = params_from_reference(jeng.params, "cpu")
    got = _teacher_forced(params, cfg, ckpt["tokens"], len(ckpt["logits"]))
    want = ckpt["logits"]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale)


def test_port_loader_matches_reference_params(ckpt):
    """The port's own loader builds the same planes as the JAX loader and
    the same logits as params_from_reference."""
    eng = Engine(ckpt["dir"], context=CONTEXT, device="cpu", kquant_runtime="nibble")
    ref = params_from_reference(ckpt["jeng"].params, "cpu")
    for name in ("wkvq", "wcr", "wo", "wv_b", "w13", "w2", "shared_w13"):
        a, b = getattr(eng.params.layers[1], name), getattr(ref.layers[1], name)
        assert isinstance(a, KNibbleTensor) and a.off == b.off
        # the CUDA kernels take row-major planes only
        assert a.p.is_contiguous() and a.a.is_contiguous()
        assert torch.equal(a.p, b.p) and torch.equal(a.a, b.a)
        assert (a.c is None) == (ckpt["quant"] == "q3_k")
        if a.c is not None:
            assert torch.equal(a.c, b.c)
    n = len(ckpt["logits"])
    got = _teacher_forced(eng.params, eng.cfg, ckpt["tokens"], n)
    want = _teacher_forced(ref, eng.cfg, ckpt["tokens"], n)
    np.testing.assert_array_equal(got, want)


def test_greedy_tokens_identical(ckpt):
    """The port's generate against the JAX Engine.generate: both hydrate
    the prompt by prefill (the decompressed hybrid-MLA branch, since the
    converted checkpoint keeps wq_b/wkv_b), then decode past the window."""
    eng = Engine(ckpt["dir"], context=CONTEXT, device="cpu", seed=0,
                 kquant_runtime="nibble")
    out, stats = eng.generate(ckpt["prompt"], num_steps=N_NEW, temperature=0.0)
    want, _ = ckpt["jeng"].generate(ckpt["prompt"], num_steps=N_NEW, temperature=0.0)
    assert out == want
    assert stats.generated_tokens == N_NEW and stats.active_bytes_per_token > 0


def test_engine_rejects_unported_options(ckpt):
    # scan_layers is accepted (the layers run one after another either way);
    # a value the JAX Engine does not take raises
    with pytest.raises(ValueError, match="scan_layers"):
        Engine(ckpt["dir"], device="cpu", scan_layers="always")
    # the int8 cache is ported: its greedy tokens are the JAX int8 Engine's
    eng8 = Engine(ckpt["dir"], context=CONTEXT, device="cpu", seed=0,
                  kv_cache_dtype="int8", kquant_runtime="nibble")
    assert eng8.new_cache().quantized
    jeng8 = JaxEngine(ckpt["dir"], seed=0, context=CONTEXT, decode_block=1,
                      kv_cache_dtype="int8", kquant_runtime="nibble")
    assert eng8.generate(ckpt["prompt"], num_steps=N_NEW, temperature=0.0)[0] == \
        jeng8.generate(ckpt["prompt"], num_steps=N_NEW, temperature=0.0)[0]
    if not torch.cuda.is_available():      # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            Engine(ckpt["dir"])


def test_hydrate_collects_logprobs(ckpt):
    """hydrate's per-position log-softmax rows and target log-probs agree
    with the JAX Engine.hydrate (one prefill chunk of 8 padded to the
    12-slot window, then decode steps past it; tolerance 2e-3 of the logit
    scale: the logits differ by up to 1e-3 of it, see
    test_decode_logits_match_jax, and a log-softmax row by at most twice
    that) and with each other (1e-5: the same port logits, gathered two
    ways)."""
    eng = Engine(ckpt["dir"], context=CONTEXT, device="cpu", kquant_runtime="nibble")
    jeng = ckpt["jeng"]
    toks = ckpt["tokens"][:14]
    _, last, rows, end = eng.hydrate(eng.new_cache(), toks, collect_all_logits=True)
    _, jlast, jrows, jend = jeng.hydrate(jeng.new_cache(), toks,
                                         collect_all_logits=True)
    scale = np.abs(ckpt["logits"]).max()
    assert end == jend == 14 and rows.shape == jrows.shape
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=2e-3 * scale)
    np.testing.assert_allclose(last, jlast, rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(rows[-1], torch.log_softmax(
        torch.from_numpy(last), -1).numpy(), rtol=0, atol=1e-6)
    _, _, lp, _ = eng.hydrate(eng.new_cache(), toks[:-1], target_tokens=toks[1:])
    np.testing.assert_allclose(lp, rows[np.arange(13), toks[1:]], rtol=0, atol=1e-5)


def test_plain_weight_checkpoint_matches_jax(tmp_path):
    """An F16 checkpoint: plain weights, so fuse_projections folds the
    shared expert into the routed tables (w13s/w2s) like the JAX loader.
    Tolerance as test_decode_logits_match_jax."""
    cfg = hf_config(dim=64, hidden=96, q_lora=32, kv_lora=32, nope=16, rope=8,
                    v_dim=16, moe_inter=24, layers=2, vocab=300, n_experts=4,
                    n_active=2, **_ARCH["q3_k"])
    hf_dir = os.path.join(str(tmp_path), "hf")
    write_hf_dir(hf_dir, cfg, hf_weights(cfg, seed=5, scale=0.1))
    out = os.path.join(str(tmp_path), "f16")
    cv.convert(hf_dir, out, quant="fp16", use_mla=True)
    jeng = JaxEngine(out, seed=0, context=CONTEXT, decode_block=1)
    eng = Engine(out, context=CONTEXT, device="cpu")
    assert eng.params.layers[1].w13s is not None
    assert jeng.params.layers[1].w13s is not None
    fwd = make_forward(jeng.cfg, prefill=False)
    cache = init_cache(jeng.cfg)
    toks = [1, 5, 9, 300 - 1, 42, 7, 7, 3, 100, 200, 11, 12, 13, 14, 15]
    want = []
    for pos, t in enumerate(toks):
        lg, cache = fwd(jeng.params, cache, jnp.asarray([[t]], jnp.int32), pos)
        want.append(np.asarray(lg[0]))
    want = np.stack(want)
    got = _teacher_forced(eng.params, eng.cfg, toks, len(toks))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
