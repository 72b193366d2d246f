"""The port's decode block (on-device sampling, ``decode_block=32``)
against the JAX package.

- ``ops/prng.py``: keys, splits, random bits and uniform floats bit for bit
  with ``jax.random``; the gumbel noise within 2e-6 (XLA's and torch's
  ``log`` differ by an ulp).
- ``ops/sampling.py``: ``sample_token`` picks the JAX tokens from the same
  float32 logits and key, greedy, nucleus, top-k, min-p and per-row
  parameters, boundary ties included; ``nucleus_dist`` within 1e-6.
- ``make_decode_loop`` against the JAX one on a converted checkpoint
  (tokens, ``logits_last``), and no step of it synchronizes with the host;
  the serving block (per-row positions and host sampling arrays, a live-
  row mask, ``with_logprobs``, ``with_hidden``) likewise.
- ``Engine`` at its default arguments against the JAX ``Engine`` at its
  own on a converted packed Q3_K checkpoint: the same tokens at
  temperature 0 and 0.8 across a block boundary and the 24-slot window's
  edge.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepseek_tpu import convert as cv
from deepseek_tpu.engine import Engine as JaxEngine
from deepseek_tpu.models import init_cache
from deepseek_tpu.models.deepseek import make_decode_loop as jax_decode_loop
from deepseek_tpu.ops import sampling as jax_sampling
from deepseek_tpu_torch.engine import Engine
from deepseek_tpu_torch.models import deepseek as port_model
from deepseek_tpu_torch.models.deepseek import make_decode_loop
from deepseek_tpu_torch.models.kvcache import init_cache as torch_cache
from deepseek_tpu_torch.ops import prng
from deepseek_tpu_torch.ops.sampling import nucleus_dist, sample_token
from deepseek_tpu_torch.parallel.mesh import Mesh
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.util_hf import hf_config, hf_weights, write_hf_dir

SEED = 7
N_NEW = 40          # 6-token prompt + 40: a block ends at 32, the window at 24


# ---------------------------------------------------------------------------
# threefry keys and noise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**32 - 1])
def test_prng_matches_jax_random(seed):
    """PRNGKey, a chain of splits, 32-bit random bits and uniform floats on
    [tiny, 1) equal jax.random's bit for bit; gumbel within 2e-6 absolute
    (the two logs differ by an ulp, and -log(-log(u)) carries it)."""
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jk), pk)
    for _ in range(6):
        jk, js = jax.random.split(jk)
        pk, ps = prng.split(pk)
        np.testing.assert_array_equal(np.asarray(jk), pk)
        np.testing.assert_array_equal(np.asarray(js), ps)
    tiny = np.finfo(np.float32).tiny
    for shape in [(3,), (2, 5), (4, 1000)]:
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(js, shape)).astype(np.int64),
            prng.random_bits(ps, shape).numpy())
        ju = np.asarray(jax.random.uniform(js, shape, jnp.float32, tiny, 1.0))
        pu = prng.uniform(ps, shape).numpy()
        np.testing.assert_array_equal(ju.view(np.uint32), pu.view(np.uint32))
        np.testing.assert_allclose(prng.gumbel(ps, shape).numpy(),
                                   np.asarray(jax.random.gumbel(js, shape)),
                                   rtol=0, atol=2e-6)


def test_prng_key_stack_draws_each_key():
    """A stack of keys draws what each key draws alone (the decode block
    makes its steps' noise in one call)."""
    keys = np.stack([prng.split(prng.PRNGKey(s))[1] for s in (3, 4, 5)])
    both = prng.gumbel(keys, (2, 7))
    for i, k in enumerate(keys):
        assert torch.equal(both[i], prng.gumbel(k, (2, 7)))


# ---------------------------------------------------------------------------
# sample_token / nucleus_dist
# ---------------------------------------------------------------------------

_ROWS = dict(temperature=[0.0, 0.5, 1.0, 1.5], top_p=[0.9, 1.0, 0.5, 0.95],
             top_k=[0.0, 3.0, 10.0, 0.0], min_p=[0.0, 0.0, 0.05, 0.2])
_CASES = {
    "greedy": dict(temperature=0.0, top_p=0.95),
    "nucleus": dict(temperature=0.8, top_p=0.95),
    "full": dict(temperature=1.0, top_p=1.0),
    "top_k": dict(temperature=0.7, top_p=0.9, top_k=5),
    "min_p": dict(temperature=1.2, top_p=0.95, min_p=0.1),
    "per_row": {k: np.asarray(v, np.float32) for k, v in _ROWS.items()},
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_sample_token_matches_jax(case):
    """Six draws of (4, 1000) float32 logits, every other one rounded to a
    tenth so that many values tie at the nucleus and top-k boundaries:
    the JAX tokens from the same logits and key, and nucleus_dist within
    1e-6 (softmax and mass sums in other orders)."""
    c = _CASES[case]
    jc = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in c.items()}
    tc = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in c.items()}
    rng = np.random.default_rng(11)
    for trial in range(6):
        lg = (rng.standard_normal((4, 1000)) * 3).astype(np.float32)
        if trial % 2:
            lg = np.round(lg, 1)
        key = prng.split(prng.PRNGKey(trial))[1]
        want = np.asarray(jax_sampling.sample_token(jnp.asarray(lg), jnp.asarray(key), **jc))
        got = sample_token(torch.from_numpy(lg), key, **tc).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(
            nucleus_dist(torch.from_numpy(lg), **tc).numpy(),
            np.asarray(jax_sampling.nucleus_dist(jnp.asarray(lg), **jc)),
            rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the decode loop and the Engine on a converted checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A converted 2-layer absorbed-MLA MoE checkpoint in Q3_K (V3
    noaux_tc routing; the dims of tests/test_torch_packed.py), loaded by
    both Engines at their default arguments: packed planes, a 24-slot
    window, decode_block 32, seed SEED."""
    cfg = hf_config(dim=256, hidden=256, q_lora=256, kv_lora=256, nope=128,
                    rope=64, v_dim=128, moe_inter=256, layers=2, vocab=300,
                    n_experts=4, n_active=2, arch="DeepseekV3ForCausalLM",
                    topk_method="noaux_tc", scoring="sigmoid")
    root = str(tmp_path_factory.mktemp("decode-loop"))
    write_hf_dir(os.path.join(root, "hf"), cfg, hf_weights(cfg, seed=41, scale=0.1))
    out = os.path.join(root, "ck")
    cv.convert(os.path.join(root, "hf"), out, quant="q3_k", use_mla=True)
    jeng = JaxEngine(out, seed=SEED)
    prompt = jeng.tokenizer.encode("hello world", bos=True)[:6]
    return dict(dir=out, jeng=jeng, prompt=prompt + [7] * (6 - len(prompt)))


def _port_engine(ckpt):
    return Engine(ckpt["dir"], device="cpu", seed=SEED)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_decode_loop_matches_jax(ckpt, temperature):
    """12 steps from an empty cache through the port's and the JAX
    make_decode_loop (top_p 0.95, the same key): the same tokens, and the
    last step's logits within 1e-3 of their scale (the tolerance of
    tests/test_torch_packed.py: f32 sums in other orders, f16 cache
    rounding)."""
    jeng, eng = ckpt["jeng"], _port_engine(ckpt)
    key = prng.split(prng.PRNGKey(SEED))[1]
    tok0 = ckpt["prompt"][0]
    jt, jl, _ = jax_decode_loop(jeng.cfg, 12)(
        jeng.params, init_cache(jeng.cfg), jnp.asarray([[tok0]], jnp.int32), 0,
        jnp.asarray(key), jnp.float32(temperature), jnp.float32(0.95))
    pt, pl, _ = make_decode_loop(eng.cfg, 12)(
        eng.params, torch_cache(eng.cfg), torch.tensor([[tok0]]), 0, key,
        temperature, 0.95)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    want = np.asarray(jl)
    np.testing.assert_allclose(pl.numpy(), want, rtol=0, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_default_matches_jax(ckpt, temperature):
    """Engine.generate at default arguments on both sides (decode_block 32,
    top_p 0.95, seed SEED): the first token from the host sampler, the rest
    in two on-device blocks past the 24-slot window's edge. The same
    tokens; sampled, twice in a row (the engine key advances a split per
    block)."""
    jeng, eng = ckpt["jeng"], _port_engine(ckpt)
    jeng.sampler.rng = np.random.default_rng(SEED)
    jeng._key = jax.random.PRNGKey(SEED)
    assert eng.decode_block == jeng.decode_block == 32
    assert eng.cfg.kv_window == jeng.cfg.kv_window == 24
    for _ in range(2 if temperature else 1):
        want, _ = jeng.generate(ckpt["prompt"], num_steps=N_NEW,
                                temperature=temperature, top_p=0.95)
        got, stats = eng.generate(ckpt["prompt"], num_steps=N_NEW,
                                  temperature=temperature, top_p=0.95)
        assert got == want
        assert stats.generated_tokens == len(got) > 32


def test_decode_loop_does_not_synchronize(ckpt, monkeypatch):
    """Inside a block, no step reads a tensor back to the host: 8 steps call
    forward_decode 8 times and no .item/.tolist/.cpu/.numpy or implicit
    bool/int/float/index conversion of a tensor, sampled with top-k and
    min-p on. Reading the tokens afterwards is the one transfer."""
    eng = _port_engine(ckpt)
    calls = {"forward": 0, "host": 0}
    fwd = port_model.forward_decode

    def counted(*a, **kw):
        calls["forward"] += 1
        return fwd(*a, **kw)

    monkeypatch.setattr(port_model, "forward_decode", counted)
    cache = torch_cache(eng.cfg)
    tok = torch.tensor([[ckpt["prompt"][0]]])
    key = prng.PRNGKey(3)
    loop = make_decode_loop(eng.cfg, 8)
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, **kw):
            calls["host"] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, spy)
    toks, logits, _ = loop(eng.params, cache, tok, 0, key, 0.8, 0.9,
                           top_k=20, min_p=0.01)
    assert calls == {"forward": 8, "host": 0}
    toks.tolist()
    assert calls["host"] == 1 and toks.shape == (1, 8)


def test_decode_loop_raises_on_unported_options(ckpt):
    """Every mesh axis is ported (tests/test_torch_seq_parallel.py,
    tests/test_torch_tensor_expert.py, tests/test_torch_data_axis.py), and
    per-token logprobs, the hidden state and live-row masks are too
    (``test_batched_decode_loop_matches_jax``): a loop over a data axis
    takes the whole batch beside this rank's cache rows and refuses a data
    shard's rows alone. The hidden state over a mesh raises as the JAX loop
    asserts (single-device), and more live rows than the occupancy bucket
    raise."""
    eng = _port_engine(ckpt)
    data_loop = make_decode_loop(eng.cfg, 4, mesh=Mesh(data=2))
    with pytest.raises(ValueError, match="whole batch"):
        data_loop(eng.params, torch_cache(eng.cfg, batch=2), torch.tensor([[5], [6]]), 0,
                  prng.PRNGKey(0), 0.0, 1.0)
    with pytest.raises(ValueError, match="single-device"):
        make_decode_loop(eng.cfg, 4, mesh=Mesh(seq=2), with_hidden=True)
    loop = make_decode_loop(eng.cfg, 4, active_bucket=1)
    with pytest.raises(ValueError, match="bucket"):
        loop(eng.params, torch_cache(eng.cfg, batch=2), torch.tensor([[5], [6]]), 0,
             prng.PRNGKey(0), 0.0, 1.0, np.ones(2, dtype=bool))
    assert Engine(ckpt["dir"], device="cpu", decode_block=0).decode_block == 1


def test_sample_token_host_rows_match_jax():
    """Per-row parameters as host numpy arrays (the scheduler's per-slot
    temperature, top-p, top-k and min-p: greedy rows, sampled rows, a
    top-k row and a min-p row in one batch): the JAX tokens from the same
    logits and key, bit for bit, and the branch decided on the host."""
    rows = dict(temperature=np.array([0.0, 0.8, 0.8, 0.0, 1.1], np.float32),
                top_p=np.array([0.95, 0.9, 1.0, 0.5, 0.95], np.float32),
                top_k=np.array([0.0, 0.0, 4.0, 0.0, 0.0], np.float32),
                min_p=np.array([0.0, 0.0, 0.0, 0.0, 0.1], np.float32))
    rng = np.random.default_rng(5)
    for trial in range(4):
        lg = np.round(rng.standard_normal((5, 700)) * 3, 1).astype(np.float32)
        key = prng.split(prng.PRNGKey(trial))[1]
        want = np.asarray(jax_sampling.sample_token(
            jnp.asarray(lg), jnp.asarray(key), **{k: jnp.asarray(v) for k, v in rows.items()}))
        np.testing.assert_array_equal(sample_token(torch.from_numpy(lg), key, **rows).numpy(),
                                      want)


def _batched_inputs(eng):
    """Four rows at positions 0/3/5/2 with per-row sampling parameters and
    row 2 dead."""
    pos = np.array([0, 3, 5, 2])
    tok = np.array([[5], [17], [40], [9]])
    rows = (np.array([0.0, 0.8, 0.8, 0.0], np.float32),
            np.array([0.95, 0.9, 0.95, 1.0], np.float32),
            np.array([0.0, 5.0, 0.0, 0.0], np.float32),
            np.array([0.0, 0.0, 0.05, 0.0], np.float32))
    active = np.array([True, True, False, True])
    return pos, tok, rows, active


@pytest.mark.parametrize("hidden", ["last", "all"])
def test_batched_decode_loop_matches_jax(ckpt, hidden):
    """A 6-step block over four rows with per-row positions, per-row host
    sampling parameters, a dead row and ``with_logprobs``/``with_hidden``
    against the JAX make_decode_loop (``active`` a device mask there): the
    same tokens, logits_last and the log-probabilities within 1e-3 of the
    logit scale, the last hidden state within 1e-3 of its scale.
    ``all_hidden``'s last step is the same hidden state."""
    jeng, eng = ckpt["jeng"], _port_engine(ckpt)
    pos, tok, (t, p, k, m), active = _batched_inputs(eng)
    key = prng.split(prng.PRNGKey(SEED))[1]
    jt, jl, jlp, jh, _ = jax_decode_loop(jeng.cfg, 6, with_logprobs=True, with_hidden=True)(
        jeng.params, init_cache(jeng.cfg, batch=4), jnp.asarray(tok, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(key), jnp.asarray(t), jnp.asarray(p),
        jnp.asarray(active), jnp.asarray(k), jnp.asarray(m))
    loop = make_decode_loop(eng.cfg, 6, with_logprobs=True, with_hidden=hidden == "last",
                            all_hidden=hidden == "all", active_bucket=4)
    pt, pl, plp, ph, _ = loop(eng.params, torch_cache(eng.cfg, batch=4),
                              torch.from_numpy(tok), pos, key, t, p, active, k, m)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    want = np.asarray(jl)
    scale = np.abs(want).max()
    np.testing.assert_allclose(pl.numpy(), want, rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), rtol=0, atol=1e-3 * scale)
    assert ph.shape == ((4, 1, eng.cfg.dim) if hidden == "last" else (4, 6, eng.cfg.dim))
    jh = np.asarray(jh)
    np.testing.assert_allclose(ph[:, -1:].numpy(), jh, rtol=0, atol=1e-3 * np.abs(jh).max())


def test_batched_decode_loop_does_not_synchronize(ckpt, monkeypatch):
    """The serving block (per-row positions, per-slot sampling arrays, an
    active mask, logprobs and hidden states) reads nothing back to the host
    inside the block: the host values cross in non-blocking copies."""
    eng = _port_engine(ckpt)
    pos, tok, (t, p, k, m), active = _batched_inputs(eng)
    loop = make_decode_loop(eng.cfg, 5, with_logprobs=True, all_hidden=True)
    calls = {"host": 0}
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, **kw):
            calls["host"] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, spy)
    toks, _, lps, hid, _ = loop(eng.params, torch_cache(eng.cfg, batch=4),
                                torch.from_numpy(tok), pos, prng.PRNGKey(3), t, p,
                                active, k, m)
    assert calls["host"] == 0
    assert toks.shape == lps.shape == (4, 5) and hid.shape == (4, 5, eng.cfg.dim)


def test_combine_pairs_sums_each_token_in_slot_order():
    """``combine_pairs`` (the pair list's combine, atomic-free in each
    token's slot order) gives each token the index_add_ sum of its weighted
    pairs (1e-6); the cut pairs of dead rows add nothing."""
    from deepseek_tpu_torch.ops.matmul import LiveRows, combine_pairs, dispatch_pairs
    g = torch.Generator().manual_seed(0)
    T, k, E, d = 5, 3, 7, 16
    idx = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(T)])
    w = torch.rand((T, k), generator=g)
    live = LiveRows.of(np.array([1, 0, 1, 1, 0], bool), "cpu")
    eid, wts, tok, pair = dispatch_pairs(idx, w, live)
    assert torch.equal(pair // k, tok) and torch.equal(idx.reshape(-1)[pair], eid)
    per = torch.randn((eid.numel(), d), generator=g)
    want = torch.zeros((T, d)).index_add_(0, tok, per * wts[:, None])
    got = combine_pairs(per, wts, pair, T, k)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert not got[[1, 4]].any()


def test_row_reductions_take_at_least_sixteen_rows():
    """``pad_rows`` appends zero rows up to INVARIANT_ROWS (a larger batch
    stays as it is); rmsnorm and the router product over the padded rows
    give the unpadded values (1e-6) in the input's shape and dtype."""
    from deepseek_tpu_torch.models.deepseek import _router_logits
    from deepseek_tpu_torch.ops.norms import INVARIANT_ROWS, pad_rows, rmsnorm
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, 1, 8), generator=g)
    p = pad_rows(x)
    assert p.shape == (INVARIANT_ROWS, 1, 8) and torch.equal(p[:3], x) and not p[3:].any()
    big = torch.randn((INVARIANT_ROWS + 4, 8), generator=g)
    assert pad_rows(big) is big
    w = torch.rand(8, generator=g)
    want = x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6) * w
    torch.testing.assert_close(rmsnorm(x, w, 1e-6), want, rtol=1e-6, atol=1e-6)
    assert rmsnorm(x.to(torch.bfloat16), w, 1e-6).dtype == torch.bfloat16
    gate = torch.randn((5, 8), generator=g)
    torch.testing.assert_close(_router_logits(x, gate), x @ gate.t(), rtol=1e-6,
                               atol=1e-6)
