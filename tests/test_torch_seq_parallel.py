"""The port's ``seq`` mesh axis (sequence-parallel decode, context-parallel
prefill over ``torch.distributed``) against the JAX package.

- The plain partials (acc, m, l) of ``ops/attention.py`` against the JAX
  ``*_partial`` functions, float and int8, an empty shard included.
- The four kernel wrappers with ``partials=True`` (their plain versions on
  the CPU) against the Pallas kernels in interpret mode with
  ``partials=True``, float and int8, at ``cache_pos0 > 0``; two shards'
  triples merged against the unsharded output.
- The forward at ``seq=2``: two gloo ranks (``parallel/launch.py``) from the
  same ``params_from_reference`` parameters as the JAX ``make_forward(...,
  mesh=make_mesh(seq=2))``: absorbed MLA, hybrid MLA and MHA, float32 and
  int8 caches, a context-parallel chunk, one straddling the shards' edge
  and one replicated, decode through the ring's wrap and the sinks'
  re-rotation, ``logits_mode`` "all" and "last"; the ranks' caches
  concatenated against the JAX cache.
- ``make_decode_loop(mesh=...)``: the same tokens on both ranks as the JAX
  loop over the same mesh, at temperature 0 and 0.8, across two blocks.
- Errors: the unported data axis (the tensor and expert axes build their
  meshes), a window the axis does not divide, a rank that raises.

The ranks import this module to find their bodies, so it imports JAX only
inside the functions that build the reference: a rank loads torch and
the port alone. The ranks run once a module (``seq2_runs``) and every
scenario's test reads its results.
"""

import dataclasses
import math
import os
import time

import numpy as np
import pytest
import torch

from deepseek_tpu_torch.models import deepseek as port_model
from deepseek_tpu_torch.models.deepseek import (
    forward_decode, forward_prefill, make_decode_loop,
)
from deepseek_tpu_torch.models.kvcache import init_cache as torch_cache
from deepseek_tpu_torch.ops import prng
from deepseek_tpu_torch.ops.kernels.attention import mha_decode_attn, mla_decode_attn
from deepseek_tpu_torch.ops.kernels.prefill_attn import mha_prefill_attn, mla_prefill_attn
from deepseek_tpu_torch.parallel.launch import launch
from deepseek_tpu_torch.parallel.mesh import Mesh, make_mesh
from deepseek_tpu_torch.parallel.sharding import WINDOW_FIELDS, shard_cache
from deepseek_tpu_torch.parallel.spmd import COUNTS, make_ctx
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SP = 2
CHUNKS = ((8, "all"), (8, "last"), (5, "all"))   # CP; CP across the edge; replicated
N_TOKENS = 40                                    # decode 21..39: the 24-slot ring wraps
LOOP_PROMPT, LOOP_BLOCK = 13, 8
KERNELS = ("mla_decode_attn", "mha_decode_attn", "mla_prefill_attn",
           "mha_prefill_attn")


def _rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _q8(shape, seed):
    """Random rows quantized by the JAX package: (int8, f32 scales) numpy."""
    import jax.numpy as jnp
    from deepseek_tpu.models.kvcache import quantize_rows
    q, s = quantize_rows(jnp.asarray(_rnd(shape, seed, 0.5)))
    return np.asarray(q), np.asarray(s)


def _assert_triples_close(got, want, tol):
    """(acc, m, l) against (acc, m, l): a row that sees no slot (m -1e30 in
    want) has acc 0, l 0 and m -1e30 in got; elsewhere m agrees within tol
    of its scale and acc, l agree within tol of their scale once both are
    rescaled to the common maximum max(m, m_want)."""
    acc, m, l = (np.asarray(x, np.float64) for x in got)
    acc_w, m_w, l_w = (np.asarray(x, np.float64) for x in want)
    assert acc.shape == acc_w.shape and m.shape == m_w.shape == l.shape == l_w.shape
    empty = m_w <= -1e29
    assert np.all(m[empty] == np.float32(-1e30)) and np.all(l[empty] == 0)
    assert np.all(acc[empty] == 0)
    live = ~empty
    if not live.any():
        return
    np.testing.assert_allclose(m[live], m_w[live], rtol=0,
                               atol=tol * max(1.0, np.abs(m_w[live]).max()))
    mx = np.maximum(m, m_w)
    a, b = np.exp(m - mx), np.exp(m_w - mx)
    np.testing.assert_allclose(l * a, l_w * b, rtol=0, atol=tol * np.abs(l_w * b).max())
    np.testing.assert_allclose(acc * a[..., None], acc_w * b[..., None], rtol=0,
                               atol=tol * np.abs(acc_w * b[..., None]).max())


def _merge(parts):
    """The exact flash merge of shard triples (numpy, f64)."""
    accs, ms, ls = zip(*[[np.asarray(x, np.float64) for x in p] for p in parts])
    mg = np.maximum.reduce(ms)
    num = sum(a * np.exp(m - mg)[..., None] for a, m in zip(accs, ms))
    den = sum(l * np.exp(m - mg) for l, m in zip(ls, ms))
    return num / np.maximum(den, 1e-30)[..., None]


# ---------------------------------------------------------------------------
# shard inputs of the four kernels: (port args, JAX args) per shard
# ---------------------------------------------------------------------------

def _shard_cases(kind: str, q8: bool):
    """Inputs of one kernel over a 2-shard window: the whole window's
    arguments, and each shard's (slice, kv_len or cache_pos0). The second
    decode sequence's live prefix ends inside shard 0 (shard 1 empty for
    it); the prefill chunk sits at positions 5.. so shard 1 (positions
    24..47) is empty for its first rows, past its latest query for none."""
    S, half = 48, 24
    if kind in ("mla_decode", "mla_prefill"):
        B, H, R, P = 2, 4, 32, 16
        rows = [_q8((B, S, R), 5), _q8((B, S, P), 6)] if q8 else \
            [(_rnd((B, S, R), 5), None), (_rnd((B, S, P), 6), None)]
        scale = 1.0 / math.sqrt(48.0)
        if kind == "mla_decode":
            q = [_rnd((B, H, R), 3), _rnd((B, H, P), 4)]
            return dict(q=q, rows=rows, scale=scale, kv_len=np.asarray([40, 17], np.int32))
        T = 12
        q = [_rnd((B, T, H, R), 7, 0.3), _rnd((B, T, H, P), 8, 0.3)]
        return dict(q=q, rows=rows, scale=scale, q_pos0=20)
    B, H, Dh, Dv = 2, 3, 48, 32
    rows = [_q8((B, S, H, Dh), 11), _q8((B, S, H, Dv), 12)] if q8 else \
        [(_rnd((B, S, H, Dh), 11), None), (_rnd((B, S, H, Dv), 12), None)]
    scale = 1.0 / math.sqrt(Dh)
    if kind == "mha_decode":
        return dict(q=[_rnd((B, H, Dh), 10)], rows=rows, scale=scale,
                    kv_len=np.asarray([40, 17], np.int32))
    return dict(q=[_rnd((B, 10, H, Dh), 13, 0.3)], rows=rows, scale=scale, q_pos0=20)


def _call_port(kind, case, sl, local, partials):
    """The port's wrapper over slots ``sl`` (kv_len or cache_pos0 ``local``)."""
    q = [_t(x) for x in case["q"]]
    (a, a_s), (b, b_s) = case["rows"]
    a, b = _t(a[:, sl]), _t(b[:, sl])
    if kind.startswith("mla"):
        sc = {} if a_s is None else dict(ckv_scale=_t(a_s[:, sl]), krope_scale=_t(b_s[:, sl]))
    else:   # the head-major (B,H,S) views of the cache's (B,S,H) scales
        sc = {} if a_s is None else dict(k_scale=_t(a_s[:, sl]).transpose(1, 2),
                                         v_scale=_t(b_s[:, sl]).transpose(1, 2))
    fn = dict(mla_decode=mla_decode_attn, mha_decode=mha_decode_attn,
              mla_prefill=mla_prefill_attn, mha_prefill=mha_prefill_attn)[kind]
    if kind.endswith("decode"):
        return fn(*q, a, b, torch.from_numpy(local), case["scale"], partials=partials, **sc)
    return fn(*q, a, b, case["q_pos0"], local, case["scale"], partials=partials, **sc)


def _call_pallas(kind, case, sl, local, partials):
    import jax.numpy as jnp
    from deepseek_tpu.ops.pallas import attention as jax_pallas
    q = [jnp.asarray(x) for x in case["q"]]
    (a, a_s), (b, b_s) = case["rows"]
    a, b = jnp.asarray(a[:, sl]), jnp.asarray(b[:, sl])
    if kind.startswith("mla"):
        sc = {} if a_s is None else dict(ckv_scale=jnp.asarray(a_s[:, sl]),
                                         krope_scale=jnp.asarray(b_s[:, sl]))
    else:
        sc = {} if a_s is None else dict(k_scale=jnp.swapaxes(jnp.asarray(a_s[:, sl]), 1, 2),
                                         v_scale=jnp.swapaxes(jnp.asarray(b_s[:, sl]), 1, 2))
    fn = getattr(jax_pallas, kind + "_attn")
    if kind.endswith("decode"):
        out = fn(*q, a, b, jnp.asarray(local), case["scale"], interpret=True,
                 partials=partials, **sc)
    else:
        out = fn(*q, a, b, case["q_pos0"], local, case["scale"], interpret=True,
                 partials=partials, **sc)
    return tuple(np.asarray(x) for x in out) if partials else np.asarray(out)


def _shards(case, kind):
    """[(slots, kv_len or cache_pos0)] of the two shards of 48 slots."""
    half = 24
    out = []
    for s in range(SP):
        sl = slice(s * half, (s + 1) * half)
        local = (np.clip(case["kv_len"] - s * half, 0, half).astype(np.int32)
                 if kind.endswith("decode") else s * half)
        out.append((sl, local))
    return out


# ---------------------------------------------------------------------------
# 1. the plain partials against the JAX *_partial functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("kind", ["mla_decode", "mha_decode", "mha_prefill",
                                  "mla_prefill"])
def test_plain_partials_match_jax(kind, q8):
    """Each plain partial over each shard (shard 1 empty for some rows)
    against the JAX function of the same name on the same rows (the JAX
    ones take float rows: an int8 shard is dequantized for them, as the
    JAX XLA route does, while the port takes the scales). Tolerance 1e-5
    of each term's scale: the same f32 arithmetic in other orders."""
    import jax.numpy as jnp
    from deepseek_tpu.models.kvcache import dequant_rows
    from deepseek_tpu.ops import attention as jax_attn

    case = _shard_cases(kind, q8)
    (a, a_s), (b, b_s) = case["rows"]
    fa = a if a_s is None else np.asarray(dequant_rows(jnp.asarray(a), jnp.asarray(a_s)))
    fb = b if b_s is None else np.asarray(dequant_rows(jnp.asarray(b), jnp.asarray(b_s)))
    q = [jnp.asarray(x) for x in case["q"]]
    saw_empty = False
    for sl, local in _shards(case, kind):
        A, Bv = jnp.asarray(fa[:, sl]), jnp.asarray(fb[:, sl])
        if kind == "mla_decode":
            want = jax_attn.decode_attn_mla_partial(*q, A, Bv, jnp.asarray(local), 48,
                                                    softmax_scale=case["scale"])
        elif kind == "mha_decode":
            want = jax_attn.decode_attn_mha_partial(*q, A, Bv, jnp.asarray(local),
                                                    softmax_scale=case["scale"])
        else:
            T = case["q"][0].shape[1]
            q_pos = case["q_pos0"] + jnp.arange(T)
            cache_pos = local + jnp.arange(A.shape[1])
            if kind == "mha_prefill":
                want = jax_attn.prefill_attn_mha_partial(*q, A, Bv, q_pos, cache_pos,
                                                         softmax_scale=case["scale"])
            else:
                want = jax_attn.prefill_attn_mla_partial(*q, A, Bv, q_pos, cache_pos, 48,
                                                         softmax_scale=case["scale"])
        want = [np.asarray(x) for x in want]
        saw_empty |= bool((want[1] <= -1e29).any())
        got = _call_port(kind, case, sl, local, partials=True)
        _assert_triples_close([x.numpy() for x in got], want, 1e-5)
    assert saw_empty


# ---------------------------------------------------------------------------
# 2. the wrappers' partials against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("kind", ["mla_decode", "mha_decode", "mha_prefill",
                                  "mla_prefill"])
def test_partials_wrappers_match_pallas_interpret(kind, q8):
    """The wrapper with ``partials=True`` over each of two shards (the
    second at cache_pos0 24 for prefill) against the Pallas kernel in
    interpret mode with ``partials=True``: within 2e-3 of each term's scale
    (the Pallas kernel folds int8 scales into scores and weights and sums
    in another order, as tests/test_torch_kv_int8.py states). The two
    shards' triples merged equal the wrapper's unsharded normalized output
    within 1e-5 of its scale (the same f32 terms, summed in two parts)."""
    case = _shard_cases(kind, q8)
    whole = (slice(None), case["kv_len"] if kind.endswith("decode") else 0)
    full = _call_port(kind, case, *whole, partials=False).numpy()
    parts = []
    for sl, local in _shards(case, kind):
        got = [x.numpy() for x in _call_port(kind, case, sl, local, partials=True)]
        _assert_triples_close(got, _call_pallas(kind, case, sl, local, True), 2e-3)
        parts.append(got)
    np.testing.assert_allclose(_merge(parts), full, rtol=0, atol=1e-5 * np.abs(full).max())


def test_attention_kernels_return_triples_on_cpu():
    """On CPU tensors ``partials=True`` returns the plain partials triple and
    launches nothing (no count moves); the normalized form is unchanged."""
    case = _shard_cases("mla_decode", False)
    counts = lambda: (mla_decode_attn.launches, mla_decode_attn.partials.launches,
                      mla_decode_attn.partials.int8.launches)
    before = counts()
    acc, m, l = _call_port("mla_decode", case, slice(24, 48),
                           np.asarray([16, 0], np.int32), partials=True)
    assert acc.shape == (2, 4, 32) and m.shape == l.shape == (2, 4)
    assert torch.all(m[1] == -1e30) and torch.all(l[1] == 0) and not acc[1].any()
    assert counts() == before


# ---------------------------------------------------------------------------
# 3. the forward at seq=2: the ranks
# ---------------------------------------------------------------------------

def _spy_partials(calls):
    """Wrap the model's four kernels to record the partials flag of each call."""
    for name in KERNELS:
        fn = getattr(port_model, name)

        def spy(*a, _fn=fn, _n=name, **kw):
            calls.setdefault(_n, []).append(bool(kw.get("partials")))
            return _fn(*a, **kw)

        setattr(port_model, name, spy)


def _rank_forward(rank, world, scenarios, loop_case):
    """Each scenario's prefill chunks and decode steps on this rank's slice
    of the window; then the decode-loop blocks. Returns numpy results."""
    mesh = make_mesh(seq=world)
    calls = {}
    _spy_partials(calls)
    out = {}
    for name, (params, cfg, toks) in scenarios.items():
        ctx = make_ctx(cfg, mesh)
        cache = shard_cache(torch_cache(cfg), cfg, mesh)
        logits, cp, pos = [], [], 0
        with torch.inference_mode():
            for T, mode in CHUNKS:
                before = COUNTS["cp_rows"]
                lg = forward_prefill(params, cache, torch.tensor([toks[pos:pos + T]]), pos,
                                     cfg, mode, ctx)
                cp.append(COUNTS["cp_rows"] - before)
                logits.append(lg[0].numpy())
                pos += T
            for p in range(pos, len(toks)):
                logits.append(forward_decode(params, cache, torch.tensor([[toks[p]]]), p,
                                             cfg, ctx)[0].numpy())
        out[name] = dict(logits=logits, cp=cp, cache={
            f.name: getattr(cache, f.name).numpy() for f in dataclasses.fields(cache)
            if getattr(cache, f.name) is not None})
    params, cfg, toks = loop_case
    ctx = make_ctx(cfg, mesh)
    loops = {}
    for temperature in (0.0, 0.8):
        cache = shard_cache(torch_cache(cfg), cfg, mesh)
        with torch.inference_mode():
            forward_prefill(params, cache, torch.tensor([toks[:8]]), 0, cfg, "none", ctx)
            forward_prefill(params, cache, torch.tensor([toks[8:LOOP_PROMPT]]), 8, cfg,
                            "none", ctx)
        loop = make_decode_loop(cfg, LOOP_BLOCK, mesh=mesh)
        key, tok, pos, got = prng.PRNGKey(5), torch.tensor([[toks[LOOP_PROMPT]]]), \
            LOOP_PROMPT, []
        for _ in range(2):
            key, sub = prng.split(key)
            blk, _, _ = loop(params, cache, tok, pos, sub, temperature, 0.9)
            got.append(blk.numpy())
            tok, pos = blk[:, -1:], pos + LOOP_BLOCK
        loops[temperature] = np.concatenate(got, 1)
    return dict(scenarios=out, loops=loops, calls=calls, sidx=mesh.seq_index)


# ---------------------------------------------------------------------------
# 3. the forward at seq=2: the references and the comparisons
# ---------------------------------------------------------------------------

def _checkpoint(root, kind):
    """A 2-layer MoE checkpoint converted from a fake HF directory: absorbed
    MLA keeping wq_b/wkv_b (kind "mla") or decompressed MHA ("mha"). F16
    weights, a 24-slot window."""
    from deepseek_tpu import convert as cv
    from tests.util_hf import hf_config, hf_weights, write_hf_dir
    cfg = hf_config(dim=64, hidden=96, q_lora=32, kv_lora=32, nope=16, rope=8, v_dim=16,
                    moe_inter=24, layers=2, vocab=300, n_experts=4, n_active=2)
    hf_dir = os.path.join(root, kind, "hf")
    write_hf_dir(hf_dir, cfg, hf_weights(cfg, seed=91, scale=0.1))
    out = os.path.join(root, kind, "ck")
    cv.convert(hf_dir, out, use_mla=kind == "mla")
    return out


def _strip_factors(params):
    return dataclasses.replace(params, layers=[
        dataclasses.replace(lp, wq_b=None, wkv_b=None) for lp in params.layers])


SCENARIOS = [(att, kv) for att in ("absorbed", "hybrid", "mha")
             for kv in ("float32", "int8")]


@pytest.fixture(scope="module")
def seq2_runs(tmp_path_factory):
    """Every scenario's JAX side (params, cfg, the seq=2 reference) and the
    port's two ranks, run once."""
    from deepseek_tpu.engine import Engine as JaxEngine
    from deepseek_tpu_torch.config import ModelConfig
    from deepseek_tpu_torch.models.loader import params_from_reference

    root = str(tmp_path_factory.mktemp("seq2"))
    ckpts = {k: _checkpoint(root, k) for k in ("mla", "mha")}
    toks = np.random.default_rng(92).integers(3, 300, N_TOKENS).tolist()
    jax_side, port_side = {}, {}
    for att, kv in SCENARIOS:
        jeng = JaxEngine(ckpts["mha" if att == "mha" else "mla"], seed=0)
        jcfg = dataclasses.replace(jeng.cfg, kv_cache_dtype=kv)
        jparams = _strip_factors(jeng.params) if att == "absorbed" else jeng.params
        assert jcfg.kv_window == 24
        cfg = dataclasses.replace(ModelConfig.from_metadata(jeng.data.metadata),
                                  kv_cache_dtype=kv)
        params = params_from_reference(jparams, "cpu")
        name = f"{att}-{kv}"
        jax_side[name] = (jparams, jcfg)
        port_side[name] = (params, cfg, toks)
    t0 = time.perf_counter()
    ranks = launch(_rank_forward, SP, port_side, port_side["absorbed-float32"])
    return dict(jax=jax_side, port=port_side, ranks=ranks, toks=toks,
                seconds=time.perf_counter() - t0)


def _jax_seq2(jparams, jcfg, toks):
    """The JAX package over make_mesh(seq=2): prefill logits of every chunk
    ("all"), then each decode step's; the cache read back whole."""
    import jax.numpy as jnp
    from deepseek_tpu.models import init_cache, make_forward
    from deepseek_tpu.parallel.mesh import make_mesh as jax_mesh
    from deepseek_tpu.parallel.sharding import shard_cache as jax_shard_cache
    from deepseek_tpu.parallel.sharding import shard_params as jax_shard_params

    mesh = jax_mesh(seq=SP)
    sc = jax_shard_cache(init_cache(jcfg, batch=1), jcfg, mesh)
    sp = jax_shard_params(jparams, jcfg, mesh)
    pre = make_forward(jcfg, prefill=True, logits_mode="all", mesh=mesh,
                       params=jparams, cache=sc)
    dec = make_forward(jcfg, prefill=False, mesh=mesh, params=jparams, cache=sc)
    want, pos = [], 0
    for T, mode in CHUNKS:
        lg, sc = pre(sp, sc, jnp.asarray([toks[pos:pos + T]], jnp.int32), pos)
        lg = np.asarray(lg[0])
        want.append(lg[-1] if mode == "last" else lg)
        pos += T
    for p in range(pos, len(toks)):
        lg, sc = dec(sp, sc, jnp.asarray([[toks[p]]], jnp.int32), p)
        want.append(np.asarray(lg[0]))
    return want, sc


def _port_seq1(params, cfg, toks):
    cache, got, pos = torch_cache(cfg), [], 0
    with torch.inference_mode():
        for T, mode in CHUNKS:
            lg = forward_prefill(params, cache, torch.tensor([toks[pos:pos + T]]), pos,
                                 cfg, mode)
            got.append(lg[0].numpy())
            pos += T
        for p in range(pos, len(toks)):
            got.append(forward_decode(params, cache, torch.tensor([[toks[p]]]), p,
                                      cfg)[0].numpy())
    return got


def _assert_caches_match(jc, ranks, int8):
    """The ranks' window slices, concatenated in rank order, against the JAX
    cache; the sink masters (whole on every rank) against JAX's on each
    rank. Float rows within 1e-4 of each field's scale (f32 activations
    summed in other orders through two layers); int8 rows equal but for
    elements one count apart (a value at a rounding boundary) in at most
    1% of them, scales and masters within 1e-4 of their scale, as
    tests/test_torch_kv_int8.py holds the unsharded int8 cache."""
    for f in ("k", "v", "ckv", "krope", "k_s", "v_s", "ckv_s", "krope_s",
              "sink_k", "sink_krope"):
        a = getattr(jc, f)
        if a is None:
            assert all(f not in r for r in ranks), f
            continue
        a = np.asarray(a)
        if f in WINDOW_FIELDS:
            got = [np.concatenate([r[f] for r in ranks], axis=2)]
        else:
            got = [r[f] for r in ranks]
        for b in got:
            assert b.shape == a.shape, f
            if b.dtype == np.int8:
                d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() <= 0.01, f
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * np.abs(a).max(),
                                           err_msg=f)


@pytest.mark.parametrize("att,kv", SCENARIOS, ids=[f"{a}-{k}" for a, k in SCENARIOS])
def test_forward_seq2_matches_jax(seq2_runs, att, kv):
    """The ranks' logits after each chunk (every row for "all", the last
    for "last") and each decode step, within 1e-3 of their scale (the
    repo's convention): against the JAX package at seq=2 and against the
    port at seq=1; equal on both ranks. Chunks of 8 run context-parallel
    (counted), the 5-token one replicated; the caches after, as
    ``_assert_caches_match`` says; every attention call of the ranks took
    the partials bodies."""
    name = f"{att}-{kv}"
    jparams, jcfg = seq2_runs["jax"][name]
    params, cfg, toks = seq2_runs["port"][name]
    ranks = seq2_runs["ranks"]
    assert [r["sidx"] for r in ranks] == [0, 1]
    want, jcache = _jax_seq2(jparams, jcfg, toks)
    one = _port_seq1(params, cfg, toks)
    got = [r["scenarios"][name] for r in ranks]
    assert len(got[0]["logits"]) == len(want) == len(one) == len(CHUNKS) + N_TOKENS - 21
    for i, w in enumerate(want):
        tol = 1e-3 * np.abs(w).max()
        for g in got:
            assert g["logits"][i].shape == w.shape
            np.testing.assert_allclose(g["logits"][i], w, rtol=0, atol=tol)
            np.testing.assert_allclose(g["logits"][i], one[i], rtol=0, atol=tol)
        np.testing.assert_array_equal(got[0]["logits"][i], got[1]["logits"][i])
    for g in got:
        assert g["cp"] == [1, 1, 0]
    _assert_caches_match(jcache, [g["cache"] for g in got], kv == "int8")
    for r in ranks:
        assert r["calls"] and all(all(v) for v in r["calls"].values())


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_decode_loop_seq2_matches_jax(seq2_runs, temperature):
    """``make_decode_loop(cfg, 8, mesh=make_mesh(seq=2))`` after a 13-token
    prompt (a CP chunk of 8, a replicated one of 5), two blocks with keys
    split from PRNGKey(5) as the Engine splits them, the second across the
    window's edge: the same 16 tokens on both ranks as the JAX loop over
    make_mesh(seq=2) with the same keys."""
    import jax
    import jax.numpy as jnp
    from deepseek_tpu.models import init_cache, make_forward
    from deepseek_tpu.models.deepseek import make_decode_loop as jax_loop
    from deepseek_tpu.parallel.mesh import make_mesh as jax_mesh
    from deepseek_tpu.parallel.sharding import shard_cache as jax_shard_cache
    from deepseek_tpu.parallel.sharding import shard_params as jax_shard_params

    jparams, jcfg = seq2_runs["jax"]["absorbed-float32"]
    toks = seq2_runs["toks"]
    mesh = jax_mesh(seq=SP)
    sc = jax_shard_cache(init_cache(jcfg, batch=1), jcfg, mesh)
    sp = jax_shard_params(jparams, jcfg, mesh)
    pre = make_forward(jcfg, prefill=True, logits_mode="none", mesh=mesh,
                       params=jparams, cache=sc)
    _, sc = pre(sp, sc, jnp.asarray([toks[:8]], jnp.int32), 0)
    _, sc = pre(sp, sc, jnp.asarray([toks[8:LOOP_PROMPT]], jnp.int32), 8)
    loop = jax_loop(jcfg, LOOP_BLOCK, mesh=mesh, params=jparams, cache=sc)
    key, tok, pos, want = jax.random.PRNGKey(5), jnp.asarray([[toks[LOOP_PROMPT]]],
                                                             jnp.int32), LOOP_PROMPT, []
    for _ in range(2):
        key, sub = jax.random.split(key)
        blk, _, sc = loop(sp, sc, tok, pos, sub, temperature, 0.9)
        want.append(np.asarray(blk))
        tok, pos = blk[:, -1:], pos + LOOP_BLOCK
    want = np.concatenate(want, 1)
    for r in seq2_runs["ranks"]:
        np.testing.assert_array_equal(r["loops"][temperature], want)


# ---------------------------------------------------------------------------
# 5. errors
# ---------------------------------------------------------------------------

def _rank_mesh(rank, world, axis):
    mesh = make_mesh(**{axis: world})
    return mesh.data_index, mesh.expert_index, mesh.tensor_index, mesh.size


@pytest.mark.parametrize("axis", ["tensor", "expert", "data"])
def test_unported_mesh_axes_raise(axis):
    """Every axis is ported (tests/test_torch_tensor_expert.py, tests/
    test_torch_data_axis.py): over two ranks each builds a mesh that gives
    rank r the index r along it."""
    i = {"data": 0, "expert": 1, "tensor": 2}[axis]
    for r, got in enumerate(launch(_rank_mesh, 2, axis)):
        want = [0, 0, 0, 2]
        want[i] = r
        assert got == tuple(want)


def _rank_mesh_2x2(rank, world):
    mesh = make_mesh(expert=2, tensor=2)
    return mesh.expert_index, mesh.tensor_index


def test_mesh_ranks_may_leave_straight_after_make_mesh():
    """Four ranks build a 2 x 2 (expert x tensor) mesh and return at once,
    so ``launch`` tears each process group down straight after: no rank
    may close its sockets while a peer still connects a subgroup
    (``parallel/mesh.py::settle_groups``)."""
    assert launch(_rank_mesh_2x2, 4) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_window_not_divisible_by_seq_raises():
    """make_ctx holds kv_window % seq == 0 (``deepseek_tpu/parallel/spmd.py::
    make_ctx``); seq=1 meshes and dividing windows pass."""
    from deepseek_tpu_torch.config import ModelConfig
    from tests.util_tinymodel import tiny_config, tiny_metadata
    cfg = ModelConfig.from_metadata(tiny_metadata(tiny_config(use_mla=True)))
    assert cfg.kv_window == 16
    with pytest.raises(ValueError, match="kv_window 16 % seq 3"):
        make_ctx(cfg, Mesh(seq=3))
    assert make_ctx(cfg, Mesh(seq=2, seq_index=1)).sidx == 1
    assert make_ctx(cfg, make_mesh()).sp == 1


def _rank_fails(rank, world):
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank one gives up")
    dist.barrier()          # waits for a peer that is gone
    return rank


def test_launch_reraises_a_rank_error():
    """A rank that raises makes ``launch`` raise in the caller with its
    traceback, without waiting out the collective timeout of the rank
    left in a barrier; the ranks' results come back in rank order."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised(.|\n)*rank one gives up"):
        launch(_rank_fails, 2, timeout=120)
    assert time.perf_counter() - t0 < 60


def _rank_sum(rank, world):
    import torch.distributed as dist
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    return rank, float(t)


def test_launch_returns_rank_results():
    assert launch(_rank_sum, 2) == [(0, 3.0), (1, 3.0)]
