"""The port's data mesh axis (DP) against the JAX package.

- ``ops/prng.py::fold_in`` bit for bit with ``jax.random.fold_in``.
- ``make_mesh`` at data=2 x expert=2 x tensor=2 (eight gloo ranks): each
  rank's coordinates are the JAX grid's, and the subgroup of each axis
  holds the ranks of its line.
- ``shard_cache`` over the data axis (with tensor and seq): each rank's
  slice of every cache field equals the part of the whole cache that the
  JAX ``cache_shardings`` places on the device at the rank's coordinates,
  a one-row cache (left whole over data) included.
- ``make_decode_loop(mesh=)`` at data=2, data=2 x tensor=2 and data=2 x
  expert=2 over a batch of four rows at per-row positions and top-p: on
  the f32 tiny checkpoint the JAX mesh loop's tokens at temperature 0 and
  0.8 (the keys folded with the data index) and its last logits within
  1e-3 of max|logit|; on a packed Q3_K checkpoint at temperature 0 the
  unsharded JAX loop's tokens (the JAX mesh cuts packed planes field by
  field at tensor > 1: ROADMAP deliberate differences) and at data=2 x
  expert=2 the JAX mesh loop's; every rank returning the whole batch.
- EP prefill capacity at data=2 x expert=2: a chunk that overflows on one
  data shard only raises ``EPCapacityOverflow`` on every rank, with the
  count summed over the data line.

The ranks import this module to find their bodies, so it imports JAX only
inside the functions that build the reference.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from deepseek_tpu_torch.models.kvcache import KVCache
from deepseek_tpu_torch.ops import prng
from deepseek_tpu_torch.parallel.launch import launch
from deepseek_tpu_torch.parallel.mesh import Mesh, make_mesh
from tests.test_torch_threads import one_torch_thread  # noqa: F401

LOOP_MESHES = {"data2": dict(data=2), "data2-tensor2": dict(data=2, tensor=2),
               "data2-expert2": dict(data=2, expert=2)}
B, PROMPT, BLOCK = 4, 8, 4
POS0 = np.array([8, 6, 7, 8], np.int64)        # rows 1, 2 rewrite their last slots
TOP_P = np.array([0.9, 0.95, 1.0, 0.9], np.float32)
TOL = 1e-3                                     # of max|logit|, f32 compute


# ---------------------------------------------------------------------------
# fold_in and the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_fold_in_matches_jax(seed):
    import jax
    key = jax.random.PRNGKey(seed)
    port = prng.PRNGKey(seed)
    np.testing.assert_array_equal(port, np.asarray(key))
    for d in (0, 1, 2, 3, 255, 2**31 - 1, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(port, d),
                                      np.asarray(jax.random.fold_in(key, d)))
    # folded keys split as JAX's do
    a, b = prng.split(prng.fold_in(port, 1))
    ja, jb = jax.random.split(jax.random.fold_in(key, 1))
    np.testing.assert_array_equal(a, np.asarray(ja))
    np.testing.assert_array_equal(b, np.asarray(jb))
    with pytest.raises(ValueError):
        prng.fold_in(port, -1)


def _rank_coords(rank, world):
    import torch.distributed as dist
    mesh = make_mesh(data=2, expert=2, tensor=2)
    lines = {}
    for ax in ("data", "expert", "tensor"):
        g = getattr(mesh, f"{ax}_group")
        t = torch.zeros(world)
        t[rank] = 1.0
        dist.all_reduce(t, group=g)
        lines[ax] = [int(i) for i in torch.nonzero(t)[:, 0]]
    return (mesh.data_index, mesh.expert_index, mesh.tensor_index, mesh.seq_index,
            mesh.size, lines)


def test_mesh_coordinates_and_lines():
    """Rank r at the JAX grid's row-major coordinates of r; each axis's
    subgroup holds the ranks of r's line along it."""
    grid = np.arange(8).reshape(2, 2, 2)
    for r, (d, e, t, s, n, lines) in enumerate(launch(_rank_coords, 8)):
        assert (d, e, t, s, n) == (*np.unravel_index(r, (2, 2, 2)), 0, 8)
        assert lines == {"data": grid[:, e, t].tolist(), "expert": grid[d, :, t].tolist(),
                         "tensor": grid[d, e, :].tolist()}


def test_make_ctx_data_axis():
    from deepseek_tpu_torch.config import ModelConfig
    from deepseek_tpu_torch.parallel.spmd import make_ctx
    from tests.util_tinymodel import tiny_config, tiny_metadata
    cfg = ModelConfig.from_metadata(tiny_metadata(tiny_config(use_mla=True)))
    ctx = make_ctx(cfg, Mesh(data=2, tensor=2, data_index=1))
    assert (ctx.dp, ctx.didx, ctx.tp) == (2, 1, 2)
    assert ctx.data_rows(4) == slice(2, 4)
    with pytest.raises(ValueError, match="data axis"):
        ctx.data_rows(3)


# ---------------------------------------------------------------------------
# shard_cache against the JAX cache shardings
# ---------------------------------------------------------------------------

CACHE_MESHES = {"data2": dict(data=2), "data2-tensor2": dict(data=2, tensor=2),
                "data2-seq2": dict(data=2, seq=2), "data2-expert2": dict(data=2, expert=2)}


@pytest.mark.parametrize("batch", [1, 2, 4])
@pytest.mark.parametrize("kind", ["mla", "mha", "mha-int8"])
@pytest.mark.parametrize("mesh", list(CACHE_MESHES))
def test_shard_cache_matches_jax_shardings(mesh, kind, batch):
    import jax
    from deepseek_tpu.models.kvcache import init_cache as jax_cache
    from deepseek_tpu.parallel.mesh import make_mesh as jax_mesh
    from deepseek_tpu.parallel.sharding import cache_shardings
    from deepseek_tpu_torch.config import ModelConfig
    from deepseek_tpu_torch.parallel.sharding import shard_cache
    from tests.util_tinymodel import tiny_config, tiny_metadata

    jcfg = tiny_config(use_mla=kind == "mla", vocab_size=64,
                       rs_original_max_position_embeddings=8,
                       kv_cache_dtype="int8" if kind.endswith("int8") else "float16")
    cfg = dataclasses.replace(ModelConfig.from_metadata(tiny_metadata(jcfg)),
                              kv_cache_dtype=jcfg.kv_cache_dtype)
    shape = CACHE_MESHES[mesh]
    jm = jax_mesh(**shape)
    jc = jax_cache(jcfg, batch=batch)
    rng = np.random.default_rng(batch)
    whole = {}
    for f in dataclasses.fields(jc):
        a = getattr(jc, f.name)
        if a is not None:
            a = np.asarray(a)
            whole[f.name] = (rng.integers(-100, 100, a.shape).astype(a.dtype)
                             if a.dtype == np.int8 else
                             rng.standard_normal(a.shape).astype(a.dtype))
    specs = cache_shardings(jc, jcfg, jm)
    sizes = tuple(shape.get(ax, 1) for ax in ("data", "expert", "tensor", "seq"))
    grid = np.asarray(jm.devices).reshape(sizes)
    for r in range(math.prod(sizes)):
        d, e, t, s = (int(c) for c in np.unravel_index(r, sizes))
        pm = Mesh(*sizes, seq_index=s, expert_index=e, tensor_index=t, data_index=d)
        got = shard_cache(KVCache(**{n: torch.from_numpy(a.copy()) for n, a in whole.items()}),
                          cfg, pm)
        dev = grid[d, e, t, s]
        for n, a in whole.items():
            idx = getattr(specs, n).devices_indices_map(a.shape)[dev]
            np.testing.assert_array_equal(getattr(got, n).numpy(), a[idx], err_msg=n)
    assert jax.devices()                          # the JAX mesh ran on virtual devices


# ---------------------------------------------------------------------------
# the decode loop over data meshes: checkpoints, ranks, references
# ---------------------------------------------------------------------------

def _tiny_ckpt(root):
    """The serving tests' tiny MLA checkpoint (f32 weights, 32-slot window)."""
    from deepseek_tpu.utils import codec
    from tests.util_tinymodel import (
        tiny_checkpoint_tensors, tiny_config, tiny_metadata, tiny_weights)
    cfg = tiny_config(use_mla=True, vocab_size=300, max_seq_len=128,
                      rs_original_max_position_embeddings=32)
    d = os.path.join(root, "tiny")
    codec.save_checkpoint(d, [tiny_checkpoint_tensors(cfg, tiny_weights(cfg, 55))],
                          tiny_metadata(cfg))
    return d


def _q3k_ckpt(root):
    """A packed Q3_K checkpoint (2 layers, 4 heads, 4 experts, V3 noaux_tc)."""
    from deepseek_tpu import convert as cv
    from tests.util_hf import hf_config, hf_weights, write_hf_dir
    cfg = hf_config(dim=256, hidden=512, q_lora=256, kv_lora=256, nope=128, rope=64,
                    v_dim=128, moe_inter=512, layers=2, vocab=300, heads=4,
                    n_experts=4, n_active=2, arch="DeepseekV3ForCausalLM",
                    topk_method="noaux_tc", scoring="sigmoid")
    hf = os.path.join(root, "q3k", "hf")
    write_hf_dir(hf, cfg, hf_weights(cfg, seed=71, scale=0.1))
    out = os.path.join(root, "q3k", "ck")
    cv.convert(hf, out, quant="q3_k", use_mla=True)
    return out


def _port_model(ckdir):
    from deepseek_tpu_torch.engine import Engine
    eng = Engine(ckdir, device="cpu", seed=0)
    return eng.params, dataclasses.replace(eng.cfg, compute_dtype="float32",
                                           kv_cache_dtype="float16")


def _prompts():
    return np.random.default_rng(81).integers(3, 300, (B, PROMPT))


def _rank_loop(rank, world, shape, ckpts, caches):
    """One rank of a data mesh: for each model, the JAX-hydrated cache cut
    to this rank's rows (and heads), two decode blocks at temperature 0 and
    0.8; at data=2 x expert=2 the overflow chunk."""
    from deepseek_tpu_torch.models.deepseek import make_decode_loop
    from deepseek_tpu_torch.parallel.sharding import shard_cache, shard_params
    mesh = make_mesh(**shape)
    out = {"rows": (mesh.data_index, mesh.expert_index, mesh.tensor_index)}
    for model, temps in (("tiny", (0.0, 0.8)), ("q3k", (0.0,))):
        params, cfg = _port_model(ckpts[model])
        sp = shard_params(params, cfg, mesh)
        loop = make_decode_loop(cfg, BLOCK, mesh=mesh)
        for t in temps:
            cache = shard_cache(KVCache(**{n: torch.from_numpy(a.copy())
                                           for n, a in caches[model].items()}), cfg, mesh, sp)
            assert cache.batch == B // mesh.data
            tok = torch.from_numpy(_prompts()[:, -1:].copy())
            key, pos, toks = prng.PRNGKey(3), POS0.copy(), []
            for _ in range(2):
                key, sub = prng.split(key)
                blk, logits, _ = loop(sp, cache, tok, pos, sub, np.full(B, t, np.float32),
                                      TOP_P)
                toks.append(blk.numpy())
                tok, pos = blk[:, -1:], pos + BLOCK
            out[(model, t)] = (np.concatenate(toks, 1), logits.numpy())
    if mesh.expert > 1:
        out["overflow"] = _rank_overflow(mesh, ckpts["q3k"])
    return out


OVF_B, OVF_T = 16, 16        # a data shard's chunk: 512 token-expert pairs


def _rank_overflow(mesh, ckdir):
    """A (32, 16) chunk at ep_capacity_factor 0.1, whose rows of data shard
    1 are given an exact capacity (so only shard 0 overflows locally):
    every rank must raise with the count summed over the data line."""
    from deepseek_tpu_torch.models.deepseek import EPCapacityOverflow, forward_prefill
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.ops import matmul
    from deepseek_tpu_torch.parallel.sharding import shard_cache, shard_params
    from deepseek_tpu_torch.parallel.spmd import make_ctx
    params, cfg = _port_model(ckdir)
    cfg = dataclasses.replace(cfg, ep_capacity_factor=0.1)
    sp = shard_params(params, cfg, mesh)
    ctx = make_ctx(cfg, mesh)
    if mesh.data_index == 1:
        exact = matmul.ep_prefill_capacity
        matmul.ep_prefill_capacity = lambda n, ep, cf, tile=128: exact(n, ep, 0.0, tile)
    toks = np.random.default_rng(77).integers(3, 300, (2 * OVF_B, OVF_T))
    cache = shard_cache(init_cache(cfg, batch=2 * OVF_B), cfg, mesh, sp)
    rows = ctx.data_rows(2 * OVF_B)
    try:
        with torch.inference_mode():
            forward_prefill(sp, cache, torch.from_numpy(toks[rows].copy()), 0, cfg, "last",
                            ctx)
        return None
    except EPCapacityOverflow as exc:
        return int(str(exc).split()[0])


def _jax_model(ckdir):
    from deepseek_tpu.engine import Engine as JaxEngine
    jeng = JaxEngine(ckdir, seed=0)
    return jeng.params, dataclasses.replace(jeng.cfg, compute_dtype="float32",
                                            kv_cache_dtype="float16")


def _jax_hydrated(jparams, jcfg):
    import jax.numpy as jnp
    from deepseek_tpu.models import init_cache, make_forward
    pre = make_forward(jcfg, prefill=True, logits_mode="none")
    _, cache = pre(jparams, init_cache(jcfg, batch=B), jnp.asarray(_prompts(), jnp.int32), 0)
    return {f.name: np.asarray(getattr(cache, f.name)) for f in dataclasses.fields(cache)
            if getattr(cache, f.name) is not None}


def _jax_loop(jparams, jcfg, cache_np, temperature, shape=None):
    """The JAX decode loop, unsharded or over a JAX mesh, two blocks from
    the hydrated cache: (tokens (B, 8), last logits)."""
    import jax
    import jax.numpy as jnp
    from deepseek_tpu.models.deepseek import make_decode_loop as jax_loop
    from deepseek_tpu.models.kvcache import KVCache as JaxCache
    cache = JaxCache(**{f.name: (jnp.asarray(cache_np[f.name]) if f.name in cache_np
                                 else None) for f in dataclasses.fields(JaxCache)})
    params = jparams
    if shape is None:
        loop = jax_loop(jcfg, BLOCK)
    else:
        from deepseek_tpu.parallel import make_mesh as jax_mesh
        from deepseek_tpu.parallel import shard_cache, shard_params
        mesh = jax_mesh(**shape)
        params = shard_params(jparams, jcfg, mesh)
        cache = shard_cache(cache, jcfg, mesh)
        loop = jax_loop(jcfg, BLOCK, mesh=mesh, params=jparams, cache=cache)
    key, tok, pos, toks = jax.random.PRNGKey(3), jnp.asarray(_prompts()[:, -1:], jnp.int32), \
        jnp.asarray(POS0, jnp.int32), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        blk, logits, cache = loop(params, cache, tok, pos, sub,
                                  jnp.full((B,), temperature, jnp.float32),
                                  jnp.asarray(TOP_P))
        toks.append(np.asarray(blk))
        tok, pos = blk[:, -1:], pos + BLOCK
    return np.concatenate(toks, 1), np.asarray(logits)


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data_axis"))
    ckpts = {"tiny": _tiny_ckpt(root), "q3k": _q3k_ckpt(root)}
    jax_models = {m: _jax_model(d) for m, d in ckpts.items()}
    caches = {m: _jax_hydrated(*jm) for m, jm in jax_models.items()}
    runs = {name: launch(_rank_loop, math.prod(shape.values()), shape, ckpts, caches,
                         timeout=600)
            for name, shape in LOOP_MESHES.items()}
    return dict(runs=runs, jax=jax_models, caches=caches, ckpts=ckpts)


_JAX_LOOPS = {}


def _want(loop_runs, model, temperature, shape):
    key = (model, temperature, None if shape is None else tuple(sorted(shape.items())))
    if key not in _JAX_LOOPS:
        _JAX_LOOPS[key] = _jax_loop(*loop_runs["jax"][model], loop_runs["caches"][model],
                                    temperature, shape)
    return _JAX_LOOPS[key]


def _check_ranks(ranks, key, want, exact_logits=True):
    toks, logits = want
    for res in ranks:
        got_t, got_l = res[key]
        assert got_t.shape == (B, 2 * BLOCK) and got_l.shape == logits.shape
        np.testing.assert_array_equal(got_t, toks)
        np.testing.assert_allclose(got_l, logits, rtol=0, atol=TOL * np.abs(logits).max())
        np.testing.assert_array_equal(got_t, ranks[0][key][0])
        if exact_logits:
            np.testing.assert_array_equal(got_l, ranks[0][key][1])


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("mesh", list(LOOP_MESHES))
def test_decode_loop_matches_jax_mesh(loop_runs, mesh, temperature):
    """The f32 tiny checkpoint: two blocks of four steps over B = 4 rows at
    per-row positions and top-p; every rank returns the whole batch's
    tokens, those of the JAX loop over the same mesh (at 0.8 each data
    shard draws with its folded key), and its last logits within 1e-3 of
    max|logit|; the ranks' tokens and logits the same bits."""
    want = _want(loop_runs, "tiny", temperature, LOOP_MESHES[mesh])
    _check_ranks(loop_runs["runs"][mesh], ("tiny", temperature), want)


@pytest.mark.parametrize("mesh", list(LOOP_MESHES))
def test_decode_loop_packed_q3k(loop_runs, mesh):
    """Packed Q3_K at temperature 0: the unsharded JAX loop's tokens and
    last logits (1e-3 of max|logit|); at data=2 x expert=2 also the JAX
    mesh loop's (its expert cut keeps whole planes)."""
    ranks = loop_runs["runs"][mesh]
    _check_ranks(ranks, ("q3k", 0.0), _want(loop_runs, "q3k", 0.0, None))
    if mesh == "data2-expert2":
        _check_ranks(ranks, ("q3k", 0.0), _want(loop_runs, "q3k", 0.0, LOOP_MESHES[mesh]))


def test_decode_loop_takes_the_whole_batch(loop_runs):
    """A data shard's rows alone are refused: the loop takes the whole
    batch beside this rank's cache rows."""
    from deepseek_tpu_torch.models.deepseek import make_decode_loop
    from deepseek_tpu_torch.models.kvcache import init_cache
    _, cfg = _port_model(loop_runs["ckpts"]["tiny"])
    loop = make_decode_loop(cfg, 2, mesh=Mesh(data=2, data_index=0))
    with pytest.raises(ValueError, match="whole batch"):
        loop(None, init_cache(cfg, batch=2), torch.zeros((2, 1), dtype=torch.int64), 0,
             prng.PRNGKey(0), 0.0, 1.0)


def test_ngram_spec_rounds_take_the_whole_batch(loop_runs):
    """The batched n-gram rounds refuse a data shard's rows alone, as the
    decode loop does."""
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.speculative import make_batched_ngram_spec_rounds
    _, cfg = _port_model(loop_runs["ckpts"]["tiny"])
    fn = make_batched_ngram_spec_rounds(cfg, 2, 1, 16, mesh=Mesh(data=2, data_index=0))
    with pytest.raises(ValueError, match="whole batch"):
        fn(None, init_cache(cfg, batch=2), torch.zeros((2, 16), dtype=torch.int64),
           torch.zeros((2, 1), dtype=torch.int64), np.zeros(2, dtype=np.int64),
           prng.PRNGKey(0), 0.0, 1.0, True, 0, 0.0)


def test_ep_overflow_raises_on_every_data_shard(loop_runs):
    """Only data shard 0's rows overflow the EP capacity; the count summed
    over the data line makes all four ranks raise, with the same count."""
    counts = [r["overflow"] for r in loop_runs["runs"]["data2-expert2"]]
    assert all(c is not None and c > 0 for c in counts)
    assert len(set(counts)) == 1
