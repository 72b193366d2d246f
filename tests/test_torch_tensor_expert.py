"""The port's tensor (TP) and expert (EP) mesh axes against the JAX package.

- Slicing: every weight kind (plain, blockwise and per-tensor fp8, packed,
  turbo and nibble Q2_K/Q3_K) cut into rank parts along its rows, columns
  and experts: the parts' dequantized weights concatenated equal the whole
  tensor's bit for bit, a ragged fp8 grid's partial edge block included; a
  cut off the block boundary refuses (the group stays whole).
- Unfusing: ``unfuse_projections`` of the JAX-fused params carried across
  equals the JAX ``unfuse_projections`` bit for bit (fp8 with the shared
  expert folded, packed Q3_K, nibble Q3_K row-permuted).
- The forward at tensor=2, expert=2, expert=2 x tensor=2 and tensor=2 x
  seq=2 (gloo ranks, ``parallel/launch.py``; one launch a mesh runs every
  scenario): absorbed and hybrid MLA over packed Q3_K with noaux_tc
  routing, MHA in F16 and in F8E5M2 with a ragged dense w2, f16 and int8
  caches, prefill chunks and decode past the window, against the
  unsharded JAX ``make_forward`` in f32 compute: logits within 1e-3 of
  max|logit|, the same bits on every rank. The decode loop: greedy tokens
  (near-ties allowed) and tokens at 0.8 equal the unsharded JAX loop's at
  the same keys, on every rank, with no host read inside an EP block.
- EP prefill capacity: exact at factor 0; a small factor's overflow count
  equals JAX's (``tests/test_sharding.py:625``) and raises
  ``EPCapacityOverflow`` through the forward.
- EP dispatch: local ids, weights, tokens, aliases and each shard's count
  of distinct experts equal JAX's ``dispatch_pairs`` (``tests/
  test_sharding.py:344-410``).
- The mesh: coordinates and subgroups of ``make_mesh``,
  ``default_mesh_shape`` as JAX's, ``make_ctx`` raising where JAX's does.

The ranks import this module to find their bodies, so it imports JAX only
inside the functions that build the reference.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from deepseek_tpu_torch.models.deepseek import (
    EPCapacityOverflow, forward_decode, forward_prefill, local_heads, make_decode_loop,
)
from deepseek_tpu_torch.models.kvcache import init_cache as torch_cache
from deepseek_tpu_torch.ops import prng
from deepseek_tpu_torch.parallel.launch import launch
from deepseek_tpu_torch.parallel.mesh import Mesh, default_mesh_shape, make_mesh
from deepseek_tpu_torch.parallel.sharding import shard_cache, shard_params
from deepseek_tpu_torch.parallel.spmd import SpmdCtx, make_ctx
from deepseek_tpu_torch.quant.qtensor import (
    Fp8Tensor, KNibbleTensor, PlainTensor, Q2KTensor, Q3KTensor, q2k_to_turbo,
    q3k_to_turbo, slice_qt,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

MESHES = {"tensor2": dict(tensor=2), "expert2": dict(expert=2),
          "expert2-tensor2": dict(expert=2, tensor=2),
          "tensor2-seq2": dict(tensor=2, seq=2)}
# (checkpoint, cache dtype, strip the factor weights: absorbed prefill)
SCENARIOS = {"q3k-hybrid": ("q3k", "float16", False),
             "q3k-absorbed": ("q3k", "float16", True),
             "q3k-int8": ("q3k", "int8", False),
             "mha-f16": ("mha", "float16", False),
             "mha-f16-int8": ("mha", "int8", False),
             "mha-fp8-ragged": ("fp8", "float16", False)}
CHUNKS = ((8, "all"), (8, "last"))        # positions 0..15 of the 24-slot window
N_TOKENS = 30                             # decode 16..29: the ring wraps at 24
LOOP_PROMPT, LOOP_BLOCK = 13, 8
CAP_B, CAP_T = 32, 16                     # an EP prefill batch of 1024 pairs


def _rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# 1. slicing every weight kind
# ---------------------------------------------------------------------------

def _u8(g, *shape):
    return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)


def _kinds():
    """One 3-D (experts, rows, cols) weight of every kind, 512 columns."""
    g = torch.Generator().manual_seed(5)
    E, d, n = 4, 96, 512
    f = lambda *s: torch.rand(s, generator=g)
    q2 = Q2KTensor(qs=_u8(g, E, d, n // 4), sm=_u8(g, E, d, n // 16),
                   d=f(E, d, n // 256) * 0.01, dmin=f(E, d, n // 256) * 0.01)
    q3 = Q3KTensor(qs=_u8(g, E, d, n // 4), hm=_u8(g, E, d, n // 8),
                   sc=torch.randint(-32, 32, (E, d, n // 16), generator=g,
                                    dtype=torch.int8), d=f(E, d, n // 256) * 0.01)
    nib = lambda c, off: KNibbleTensor(p=_u8(g, E, d, n // 2),
                                       a=(f(E, d, n // 16) * 0.01).bfloat16(),
                                       c=None if c is None else c.bfloat16(), off=off)
    fp8 = lambda b: Fp8Tensor(data=(torch.randn((E, d, n), generator=g) * 0.1)
                              .to(torch.float8_e5m2), scale=f(E, -(-d // b[0]),
                                                              -(-n // b[1])) + 0.5,
                              block_size=b)
    return {"plain": PlainTensor(data=torch.randn((E, d, n), generator=g)),
            "fp8-128": fp8((128, 128)),       # 96 rows: one partial row block
            "fp8-32": fp8((32, 32)),
            "fp8-per-tensor": Fp8Tensor(data=(torch.randn((E, d, n), generator=g) * 0.1)
                                        .to(torch.float8_e5m2), scale=f(E, 1, 1) + 0.5),
            "q2k": q2, "q3k": q3, "q2k-turbo": q2k_to_turbo(q2),
            "q3k-turbo": q3k_to_turbo(q3),
            "q2k-nibble": nib(f(E, d, n // 16) * 0.01, 0), "q3k-nibble": nib(None, 4)}


@pytest.mark.parametrize("kind", list(_kinds()))
@pytest.mark.parametrize("dim,n", [("rows", 2), ("rows", 3), ("cols", 2), ("experts", 2),
                                   ("experts", 4)])
def test_rank_slices_concatenate_to_the_whole(kind, dim, n):
    """The n parts' dequantized weights, concatenated in rank order, equal
    the whole tensor's bit for bit wherever every part cuts; a part that
    would split a block refuses (None) on every rank, and only where the
    kind has a block there."""
    qt = _kinds()[kind]
    whole = qt.dequant(torch.float32)
    axis = {"rows": -2, "cols": -1, "experts": 0}[dim]
    size = whole.shape[axis]
    s = size // n
    parts = [slice_qt(qt, dim, i * s, (i + 1) * s) for i in range(n)]
    blocked = (kind.startswith("fp8-") and kind != "fp8-per-tensor" and dim != "experts"
               and s % qt.block_size[0 if dim == "rows" else 1]) or \
        (kind.startswith("q") and dim == "cols" and s % 256)
    if blocked:
        assert all(p is None for p in parts)
        return
    assert all(p is not None for p in parts)
    got = torch.cat([p.dequant(torch.float32) for p in parts], dim=axis)
    assert torch.equal(got, whole)
    for p in parts:                      # contiguous copies, not views
        for v in vars(p).values():
            if isinstance(v, torch.Tensor) and v.dim():
                assert v.is_contiguous()


def test_ragged_fp8_grid_edge_block():
    """A 300-column blockwise fp8 weight (3 column blocks, the last 44 wide):
    cut at 128 and 256 the parts carry 1, 1 and 1 (partial) blocks and
    concatenate to the whole; a cut at 150 refuses (as the V2-Lite dense w2
    at tensor=2: 5472 of 10944 columns, no multiple of 128)."""
    g = torch.Generator().manual_seed(6)
    qt = Fp8Tensor(data=(torch.randn((40, 300), generator=g) * 0.1).to(torch.float8_e5m2),
                   scale=torch.rand((1, 3), generator=g) + 0.5, block_size=(128, 128))
    parts = [slice_qt(qt, "cols", lo, hi) for lo, hi in ((0, 128), (128, 256), (256, 300))]
    assert [tuple(p.scale.shape) for p in parts] == [(1, 1)] * 3
    assert torch.equal(torch.cat([p.dequant() for p in parts], -1), qt.dequant())
    assert slice_qt(qt, "cols", 0, 150) is None and slice_qt(qt, "cols", 150, 300) is None


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _convert(root, kind):
    """Tiny 2-layer MoE checkpoints (one dense, one MoE layer; 4 heads, 4
    experts, top-2, a 24-slot window) from a fake HF directory:

    - q3k: absorbed MLA with the factor weights, packed Q3_K, V3 noaux_tc
      routing; widths whose halves are superblocks (wo 512 -> 256 columns
      a rank, the dense and shared w2 512 -> 256), the lm_head cut in rows;
    - mha: decompressed MHA in F16;
    - fp8: decompressed MHA in F8E5M2 with 32x32 blocks: the heads split
      (64 -> 32 wo columns a rank), the dense FFN's 80-wide hidden does not
      (40 a rank: the group stays whole), nor the 300-row lm_head's vocab
      rows (150)."""
    from deepseek_tpu import convert as cv
    from tests.util_hf import hf_config, hf_weights, write_hf_dir
    if kind == "q3k":
        cfg = hf_config(dim=256, hidden=512, q_lora=256, kv_lora=256, nope=128, rope=64,
                        v_dim=128, moe_inter=512, layers=2, vocab=300, heads=4,
                        n_experts=4, n_active=2, arch="DeepseekV3ForCausalLM",
                        topk_method="noaux_tc", scoring="sigmoid")
        kw = dict(quant="q3_k", use_mla=True)
    elif kind == "mha":
        cfg = hf_config(dim=64, hidden=96, q_lora=0, kv_lora=32, nope=16, rope=8,
                        v_dim=16, moe_inter=24, layers=2, vocab=300, heads=4,
                        n_experts=4, n_active=2)
        kw = dict(use_mla=False)
    else:
        cfg = hf_config(dim=64, hidden=80, q_lora=0, kv_lora=32, nope=16, rope=16,
                        v_dim=16, moe_inter=64, layers=2, vocab=300, heads=4,
                        n_experts=4, n_active=2)
        kw = dict(use_mla=False, quant="f8e5m2", bsize=32)
    hf_dir = os.path.join(root, kind, "hf")
    write_hf_dir(hf_dir, cfg, hf_weights(cfg, seed=71, scale=0.1))
    out = os.path.join(root, kind, "ck")
    cv.convert(hf_dir, out, **kw)
    return out


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_ep"))
    return {k: _convert(root, k) for k in ("q3k", "mha", "fp8")}


def _strip_factors(params):
    return dataclasses.replace(params, layers=[
        dataclasses.replace(lp, wq_b=None, wkv_b=None) for lp in params.layers])


# ---------------------------------------------------------------------------
# 2. unfusing
# ---------------------------------------------------------------------------

def _leaves(obj, prefix=""):
    """(path, numpy bits) of every array in a params tree of either package."""
    if obj is None:
        return []
    if isinstance(obj, (list, tuple)):
        return [x for i, o in enumerate(obj) for x in _leaves(o, f"{prefix}[{i}]")]
    if dataclasses.is_dataclass(obj):
        out = []
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, (int, tuple)):          # off, rowperm, block_size
                out.append((f"{prefix}.{f.name}", np.asarray(v)))
            else:
                out.extend(_leaves(v, f"{prefix}.{f.name}"))
        return out
    if isinstance(obj, torch.Tensor):
        t = obj.cpu()
        if t.dtype in (torch.bfloat16, torch.float8_e5m2):
            t = t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.uint8)
        return [(prefix, t.numpy())]
    a = np.asarray(obj)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    elif a.dtype.name.startswith("float8"):
        a = a.view(np.uint8)
    return [(prefix, a)]


@pytest.mark.parametrize("case", ["fp8-folded", "q3k-packed", "q3k-nibble-rowperm"])
def test_unfuse_projections_matches_jax(ckpts, case, monkeypatch):
    from deepseek_tpu.engine import Engine as JaxEngine
    from deepseek_tpu.models.loader import unfuse_projections as jax_unfuse
    from deepseek_tpu_torch.config import ModelConfig
    from deepseek_tpu_torch.models.loader import params_from_reference, unfuse_projections

    if case == "q3k-nibble-rowperm":
        monkeypatch.setenv("DSEEK_FUSED_FFN", "1")
    kw = dict(kquant_runtime="nibble") if "nibble" in case else {}
    jeng = JaxEngine(ckpts["fp8" if case.startswith("fp8") else "q3k"], seed=0, **kw)
    fused = jeng.params
    lp = fused.layers[1]
    if case == "fp8-folded":
        assert lp.w13s is not None and lp.w2s is not None
    if case == "q3k-packed":
        assert fused.layers[0].wcr is not None and fused.layers[0].wkvq is not None
        assert lp.shared_w13 is not None
    if case == "q3k-nibble-rowperm":
        assert any(getattr(getattr(lp, f), "rowperm", 0) for f in ("w13s", "w13")
                   if getattr(lp, f) is not None)
    monkeypatch.delenv("DSEEK_FUSED_FFN", raising=False)
    cfg = ModelConfig.from_metadata(jeng.data.metadata)
    got = _leaves(unfuse_projections(params_from_reference(fused, "cpu"), cfg))
    want = _leaves(params_from_reference(jax_unfuse(fused, jeng.cfg), "cpu"))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    names = {p.split(".")[-2] for p, _ in got if "layers" in p}
    assert not names & {"w13", "w13s", "w2s", "wcr", "wkvq", "shared_w13"}


# ---------------------------------------------------------------------------
# 3. the forward over the meshes: the ranks
# ---------------------------------------------------------------------------

def _model(ckdir, kv, strip):
    from deepseek_tpu_torch.engine import Engine
    eng = Engine(ckdir, device="cpu", seed=0)
    cfg = dataclasses.replace(eng.cfg, compute_dtype="float32", kv_cache_dtype=kv)
    return (_strip_factors(eng.params) if strip else eng.params), cfg


def _path(params, cfg, toks, ctx, mesh=None):
    """Prefill CHUNKS then decode to the end of toks: the logits of each
    chunk (every row for "all", the last for "last") and of each step. On a
    mesh the cache is made at the rank's head count, then cut to its
    window slots."""
    if mesh is None:
        cache = torch_cache(cfg)
    else:
        cache = shard_cache(torch_cache(cfg, heads=local_heads(params.layers[0], cfg)),
                            cfg, mesh, params)
    out, pos = [], 0
    with torch.inference_mode():
        for T, mode in CHUNKS:
            out.append(forward_prefill(params, cache, torch.tensor([toks[pos:pos + T]]),
                                       pos, cfg, mode, ctx)[0].numpy())
            pos += T
        for p in range(pos, len(toks)):
            out.append(forward_decode(params, cache, torch.tensor([[toks[p]]]), p, cfg,
                                      ctx)[0].numpy())
    return out, cache


def _layout(params, cfg):
    """What a rank holds: wo's columns, each FFN's w2 in-features (dense,
    shared) or expert count, the lm_head's rows."""
    out = {"lm_head": params.lm_head.shape[0]}
    for l, lp in enumerate(params.layers):
        out[f"wo{l}"] = lp.wo.shape[-1]
        out[f"w2_{l}"] = lp.w2.shape[0] if cfg.is_moe_layer(l) else lp.w2.shape[-1]
        if lp.shared_w2 is not None:
            out[f"shared_w2_{l}"] = lp.shared_w2.shape[-1]
    return out


def _count_host_reads(fn):
    """fn() with the tensor methods that read a value back to the host
    counted (the spies are removed after)."""
    calls = {"n": 0}
    saved = {}
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__",
                 "__index__"):
        saved[name] = orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, **kw):
            calls["n"] += 1
            return _orig(self, *a, **kw)

        setattr(torch.Tensor, name, spy)
    try:
        out = fn()
    finally:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)
    return out, calls["n"]


def _rank_run(rank, world, shape, ckpts, toks, loop_toks):
    import torch.distributed as dist
    mesh = make_mesh(**shape)
    groups = {}
    for ax in ("expert", "tensor", "seq"):
        g = getattr(mesh, f"{ax}_group")
        if g is not None:
            t = torch.tensor([float(rank)])
            dist.all_reduce(t, group=g)
            groups[ax] = (float(t), dist.get_world_size(g))
    out = dict(coords=(mesh.expert_index, mesh.tensor_index, mesh.seq_index),
               groups=groups, scenarios={})
    for name, (ck, kv, strip) in SCENARIOS.items():
        params, cfg = _model(ckpts[ck], kv, strip)
        sp = shard_params(params, cfg, mesh)
        logits, cache = _path(sp, cfg, toks, make_ctx(cfg, mesh), mesh)
        out["scenarios"][name] = dict(
            logits=logits, layout=_layout(sp, cfg),
            cache={f.name: tuple(getattr(cache, f.name).shape)
                   for f in dataclasses.fields(cache) if getattr(cache, f.name) is not None})
    # the decode loop over the q3k model (hybrid prefill, f16 cache)
    params, cfg = _model(ckpts["q3k"], "float16", False)
    sp, ctx = shard_params(params, cfg, mesh), make_ctx(cfg, mesh)
    loops, reads = {}, []
    for temperature in (0.0, 0.8):
        cache = shard_cache(torch_cache(cfg), cfg, mesh, sp)
        with torch.inference_mode():
            forward_prefill(sp, cache, torch.tensor([loop_toks[:8]]), 0, cfg, "none", ctx)
            forward_prefill(sp, cache, torch.tensor([loop_toks[8:LOOP_PROMPT]]), 8, cfg,
                            "none", ctx)
        loop = make_decode_loop(cfg, LOOP_BLOCK, mesh=mesh)
        key, tok, pos, got = prng.PRNGKey(5), torch.tensor([[loop_toks[LOOP_PROMPT]]]), \
            LOOP_PROMPT, []
        for _ in range(2):
            key, sub = prng.split(key)
            (blk, _, _), n = _count_host_reads(
                lambda: loop(sp, cache, tok, pos, sub, temperature, 0.9))
            reads.append(n)
            got.append(blk.numpy())
            tok, pos = blk[:, -1:], pos + LOOP_BLOCK
        loops[temperature] = np.concatenate(got, 1)
    out.update(loops=loops, loop_host_reads=reads)
    if mesh.expert > 1:
        out["capacity"] = _rank_capacity(mesh, ckpts["q3k"])
    return out


def _cap_tokens():
    return np.random.default_rng(77).integers(3, 300, (CAP_B, CAP_T))


def _rank_capacity(mesh, ckdir):
    """A (32, 16) prefill chunk (1024 token-expert pairs: the grouped path)
    at factor 0 (exact: its last-row logits) and at 0.1 (capacity 128
    pairs, 3 tiles of the 2 local experts: overflows and raises)."""
    from deepseek_tpu_torch.engine import Engine
    eng = Engine(ckdir, device="cpu", seed=0)
    out = {}
    for cf in (0.0, 0.1):
        cfg = dataclasses.replace(eng.cfg, compute_dtype="float32", ep_capacity_factor=cf)
        sp = shard_params(eng.params, cfg, mesh)
        cache = shard_cache(torch_cache(cfg, batch=CAP_B), cfg, mesh, sp)
        try:
            with torch.inference_mode():
                lg = forward_prefill(sp, cache, torch.from_numpy(_cap_tokens()), 0, cfg,
                                     "last", make_ctx(cfg, mesh))
            out[cf] = lg.numpy()
        except EPCapacityOverflow as exc:
            out[cf] = (str(exc), exc.cache is cache, exc.logits is not None)
    return out


@pytest.fixture(scope="module")
def mesh_runs(ckpts):
    """Every mesh's ranks, each running every scenario, the decode loop and
    (expert meshes) the capacity chunk, one launch a mesh."""
    toks = np.random.default_rng(72).integers(3, 300, N_TOKENS).tolist()
    loop_toks = np.random.default_rng(73).integers(3, 300, LOOP_PROMPT + 1).tolist()
    runs = {name: launch(_rank_run, math.prod(shape.values()), shape, ckpts, toks,
                         loop_toks, timeout=900)
            for name, shape in MESHES.items()}
    return dict(runs=runs, toks=toks, loop_toks=loop_toks, ckpt_dirs=ckpts)


# ---------------------------------------------------------------------------
# 3. the references and the comparisons
# ---------------------------------------------------------------------------

_JAX_CACHE = {}


def _jax_model(ckdir, kv, strip):
    from deepseek_tpu.engine import Engine as JaxEngine
    key = (ckdir, kv, strip)
    if key not in _JAX_CACHE:
        jeng = JaxEngine(ckdir, seed=0)
        jcfg = dataclasses.replace(jeng.cfg, compute_dtype="float32", kv_cache_dtype=kv)
        _JAX_CACHE[key] = (_strip_factors(jeng.params) if strip else jeng.params), jcfg
    return _JAX_CACHE[key]


def _jax_path(jparams, jcfg, toks):
    """The unsharded JAX forward over the same chunks and steps."""
    import jax.numpy as jnp
    from deepseek_tpu.models import init_cache, make_forward
    cache = init_cache(jcfg, batch=1)
    pre = make_forward(jcfg, prefill=True, logits_mode="all")
    dec = make_forward(jcfg, prefill=False)
    want, pos = [], 0
    for T, mode in CHUNKS:
        lg, cache = pre(jparams, cache, jnp.asarray([toks[pos:pos + T]], jnp.int32), pos)
        lg = np.asarray(lg[0])
        want.append(lg[-1] if mode == "last" else lg)
        pos += T
    for p in range(pos, len(toks)):
        lg, cache = dec(jparams, cache, jnp.asarray([[toks[p]]], jnp.int32), p)
        want.append(np.asarray(lg[0]))
    return want


def _expected_layout(name, mesh):
    """What each rank must hold under ``mesh``: the heads split at tensor=2
    (every model), the dense FFN but for fp8's ragged 80-wide hidden, the
    shared expert, the lm_head's vocab but for fp8's (150 rows is no
    multiple of its 32-row blocks), the experts at expert=2."""
    tp, ep = MESHES[mesh].get("tensor", 1), MESHES[mesh].get("expert", 1)
    ck = SCENARIOS[name][0]
    full = {"q3k": dict(wo=512, dense=512, shared=512),
            "mha": dict(wo=64, dense=96, shared=24),
            "fp8": dict(wo=64, dense=80, shared=64)}[ck]
    return {"lm_head": 300 // (tp if ck != "fp8" else 1),
            "wo0": full["wo"] // tp, "wo1": full["wo"] // tp,
            "w2_0": full["dense"] // (tp if ck != "fp8" else 1),
            "w2_1": 4 // ep, "shared_w2_1": full["shared"] // tp}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_forward_matches_unsharded_jax(mesh_runs, mesh, scenario):
    """Each chunk's logits (every row of an "all" chunk) and each decode
    step's, past the window's wrap, within 1e-3 of max|logit| of the
    unsharded JAX forward in f32 compute; equal bit for bit on every rank;
    each rank holding its slice (``_expected_layout``) and, for MHA, the
    cache of its heads and window slots."""
    ck, kv, strip = SCENARIOS[scenario]
    want = _jax_path(*_jax_model(mesh_runs["ckpt_dirs"][ck], kv, strip), mesh_runs["toks"])
    ranks = mesh_runs["runs"][mesh]
    for r in ranks:
        got = r["scenarios"][scenario]
        assert len(got["logits"]) == len(want)
        for g, w in zip(got["logits"], want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * np.abs(w).max())
        assert got["layout"] == _expected_layout(scenario, mesh)
        for g, g0 in zip(got["logits"], ranks[0]["scenarios"][scenario]["logits"]):
            np.testing.assert_array_equal(g, g0)
        heads = 4 // MESHES[mesh].get("tensor", 1)
        slots = 24 // MESHES[mesh].get("seq", 1)
        cache = got["cache"]
        if ck == "q3k":
            assert cache["ckv"][2] == slots and "k" not in cache
        else:
            assert cache["k"][2:4] == (slots, heads) and cache["v"][2:4] == (slots, heads)
            if kv == "int8":
                assert cache["k_s"][2:] == (slots, heads)
                assert cache["sink_k"][3] == heads


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_decode_loop_matches_unsharded_jax(mesh_runs, mesh, temperature):
    """``make_decode_loop(cfg, 8, mesh=mesh)`` after a 13-token prompt, two
    blocks with keys split from PRNGKey(5): at 0.8 the JAX loop's tokens at
    the same keys, greedy the JAX loop's or, from a step whose two
    candidates lie within 1e-3 of max|logit| in the JAX teacher-forced
    logits, free to differ (a near-tie); the same tokens on every rank; no
    block read a value back to the host."""
    import jax
    import jax.numpy as jnp
    from deepseek_tpu.models import init_cache, make_forward
    from deepseek_tpu.models.deepseek import make_decode_loop as jax_loop

    jparams, jcfg = _jax_model(mesh_runs["ckpt_dirs"]["q3k"], "float16", False)
    toks = mesh_runs["loop_toks"]
    cache = init_cache(jcfg, batch=1)
    pre = make_forward(jcfg, prefill=True, logits_mode="none")
    _, cache = pre(jparams, cache, jnp.asarray([toks[:8]], jnp.int32), 0)
    _, cache = pre(jparams, cache, jnp.asarray([toks[8:LOOP_PROMPT]], jnp.int32), 8)
    loop = jax_loop(jcfg, LOOP_BLOCK)
    key, tok, pos, want = jax.random.PRNGKey(5), jnp.asarray([[toks[LOOP_PROMPT]]],
                                                             jnp.int32), LOOP_PROMPT, []
    for _ in range(2):
        key, sub = jax.random.split(key)
        blk, _, cache = loop(jparams, cache, tok, pos, sub, temperature, 0.9)
        want.append(np.asarray(blk))
        tok, pos = blk[:, -1:], pos + LOOP_BLOCK
    want = np.concatenate(want, 1)[0]
    ranks = mesh_runs["runs"][mesh]
    got = ranks[0]["loops"][temperature][0]
    for r in ranks:
        np.testing.assert_array_equal(r["loops"][temperature][0], got)
        assert r["loop_host_reads"] == [0, 0, 0, 0]
    if temperature > 0 or np.array_equal(got, want):
        np.testing.assert_array_equal(got, want)
        return
    # greedy: the first differing step must be a near-tie of the JAX logits
    i = int(np.argmax(got != want))
    teacher = _jax_path(jparams, jcfg, toks[:LOOP_PROMPT + 1] + list(want[:i]))[-1]
    assert teacher[want[i]] - teacher[got[i]] <= 1e-3 * np.abs(teacher).max()


def test_mesh_coordinates_and_groups(mesh_runs):
    """Rank r sits at np.arange(n).reshape(data, expert, tensor, seq)'s
    coordinates of r, and each axis subgroup holds the ranks of its line
    (the all-reduced rank ids sum to the line's)."""
    for name, shape in MESHES.items():
        sizes = (1, shape.get("expert", 1), shape.get("tensor", 1), shape.get("seq", 1))
        grid = np.arange(math.prod(sizes)).reshape(sizes)
        for r, res in enumerate(mesh_runs["runs"][name]):
            c = np.unravel_index(r, sizes)
            assert res["coords"] == (c[1], c[2], c[3])
            for ax, i in (("expert", 1), ("tensor", 2), ("seq", 3)):
                if sizes[i] == 1:
                    assert ax not in res["groups"]
                    continue
                idx = list(c)
                idx[i] = slice(None)
                line = grid[tuple(idx)]
                assert res["groups"][ax] == (float(line.sum()), sizes[i])


# ---------------------------------------------------------------------------
# 4. EP prefill capacity
# ---------------------------------------------------------------------------

def _jax_capacity(cf, idx, w1, w2, w3, xb, wts):
    """The JAX grouped FFN over make_mesh(expert=2) (tests/test_sharding.py
    :610-645): (out, overflow count)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from deepseek_tpu.config import ActivationType
    from deepseek_tpu.ops.matmul import grouped_expert_ffn
    from deepseek_tpu.parallel.mesh import make_mesh as jax_mesh
    from deepseek_tpu.parallel.spmd import SpmdCtx as JaxCtx
    from deepseek_tpu.quant.qtensor import PlainTensor as JPlain

    ctx = JaxCtx(ep=2, ep_capacity_factor=cf)

    def body(w1, w2, w3, xb, wts, idx):
        return grouped_expert_ffn(JPlain(data=w1), JPlain(data=w2), JPlain(data=w3), xb,
                                  wts, idx, ActivationType.SILU, ctx, interpret=True)

    f = jax.jit(jax.shard_map(body, mesh=jax_mesh(data=1, expert=2, tensor=1),
                              in_specs=(P("expert"),) * 3 + (P(), P(), P()),
                              out_specs=(P(), P()), check_vma=False))
    out, ovf = f(*(jnp.asarray(a) for a in (w1, w2, w3, xb, wts, idx)))
    return np.asarray(out), int(ovf)


@pytest.mark.parametrize("case", ["balanced-exact", "balanced-2.0", "skewed-0.5"])
def test_ep_prefill_capacity_matches_jax(case):
    """The port's grouped FFN on each of two expert shards (its tables the
    shard's 2 of 4 experts), the shards' outputs and overflow counts
    summed, against the JAX shard_map run: the same count (0 when
    balanced; N - 128 = 128 when every pair routes to expert 0 at factor
    0.5, capacity 128) and outputs within 1e-4 of their scale."""
    from deepseek_tpu_torch.config import ActivationType
    from deepseek_tpu_torch.ops.matmul import ep_prefill_capacity, grouped_expert_ffn

    E, m, dim, B, T, k = 4, 128, 128, 1, 128, 2
    N = B * T * k
    w1, w2, w3 = _rnd((E, m, dim), 50, 0.1), _rnd((E, dim, m), 51, 0.1), \
        _rnd((E, m, dim), 52, 0.1)
    xb, wts = _rnd((B, T, dim), 53, 0.3), np.random.default_rng(54).uniform(
        size=(B, T, k)).astype(np.float32)
    rng = np.random.default_rng(55)
    idx = (np.zeros((B, T, k), np.int32) if case.startswith("skewed")
           else rng.integers(0, E, (B, T, k)).astype(np.int32))
    cf = {"balanced-exact": 0.0, "balanced-2.0": 2.0, "skewed-0.5": 0.5}[case]
    assert ep_prefill_capacity(N, 2, 0.5) == 128 and ep_prefill_capacity(N, 1, 0.0) == 256
    want, want_ovf = _jax_capacity(cf, idx, w1, w2, w3, xb, wts)
    out, ovf = 0.0, 0
    for s in range(2):
        ctx = SpmdCtx(ep=2, eidx=s, ep_capacity_factor=cf)
        sl = slice(2 * s, 2 * s + 2)
        counted = []
        out = out + grouped_expert_ffn(
            PlainTensor(torch.from_numpy(w1[sl])), PlainTensor(torch.from_numpy(w2[sl])),
            PlainTensor(torch.from_numpy(w3[sl])), torch.from_numpy(xb),
            torch.from_numpy(wts), torch.from_numpy(idx), ActivationType.SILU, ctx=ctx,
            ovf=counted).numpy()
        ovf += int(counted[0])
    assert ovf == want_ovf == (N - 128 if case.startswith("skewed") else 0)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_ep_prefill_capacity_through_the_forward(mesh_runs):
    """At expert=2 (and 2 x tensor 2) a (32, 16) chunk: at factor 0 the
    last rows' logits within 1e-3 of the unsharded JAX prefill's; at 0.1
    EPCapacityOverflow, with its positive count in the message and the
    call's cache and logits on the exception, on every rank alike."""
    import jax.numpy as jnp
    from deepseek_tpu.models import init_cache, make_forward
    jparams, jcfg = _jax_model(mesh_runs["ckpt_dirs"]["q3k"], "float16", False)
    pre = make_forward(jcfg, prefill=True, logits_mode="last")
    want, _ = pre(jparams, init_cache(jcfg, batch=CAP_B),
                  jnp.asarray(_cap_tokens(), jnp.int32), 0)
    want = np.asarray(want)
    for mesh in ("expert2", "expert2-tensor2"):
        ranks = mesh_runs["runs"][mesh]
        for r in ranks:
            got = r["capacity"][0.0]
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
            msg, same_cache, has_logits = r["capacity"][0.1]
            n = int(msg.split()[0])
            assert n > 0 and same_cache and has_logits
            assert "EP prefill capacity" in msg
            assert r["capacity"][0.1] == ranks[0]["capacity"][0.1]


# ---------------------------------------------------------------------------
# 5. EP decode dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,ep,B", [(4, 4, 4), (8, 4, 4), (8, 2, 3)])
def test_ep_dispatch_matches_jax(E, ep, B):
    """``dispatch_pairs(..., ctx=SpmdCtx(ep, eidx=s))`` on every shard
    against JAX's ``SpmdCtx.dispatch_pairs`` under shard_map over
    make_mesh(expert=ep): the same local ids (non-owned pairs aliased to
    the last owned expert), weights (0 where not owned), tokens, and so the
    same count of distinct experts a shard's expert kernel reads; every
    pair owned by exactly one shard."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from deepseek_tpu.parallel.mesh import make_mesh as jax_mesh
    from deepseek_tpu.parallel.spmd import SpmdCtx as JaxCtx
    from deepseek_tpu_torch.ops.matmul import dispatch_pairs

    k = 2
    rng = np.random.default_rng(E * 10 + ep)
    idx = rng.integers(0, E, size=(B, k)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, size=(B, k)).astype(np.float32)
    jctx = JaxCtx(ep=ep)

    def body(idx, w):
        lidx, ws, tok = jctx.dispatch_pairs(idx, w, E)
        return lidx[None], ws[None], tok[None]

    f = jax.jit(jax.shard_map(body, mesh=jax_mesh(data=1, expert=ep, tensor=1),
                              in_specs=(P(), P()), out_specs=(P("expert"),) * 3,
                              check_vma=False))
    jl, jw, jt = map(np.asarray, f(jnp.asarray(idx), jnp.asarray(w)))
    owned = 0
    for s in range(ep):
        eid, ws, tok, pair = dispatch_pairs(torch.from_numpy(idx), torch.from_numpy(w),
                                            ctx=SpmdCtx(ep=ep, eidx=s), n_experts=E)
        np.testing.assert_array_equal(eid.numpy(), jl[s])
        np.testing.assert_array_equal(ws.numpy(), jw[s])
        np.testing.assert_array_equal(tok.numpy(), jt[s])
        fetches = 1 + int((eid[1:] != eid[:-1]).sum())
        assert fetches == 1 + int((jl[s][1:] != jl[s][:-1]).sum())
        assert fetches == max(1, len(set(idx.reshape(-1)[
            (idx.reshape(-1) // (E // ep)) == s].tolist())))
        np.testing.assert_array_equal(tok.numpy(), pair.numpy() // k)
        owned += int((ws > 0).sum())
    assert owned == B * k


# ---------------------------------------------------------------------------
# 6. the mesh
# ---------------------------------------------------------------------------

def test_default_mesh_shape_matches_jax():
    from deepseek_tpu.parallel.mesh import default_mesh_shape as jax_shape
    from deepseek_tpu_torch.models.testing import (
        deepseek_v2_lite_proportions, deepseek_v3_proportions)
    from tests.util_tinymodel import tiny_config
    cfgs = [None, tiny_config(), deepseek_v2_lite_proportions(n_layers=2),
            deepseek_v3_proportions(n_layers=4)]
    for cfg in cfgs:
        for n in range(1, 17):
            assert default_mesh_shape(n, cfg) == jax_shape(n, cfg), (n, cfg)


@pytest.mark.parametrize("shape", [
    dict(tensor=3), dict(tensor=4), dict(expert=3), dict(expert=4), dict(seq=3),
    dict(tensor=2, expert=2), dict(tensor=8), dict(expert=8, tensor=2, seq=2)])
def test_make_ctx_raises_where_jax_does(shape):
    """The divisibility checks (heads, hidden width, shared-expert width,
    experts, window) raise ValueError with JAX's text where JAX's make_ctx
    does, on a tiny config whose widths make some of them fail, and pass
    where JAX's pass; a data axis raises NotImplementedError."""
    from deepseek_tpu.parallel.spmd import make_ctx as jax_make_ctx
    from deepseek_tpu_torch.config import ModelConfig
    from tests.util_tinymodel import tiny_config, tiny_metadata
    jcfg = tiny_config(use_mla=True, hidden_dim=36, moe_intermediate_size=12)
    cfg = ModelConfig.from_metadata(tiny_metadata(jcfg))
    full = {**dict(data=1, expert=1, tensor=1, seq=1), **shape}

    class JaxMesh:             # make_ctx reads the axis sizes only
        pass
    jm = JaxMesh()
    jm.shape = full
    try:
        jax_make_ctx(jcfg, jm)
        jerr = None
    except ValueError as exc:
        jerr = str(exc).split(";")[0]
    mesh = Mesh(**{k: v for k, v in full.items()})
    if jerr is None:
        ctx = make_ctx(cfg, mesh)
        assert (ctx.tp, ctx.ep, ctx.sp) == (full["tensor"], full["expert"], full["seq"])
    else:
        with pytest.raises(ValueError) as exc:
            make_ctx(cfg, mesh)
        assert str(exc.value).split(";")[0] == jerr
    ctx = make_ctx(cfg, Mesh(data=2, data_index=1))
    assert (ctx.dp, ctx.didx) == (2, 1)


def test_lm_head_tp_follows_the_vocab():
    from deepseek_tpu_torch.config import ModelConfig
    from tests.util_tinymodel import tiny_config, tiny_metadata
    cfg = ModelConfig.from_metadata(tiny_metadata(tiny_config(use_mla=True)))
    assert make_ctx(cfg, Mesh(tensor=2)).lm_head_tp
    assert not make_ctx(dataclasses.replace(cfg, vocab_size=63), Mesh(tensor=2)).lm_head_tp
    assert not make_ctx(cfg, Mesh(expert=2)).lm_head_tp
