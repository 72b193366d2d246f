"""The port's pipeline stages (``parallel/pipeline.py``) against the JAX
package's ``Pipeline`` (``tests/test_pipeline.py``'s six cases).

- ``stage_bounds`` equals the JAX function's.
- Two stages in one process (absorbed MLA and MHA, dense layer 0 on
  stage 0 and the MoE layers on stage 1): prefill and decode past the
  ring's wrap, logits within 1e-3 of max|logit| of the JAX ``Pipeline``'s
  on two virtual devices, in f32.
- Microbatched decode against the JAX microbatched decode; the persistent
  microbatch caches split once and merge back on a whole-batch call.
- PP x TP and PP x EP: two stages, each a tensor=2 or expert=2 mesh, four
  gloo ranks (``parallel/launch.py``), against the unsharded JAX forward
  (the JAX mesh is not the reference at tensor > 1 on quantized weights;
  these are f32 weights, held against the unsharded forward all the
  same), every rank returning the same logits.
- Three stages over an int8 cache against the JAX three-stage pipeline.

The ranks import this module to find their bodies, so it imports JAX only
inside the functions that build the reference.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepseek_tpu_torch.parallel.launch import launch
from deepseek_tpu_torch.parallel.pipeline import Pipeline, stage_bounds
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-3                     # of max|logit|, f32 compute
PP_MESHES = {"tensor2": {"tensor": 2}, "expert2": {"expert": 2}}


def _model(seed, use_mla=True, **kw):
    """The JAX tiny model of ``tests/test_pipeline.py`` and the port's copy
    of its parameters and config."""
    from deepseek_tpu_torch.config import ModelConfig
    from deepseek_tpu_torch.models.loader import params_from_reference
    from tests.test_model import build
    from tests.util_tinymodel import tiny_config, tiny_metadata

    jcfg = tiny_config(use_mla=use_mla, vocab_size=64, **kw)
    _, jparams = build(jcfg, seed=seed)
    cfg = dataclasses.replace(ModelConfig.from_metadata(tiny_metadata(jcfg)),
                              compute_dtype=jcfg.compute_dtype,
                              kv_cache_dtype=jcfg.kv_cache_dtype)
    return jcfg, jparams, cfg, params_from_reference(jparams, "cpu")


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def _jax_pipeline(jcfg, jparams, n_stages, batch):
    import jax
    from deepseek_tpu.parallel.pipeline import Pipeline as JaxPipeline
    return JaxPipeline(jcfg, jparams, n_stages=n_stages, batch=batch,
                       devices=jax.devices()[:n_stages])


def test_stage_bounds():
    from deepseek_tpu.parallel.pipeline import stage_bounds as jax_bounds
    assert stage_bounds(3, 2) == [(0, 2), (2, 3)]
    assert stage_bounds(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert stage_bounds(5, 1) == [(0, 5)]
    for n in range(1, 9):
        for s in range(1, n + 1):
            assert stage_bounds(n, s) == jax_bounds(n, s)
    with pytest.raises(ValueError):
        stage_bounds(2, 3)


@pytest.mark.parametrize("use_mla", [False, True])
def test_pipeline_matches_jax(use_mla):
    """Prefill, then decode past the 8-slot ring's wrap through two stages
    (dense layer 0 on stage 0, the MoE layers on stage 1): each call's
    logits within 1e-3 of max|logit| of the JAX pipeline's."""
    import jax.numpy as jnp
    jcfg, jparams, cfg, params = _model(44, use_mla, rs_original_max_position_embeddings=8)
    B, tokens = 2, [1, 9, 22, 40, 3, 15, 27, 8, 33, 5]
    jpp = _jax_pipeline(jcfg, jparams, 2, B)
    pp = Pipeline(cfg, params, n_stages=2, batch=B, devices=["cpu", "cpu"])
    assert [(st.lo, st.hi) for st in pp.stages] == [(0, 2), (2, 3)]
    assert pp.stages[0].params.lm_head is None and pp.stages[1].params.embed is None
    assert pp.stages[1].cfg.first_k_dense_replace == 0
    assert pp.stages[1].cache.batch == B and (
        pp.stages[1].cache.ckv if use_mla else pp.stages[1].cache.k).shape[0] == 1
    toks = [tokens[:4]] * B
    _close(pp.prefill(torch.tensor(toks), 0), jpp.prefill(jnp.asarray(toks, jnp.int32), 0))
    for pos, t in enumerate(tokens[4:], start=4):
        _close(pp.decode_step(torch.tensor([[t]] * B), pos),
               jpp.decode_step(jnp.asarray([[t]] * B, jnp.int32), pos))


def test_pipeline_microbatched_decode():
    """Microbatched decode gives the JAX microbatched decode's logits, and
    those of the straight-through step."""
    import jax.numpy as jnp
    jcfg, jparams, cfg, params = _model(45)
    tok = [[3], [5], [7], [9]]
    jpp = _jax_pipeline(jcfg, jparams, 2, 4)
    pp = Pipeline(cfg, params, n_stages=2, batch=4, devices=["cpu", "cpu"])
    whole = Pipeline(cfg, params, n_stages=2, batch=4, devices=["cpu", "cpu"])
    for pos in (0, 1):
        got = pp.decode_microbatched(torch.tensor(tok), pos, n_micro=2)
        _close(got, jpp.decode_microbatched(jnp.asarray(tok, jnp.int32), pos, n_micro=2))
        _close(got, whole.decode_step(torch.tensor(tok), pos).numpy())


def test_pipeline_microbatch_whole_batch_transitions():
    """Persistent microbatch caches: split once, and a whole-batch
    decode_step after microbatched decode merges them back; every call
    within 1e-3 of the JAX pipeline's."""
    import jax.numpy as jnp
    jcfg, jparams, cfg, params = _model(48)
    tok = [[3], [5], [7], [9]]
    jpp = _jax_pipeline(jcfg, jparams, 2, 4)
    pp = Pipeline(cfg, params, n_stages=2, batch=4, devices=["cpu", "cpu"])
    jt = jnp.asarray(tok, jnp.int32)
    _close(pp.decode_microbatched(torch.tensor(tok), 0, n_micro=2),
           jpp.decode_microbatched(jt, 0, n_micro=2))
    assert pp.stages[0].cache is None and len(pp.stages[0].mb_caches) == 2
    split = pp.stages[1].mb_caches[0].ckv
    _close(pp.decode_microbatched(torch.tensor(tok), 1, n_micro=2),
           jpp.decode_microbatched(jt, 1, n_micro=2))
    assert pp.stages[1].mb_caches[0].ckv is split        # not split again
    _close(pp.decode_step(torch.tensor(tok), 2), jpp.decode_step(jt, 2))
    assert pp.stages[0].mb_caches is None and pp.stages[0].cache.batch == 4


def test_pipeline_three_stages_int8_cache():
    import jax.numpy as jnp
    jcfg, jparams, cfg, params = _model(46, kv_cache_dtype="int8")
    jpp = _jax_pipeline(jcfg, jparams, 3, 1)
    pp = Pipeline(cfg, params, n_stages=3, batch=1, devices=["cpu"] * 3)
    assert pp.stages[2].cache.ckv.dtype == torch.int8
    for pos, t in enumerate([2, 11, 30]):
        _close(pp.decode_step(torch.tensor([[t]]), pos),
               jpp.decode_step(jnp.asarray([[t]], jnp.int32), pos))


# ---------------------------------------------------------------------------
# PP x TP / EP over four gloo ranks
# ---------------------------------------------------------------------------

PP_TOKENS = [1, 9, 22, 40, 3, 17]


def _rank_pp(rank, world, cfg, params):
    """Both meshes: 2 stages x 2 ranks, a prefill of 4 tokens then two
    decode steps, then microbatched decode at B = 2 in 2 microbatches."""
    out = {}
    for name, shape in PP_MESHES.items():
        pp = Pipeline(cfg, params, n_stages=2, batch=2, devices=["cpu"] * world,
                      mesh_shape=shape)
        st = pp.stages[pp.stage]
        toks = torch.tensor([PP_TOKENS[:4]] * 2)
        lg = [pp.prefill(toks, 0).numpy()]
        for pos in (4, 5):
            lg.append(pp.decode_step(torch.tensor([[PP_TOKENS[pos]]] * 2), pos).numpy())
        lg.append(pp.decode_microbatched(torch.tensor([[5], [7]]), 6, n_micro=2).numpy())
        out[name] = dict(logits=lg, stage=pp.stage, held=[p is not None for p in pp.stages],
                         wo=st.params.layers[0].wo.shape[-1],
                         experts=st.params.layers[-1].w2.shape[0])
    return out


@pytest.fixture(scope="module")
def pp_runs():
    jcfg, jparams, cfg, params = _model(47)
    ranks = launch(_rank_pp, 4, cfg, params, timeout=300)
    return jcfg, jparams, ranks


def _unsharded_jax(jcfg, jparams):
    import jax.numpy as jnp
    from deepseek_tpu.models import init_cache, make_forward
    pre = make_forward(jcfg, prefill=True, logits_mode="last")
    step = make_forward(jcfg, prefill=False, logits_mode="last")
    cache = init_cache(jcfg, batch=2)
    lg, cache = pre(jparams, cache, jnp.asarray([PP_TOKENS[:4]] * 2, jnp.int32), 0)
    want = [np.asarray(lg)]
    for pos in (4, 5):
        lg, cache = step(jparams, cache, jnp.asarray([[PP_TOKENS[pos]]] * 2, jnp.int32), pos)
        want.append(np.asarray(lg))
    lg, cache = step(jparams, cache, jnp.asarray([[5], [7]], jnp.int32), 6)
    want.append(np.asarray(lg))
    return want


@pytest.mark.parametrize("mesh", list(PP_MESHES))
def test_pipeline_pp_x_mesh_matches_unsharded_jax(pp_runs, mesh):
    """Two stages, each a tensor=2 or expert=2 mesh over its two ranks:
    rank r sits on stage r // 2 and holds its stage's layers cut to its
    slice (1 of the 2 heads' wo columns, or 2 of the 4 experts); every
    call's logits within 1e-3 of max|logit| of the unsharded JAX forward
    and the same bits on every rank."""
    jcfg, jparams, ranks = pp_runs
    want = _unsharded_jax(jcfg, jparams)
    for r, res in enumerate(ranks):
        got = res[mesh]
        assert got["stage"] == r // 2
        assert got["held"] == [r // 2 == 0, r // 2 == 1]
        tp, ep = PP_MESHES[mesh].get("tensor", 1), PP_MESHES[mesh].get("expert", 1)
        assert got["wo"] == jcfg.n_heads * jcfg.v_head_dim // tp
        if r // 2 == 1:
            assert got["experts"] == jcfg.n_routed_experts // ep
        for g, w in zip(got["logits"], want):
            _close(g, w)
        for g, g0 in zip(got["logits"], ranks[0][mesh]["logits"]):
            np.testing.assert_array_equal(g, g0)


def test_pipeline_refuses_a_batch_axis():
    jcfg, jparams, cfg, params = _model(47)
    with pytest.raises(ValueError, match="model axes"):
        Pipeline(cfg, params, n_stages=2, mesh_shape={"data": 2})
