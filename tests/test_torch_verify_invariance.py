"""Verify chunks made batch invariant: inside ``ops/matmul.py::
verify_chunk`` (``forward_prefill`` with per-row starts) every dispatch
choice that decides a row's bits is the same for B = 1, 2 and 4 sequences
at spec_k 1-4 (B x (k+1) rows); the card test
``tests/test_torch_cuda.py::test_verify_chunk_rows_are_the_rows_alone``
holds the rows bit for bit. Checked here on the CPU, against the choices'
own functions:

- the tile formulation: every product runs slices of exactly
  ``VERIFY_ROWS`` (16) rows, a kernel-backed weight on its row-tiled route
  (``qmm_tiled``: one narrow tile of MMA width 16 on the card), whatever
  the row count, where outside verify mode 2-4 rows take the matvec;
- K9/K10's span plan: one sequence's over the whole window, whatever B
  and the other rows' starts;
- the MoE route: the pair list whenever one sequence's chunk has at most
  ``PAIR_PREFILL_MAX_PAIRS`` pairs, though the batch's exceed it; past
  that (spec_k 16 at 8 experts) the grouped products, each sequence's
  pairs sorted into tiles of their own: the plan of the sequence verified
  alone;
- the padding: the router product's and rmsnorm's rows each get the bits
  they get alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepseek_tpu_torch.models import deepseek as model
from deepseek_tpu_torch.models.kvcache import init_cache
from deepseek_tpu_torch.models.testing import deepseek_v3_proportions, random_fused_params
from deepseek_tpu_torch.ops import matmul
from deepseek_tpu_torch.ops.kernels.prefill_attn import prefill_splits
from deepseek_tpu_torch.ops.kernels.qmm import VERIFY_ROWS, tile_width
from deepseek_tpu_torch.ops.norms import rmsnorm
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(B, k + 1) for B in (1, 2, 4) for k in (1, 2, 3, 4)]


def _cfg():
    return dataclasses.replace(deepseek_v3_proportions(
        n_layers=2, dim=512, hidden_dim=1024, n_heads=4, vocab_size=1024,
        first_k_dense_replace=1, n_routed_experts=16, n_active_routed=8,
        moe_intermediate_size=256, n_group=2, topk_group=1, q_lora_rank=512),
        compute_dtype="float32")


@pytest.fixture(scope="module")
def model_q3k():
    cfg = _cfg()
    return cfg, random_fused_params(cfg, "q3_k", seed=5, device="cpu")


def test_slices_are_one_narrow_tile_shape():
    assert VERIFY_ROWS == 16 and tile_width(VERIFY_ROWS) == 16
    for B, T in SHAPES:
        rows = B * T
        seen = []
        x = torch.randn(rows, 8)
        y = matmul.row_slices(lambda xs: (seen.append(xs.shape[0]), xs * 2)[1], x)
        assert seen == [VERIFY_ROWS] * -(-rows // VERIFY_ROWS)
        assert torch.equal(y, x * 2)


def test_verify_products_take_the_tile_route(model_q3k, monkeypatch):
    """Within verify_chunk every K-quant projection of a chunk goes to
    qmm_tiled in 16-row slices (at 2 rows too); outside, 2-4 rows take the
    matvec route (qmm), as decode does."""
    cfg, params = model_q3k
    tiled, plain = [], []
    real_tiled, real_qmm = matmul.qmm_tiled, matmul.qmm
    monkeypatch.setattr(matmul, "qmm_tiled",
                        lambda qt, x: (tiled.append(x.shape[0]), real_tiled(qt, x))[1])
    monkeypatch.setattr(matmul, "qmm", lambda qt, x: (plain.append(x.shape[0]),
                                                       real_qmm(qt, x))[1])
    wo = params.layers[0].wo
    x = torch.randn(2, 1, wo.shape[-1])
    with matmul.verify_chunk():
        assert matmul.in_verify_chunk()
        yv = matmul.qmatmul(wo, x)
    assert not matmul.in_verify_chunk()
    yd = matmul.qmatmul(wo, x)
    assert tiled == [VERIFY_ROWS] and plain == [2]
    torch.testing.assert_close(yv, yd, rtol=1e-5, atol=1e-5)
    tiled.clear()
    starts = np.array([3, 40, 17, 90])
    for B, T in SHAPES:
        cache = init_cache(cfg, batch=B)
        tok = torch.randint(3, cfg.vocab_size, (B, T), generator=torch.Generator()
                            .manual_seed(B * 10 + T))
        with torch.inference_mode():
            model.forward_prefill(params, cache, tok, starts[:B], cfg, logits_mode="all")
        assert tiled and set(tiled) == {VERIFY_ROWS}, (B, T, set(tiled))
        tiled.clear()


@pytest.mark.parametrize("mqa", [True, False])
def test_span_plan_is_the_windows(mqa):
    """K9/K10 with per-row starts: one plan for every B and any starts,
    B = 1's over the whole window; without per-row starts the plan follows
    B and the start (the ordinary prefill)."""
    for S, H in ((4096, 128), (4096, 16), (512, 4), (200, 2)):
        for T in (2, 3, 4, 5):
            plans = {prefill_splits(B, T, H, S, q0, 0, mqa, per_row=True)
                     for B in (1, 2, 4) for q0 in (0, 37, S - T)}
            assert plans == {prefill_splits(1, T, H, S, S - T, 0, mqa)}
            n, span = plans.pop()
            assert n == 1 or (n - 1) * span < S <= n * span
    assert prefill_splits(1, 5, 4, 4096, 37, 0, mqa) != \
        prefill_splits(4, 5, 4, 4096, 3000, 0, mqa)


def test_moe_route_follows_one_sequence(model_q3k, monkeypatch):
    """One sequence's 5 x 8 = 40 pairs take the pair list at B = 1, 2 and
    4 (160 pairs: past PAIR_PREFILL_MAX_PAIRS, where an ordinary prefill
    chunk takes the grouped products)."""
    cfg, params = model_q3k
    routes = []
    real_pair, real_grouped = model._pair_ffn, model.grouped_expert_ffn
    monkeypatch.setattr(model, "_pair_ffn",
                        lambda *a, **k: (routes.append("pair"), real_pair(*a, **k))[1])
    monkeypatch.setattr(model, "grouped_expert_ffn",
                        lambda *a, **k: (routes.append("grouped"), real_grouped(*a, **k))[1])
    T = 5
    assert 4 * T * cfg.n_active_routed > model.PAIR_PREFILL_MAX_PAIRS
    for B in (1, 2, 4):
        routes.clear()
        with torch.inference_mode():
            model.forward_prefill(params, init_cache(cfg, batch=B),
                                  torch.full((B, T), 7), np.arange(B) * 9, cfg,
                                  logits_mode="all")
        assert routes == ["pair"], (B, routes)
    routes.clear()
    with torch.inference_mode():
        model.forward_prefill(params, init_cache(cfg, batch=4), torch.full((4, T), 7), 0,
                              cfg, logits_mode="none")
    assert routes == ["grouped"]


def test_padded_rows_are_the_rows_alone(model_q3k):
    """The router product (16-row slices inside verify_chunk) and rmsnorm
    (at least 16 rows) give each sequence's rows their bits alone."""
    cfg, params = model_q3k
    lp = params.layers[1]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 5, cfg.dim, generator=g)
    with matmul.verify_chunk():
        for B in (2, 4):
            got = model._router_logits(x[:B], lp.moegate)
            for b in range(B):
                assert torch.equal(got[b], model._router_logits(x[b:b + 1], lp.moegate)[0])
    for B in (2, 4):
        got = rmsnorm(x[:B], lp.attn_norm, cfg.norm_eps)
        for b in range(B):
            assert torch.equal(got[b], rmsnorm(x[b:b + 1], lp.attn_norm, cfg.norm_eps)[0])


def test_grouped_tiles_hold_one_sequence(model_q3k, monkeypatch):
    """At spec_k 16 (17 x 8 = 136 pairs a sequence, past
    PAIR_PREFILL_MAX_PAIRS) a verify chunk of B = 4 sequences takes the
    grouped products once a sequence: no tile holds rows of two
    sequences, and each sequence's tile plan (the tiles' experts and live
    rows, so their MMA widths) is the one it gets verified alone. An
    ordinary prefill chunk of the same rows keeps one sort over all."""
    cfg, params = model_q3k
    plans = []
    real = matmul.owned_tiles

    def spy(lidx, owned, within, counts, capacity, tile=128):
        out = real(lidx, owned, within, counts, capacity, tile)
        plans.append((lidx.shape[0], out[0].tolist(), out[1].tolist()))
        return out

    monkeypatch.setattr(matmul, "owned_tiles", spy)
    T, B = 17, 4
    assert T * cfg.n_active_routed > model.PAIR_PREFILL_MAX_PAIRS
    g = torch.Generator().manual_seed(11)
    tok = torch.randint(3, cfg.vocab_size, (B, T), generator=g)
    starts = np.array([3, 40, 17, 90])
    with torch.inference_mode():
        alone = []
        for b in range(B):
            plans.clear()
            model.forward_prefill(params, init_cache(cfg), tok[b:b + 1], starts[b:b + 1],
                                  cfg, logits_mode="none")
            alone.append(list(plans))
        plans.clear()
        model.forward_prefill(params, init_cache(cfg, batch=B), tok, starts, cfg,
                              logits_mode="none")
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert len(plans) == B * moe_layers
    assert all(n == T * cfg.n_active_routed for n, _, _ in plans)
    for layer in range(moe_layers):
        assert [plans[layer * B + b] for b in range(B)] == \
            [alone[b][layer] for b in range(B)]
    plans.clear()
    with torch.inference_mode():
        model.forward_prefill(params, init_cache(cfg, batch=B), tok, 0, cfg,
                              logits_mode="none")
    assert [n for n, _, _ in plans] == [B * T * cfg.n_active_routed] * moe_layers
