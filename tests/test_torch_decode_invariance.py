"""Decode steps made batch invariant past 4 rows: inside ``ops/matmul.py::
decode_rows`` (``forward_decode``, the MTP layer's decode) a step of up to
``DECODE_INVARIANT_ROWS`` rows runs every kernel-backed projection on the
matvec in slices of at most ``ROW_TILE_MIN`` rows, where 5-8 rows took the
tile GEMM. Checked here on the CPU, against the choices' own functions:

- the bound: up to ``DECODE_INVARIANT_ROWS`` sequences K3's and K8's span
  plans are one sequence's at V3's and V2-Lite's head counts over a
  4096-slot window (K3's stops there at V3's 128 heads);
- the route: at B = 5..8 every kernel-backed projection reaches
  ``qmm_matvec`` (the matvec in passes of at most ``ROW_TILE_MIN`` rows;
  its launches are counted on the card), never ``qmm``, whose row-tiled
  route takes more than ``ROW_TILE_MIN`` rows, nor ``qmm_tiled``; past the
  bound, and in prefill chunks, the rows go to ``qmm`` whole, as before;
- the rows: each row of a B = 8 step matches the same sequence decoded
  alone, in the packed, nibble and fp8 layouts, within 1e-3 of the logit
  scale: the plain versions' BLAS products on the CPU sum a row by the
  row count (a one-row product is a GEMV, more rows a GEMM), so the CPU
  cannot hold the bits.

The card holds the same rows bit for bit through the kernels
(``tests/test_torch_cuda.py::test_decode_rows_past_four_are_the_rows_alone``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepseek_tpu_torch.config import QuantKind
from deepseek_tpu_torch.models import deepseek as model
from deepseek_tpu_torch.models.kvcache import init_cache
from deepseek_tpu_torch.models.testing import (
    deepseek_v3_proportions, random_fp8_params, random_fused_params,
)
from deepseek_tpu_torch.ops import matmul
from deepseek_tpu_torch.ops.kernels.attention import (
    DECODE_INVARIANT_ROWS, decode_splits, mla_decode_splits,
)
from deepseek_tpu_torch.ops.kernels.qmm import ROW_TILE_MIN
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _cfg():
    return dataclasses.replace(deepseek_v3_proportions(
        n_layers=2, dim=512, hidden_dim=1024, n_heads=4, vocab_size=1024,
        first_k_dense_replace=1, n_routed_experts=8, n_active_routed=2,
        moe_intermediate_size=256, n_group=2, topk_group=1, q_lora_rank=512),
        compute_dtype="float32")


_LAYOUTS = {}


def _params(quant):
    if quant not in _LAYOUTS:
        cfg = _cfg()
        if quant == "fp8":
            cfg = dataclasses.replace(cfg, weight_quant=QuantKind.F8E5M2,
                                      block_size=(128, 128))
            _LAYOUTS[quant] = cfg, random_fp8_params(cfg, seed=4, device="cpu")
        else:
            _LAYOUTS[quant] = cfg, random_fused_params(cfg, quant, seed=4, device="cpu")
    return _LAYOUTS[quant]


def test_bound_is_where_k3_spans_stop():
    """At V3's 128 heads over 4096 slots K3's plan is one sequence's up to
    DECODE_INVARIANT_ROWS = 8 sequences and longer past it; K8's holds at
    least as far at V2-Lite's 16 heads and at 128."""
    assert DECODE_INVARIANT_ROWS == 8
    one = mla_decode_splits(1, 128, 4096)
    assert all(mla_decode_splits(B, 128, 4096) == one
               for B in range(1, DECODE_INVARIANT_ROWS + 1))
    assert mla_decode_splits(DECODE_INVARIANT_ROWS + 1, 128, 4096) != one
    for H in (16, 128):
        assert all(mla_decode_splits(B, H, 4096) == mla_decode_splits(1, H, 4096)
                   for B in range(1, DECODE_INVARIANT_ROWS + 1))
        assert all(decode_splits(B, H, 4096) == decode_splits(1, H, 4096)
                   for B in range(1, DECODE_INVARIANT_ROWS + 1))


def _spy(monkeypatch):
    """The rows of each ``qmm``, ``qmm_matvec`` and ``qmm_tiled`` call that
    ``qmatmul`` makes."""
    seen = {"qmm": [], "matvec": [], "tiled": []}
    for key, name in (("qmm", "qmm"), ("matvec", "qmm_matvec"), ("tiled", "qmm_tiled")):
        real = getattr(matmul, name)
        monkeypatch.setattr(matmul, name, lambda qt, x, key=key, real=real: (
            seen[key].append(x.numel() // x.shape[-1]), real(qt, x))[1])
    return seen


@pytest.mark.parametrize("B", [5, 6, 7, 8])
def test_decode_rows_take_the_matvec(B, monkeypatch):
    """Every projection of a B-row decode step goes to qmm_matvec with the
    step's B rows (the matvec in passes of at most ROW_TILE_MIN rows);
    none to qmm, whose route above ROW_TILE_MIN rows is the tile GEMM, nor
    to qmm_tiled."""
    cfg, params = _params("q3_k")
    seen = _spy(monkeypatch)
    cache = init_cache(cfg, batch=B)
    with torch.inference_mode():
        model.forward_decode(params, cache, torch.arange(3, 3 + B)[:, None], 0, cfg)
    assert B > ROW_TILE_MIN and set(seen["matvec"]) == {B}, seen
    assert not seen["qmm"] and not seen["tiled"], seen
    assert not matmul._DECODE.get()


def test_past_the_bound_and_in_prefill_rows_go_whole(monkeypatch):
    """Past DECODE_INVARIANT_ROWS a decode step's projections take the
    rows whole (the row-tiled route above ROW_TILE_MIN on the card), as a
    prefill chunk's do."""
    cfg, params = _params("q3_k")
    seen = _spy(monkeypatch)
    B = DECODE_INVARIANT_ROWS + 1
    with torch.inference_mode():
        model.forward_decode(params, init_cache(cfg, batch=B),
                             torch.arange(3, 3 + B)[:, None], 0, cfg)
    assert set(seen["qmm"]) == {B} and not seen["matvec"]
    seen["qmm"].clear()
    with torch.inference_mode():
        model.forward_prefill(params, init_cache(cfg), torch.arange(3, 9)[None], 0, cfg,
                              logits_mode="all")
    assert set(seen["qmm"]) == {6} and not seen["matvec"]


@pytest.mark.parametrize("quant", ["q3_k", "q3_k_nibble", "fp8"])
def test_decode_rows_match_the_rows_alone(quant):
    """Each row of a decode step over 8 sequences at their own positions
    matches the same sequence decoded alone, three steps running (the
    kernels' plain versions), within 1e-3 of the logit scale."""
    cfg, params = _params(quant)
    B = 8
    batch = init_cache(cfg, batch=B)
    alone = [init_cache(cfg) for _ in range(B)]
    pos = np.arange(B) * 3
    g = torch.Generator().manual_seed(4)
    with torch.inference_mode():
        for step in range(3):
            tok = torch.randint(3, cfg.vocab_size, (B, 1), generator=g)
            got = model.forward_decode(params, batch, tok, pos + step, cfg,
                                       active=np.ones(B, bool))
            for b in range(B):
                want = model.forward_decode(params, alone[b], tok[b:b + 1],
                                            int(pos[b]) + step, cfg)
                tol = 1e-3 * float(want.abs().max())
                torch.testing.assert_close(got[b], want[0], rtol=0, atol=tol,
                                           msg=lambda m: f"{quant} {step} {b}: {m}")
