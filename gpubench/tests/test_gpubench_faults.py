"""``correct`` comes out false when the timed path is broken underneath a
run (the harness's look for a chip skipped, the tiny cells on the CPU), once
for each fault a cell can have: a step that leaves its state unchanged (the
cache writes dropped), half of the batch's work left out (half the live rows
dead, or half the chunk's rows without their experts), and a token or an
answer altered where it is produced. The cells run on one chip, so none has
an exchange between chips to leave out. A run whose router calls the log
does not see is not correct either, by its own reason (``routes_missing``).
And the control (the reference in TF32, put in the program's place) fails the
limits that the program meets."""

import numpy as np
import pytest

from gpubench import run, trace

import tiny


def _run(cell, **kw):
    return run.run_cell(tiny.bench(), cell, 2**31 + 3, 1.0, False, "cpu", root=tiny.DATA,
                        log=lambda s: None, **kw)


def _serve_faults(monkeypatch, fault):
    from deepseek_tpu_torch.models import deepseek
    from deepseek_tpu_torch.ops import matmul
    from deepseek_tpu_torch.serving import BatchScheduler
    if fault == "state_unchanged":
        monkeypatch.setattr(deepseek, "write_slot", lambda *a, **k: None)
    elif fault == "half_the_batch":
        of = matmul.LiveRows.of.__func__

        def half(cls, active, device):
            if active is None or isinstance(active, matmul.LiveRows):
                return of(cls, active, device)
            mask = np.array(active, dtype=bool).reshape(-1)
            mask[np.flatnonzero(mask)[::2]] = False
            return of(cls, mask, device)
        monkeypatch.setattr(matmul.LiveRows, "of", classmethod(half))
    else:
        emit = BatchScheduler._emit
        monkeypatch.setattr(BatchScheduler, "_emit",
                            lambda self, req, token, prev: emit(self, req, (token + 1) % 512, prev))


def _ppl_faults(monkeypatch, fault):
    from deepseek_tpu_torch import engine
    from deepseek_tpu_torch.models import deepseek
    if fault == "state_unchanged":
        monkeypatch.setattr(deepseek, "write_rows", lambda *a, **k: None)
    elif fault == "half_the_batch":
        ffn = deepseek._ffn

        def half(lp, cfg, xb, layer, **kw):
            out = ffn(lp, cfg, xb, layer, **kw)
            if cfg.is_moe_layer(layer):
                out = out.clone()
                out[:, ::2] = 0
            return out
        monkeypatch.setattr(deepseek, "_ffn", half)
    else:
        hydrate = engine.hydrate_cache

        def altered(*a, **k):
            cache, last, collected, end = hydrate(*a, **k)
            return cache, last, None if collected is None else collected + 0.05, end
        monkeypatch.setattr(engine, "hydrate_cache", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "altered"])
@pytest.mark.parametrize("cell", ["tiny-v3.serve", "tiny-v2.ppl"])
def test_a_fault_makes_the_run_incorrect(monkeypatch, cell, fault):
    (_serve_faults if cell.endswith("serve") else _ppl_faults)(monkeypatch, fault)
    res = _run(cell)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", ["tiny-v3.serve", "tiny-v2.ppl"])
def test_an_unlogged_routing_makes_the_run_incorrect(monkeypatch, cell):
    """The router no longer reached through the name the log wraps (as a
    fused router or a replayed CUDA graph would do): the run is not
    correct, and the routing row is what fails."""
    monkeypatch.setattr(trace.RouteLog, "install", lambda self: self)
    res = _run(cell)
    assert not res["correct"]
    failing = {name for name, v, lim in res["check"] if v > lim}
    assert failing == {"routes_missing"}, res["check"]


@pytest.mark.parametrize("cell", ["tiny-v3.serve", "tiny-v2.ppl"])
def test_the_control_fails_where_the_program_passes(cell):
    got = _run(cell, control=True)
    limits = run.load_json(tiny.DATA, "limits", f"{cell}.json")
    assert got["correct"], got["check"]
    assert any(got["control"][k] > v for k, v in limits.items()), got["control"]
