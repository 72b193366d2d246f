"""Each cell's path end to end on the CPU at a tiny size (the test-only
configurations of ``tests/data``, not in BENCHMARK.json), through
``run.run_cell``: set-up, the window, the traced run's taps and the check
against the reference. The port runs its plain versions here, so the device
metrics stay unread (no number from the CPU under a device metric's name)."""

import pytest

from gpubench import run

import tiny


@pytest.mark.parametrize("cell", ["tiny-v3.serve", "tiny-v2.ppl"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_path_on_the_cpu(cell, trace):
    b = tiny.bench()
    res = run.run_cell(b, cell, 2**31 + 77, 1.0, trace, "cpu", root=tiny.DATA,
                       log=lambda s: None)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    e2e, per = run.cell_metrics(b, cell)
    if trace:
        # host counts only: the device's numbers need the card
        assert set(res["metrics"]) <= {"slot_occupancy.serve"}
        assert all(run.read_metric(m["name"], res["record"]) is None
                   for m in per if m["source"] == "device_trace")
    else:
        assert set(res["metrics"]) == {m["name"] for m in e2e} - {"setup_s"}
        assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.cuda
def test_a_cell_on_the_card(capsys):
    """The command as the benchmark runs it, a short window of each cell."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import json
    for cell in ("v3-q3k.serve", "v2lite-fp8.ppl"):
        assert run.main(["--workload", cell, "--seed", "11", "--seconds", "5",
                         "--trace", "0"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["correct"] and out["device"]["platform"] == "gpu"
