"""No module the benchmark runs is JAX's or the JAX package's: top-level
module names compared whole (``deepseek_tpu_torch`` is the port,
``deepseek_tpu`` the JAX package)."""

import os
import subprocess
import sys

from gpubench import run

from tiny import DATA

SCRIPT = f"""
import sys, json
sys.path.insert(0, {run.ROOT!r}); sys.path.insert(1, {os.path.dirname(DATA)!r})
import torch
torch.set_num_threads(1)
from gpubench import run, calibrate, check, draw, work, stats, trace, readers
from gpubench.reference import forward, decode
from gpubench.kinds import serve, ppl
import tiny
b = tiny.bench()
for cell in ("tiny-v3.serve", "tiny-v2.ppl"):
    res = run.run_cell(b, cell, 5, 0.5, True, "cpu", root=tiny.DATA, log=lambda s: None)
    for m in b["per_layer"]:
        run.read_metric(m["name"], res["record"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "deepseek_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert "deepseek_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "deepseek_tpu.fake", sys)
    assert "deepseek_tpu" in run.forbidden_modules()


def test_a_run_loads_no_jax_and_no_jax_package():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "deepseek_tpu_torch" in loaded and "gpubench" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for path in ("draw.py", "reference/forward.py", "reference/decode.py"):
        with open(os.path.join(here, path)) as f:
            src = f.read()
        assert "deepseek_tpu" not in src and "import jax" not in src, path
