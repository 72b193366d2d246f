"""The test-only tiny cells (``tests/data``: DeepSeek-V3's and V2-Lite's
layer types at toy widths, not in BENCHMARK.json) and a benchmark description
that names them, with the real one's metrics."""

import json
import os

from gpubench.run import ROOT

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CELLS = {"v3-q3k.serve": "tiny-v3.serve", "v2lite-fp8.ppl": "tiny-v2.ppl"}


def bench() -> dict:
    with open(os.path.join(DATA, "bench.json")) as f:
        out = json.load(f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    for key in ("end_to_end", "per_layer"):
        out[key] = [dict(m, workloads=[CELLS[w] for w in m["workloads"]])
                    if "workloads" in m else m for m in real[key]]
    return out
