"""Read the numbers that ``correct`` compares, for the program and for its
control, over many seeds in one process (the limits in ``limits/<cell>.json``
are set from these readings; the benchmark's own runs never run this).

    python3 gpubench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, ``run.run_cell`` with the control: the cell's set-up and a
window of ``--seconds`` at the cell's own load, then the check of the same
sample a run takes, against the reference in float32 and against the control
(the reference in TF32, the nearest precision below the configuration's
float32). One JSON line a seed on standard output: {"seed", "program":
numbers, "control": numbers, "correct", "check", "metrics"}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from gpubench.run import cache_dirs, load_json, run_cell
    cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("the control is read on the card", file=sys.stderr)
        return 3
    bench = load_json(ROOT, "BENCHMARK.json")
    for seed in args.seeds:
        res = run_cell(bench, args.workload, seed, args.seconds, False, "cuda", control=True)
        print(json.dumps({"seed": seed, "program": res.get("program"),
                          "control": res.get("control"), "correct": res["correct"],
                          "check": res["check"], "metrics": res["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
