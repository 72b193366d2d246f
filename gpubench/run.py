"""Run one cell of the benchmark once and print its result as the last line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``gpubench/configs/<config>.json``) and a traffic mix
(``gpubench/traffic/<traffic>.json``, whose ``kind`` picks the driver
``gpubench/kinds/<kind>.py``); the per-layer metrics are read by
``gpubench/metrics/<metric>.py`` and ``correct`` is held to
``gpubench/limits/<cell>.json``. Set-up (kernels built, weights drawn and
fused, warm-up), the measured window, then, after the window, the check
against the plain reference. ``--trace 1`` reports the per-layer metrics
and ``breakdown`` from a profiled part of the window instead of the
end-to-end metrics. Runs only on an NVIDIA GPU.
"""

from __future__ import annotations

import time

_T_MAIN = time.perf_counter()
_EPOCH_MAIN = time.time()

import argparse                                           # noqa: E402
import gc                                                  # noqa: E402
import importlib                                           # noqa: E402
import importlib.util                                      # noqa: E402
import json                                                # noqa: E402
import os                                                  # noqa: E402
import subprocess                                          # noqa: E402
import sys                                                 # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "deepseek_tpu")
# run as a script, this folder is sys.path[0]: its modules would shadow
# others of the same name (trace, ...); import them as gpubench.* instead
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT


def process_start_epoch() -> float:
    """When this process started (Linux /proc), or when this module loaded."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _EPOCH_MAIN


def cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port builds its kernels into build/torch_kernels/ and its host libraries
    into build/native/ itself)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(root, "build", "gpubench", sub)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Ctx:
    """What a driver (``kinds/<kind>.py``) gets: the cell's data, the run's
    arguments, and the set-up clock."""

    def __init__(self, spec, traffic, seed, seconds, trace, device, log):
        self.spec, self.traffic, self.seed = spec, traffic, seed
        self.seconds, self.trace, self.device, self.log = seconds, trace, device, log
        self.setup = {}
        self._last = time.perf_counter()

    def mark(self, name: str) -> None:
        """The set-up phase ``name`` ended now."""
        now = time.perf_counter()
        self.setup[name] = now - self._last
        self._last = now

    def memory_peak(self) -> int:
        import torch
        return int(torch.cuda.max_memory_allocated()) if self.device.type == "cuda" else 0

    def free(self) -> None:
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def cell_metrics(bench: dict, cell: str):
    """(end-to-end metric entries, per-layer metric entries) the cell reports."""
    names = [w["name"] for w in bench["workloads"]]
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", names)]
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if cell in m.get("workloads", [c for c in names if m["moves"] in moved])]
    return e2e, per


def read_metric(name: str, record: dict, root: str = HERE):
    """``metrics/<name>.py``'s ``read(record)``: a number, or None where
    the run has nothing for it to read."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("gpubench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device,
             root: str = HERE, log=None, control: bool = False) -> dict:
    """Set-up, window and check of one cell on ``device`` (no look for a
    chip: ``main`` makes it); the result object without its device entry.
    ``control``: the check also reads the control (``check.compare``), under
    the result's ``control`` key."""
    import torch
    from gpubench import check

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    w = next(x for x in bench["workloads"] if x["name"] == cell)
    spec = load_json(root, "configs", f"{w['config']}.json")
    traffic = load_json(root, "traffic", f"{w['traffic']}.json")
    limits = load_json(root, "limits", f"{cell}.json")
    device = torch.device(device)
    ctx = Ctx(spec, traffic, seed, seconds, trace, device, log)
    if device.type == "cuda":
        from deepseek_tpu_torch.ops.kernels import build
        build.build_all()
    ctx.mark("kernels_built")
    kind = importlib.import_module(f"gpubench.kinds.{traffic['kind']}")
    res = kind.run(ctx)
    log("set-up s: " + json.dumps(ctx.setup))
    e2e, per = cell_metrics(bench, cell)
    mroot = root if os.path.isdir(os.path.join(root, "metrics")) else HERE
    metrics = {}
    if trace:
        for m in per:
            v = read_metric(m["name"], res["record"], mroot)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            v = res["metrics"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    items = res.get("served") or res.get("scored")
    t = time.perf_counter()
    got = check.compare(spec, seed, device, items, control=control) if items else None
    log(f"reference check took {time.perf_counter() - t:.2f} s")
    if got:
        log(f"check over {got['positions']} positions (routing ties taken "
            f"{got['ties_taken']}): " + json.dumps(got["program"]))
        rows = check.verdict(got, limits)
    else:
        rows = [[k, None, v] for k, v in sorted({**limits, **check.ROUTING}.items())]
    over = [name for name, v, lim in rows if v is None or v > lim]
    if res["failed"]:
        over.append(f"failed requests {res['failed']}")
    if over:
        log("not correct: " + ", ".join(over) + ("" if not set(over) & set(check.ROUTING) else
            " (the program's routing was not logged in full, or it left the reference's "
            "choice by more than a tie: see trace.RouteLog)"))
    out = {"correct": bool(got) and not over, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "record": res["record"],
           "check": rows, "memory_peak_bytes": res["memory_peak_bytes"], "setup": ctx.setup,
           "t0": res["t0"]}
    if control and got:
        out["control"], out["program"] = got["control"], got["program"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_dirs(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    bench = load_json(ROOT, "BENCHMARK.json")
    w = next((x for x in bench["workloads"] if x["name"] == args.workload), None)
    if w is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"{args.workload} needs {w['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    t_proc = process_start_epoch()
    torch.cuda.reset_peak_memory_stats()
    print(f"start-up s {(_EPOCH_MAIN - t_proc) + (time.perf_counter() - _T_MAIN):.3f} (process "
          f"start to the cell's set-up: the interpreter, torch, the CUDA context)",
          file=sys.stderr, flush=True)

    res = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    card = power_limit()
    print(f"card (name, power limit): {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 4
    setup_s = (_EPOCH_MAIN - t_proc) + (res["t0"] - _T_MAIN)
    print(f"setup_s {setup_s} (process start to the window; this module loaded "
          f"{_EPOCH_MAIN - t_proc:.3f} s after the process started)", file=sys.stderr)
    if not args.trace and any(m["name"] == "setup_s" for m in cell_metrics(bench, w["name"])[0]):
        res["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": w["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"], "power_limit": card}
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"], "device": device}
    if args.trace:
        tr = res["record"].get("trace") or {}
        device["busy_s"], device["window_s"] = tr.get("busy_s"), tr.get("window_s")
        out["breakdown"] = {"device_ops": tr.get("device_ops", []),
                            "idle_gaps": tr.get("idle_gaps", [])}
    out["check"] = {name: {"value": v, "limit": lim} for name, v, lim in res["check"]}
    for name, v, lim in res["check"]:
        print(f"check {name} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
