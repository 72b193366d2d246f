"""Run a function on ``world`` ranks, one process each, and collect what
each returns.

``launch(fn, world, *args)`` spawns the ranks (the spawn start method: no
rank inherits the caller's CUDA context or threads), joins them in one
``torch.distributed`` group through a ``FileStore`` rendezvous in a fresh
temporary directory (so launches in parallel processes never compete for
a port), calls ``fn(rank, world, *args)`` on each and returns the list of
results in rank order. Arguments and results cross as plain pickles
(tensors are copied, no shared memory), so keep them small: the ranks
build their own models from a seed or from what the arguments carry.

A rank that raises makes ``launch`` raise in the caller with that rank's
traceback (and those of the ranks whose collectives failed with it, which
may report first), and the other ranks are stopped instead of waiting in
a collective for a peer that is gone; a rank that dies, or a launch that
outlasts ``timeout`` seconds, raises too. Every process ``launch``
starts has ended when it returns or raises.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List


def _rank_main(fn_args: bytes, rank: int, world: int, init_method: str,
               backend: str, timeout: float, threads, results) -> None:
    try:
        import torch
        import torch.distributed as dist

        from deepseek_tpu_torch.parallel.mesh import init_distributed

        if threads:
            torch.set_num_threads(threads)
        fn, args = pickle.loads(fn_args)
        init_distributed(backend, init_method, world, rank, timeout)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the caller, which raises it
        results.put((rank, False, traceback.format_exc()))


def _failures(results, world: int, failed: dict, wait: float = 5.0) -> str:
    """Every failed rank's traceback in rank order: the first failure's
    peers see their collectives fail too, and may report before it does,
    so the reports of the next ``wait`` seconds are read as well."""
    deadline = time.monotonic() + wait
    while len(failed) < world and time.monotonic() < deadline:
        try:
            rank, ok, data = results.get(timeout=max(0.01, deadline - time.monotonic()))
        except queue.Empty:
            break
        if not ok:
            failed[rank] = data
    return "\n".join(f"rank {r} of {world} raised:\n{failed[r]}" for r in sorted(failed))


def launch(fn: Callable, world: int, *args, backend: str = "gloo",
           timeout: float = 600.0, threads: int = 1) -> List[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in its own process inside one process group. ``fn`` must be a
    module-level function (the spawned ranks import it); ``threads`` sets
    each rank's torch CPU threads (None leaves torch's default)."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="dseek_launch_")
    init_method = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    payload = pickle.dumps((fn, args))
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(payload, r, world, init_method, backend, timeout,
                               threads, results))
             for r in range(world)]
    out, deadline = {}, time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, data = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # a rank's report may still be in flight: read once more
                    try:
                        rank, ok, data = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} of {world} exited with code "
                            f"{procs[dead[0]].exitcode} and reported nothing") from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"launch of {world} ranks outlasted {timeout} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(_failures(results, world, {rank: data}))
            out[rank] = pickle.loads(data)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
