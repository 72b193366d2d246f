"""Independent processes over TCP: the port's counterpart of
tests/test_multihost.py.

Every process here is its own interpreter (``subprocess.Popen``), started
by no common parent process group: they meet only through the rendezvous
``tcp://127.0.0.1:<free port>`` that ``parallel/mesh.py::init_distributed``
joins (gloo; process 0 serves the TCP store). The worker,
``tests/torch_multihost_worker.py``, imports torch and the port only.

- Two processes at data=2 decode one row each of a batch of two and
  reproduce the JAX package's single-process batch-2 logits (within 1e-3
  of their scale, f32), each on its own row and on the batch gathered
  over the data line.
- A peer that never comes fails the rendezvous within its timeout, with a
  non-zero exit, whether the missing one is the store's client or its
  server.
- A peer that exits without a handshake makes the survivor's next
  collective raise well within its timeout: no hang.
- ``scripts/torch_launch_multihost.py``: two processes through the
  launcher, each running the CLI on the CPU, print the single-process
  CLI's greedy completion.
"""

import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from tests.test_torch_threads import one_torch_thread  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "torch_multihost_worker.py")
_LAUNCHER = os.path.join(_REPO, "scripts", "torch_launch_multihost.py")
TIMEOUT = 10            # the rendezvous's and every collective's, seconds


def _free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(args):
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=_env(), cwd=_REPO)


def _finish(procs, timeout):
    """Each process's (return code, output), every one ended within
    ``timeout`` seconds in all (killed and failed otherwise)."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out.decode("utf-8", errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a process outlasted {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def test_two_process_data_parallel_matches_single(tmp_path):
    from deepseek_tpu.utils import codec
    from tests.util_tinymodel import (
        tiny_checkpoint_tensors, tiny_config, tiny_metadata, tiny_weights,
    )

    cfg = tiny_config(use_mla=True, vocab_size=64)
    ckpt = str(tmp_path / "ckpt")
    codec.save_checkpoint(ckpt, [tiny_checkpoint_tensors(cfg, tiny_weights(cfg, 60))],
                          tiny_metadata(cfg))

    # the JAX package's single-process reference: the batch of two
    import jax.numpy as jnp
    from deepseek_tpu.config import ModelConfig
    from deepseek_tpu.models import init_cache, make_forward
    from deepseek_tpu.models.loader import load_params
    from deepseek_tpu.utils.codec import load_checkpoint

    data = load_checkpoint(ckpt)
    rcfg = ModelConfig.from_metadata(data.metadata)
    assert rcfg.compute_dtype == "float32"
    params = load_params(data, rcfg)
    step = make_forward(rcfg, prefill=False, logits_mode="last")
    cache = init_cache(rcfg, batch=2)
    tokens = np.asarray([1, 9, 22, 40, 3], np.int32)
    rows = np.asarray([[0], [17]], np.int32)       # the rows differ by an offset
    lg = None
    for pos, t in enumerate(tokens.tolist()):
        lg, cache = step(params, cache, jnp.asarray((rows + t) % rcfg.vocab_size), pos)
    ref = str(tmp_path / "ref.npz")
    np.savez(ref, tokens=tokens, offsets=rows[:, 0], logits=np.asarray(lg, np.float32))

    coord = f"127.0.0.1:{_free_port()}"
    got = _finish([_start([_WORKER, "data2", coord, str(pid), "2", "60", ckpt, ref])
                   for pid in range(2)], 60)
    for pid, (rc, out) in enumerate(got):
        assert rc == 0, f"process {pid} failed:\n{out[-4000:]}"
        assert f"WORKER_OK pid={pid}" in out, out[-4000:]


@pytest.mark.parametrize("pid", [0, 1])
def test_missing_peer_fails_within_timeout(pid):
    """Only one of two processes starts: process 0 waits for a client of
    its store that never comes, process 1 for a store that is never
    served. Either gives up the rendezvous within the timeout (and 2 s of
    polling) and exits non-zero, never reporting a joined group."""
    coord = f"127.0.0.1:{_free_port()}"
    (rc, out), = _finish([_start([_WORKER, "solo", coord, str(pid), "2", str(TIMEOUT)])],
                         TIMEOUT + 40)
    assert rc == 3 and "INIT_OK" not in out, out[-2000:]
    took = float(re.search(rf"INIT_FAILED pid={pid} after ([0-9.]+) s", out).group(1))
    assert took <= TIMEOUT + 2, took


def test_dead_peer_makes_the_survivor_raise():
    """Both processes join; process 1 then exits without a handshake. The
    survivor's next all-reduce raises (exit 7), within the timeout."""
    coord = f"127.0.0.1:{_free_port()}"
    (rc0, out0), (rc1, out1) = _finish(
        [_start([_WORKER, "die", coord, str(pid), "2", str(TIMEOUT)]) for pid in range(2)],
        TIMEOUT + 40)
    assert "INIT_OK pid=1" in out1 and rc1 == 1, out1[-2000:]
    assert "NO_FAILURE_SEEN" not in out0, out0[-2000:]
    assert rc0 == 7 and "CLEAN_FAIL_DETECTED pid=0" in out0, out0[-2000:]


def _completion(out: str) -> str:
    texts = re.findall(r"Model bits per weight: [^\n]*\n(.*?)\nGeneration stats:", out,
                       re.S)
    assert len(texts) == 1, out[-3000:]
    return texts[0]


def test_launcher_ranks_print_the_single_process_cli(tmp_path):
    """``scripts/torch_launch_multihost.py --coord --nprocs 2 --pid i``
    then the CLI's arguments (``--device cpu``, greedy, 16 tokens): each
    process joins the group, says so on stderr, and prints the completion
    that ``python -m deepseek_tpu_torch`` prints alone."""
    from tests.test_torch_cli import _convert

    ckpt = _convert(str(tmp_path), "fp32", use_mla=True)
    cli = [ckpt, "-m", "completion", "-i", "Hello world", "-n", "16", "-t", "0",
           "--device", "cpu"]
    coord = f"127.0.0.1:{_free_port()}"
    procs = [_start(["-m", "deepseek_tpu_torch", *cli])] + [
        _start([_LAUNCHER, "--coord", coord, "--nprocs", "2", "--pid", str(pid),
                "--timeout", "60", *cli]) for pid in range(2)]
    (rc, alone), *ranks = _finish(procs, 60)
    assert rc == 0, alone[-3000:]
    want = _completion(alone)
    assert want.strip()
    for pid, (rc, out) in enumerate(ranks):
        assert rc == 0, out[-3000:]
        assert f"[multihost] process {pid}/2" in out, out[-3000:]
        assert _completion(out) == want
