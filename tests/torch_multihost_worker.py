"""One process of the port's multi-process tests (tests/test_torch_multihost.py):
an independent interpreter that joins the others over a TCP rendezvous.
It imports torch and the port only, never JAX.

    python tests/torch_multihost_worker.py <mode> <coord> <pid> <nprocs> <timeout> [args]

Modes:
- ``data2 <ckpt> <ref.npz>``: ``init_distributed`` over ``tcp://<coord>``,
  ``make_mesh(data=nprocs)``; the process decodes its row of the batch
  (``shard_cache`` cuts the batch over the data line) through
  ``forward_decode`` on the tokens in ref.npz (plus its row's offset), gathers the rows over the
  data line, and holds its row and the gathered batch against the
  single-process logits in ref.npz within 1e-3 of their scale. Prints
  ``WORKER_OK pid=<pid>``.
- ``solo``: the rendezvous while the peers never start; it must fail
  within ``timeout``: prints ``INIT_FAILED pid=<pid> after <seconds> s``
  and exits 3 (``INIT_OK`` only if it joined).
- ``die``: every process joins; the others then exit without a handshake
  (``os._exit(1)``) and process 0 runs barriers until one raises
  (``CLEAN_FAIL_DETECTED``, exit 7), or reports ``NO_FAILURE_SEEN``
  (exit 8) after 120 s of them.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def data2(pid, nprocs, ckpt, ref_path):
    import numpy as np
    import torch
    import torch.distributed as dist

    from deepseek_tpu_torch.config import ModelConfig
    from deepseek_tpu_torch.models.deepseek import forward_decode
    from deepseek_tpu_torch.models.kvcache import init_cache
    from deepseek_tpu_torch.models.loader import load_params
    from deepseek_tpu_torch.parallel.mesh import make_mesh
    from deepseek_tpu_torch.parallel.sharding import shard_cache, shard_params
    from deepseek_tpu_torch.parallel.spmd import make_ctx
    from deepseek_tpu_torch.utils.codec import load_checkpoint

    torch.set_num_threads(1)
    data = load_checkpoint(ckpt)
    cfg = ModelConfig.from_metadata(data.metadata)
    params = load_params(data, cfg, device="cpu")
    mesh = make_mesh(data=nprocs)
    assert (mesh.data, mesh.data_index) == (nprocs, pid), mesh
    ctx = make_ctx(cfg, mesh)
    sp = shard_params(params, cfg, mesh)
    cache = shard_cache(init_cache(cfg, batch=nprocs), cfg, mesh, sp)
    assert cache.batch == 1
    ref = np.load(ref_path)
    with torch.inference_mode():
        off = int(ref["offsets"][pid])            # this row's tokens
        for pos, t in enumerate(ref["tokens"].tolist()):
            tok = torch.tensor([[(t + off) % cfg.vocab_size]])
            lg = forward_decode(sp, cache, tok, pos, cfg, ctx)
        whole = ctx.gather_d(lg)
    want = ref["logits"]                                  # (nprocs, V)
    tol = 1e-3 * float(np.abs(want).max())
    np.testing.assert_allclose(lg.numpy()[0], want[pid], rtol=0, atol=tol)
    np.testing.assert_allclose(whole.numpy(), want, rtol=0, atol=tol)
    assert "jax" not in sys.modules, "the port's process imported jax"
    dist.barrier()
    dist.destroy_process_group()
    print(f"WORKER_OK pid={pid}", flush=True)


def die(pid):
    import torch
    import torch.distributed as dist

    if pid != 0:
        os._exit(1)                  # a crash: no handshake, sockets dropped
    t = torch.ones(1)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            dist.all_reduce(t)
            time.sleep(0.2)
    except Exception as e:       # noqa: BLE001 (any failure of the collective)
        print(f"CLEAN_FAIL_DETECTED pid={pid}: {type(e).__name__}", flush=True)
        os._exit(7)
    print("NO_FAILURE_SEEN", flush=True)
    os._exit(8)


def main():
    mode, coord, pid, nprocs, timeout = sys.argv[1:6]
    pid, nprocs = int(pid), int(nprocs)
    from deepseek_tpu_torch.parallel.mesh import init_distributed

    t0 = time.monotonic()
    try:
        got = init_distributed("gloo", f"tcp://{coord}", nprocs, pid, float(timeout))
    except Exception as e:       # noqa: BLE001 (reported, then a non-zero exit)
        print(f"INIT_FAILED pid={pid} after {time.monotonic() - t0:.3f} s: "
              f"{type(e).__name__}", flush=True)
        sys.exit(3)
    assert got == pid
    assert "jax" not in sys.modules, "the port's process imported jax"
    print(f"INIT_OK pid={pid}", flush=True)
    if mode == "data2":
        data2(pid, nprocs, *sys.argv[6:8])
    elif mode == "die":
        die(pid)


if __name__ == "__main__":
    main()
