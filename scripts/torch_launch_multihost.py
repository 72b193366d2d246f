"""Multi-process launch helper for deepseek_tpu_torch (the counterpart of
``scripts/launch_multihost.py``).

Nothing on a machine announces a cluster to torch, so every process is
given the topology: the rendezvous address, the process count and its own
index. Run the same command once per process, on one host or several:

    python scripts/torch_launch_multihost.py --coord host0:29500 --nprocs 2 \\
        --pid <this process's index> [--timeout SECONDS] <ckpt_dir> ...

Process 0 serves the rendezvous (a TCP store) on ``--coord``'s port. Each
process joins the gloo process group (``parallel.mesh.init_distributed``),
prints ``[multihost] process i/N`` on stderr and runs the port's CLI
(``deepseek_tpu_torch.cli``) on the remaining arguments, on the card by
default (``--device cpu`` for the plain versions). As in the JAX script,
the CLI takes no mesh flag: each process runs its own copy of the request.

``--timeout`` (seconds, default 300; ``init_multihost``'s
``initialization_timeout``) bounds the rendezvous and every collective:
a process whose peer never comes exits non-zero after it, and one whose
peer dies raises in its next collective. When the CLI returns, the
processes meet once more before the group is torn down, so none closes its
sockets while a peer still uses them.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse(argv):
    """(coord, nprocs, pid, timeout, the CLI's arguments)."""
    coord = nprocs = pid = None
    timeout = 300.0
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("--coord", "--nprocs", "--pid", "--timeout"):
            if i + 1 >= len(argv):
                sys.exit(f"{a} needs a value")
            v = argv[i + 1]
            if a == "--coord":
                coord = v
            elif a == "--nprocs":
                nprocs = int(v)
            elif a == "--pid":
                pid = int(v)
            else:
                timeout = float(v)
            i += 2
        else:
            rest.append(a)
            i += 1
    if coord is None or nprocs is None or pid is None:
        sys.exit("usage: torch_launch_multihost.py --coord HOST:PORT --nprocs N --pid I "
                 "[--timeout SECONDS] <ckpt_dir> [CLI arguments]")
    if not 0 <= pid < nprocs:
        sys.exit(f"--pid {pid} is not in [0, {nprocs})")
    return coord, nprocs, pid, timeout, rest


def main(argv=None):
    coord, nprocs, pid, timeout, rest = parse(list(sys.argv[1:] if argv is None else argv))
    import torch.distributed as dist

    from deepseek_tpu_torch.parallel.mesh import init_distributed

    idx = init_distributed("gloo", f"tcp://{coord}", nprocs, pid, timeout)
    print(f"[multihost] process {idx}/{dist.get_world_size()}", file=sys.stderr, flush=True)

    from deepseek_tpu_torch.cli import main as cli_main
    cli_main(rest)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
