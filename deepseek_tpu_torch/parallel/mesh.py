"""The device mesh of the port: ``torch.distributed`` in place of a
``jax.sharding.Mesh`` (``deepseek_tpu/parallel/mesh.py``).

One process per shard. ``init_distributed`` joins the process group,
``make_mesh`` lays the four logical axes of the JAX package (data, expert,
tensor, seq) over its ranks as the JAX grid does: rank r sits at
``np.arange(n).reshape(data, expert, tensor, seq)``'s coordinates of r
(row-major, ``mesh.py:83``). The axes:

- ``data`` (DP) shards the batch: each rank runs its rows of the batch
  and of the KV cache, with the weights replicated; the decode block and
  the batched speculation gather the rows' results over the data line;
- ``expert`` (EP) shards the routed-expert tables; each rank computes the
  token-expert pairs it owns and one all-reduce over the expert line sums
  the mixtures (``parallel/spmd.py``);
- ``tensor`` (TP) shards the attention heads and the FFN hidden width
  (column-parallel w1/w3 and head projections, row-parallel w2 and wo,
  an all-reduce after each row-parallel product) and the lm_head's vocab;
- ``seq`` shards the KV cache along the window (sequence-parallel decode,
  context-parallel prefill).

Every rank builds one ``torch.distributed`` subgroup per line of each axis
larger than 1, in the same order (``new_group`` is collective), and keeps
the lines it sits on. ``make_mesh(stages=s)`` lays s such meshes side by
side over s times the ranks, one a pipeline stage (``parallel/
pipeline.py``). The ranks of one mesh may share a card: NCCL takes one
rank per device, so ranks that share one use the ``gloo`` backend, which
also runs the CPU tests. The backend is the caller's choice.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Optional, Tuple

import numpy as np
import torch.distributed as dist

AXES = ("data", "expert", "tensor", "seq")

# the timeout init_distributed gave the default group, for the subgroups
_TIMEOUT: Optional[datetime.timedelta] = None


def init_distributed(backend: str = "gloo", init_method: Optional[str] = None,
                     world_size: int = 1, rank: int = 0,
                     timeout: float = 300.0) -> int:
    """Join the process group (the counterpart of ``init_multihost``).
    ``init_method`` is a ``tcp://host:port`` or ``file://path`` rendezvous;
    nothing on the machine announces a cluster, so the caller gives the
    world size and this process's rank. ``timeout`` (seconds) bounds the
    rendezvous and every collective, the mesh's subgroups' too, so a rank
    that dies makes the others raise instead of hanging. Returns the
    rank."""
    global _TIMEOUT
    _TIMEOUT = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=_TIMEOUT)
    return dist.get_rank()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes, this process's index along each axis, and the subgroup
    of its line along each axis (None where the axis has one rank, or for
    a mesh built by hand: the default group then runs the collectives)."""
    data: int = 1
    expert: int = 1
    tensor: int = 1
    seq: int = 1
    seq_index: int = 0
    expert_index: int = 0
    tensor_index: int = 0
    expert_group: Any = None
    tensor_group: Any = None
    seq_group: Any = None
    data_index: int = 0
    data_group: Any = None

    @property
    def size(self) -> int:
        return self.data * self.expert * self.tensor * self.seq


def make_mesh(data: int = 1, expert: int = 1, tensor: int = 1, seq: int = 1, *,
              stages: int = 1) -> Mesh:
    """A DP x EP x TP x SP mesh over the default group, which must have
    data * expert * tensor * seq ranks; call it on every rank. With
    ``stages`` the group holds ``stages`` meshes of that shape side by
    side, stage s on ranks [s * n, (s + 1) * n), and each rank gets its
    stage's mesh (the subgroups of every stage are made on every rank)."""
    sizes = (data, expert, tensor, seq)
    if any(n < 1 for n in sizes) or stages < 1:
        raise ValueError(f"mesh axes {dict(zip(AXES, sizes))} and stages {stages} "
                         "must be >= 1")
    n = int(np.prod(sizes))
    if n * stages == 1:
        return Mesh()
    if not dist.is_initialized():
        raise RuntimeError(f"make_mesh over {n * stages} ranks needs init_distributed "
                           "first")
    world = dist.get_world_size()
    if world != n * stages:
        raise ValueError(f"mesh {dict(zip(AXES, sizes))} x {stages} stages needs "
                         f"{n * stages} ranks, the process group has {world}")
    rank = dist.get_rank()
    grid = np.arange(n * stages).reshape((stages,) + sizes)
    coords = [int(c) for c in np.unravel_index(rank % n, sizes)]
    groups = {}
    for ax in range(4):
        if sizes[ax] == 1:
            continue
        for line in np.moveaxis(grid, ax + 1, -1).reshape(-1, sizes[ax]):
            group = dist.new_group(line.tolist(), timeout=_TIMEOUT)
            if rank in line:
                groups[AXES[ax]] = group
    return Mesh(data, expert, tensor, seq, seq_index=coords[3], expert_index=coords[1],
                tensor_index=coords[2], expert_group=groups.get("expert"),
                tensor_group=groups.get("tensor"), seq_group=groups.get("seq"),
                data_index=coords[0], data_group=groups.get("data"))


def default_mesh_shape(n_devices: int, cfg=None) -> Tuple[int, int, int]:
    """Balanced (data, expert, tensor) factorization for n devices
    (``deepseek_tpu/parallel/mesh.py::default_mesh_shape``).

    Prime factors are assigned round-robin expert -> tensor -> data (expert
    parallelism first: routed-expert products dominate decode bytes for
    MoE), respecting divisibility of n_routed_experts / n_heads when a
    config is given. Any factor that fits nowhere lands on data.
    """
    factors = []
    n = n_devices
    for p in (2, 3, 5, 7):
        while n % p == 0:
            factors.append(p)
            n //= p
    if n > 1:
        factors.append(n)

    data = expert = tensor = 1
    moe = cfg is None or cfg.n_routed_experts > 0
    order = 0
    for f in sorted(factors, reverse=True):
        placed = False
        for _ in range(3):
            which = ("expert", "tensor", "data")[order % 3]
            order += 1
            if which == "expert":
                if moe and (cfg is None or cfg.n_routed_experts % (expert * f) == 0):
                    expert *= f
                    placed = True
                    break
            elif which == "tensor":
                if cfg is None or cfg.n_heads % (tensor * f) == 0:
                    tensor *= f
                    placed = True
                    break
            else:
                data *= f
                placed = True
                break
        if not placed:
            data *= f
    return (data, expert, tensor)
