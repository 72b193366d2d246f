"""The device mesh of the port: ``torch.distributed`` in place of a
``jax.sharding.Mesh`` (``deepseek_tpu/parallel/mesh.py``).

One process per shard. ``init_distributed`` joins the process group,
``make_mesh`` describes the four logical axes of the JAX package (data,
expert, tensor, seq). Only the ``seq`` axis is ported: it shards the KV
cache along the window (sequence-parallel decode, context-parallel
prefill; ``parallel/spmd.py``). The ranks of one mesh may share a card:
NCCL takes one rank per device, so ranks that share one use the ``gloo``
backend, which also runs the CPU tests. The backend is the caller's
choice.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch.distributed as dist

AXES = ("data", "expert", "tensor", "seq")


def init_distributed(backend: str = "gloo", init_method: Optional[str] = None,
                     world_size: int = 1, rank: int = 0,
                     timeout: float = 300.0) -> int:
    """Join the process group (the counterpart of ``init_multihost``).
    ``init_method`` is a ``tcp://host:port`` or ``file://path`` rendezvous;
    nothing on the machine announces a cluster, so the caller gives the
    world size and this process's rank. ``timeout`` (seconds) bounds the
    rendezvous and every collective, so a rank that dies makes the others
    raise instead of hanging. Returns the rank."""
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout))
    return dist.get_rank()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes and this process's index along ``seq`` (its rank in the
    default process group, over which the ``seq`` axis runs its
    collectives)."""
    data: int = 1
    expert: int = 1
    tensor: int = 1
    seq: int = 1
    seq_index: int = 0


def make_mesh(data: int = 1, expert: int = 1, tensor: int = 1, seq: int = 1) -> Mesh:
    """A DP x EP x TP x SP mesh of the processes of the default group, which
    must have ``seq`` ranks. The data, expert and tensor axes are not ported
    and raise."""
    others = dict(zip(AXES[:3], (data, expert, tensor)))
    if any(n != 1 for n in others.values()):
        raise NotImplementedError(
            f"mesh axes {others}: only the seq axis is ported; the tensor, "
            "expert and data axes belong to multi-device (ROADMAP.md queue 1, "
            "item 14 (tensor, expert, data axes))")
    if seq < 1:
        raise ValueError(f"seq must be >= 1, got {seq}")
    if seq == 1:
        return Mesh()
    if not dist.is_initialized():
        raise RuntimeError("make_mesh(seq > 1) needs init_distributed first")
    world = dist.get_world_size()
    if world != seq:
        raise ValueError(f"mesh seq={seq} over a process group of {world} ranks")
    return Mesh(seq=seq, seq_index=dist.get_rank())
