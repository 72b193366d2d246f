"""Activation capture: the port of ``deepseek_tpu/utils/debug.py``.

Captures named intermediate activations of a forward, writes them as one
safetensors file and diffs two captures by per-tensor max error: the tool
for holding a run against an outside reference (a HuggingFace or numpy
run, the JAX package, the card against the CPU). The file format is the
JAX package's, so a capture written by either package loads in the other.

    with debug_capture() as cap:
        forward_prefill(params, cache, tokens, 0, cfg)
    cap.save("acts.safetensors")

The forward's hooks (``models/deepseek.py``: ``embed``, ``l{i}.attn_norm``,
``l{i}.attn``, ``l{i}.ffn_norm``, ``l{i}.ffn``, ``logits``, the JAX names)
call ``dbg``, which returns at once when no capture is active: no copy to
the host and no synchronization. While one is, each hook copies its
tensor to the host (a synchronizing read on the card).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from deepseek_tpu_torch.utils import codec

_active: Optional["DebugCapture"] = None


class DebugCapture:
    def __init__(self):
        self.tensors: Dict[str, np.ndarray] = {}

    def add(self, name: str, value) -> None:
        base = name
        i = 1
        while name in self.tensors:  # repeated layers/steps get suffixes
            i += 1
            name = f"{base}#{i}"
        if isinstance(value, torch.Tensor):
            value = value.detach().float().cpu().numpy()
        self.tensors[name] = np.asarray(value, dtype=np.float32)

    def save(self, path: str) -> None:
        codec.save_shard(path, self.tensors)

    @classmethod
    def load(cls, path: str) -> "DebugCapture":
        cap = cls()
        _, tensors = codec.load_shard(path, read_metadata=False)
        cap.tensors = {k: np.asarray(v.array, np.float32) for k, v in tensors.items()}
        return cap

    def max_err(self, other: "DebugCapture") -> Dict[str, float]:
        """Per-tensor max abs error against another capture, over the names
        both hold (inf where the shapes differ)."""
        out = {}
        for k in self.tensors:
            if k in other.tensors:
                a, b = self.tensors[k], other.tensors[k]
                if a.shape != b.shape:
                    out[k] = float("inf")
                else:
                    out[k] = float(np.abs(a - b).max())
        return out


@contextlib.contextmanager
def debug_capture() -> Iterator[DebugCapture]:
    global _active
    cap = DebugCapture()
    prev, _active = _active, cap
    try:
        yield cap
    finally:
        _active = prev


def dbg(name: str, value) -> None:
    """Record an activation if a capture is active (a no-op otherwise)."""
    if _active is not None:
        _active.add(name, value)


def capture_active() -> bool:
    """True while a debug capture is recording."""
    return _active is not None
