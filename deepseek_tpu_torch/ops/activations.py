"""GLU feed-forward activations (reference infer.cpp:636-646)."""

from __future__ import annotations

import torch

from deepseek_tpu_torch.config import ActivationType


def glu_act(gate: torch.Tensor, up: torch.Tensor, act: ActivationType) -> torch.Tensor:
    """act(gate) * up — the GLU nonlinearity used in every FFN."""
    g = gate.float()
    if act == ActivationType.SILU:
        a = g * torch.sigmoid(g)
    else:  # tanh-approximated GELU, matching the reference's gelu()
        a = 0.5 * g * (1.0 + torch.tanh(0.797885 * (g + 0.044715 * g * g * g)))
    return (a * up.float()).to(gate.dtype)
