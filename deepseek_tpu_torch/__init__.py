"""PyTorch + CUDA port of deepseek_tpu for one NVIDIA H100.

Imports torch, never jax and nothing of ``deepseek_tpu``. The entry point is
``deepseek_tpu_torch.engine.Engine``; the hand-written Hopper kernels live
in ``csrc/`` and are wrapped by ``ops/kernels/``.
"""

from deepseek_tpu_torch.config import ModelConfig

__all__ = ["ModelConfig"]
