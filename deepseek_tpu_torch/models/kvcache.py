"""Ring-buffer + attention-sink KV cache, for either attention path.

``kv_window`` slots per layer (the reference windows at
``rs_original_max_position_embeddings``, infer.cpp:1271-1277). Past the
window, slots are replaced in ring order while the first ``KV_SINKS``
slots hold StreamingLLM sinks whose rope chunk is re-rotated by +1 every
step. Absorbed MLA caches only the shared latent + rope key per slot
(``ckv``/``krope``); the decompressed-MHA path caches every head's key
and value (``k``/``v``). The other pair is None.

Unlike the JAX package's immutable arrays, the port updates the cache in
place: one write per layer per step, no copy of the cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deepseek_tpu_torch.config import KV_SINKS, ModelConfig

_CACHE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class KVCache:
    # absorbed MLA
    ckv: Optional[torch.Tensor] = None     # (L, B, S, kv_lora_rank)
    krope: Optional[torch.Tensor] = None   # (L, B, S, qk_rope_head_dim)
    # decompressed MHA
    k: Optional[torch.Tensor] = None       # (L, B, S, H, head_dim)
    v: Optional[torch.Tensor] = None       # (L, B, S, H, v_head_dim)

    def _first(self) -> torch.Tensor:
        return self.k if self.k is not None else self.ckv

    @property
    def batch(self) -> int:
        return self._first().shape[1]

    @property
    def window(self) -> int:
        return self._first().shape[2]

    @property
    def device(self) -> torch.device:
        return self._first().device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.ckv, self.krope, self.k, self.v) if t is not None)


def init_cache(cfg: ModelConfig, batch: int = 1, device="cpu") -> KVCache:
    dt = _CACHE_DTYPES.get(str(cfg.kv_cache_dtype))
    if dt is None:
        raise NotImplementedError(
            f"kv_cache_dtype={cfg.kv_cache_dtype!r}: the int8 cache is not "
            "ported yet (ROADMAP.md queue 1, item 10)")
    L, S = cfg.n_layers, cfg.kv_window
    if not cfg.use_mla:
        H = cfg.n_heads
        return KVCache(
            k=torch.zeros((L, batch, S, H, cfg.head_dim), dtype=dt, device=device),
            v=torch.zeros((L, batch, S, H, cfg.v_head_dim), dtype=dt, device=device))
    return KVCache(
        ckv=torch.zeros((L, batch, S, cfg.kv_lora_rank), dtype=dt, device=device),
        krope=torch.zeros((L, batch, S, cfg.qk_rope_head_dim), dtype=dt,
                          device=device))


def ring_positions(cfg: ModelConfig, pos: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(kv_sink, kv_pos, kv_len) for decode positions ``pos`` (B,) int64
    (infer.cpp:1271-1277):
      kv_sink = pos >= window ? KV_SINKS : 0
      kv_pos  = kv_sink + (pos - kv_sink) % (window - kv_sink)
      kv_len  = min(pos + 1, window)
    """
    window = cfg.kv_window
    kv_sink = torch.where(pos >= window, KV_SINKS, 0)
    kv_pos = kv_sink + torch.remainder(pos - kv_sink, window - kv_sink)
    kv_len = torch.clamp(pos + 1, max=window)
    return kv_sink, kv_pos, kv_len


def write_rows(cache: KVCache, layer: int, first: torch.Tensor,
               second: torch.Tensor, start: int) -> None:
    """Prefill write into slots start .. start+T-1 of ``layer``, in place:
    the latent rows ckv (B,T,R) and krope (B,T,P) of an MLA cache, or the
    keys (B,T,H,head_dim) and values (B,T,H,v_head_dim) of an MHA cache.
    Prefill runs only while start + T <= window, so slot == position and no
    sink rotates."""
    T = first.shape[1]
    if start < 0 or start + T > cache.window:
        raise ValueError(f"prefill rows {start}..{start + T - 1} leave the "
                         f"{cache.window}-slot window")
    a, b = (cache.k, cache.v) if cache.k is not None else (cache.ckv, cache.krope)
    a[layer, :, start:start + T] = first.to(a.dtype)
    b[layer, :, start:start + T] = second.to(b.dtype)
