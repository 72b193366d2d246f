"""Ring-buffer + attention-sink KV cache, for either attention path.

``kv_window`` slots per layer (the reference windows at
``rs_original_max_position_embeddings``, infer.cpp:1271-1277). Past the
window, slots are replaced in ring order while the first ``KV_SINKS``
slots hold StreamingLLM sinks whose rope chunk is re-rotated by +1 every
step. Absorbed MLA caches only the shared latent + rope key per slot
(``ckv``/``krope``); the decompressed-MHA path caches every head's key
and value (``k``/``v``). The other pair is None.

``kv_cache_dtype="int8"`` stores each row as int8 with one f32 amax/127
scale per (slot, [head]) row (``quantize_rows``), half the bytes of f16,
and keeps a float master of the sink rows (``sink_krope``/``sink_k``): the
sinks re-rotate from the master and are quantized fresh every step, so
the int8 rounding does not compound over the rotations.

Unlike the JAX package's immutable arrays, the port updates the cache in
place: one write per layer per step, no copy of the cache.

On a mesh with a ``seq`` axis (``parallel/``) each rank holds one slice
of the window (``parallel/sharding.py::shard_cache``): the writes take
the forward's ``SpmdCtx`` and commit only the rows that fall in the
rank's slice; the int8 sink masters stay whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deepseek_tpu_torch.config import KV_SINKS, ModelConfig
from deepseek_tpu_torch.parallel.spmd import NULL_CTX, SpmdCtx

_CACHE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16, "int8": torch.int8}


@dataclasses.dataclass
class KVCache:
    # absorbed MLA
    ckv: Optional[torch.Tensor] = None     # (L, B, S, kv_lora_rank)
    krope: Optional[torch.Tensor] = None   # (L, B, S, qk_rope_head_dim)
    # decompressed MHA
    k: Optional[torch.Tensor] = None       # (L, B, S, H, head_dim)
    v: Optional[torch.Tensor] = None       # (L, B, S, H, v_head_dim)
    # int8 caches only: f32 scale of each stored row (amax / 127)
    k_s: Optional[torch.Tensor] = None      # (L, B, S, H)
    v_s: Optional[torch.Tensor] = None      # (L, B, S, H)
    ckv_s: Optional[torch.Tensor] = None    # (L, B, S)
    krope_s: Optional[torch.Tensor] = None  # (L, B, S)
    # int8 caches only: float masters of the sink rows
    sink_krope: Optional[torch.Tensor] = None  # (L, B, KV_SINKS, P) f32
    sink_k: Optional[torch.Tensor] = None      # (L, B, KV_SINKS, H, head_dim) f32

    def _first(self) -> torch.Tensor:
        return self.k if self.k is not None else self.ckv

    @property
    def quantized(self) -> bool:
        return self._first().dtype == torch.int8

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
        """Bytes of the rows and their scales; the sink masters are not
        counted (as in the JAX package)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.ckv, self.krope, self.k, self.v, self.k_s,
                             self.v_s, self.ckv_s, self.krope_s) if t is not None)


def init_cache(cfg: ModelConfig, batch: int = 1, device="cpu") -> KVCache:
    dt = _CACHE_DTYPES.get(str(cfg.kv_cache_dtype))
    if dt is None:
        raise ValueError(f"kv_cache_dtype={cfg.kv_cache_dtype!r}: expected one of "
                         f"{sorted(_CACHE_DTYPES)}")
    L, S = cfg.n_layers, cfg.kv_window
    q8 = dt == torch.int8

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def f32(*shape):
        return zeros(*shape, dtype=torch.float32) if q8 else None

    if not cfg.use_mla:
        H = cfg.n_heads
        return KVCache(k=zeros(L, batch, S, H, cfg.head_dim),
                       v=zeros(L, batch, S, H, cfg.v_head_dim),
                       k_s=f32(L, batch, S, H), v_s=f32(L, batch, S, H),
                       sink_k=f32(L, batch, KV_SINKS, H, cfg.head_dim))
    return KVCache(ckv=zeros(L, batch, S, cfg.kv_lora_rank),
                   krope=zeros(L, batch, S, cfg.qk_rope_head_dim),
                   ckv_s=f32(L, batch, S), krope_s=f32(L, batch, S),
                   sink_krope=f32(L, batch, KV_SINKS, cfg.qk_rope_head_dim))


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) f32 -> (int8 rows, f32 scale amax/127 (...,)); the JAX
    package's rounding bit for bit (half to even, clipped to +-127)."""
    scale = x.abs().amax(dim=-1) / 127.0
    q = torch.round(x / torch.clamp(scale, min=1e-20)[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale.float()


def dequant_rows(q: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverse of quantize_rows; a float cache (scale None) passes through."""
    if scale is None:
        return q
    return q.float() * scale[..., None]


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
               second: torch.Tensor, start: int, ctx: SpmdCtx = NULL_CTX) -> None:
    """Prefill write into slots start .. start+T-1 of ``layer``, in place:
    the latent rows ckv (B,T,R) and krope (B,T,P) of an MLA cache, or the
    keys (B,T,H,head_dim) and values (B,T,H,v_head_dim) of an MHA cache.
    Prefill runs only while start + T <= window, so slot == position and no
    sink rotates. An int8 cache stores the rows quantized (each widened to
    f32 first), their scales, and the f32 keys of rows landing in the sink
    slots as their masters (``deepseek_tpu/models/deepseek.py::
    _sink_update``).

    Under a ``seq`` axis (``ctx.sp > 1``) the cache is this rank's slice of
    the window and only the chunk's rows inside it are committed
    (``deepseek.py::_cache_write_sp_prefill``); under context parallelism
    (``ctx.cp``) the rows are this rank's share of the chunk, gathered
    first at the cache dtype, int8 with their scales, as JAX gathers them
    after quantizing (``deepseek.py:296-305``)."""
    s_local = cache.window
    lo = ctx.sidx * s_local
    mha = cache.k is not None
    a, b = (cache.k, cache.v) if mha else (cache.ckv, cache.krope)
    a_s, b_s = (cache.k_s, cache.v_s) if mha else (cache.ckv_s, cache.krope_s)
    key = first if mha else second
    if cache.quantized:
        (first, fs), (second, ss) = quantize_rows(first.float()), quantize_rows(second.float())
    else:
        first, second, fs, ss = first.to(a.dtype), second.to(b.dtype), None, None
    master = cache.sink_k if mha else cache.sink_krope
    if ctx.cp:
        first, second, fs, ss = map(ctx.cp_gather_rows, (first, second, fs, ss))
        key = ctx.cp_gather_rows(key.float()) if master is not None else key
    T = first.shape[1]
    if start < 0 or start + T > s_local * ctx.sp:
        raise ValueError(f"prefill rows {start}..{start + T - 1} leave the "
                         f"{s_local * ctx.sp}-slot window")
    # the chunk's rows inside this rank's slots lo .. lo + s_local - 1
    g0, g1 = max(start, lo), min(start + T, lo + s_local)
    if g0 < g1:
        src, dst = slice(g0 - start, g1 - start), slice(g0 - lo, g1 - lo)
        for t, x in ((a, first), (b, second), (a_s, fs), (b_s, ss)):
            if x is not None:
                t[layer, :, dst] = x[:, src]
    n = min(start + T, KV_SINKS) - start
    if master is not None and n > 0:
        master[layer, :, start:start + n] = key[:, :n].float()


def write_slot(t: torch.Tensor, bidx: torch.Tensor, lpos: torch.Tensor, x: torch.Tensor,
               own=None) -> None:
    """t[bidx, lpos] = x in place, or, with ``own`` (B,) bool (a window
    shard: the slot lies in this rank's slice), only where owned."""
    if own is not None:
        old = t[bidx, lpos]
        x = torch.where(own.reshape((-1,) + (1,) * (x.dim() - 1)), x.to(t.dtype), old)
    t[bidx, lpos] = x.to(t.dtype)


def write_step_int8(cache: KVCache, layer: int, kv_pos: torch.Tensor,
                    first: torch.Tensor, second: torch.Tensor,
                    kv_sink: torch.Tensor, rotate, ctx: SpmdCtx = NULL_CTX) -> None:
    """Decode write into an int8 cache, in place and without a host sync:
    the rows first (B,...) and second (B,...) (MLA: ckv, krope; MHA: the
    keys and values of every head) quantized into ring slots kv_pos (B,)
    with their scales; a key landing in a sink slot mirrored into the
    float master (``deepseek.py::_sink_update``); then, for sequences
    whose ring has wrapped (kv_sink > 0), the master re-rotated by
    ``rotate(master)`` and the sink keys quantized fresh from it, whole
    rows, as one scale covers each (``deepseek.py:410-430, 580-601``).
    Under a ``seq`` axis only the shard that holds slot kv_pos commits the
    row, the master (whole on every rank) follows the global slot, and the
    sink slots, on shard 0, are requantized there only."""
    mha = cache.k is not None
    a, b = (cache.k, cache.v) if mha else (cache.ckv, cache.krope)
    a_s, b_s = (cache.k_s, cache.v_s) if mha else (cache.ckv_s, cache.krope_s)
    bidx = torch.arange(kv_pos.shape[0], device=kv_pos.device)
    lpos, own = ctx.local_slots(kv_pos, cache.window * ctx.sp)
    for t, t_s, x in ((a, a_s, first), (b, b_s, second)):
        q, sc = quantize_rows(x.float())
        write_slot(t[layer], bidx, lpos, q, own)
        write_slot(t_s[layer], bidx, lpos, sc, own)
    keys, keys_s, key = (a, a_s, first) if mha else (b, b_s, second)
    master = (cache.sink_k if mha else cache.sink_krope)[layer]
    expand = (-1,) + (1,) * (key.dim() - 1)
    slot = kv_pos.clamp(max=KV_SINKS - 1)
    hit = (kv_pos < KV_SINKS).reshape(expand)
    master[bidx, slot] = torch.where(hit, key.float(), master[bidx, slot])
    keep = (kv_sink > 0).reshape(expand + (1,))
    rot = rotate(master)
    master.copy_(torch.where(keep, rot, master))
    if ctx.sidx != 0:
        return                      # the sink slots live on seq shard 0
    rot_q, rot_s = quantize_rows(rot)
    sinks = keys[layer, :, :KV_SINKS]
    sinks.copy_(torch.where(keep, rot_q, sinks))
    sinks_s = keys_s[layer, :, :KV_SINKS]
    sinks_s.copy_(torch.where(keep[..., 0], rot_s, sinks_s))
