"""Kernels K3 and K8: flash decode over the ring cache.

``mla_decode_attn`` replaces ``deepseek_tpu/ops/pallas/attention.py::
mla_decode_attn`` (``_mla_body``, K3: absorbed MLA over the latent cache)
and launches ``csrc/mla_decode.cu``; ``mha_decode_attn`` replaces
``::mha_decode_attn`` (``_mha_body``, K8: decompressed MHA over the
per-head key/value cache) and launches ``csrc/mha_decode.cu``. Both run a
split-KV pass writing (acc, m, l) partials, then an exact merge (see the
source headers for the designs and their bounds). ``.launches`` counts
calls that launched each. CPU tensors take the plain versions
(ops.attention.decode_attn_*); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import math

import torch

from deepseek_tpu_torch.ops.attention import decode_attn_mha, decode_attn_mla
from deepseek_tpu_torch.ops.kernels.build import check, library

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_TILE = 32          # cache slots per tile in the kernel (kTS)
_HEADS = 16         # heads per block (kHG)
_MAX_SPLITS = 64    # kMaxSplits


def mla_decode_attn_plain(q_c, q_rope, ckv_cache, krope_cache, kv_len,
                          softmax_scale: float) -> torch.Tensor:
    return decode_attn_mla(q_c, q_rope, ckv_cache, krope_cache, kv_len,
                           head_dim=0, softmax_scale=softmax_scale)


def _n_splits(device, B: int, H: int, S: int) -> int:
    """KV splits per (sequence, head group): about two blocks per SM, at
    most one split per tile of the cache."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = B * math.ceil(H / _HEADS)
    return max(1, min(math.ceil(S / _TILE), math.ceil(2 * sms / blocks),
                      _MAX_SPLITS))


def mla_decode_attn(q_c: torch.Tensor, q_rope: torch.Tensor,
                    ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
                    kv_len: torch.Tensor, softmax_scale: float) -> torch.Tensor:
    """q_c (B,H,R), q_rope (B,H,P), ckv_cache (B,S,R), krope_cache (B,S,P)
    in f32/f16/bf16, kv_len (B,) -> attended latents (B,H,R) float32."""
    if q_c.device.type == "cpu":
        return mla_decode_attn_plain(q_c, q_rope, ckv_cache, krope_cache,
                                     kv_len, softmax_scale)
    if q_c.device.type != "cuda":
        raise ValueError(f"mla_decode_attn runs on cuda or cpu, not {q_c.device}")
    B, H, R = q_c.shape
    P = q_rope.shape[-1]
    S = ckv_cache.shape[1]
    if (ckv_cache.shape != (B, S, R) or krope_cache.shape != (B, S, P)
            or q_rope.shape != (B, H, P)):
        raise ValueError("mla_decode_attn: inconsistent shapes "
                         f"{tuple(q_c.shape)} {tuple(q_rope.shape)} "
                         f"{tuple(ckv_cache.shape)} {tuple(krope_cache.shape)}")
    if ckv_cache.dtype != krope_cache.dtype or ckv_cache.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported cache dtype {ckv_cache.dtype}")
    if R > 512 or R + P > 768 or (R + P) % 4:
        raise ValueError(f"mla_decode_attn needs R <= 512, R+P <= 768 and "
                         f"(R+P) % 4 == 0, got R={R} P={P}")
    dev = q_c.device
    for t in (q_rope, ckv_cache, krope_cache):
        if t.device != dev:
            raise ValueError("mla_decode_attn: operands on different devices")
    ckv = ckv_cache.contiguous()
    kr = krope_cache.contiguous()
    qc = q_c.float().contiguous()
    qr = q_rope.float().contiguous()
    kl = torch.as_tensor(kv_len, device=dev).reshape(-1).expand(B) \
        .to(torch.int32).contiguous()
    ns = _n_splits(dev, B, H, S)
    out = torch.empty((B, H, R), dtype=torch.float32, device=dev)
    acc = torch.empty((B, H, ns, R), dtype=torch.float32, device=dev)
    m = torch.empty((B, H, ns), dtype=torch.float32, device=dev)
    l = torch.empty((B, H, ns), dtype=torch.float32, device=dev)
    err = library("mla_decode").mla_decode(
        qc.data_ptr(), qr.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
        kl.data_ptr(), out.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), B, H, S, R, P, _DTYPE_CODE[ckv.dtype], ns,
        float(softmax_scale), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "mla_decode")
    mla_decode_attn.launches += 1
    return out


mla_decode_attn.launches = 0


_MHA_MAX_D = 256          # kMaxD in csrc/mha_decode.cu
_MHA_MAX_SPLITS = 256     # kMaxSplits


def mha_decode_attn_plain(q, k_cache, v_cache, kv_len,
                          softmax_scale: float) -> torch.Tensor:
    return decode_attn_mha(q, k_cache, v_cache, kv_len, softmax_scale)


def mha_decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, kv_len: torch.Tensor,
                    softmax_scale: float, k_scale=None, v_scale=None,
                    partials: bool = False) -> torch.Tensor:
    """K8: q (B,H,Dh), k_cache (B,S,H,Dh), v_cache (B,S,H,Dv) in
    f32/f16/bf16, kv_len (B,) -> (B,H,Dv) float32. The int8 scales
    (ROADMAP.md queue 1, item 10) and seq-parallel ``partials`` (item 14)
    are not ported and raise."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "mha_decode_attn: int8 cache scales are not ported yet (ROADMAP.md "
            "queue 1, item 10)")
    if partials:
        raise NotImplementedError(
            "mha_decode_attn: seq-parallel partials are not ported yet "
            "(ROADMAP.md queue 1, item 14)")
    if q.device.type == "cpu":
        return mha_decode_attn_plain(q, k_cache, v_cache, kv_len, softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha_decode_attn runs on cuda or cpu, not {q.device}")
    B, H, Dh = q.shape
    S, Dv = k_cache.shape[1], v_cache.shape[-1]
    if k_cache.shape != (B, S, H, Dh) or v_cache.shape != (B, S, H, Dv):
        raise ValueError("mha_decode_attn: inconsistent shapes "
                         f"{tuple(q.shape)} {tuple(k_cache.shape)} {tuple(v_cache.shape)}")
    dt = k_cache.dtype
    if v_cache.dtype != dt or dt not in _DTYPE_CODE:
        raise ValueError(f"unsupported cache dtypes {dt}, {v_cache.dtype}")
    per_vec = 16 // k_cache.element_size()
    if Dh > _MHA_MAX_D or Dv > _MHA_MAX_D or Dh % per_vec or Dv % per_vec:
        raise ValueError(f"mha_decode_attn needs head widths <= {_MHA_MAX_D} in "
                         f"whole 16-byte vectors, got Dh={Dh} Dv={Dv} ({dt})")
    dev = q.device
    for t in (k_cache, v_cache):
        if t.device != dev:
            raise ValueError("mha_decode_attn: operands on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("mha_decode_attn: the cache must be contiguous "
                             "and 16-byte aligned")
    qf = q.float().contiguous()
    kl = torch.as_tensor(kv_len, device=dev).reshape(-1).expand(B) \
        .to(torch.int32).contiguous()
    # about two blocks per SM, at most one split per 32-slot tile
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = B * math.ceil(H / _HEADS)
    ns = max(1, min(math.ceil(S / _TILE), math.ceil(2 * sms / blocks),
                    _MHA_MAX_SPLITS))
    out = torch.empty((B, H, Dv), dtype=torch.float32, device=dev)
    acc = torch.empty((B, H, ns, Dv), dtype=torch.float32, device=dev)
    m = torch.empty((B, H, ns), dtype=torch.float32, device=dev)
    l = torch.empty((B, H, ns), dtype=torch.float32, device=dev)
    err = library("mha_decode").mha_decode(
        qf.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kl.data_ptr(),
        out.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, H, S, Dh, Dv, _DTYPE_CODE[dt], ns, float(softmax_scale),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "mha_decode")
    mha_decode_attn.launches += 1
    return out


mha_decode_attn.launches = 0
