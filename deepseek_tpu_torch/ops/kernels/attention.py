"""Kernels K3 and K8: flash decode over the ring cache.

``mla_decode_attn`` replaces ``deepseek_tpu/ops/pallas/attention.py::
mla_decode_attn`` (``_mla_body``, K3: absorbed MLA over the latent cache)
and launches the decode mode of ``csrc/prefill_attn.cu`` (K10's kernel on
Hopper's tensor cores with one query: 64 heads a block as the MMA's rows,
the f32 function through split bf16 operands); ``mha_decode_attn``
replaces ``::mha_decode_attn`` (``_mha_body``, K8: decompressed MHA over
the per-head key/value cache) and launches ``csrc/mha_decode.cu``. Both
run a split-KV pass writing (acc, m, l) partials, then an exact merge (see
the source headers for the designs and their bounds; the split counts are
``mla_decode_splits`` and ``decode_splits``, pure functions of the shapes:
kv_len stays on the card). Over an int8 cache both
take the f32 scales of the stored rows, in the JAX layouts: (B,S) for the
latent rows, head-major (B,H,S) for the per-head keys and values, which
K8 reads through their strides (the cache's (B,S,H) scales transposed, no
copy). With ``partials=True`` (sequence-parallel decode over one shard
of the window) each returns the TPU kernel's partials triple instead of
the normalized output: the unnormalized accumulator and its flash
statistics (acc, m (B,H), l (B,H)); the merge kernel combines its splits
without dividing. ``.launches`` counts the normalized launches over a
float cache, ``.int8.launches`` those over an int8 cache,
``.partials.launches`` and ``.partials.int8.launches`` the partials ones;
K3 also counts its normalized launches over f16 and f32 caches (the
two-term bodies) in ``.f16.launches`` / ``.f32.launches``.
CPU tensors take the plain versions (ops.attention.decode_attn_*); CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from deepseek_tpu_torch.ops.attention import (
    decode_attn_mha, decode_attn_mha_partial, decode_attn_mla,
    decode_attn_mla_partial,
)
from deepseek_tpu_torch.ops.kernels.build import check, library

DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2, torch.int8: 3}
# K3's decode mode of csrc/prefill_attn.cu (the tests read its constants
# there): heads a block (Cfg::BM), the latent widths it is built for (its
# DV instances) and the splits its merge takes (kMaxDecodeSplits)
_DECODE_ROWS = 64
_DECODE_R = (128, 512)
_MAX_DECODE_SPLITS = 128
_DECODE_SPAN_ALIGN = 64     # split spans are whole multiples of every tile size
_DECODE_FILL_BLOCKS = 132   # one block an SM (a block takes ~226 KB of shared memory)
_DECODE_MAX_BLOCKS = 1024   # of a launch (bounds the partials' scratch: 134 MB at V3)


def launch_counters() -> SimpleNamespace:
    """A wrapper's partials counts: float cache, and ``.int8``."""
    return SimpleNamespace(launches=0, int8=SimpleNamespace(launches=0))


def count_launch(fn, partials: bool, q8: bool) -> None:
    """One launch of ``fn``'s kernel, counted by its body."""
    c = fn.partials if partials else fn
    (c.int8 if q8 else c).launches += 1


_TWO_TERM = {torch.float16: "f16", torch.float32: "f32"}


def count_body(fn, partials: bool, cache_dtype) -> None:
    """``count_launch``, and among the normalized float launches those
    over f16 and f32 caches (the bodies that take the cache in two bf16
    terms) in ``.f16`` / ``.f32``."""
    count_launch(fn, partials, cache_dtype == torch.int8)
    if not partials and cache_dtype in _TWO_TERM:
        getattr(fn, _TWO_TERM[cache_dtype]).launches += 1


def stats_outputs(partials: bool, shape, dev):
    """(m, l) f32 buffers of ``shape`` for a partials launch, else (None, None)."""
    if not partials:
        return None, None
    return (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.float32, device=dev))


def check_scales(name: str, cache: torch.Tensor, scales, shape) -> None:
    """An int8 cache needs both f32 scales of ``shape`` on its device; a
    float cache takes none."""
    if cache.dtype != torch.int8:
        if any(s is not None for s in scales):
            raise ValueError(f"{name}: scales come with an int8 cache, not {cache.dtype}")
        return
    for s in scales:
        if s is None or s.dtype != torch.float32 or tuple(s.shape) != tuple(shape) \
                or s.device != cache.device:
            raise ValueError(f"{name}: an int8 cache needs f32 scales of shape "
                             f"{tuple(shape)} on {cache.device}")


def data_ptr_or_0(t) -> int:
    return 0 if t is None else t.data_ptr()


def mla_decode_attn_plain(q_c, q_rope, ckv_cache, krope_cache, kv_len,
                          softmax_scale: float, ckv_scale=None,
                          krope_scale=None, partials: bool = False):
    fn = decode_attn_mla_partial if partials else decode_attn_mla
    return fn(q_c, q_rope, ckv_cache, krope_cache, kv_len, head_dim=0,
              softmax_scale=softmax_scale, ckv_scale=ckv_scale,
              krope_scale=krope_scale)


def mla_decode_splits(B: int, H: int, S: int):
    """(n_split, span): K3 walks the window of S slots in n_split spans of
    ``span`` slots, one block per span, 64-head row block and sequence; a
    merge kernel combines the spans' partials. The spans are one
    sequence's (about ``_DECODE_FILL_BLOCKS`` blocks for its row blocks),
    the same for every batch whose launch stays within
    ``_DECODE_MAX_BLOCKS`` blocks, so that a sequence's attended latents are
    the same bits whatever batch it is decoded in (a served row equals the
    sequence decoded alone; V3: up to 8 sequences); a larger batch takes
    longer spans. A pure function of the shapes (kv_len stays on the
    card): spans past a sequence's live prefix return at once."""
    row_blocks = -(-H // _DECODE_ROWS)
    chunks = -(-S // _DECODE_SPAN_ALIGN)
    n = max(1, min(-(-_DECODE_FILL_BLOCKS // row_blocks), chunks, _MAX_DECODE_SPLITS,
                   _DECODE_MAX_BLOCKS // (B * row_blocks)))
    span = -(-chunks // n) * _DECODE_SPAN_ALIGN
    return -(-S // span), span


def check_mla_decode_shapes(B: int, H: int, S: int, R: int, P: int, dtype) -> None:
    """Raise ValueError unless K3's decode kernel takes these shapes."""
    if min(B, H, S, R) <= 0 or P < 0 or B > 65535:
        raise ValueError(f"mla_decode_attn: empty or oversized shapes B={B} H={H} "
                         f"S={S} R={R} P={P}")
    if R not in _DECODE_R or (R + P) % 4:
        raise ValueError(f"mla_decode_attn needs R in {_DECODE_R} and (R+P) % 4 == 0, "
                         f"got R={R} P={P}")
    if dtype not in DTYPE_CODE:
        raise ValueError(f"mla_decode_attn: unsupported cache dtype {dtype}")


def mla_decode_attn(q_c: torch.Tensor, q_rope: torch.Tensor,
                    ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
                    kv_len: torch.Tensor, softmax_scale: float, ckv_scale=None,
                    krope_scale=None, partials: bool = False):
    """K3: q_c (B,H,R), q_rope (B,H,P), ckv_cache (B,S,R), krope_cache
    (B,S,P) in f32/f16/bf16, or int8 with ckv_scale/krope_scale (B,S) f32,
    kv_len (B,) -> attended latents (B,H,R) float32; with ``partials``
    (acc (B,H,R), m (B,H), l (B,H)) over this shard of the window."""
    if q_c.device.type == "cpu":
        return mla_decode_attn_plain(q_c, q_rope, ckv_cache, krope_cache,
                                     kv_len, softmax_scale, ckv_scale, krope_scale,
                                     partials)
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
    if ckv_cache.dtype != krope_cache.dtype:
        raise ValueError(f"mla_decode_attn: cache dtypes {ckv_cache.dtype} and "
                         f"{krope_cache.dtype} differ")
    check_mla_decode_shapes(B, H, S, R, P, ckv_cache.dtype)
    dev = q_c.device
    for t in (q_rope, ckv_cache, krope_cache):
        if t.device != dev:
            raise ValueError("mla_decode_attn: operands on different devices")
    check_scales("mla_decode_attn", ckv_cache, (ckv_scale, krope_scale), (B, S))
    q8 = ckv_cache.dtype == torch.int8
    cs = ckv_scale.contiguous() if q8 else None
    rs = krope_scale.contiguous() if q8 else None
    ckv = ckv_cache.contiguous()
    kr = krope_cache.contiguous()
    qc = q_c.float().contiguous()
    qr = q_rope.float().contiguous()
    kl = torch.as_tensor(kv_len, device=dev).reshape(-1).expand(B) \
        .to(torch.int32).contiguous()
    ns, span = mla_decode_splits(B, H, S)
    out = torch.empty((B, H, R), dtype=torch.float32, device=dev)
    m_out, l_out = stats_outputs(partials, (B, H), dev)
    scratch = None if ns == 1 else torch.empty(
        ns * B * H * (R + 2), dtype=torch.float32, device=dev)
    err = library("prefill_attn").mla_decode(
        qc.data_ptr(), qr.data_ptr(), ckv.data_ptr(), kr.data_ptr(), data_ptr_or_0(cs),
        data_ptr_or_0(rs), kl.data_ptr(), out.data_ptr(), data_ptr_or_0(m_out),
        data_ptr_or_0(l_out), data_ptr_or_0(scratch), ns, span, B, H, S, R, P,
        DTYPE_CODE[ckv.dtype], float(softmax_scale),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "mla_decode")
    count_body(mla_decode_attn, partials, ckv.dtype)
    return (out, m_out, l_out) if partials else out


mla_decode_attn.launches = 0
mla_decode_attn.int8 = SimpleNamespace(launches=0)
mla_decode_attn.partials = launch_counters()
mla_decode_attn.f16 = SimpleNamespace(launches=0)
mla_decode_attn.f32 = SimpleNamespace(launches=0)


# csrc/mha_decode.cu's constants (the tests read them there): head widths
# (kMaxD), splits its merge takes (kMaxSplits), heads a block (kHG)
_MHA_MAX_D = 256
_MHA_MAX_SPLITS = 256
_MHA_HEADS = 8
_MHA_SPAN_ALIGN = 8       # split spans are whole tiles (TS: 8 int8, 4 otherwise)
_MHA_FILL_BLOCKS = 264    # about 2 blocks on each of the H100's 132 SMs


def decode_splits(B: int, H: int, S: int):
    """(n_split, span): K8 walks the window of S slots in n_split spans
    of ``span`` slots, one block per span, head group and sequence, about
    ``_MHA_FILL_BLOCKS`` blocks in all; a merge kernel combines the spans'
    partials. A pure function of the shapes (kv_len stays on the card)."""
    blocks = B * -(-H // _MHA_HEADS)
    chunks = -(-S // _MHA_SPAN_ALIGN)
    n = max(1, min(-(-_MHA_FILL_BLOCKS // blocks), chunks, _MHA_MAX_SPLITS))
    span = -(-chunks // n) * _MHA_SPAN_ALIGN
    return -(-S // span), span


def mha_decode_attn_plain(q, k_cache, v_cache, kv_len, softmax_scale: float,
                          k_scale=None, v_scale=None, partials: bool = False):
    fn = decode_attn_mha_partial if partials else decode_attn_mha
    return fn(q, k_cache, v_cache, kv_len, softmax_scale, k_scale, v_scale)


def head_major_strides(name: str, k_scale, v_scale):
    """(b, h, s) element strides shared by the two (B,H,S) scale views,
    (0, 0, 0) without scales."""
    if k_scale is None:
        return 0, 0, 0
    if k_scale.stride() != v_scale.stride():
        raise ValueError(f"{name}: k_scale and v_scale need the same strides, "
                         f"got {k_scale.stride()} and {v_scale.stride()}")
    return k_scale.stride()


def mha_decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, kv_len: torch.Tensor,
                    softmax_scale: float, k_scale=None, v_scale=None,
                    partials: bool = False):
    """K8: q (B,H,Dh), k_cache (B,S,H,Dh), v_cache (B,S,H,Dv) in
    f32/f16/bf16, or int8 with k_scale/v_scale (B,H,S) f32 (any strides:
    the cache's (B,S,H) scales transposed), kv_len (B,) -> (B,H,Dv)
    float32; with ``partials`` (acc (B,H,Dv), m (B,H), l (B,H)) over this
    shard of the window."""
    if q.device.type == "cpu":
        return mha_decode_attn_plain(q, k_cache, v_cache, kv_len, softmax_scale,
                                     k_scale, v_scale, partials)
    if q.device.type != "cuda":
        raise ValueError(f"mha_decode_attn runs on cuda or cpu, not {q.device}")
    B, H, Dh = q.shape
    S, Dv = k_cache.shape[1], v_cache.shape[-1]
    if k_cache.shape != (B, S, H, Dh) or v_cache.shape != (B, S, H, Dv):
        raise ValueError("mha_decode_attn: inconsistent shapes "
                         f"{tuple(q.shape)} {tuple(k_cache.shape)} {tuple(v_cache.shape)}")
    dt = k_cache.dtype
    if v_cache.dtype != dt or dt not in DTYPE_CODE:
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
    check_scales("mha_decode_attn", k_cache, (k_scale, v_scale), (B, H, S))
    sb, sh, ss = head_major_strides("mha_decode_attn", k_scale, v_scale)
    qf = q.float().contiguous()
    kl = torch.as_tensor(kv_len, device=dev).reshape(-1).expand(B) \
        .to(torch.int32).contiguous()
    ns, span = decode_splits(B, H, S)
    out = torch.empty((B, H, Dv), dtype=torch.float32, device=dev)
    m_out, l_out = stats_outputs(partials, (B, H), dev)
    acc = torch.empty((B, H, ns, Dv), dtype=torch.float32, device=dev)
    m = torch.empty((B, H, ns), dtype=torch.float32, device=dev)
    l = torch.empty((B, H, ns), dtype=torch.float32, device=dev)
    err = library("mha_decode").mha_decode(
        qf.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), data_ptr_or_0(k_scale),
        data_ptr_or_0(v_scale), kl.data_ptr(), out.data_ptr(), data_ptr_or_0(m_out),
        data_ptr_or_0(l_out), acc.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, S,
        Dh, Dv, DTYPE_CODE[dt], ns, span, float(softmax_scale), sb, sh, ss,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "mha_decode")
    count_launch(mha_decode_attn, partials, dt == torch.int8)
    return (out, m_out, l_out) if partials else out


mha_decode_attn.launches = 0
mha_decode_attn.int8 = SimpleNamespace(launches=0)
mha_decode_attn.partials = launch_counters()
