"""Kernels K9 and K10: chunked causal flash attention for prefill.

``mha_prefill_attn`` replaces ``deepseek_tpu/ops/pallas/attention.py::
mha_prefill_attn`` (K9, the decompressed heads of the hybrid-MLA prefill)
and ``mla_prefill_attn`` replaces ``::mla_prefill_attn`` (K10, absorbed
prefill over the latent cache). Both launch ``csrc/prefill_attn.cu``, the
f32 function on Hopper's tensor cores through split bf16 operands (see
its header for the design and its bound), and keep the JAX public layouts
and arguments: query t sits at position ``q_pos0 + t``, cache slot s holds
position ``cache_pos0 + s``, and t sees s when ``cache_pos0 + s <= q_pos0 +
t``. Over an int8 cache both take the f32 scales of the stored rows in
the JAX layouts: (B,S) for the latent rows (K10), head-major (B,H,S) for
the per-head keys and values (K9), read through their strides (the
cache's (B,S,H) scales transposed, no copy). With ``partials=True``
(context-parallel prefill over one shard of the window, whose slot s holds
position ``cache_pos0 + s``) each returns the TPU kernel's partials triple:
the unnormalized accumulator and its flash statistics, (acc, m (B,T,H),
l (B,T,H)). Where the row blocks are too few to fill the card
(``prefill_splits``), the window is split over blocks and merged.

CPU tensors take the plain versions (ops.attention.prefill_attn_*);
CUDA tensors launch the kernel or raise. ``.launches`` counts the
normalized launches over a float cache, and among them ``.f16.launches``
and ``.f32.launches`` those over f16 and f32 caches (the bodies that take
the cache in two bf16 terms); ``.int8.launches`` those over an int8 cache,
``.partials.launches`` and ``.partials.int8.launches`` the partials ones.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from deepseek_tpu_torch.ops.attention import (
    prefill_attn_mha, prefill_attn_mha_partial, prefill_attn_mla,
    prefill_attn_mla_partial,
)
from deepseek_tpu_torch.ops.kernels.attention import (
    DTYPE_CODE, check_scales, count_body, data_ptr_or_0, head_major_strides,
    launch_counters, stats_outputs,
)
from deepseek_tpu_torch.ops.kernels.build import check, library

_DV = (128, 512)      # value widths the kernel is built for
# The kernel's own constants, in csrc/prefill_attn.cu (the tests read them
# there): query rows per block (Cfg::BM) and the most window splits its
# merge takes (kMaxSplits: mha_prefill/mla_prefill refuse more)
_BLOCK_ROWS = 64
_MAX_SPLITS = 16
_SPAN_ALIGN = 64      # split spans are whole multiples of every tile size
_FILL_BLOCKS = 264    # about 2 blocks on each of the H100's 132 SMs


def prefill_splits(B: int, T: int, H: int, S: int, q_pos0: int, cache_pos0: int,
                   mqa: bool):
    """(n_split, span): the kernel walks the window in n_split spans of
    ``span`` slots, one block per span and row block, when the row blocks
    alone (K9: B x H x ceil(T/64), K10: B x ceil(T*H/64)) are fewer than
    ``_FILL_BLOCKS``; a merge kernel then combines the spans' partials. The
    spans cover only the slots the chunk's latest query sees."""
    blocks = B * (-(-T * H // _BLOCK_ROWS) if mqa else H * -(-T // _BLOCK_ROWS))
    used = max(0, min(S, q_pos0 + T - cache_pos0))
    chunks = -(-used // _SPAN_ALIGN)
    n = min(-(-_FILL_BLOCKS // blocks), chunks, _MAX_SPLITS)
    if n <= 1:
        return 1, S
    span = -(-chunks // n) * _SPAN_ALIGN
    return -(-used // span), span


def _split_buffers(n_split: int, rows: int, dv: int, device):
    """Scratch for the spans' partials (acc, m, l), or None for one span."""
    if n_split == 1:
        return None
    return torch.empty(n_split * rows * (dv + 2), dtype=torch.float32, device=device)


def _positions(T: int, S: int, q_pos0: int, cache_pos0: int, device):
    q_pos = q_pos0 + torch.arange(T, device=device)
    cache_pos = cache_pos0 + torch.arange(S, device=device)
    return q_pos, cache_pos


def mha_prefill_attn_plain(q, k_cache, v_cache, q_pos0: int, cache_pos0: int,
                           softmax_scale: float, k_scale=None, v_scale=None,
                           partials: bool = False):
    q_pos, cache_pos = _positions(q.shape[1], k_cache.shape[1], q_pos0,
                                  cache_pos0, q.device)
    fn = prefill_attn_mha_partial if partials else prefill_attn_mha
    return fn(q, k_cache, v_cache, q_pos, cache_pos, softmax_scale=softmax_scale,
              k_scale=k_scale, v_scale=v_scale)


def mla_prefill_attn_plain(q_c, q_rope, ckv_cache, krope_cache, q_pos0: int,
                           cache_pos0: int, softmax_scale: float,
                           ckv_scale=None, krope_scale=None, partials: bool = False):
    q_pos, cache_pos = _positions(q_c.shape[1], ckv_cache.shape[1], q_pos0,
                                  cache_pos0, q_c.device)
    fn = prefill_attn_mla_partial if partials else prefill_attn_mla
    return fn(q_c, q_rope, ckv_cache, krope_cache, q_pos, cache_pos, head_dim=0,
              softmax_scale=softmax_scale, ckv_scale=ckv_scale,
              krope_scale=krope_scale)


def _check_operands(name, queries, caches):
    dev = queries[0].device
    for t in (*queries, *caches):
        if t.device != dev:
            raise ValueError(f"{name}: operands on different devices")
    if caches[0].dtype not in DTYPE_CODE or \
            any(c.dtype != caches[0].dtype for c in caches):
        raise ValueError(f"{name}: unsupported cache dtypes "
                         f"{[c.dtype for c in caches]}")
    for c in caches:
        if not c.is_contiguous():
            raise ValueError(f"{name}: the cache planes must be contiguous")


def mha_prefill_attn(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_pos0: int, cache_pos0: int,
                     softmax_scale: float, k_scale=None, v_scale=None,
                     partials: bool = False):
    """K9: q (B,T,H,Dh), k_cache (B,S,H,Dh), v_cache (B,S,H,Dv) in
    f32/f16/bf16, or int8 with k_scale/v_scale (B,H,S) f32 -> (B,T,H,Dv)
    float32; with ``partials`` (acc (B,T,H,Dv), m (B,T,H), l (B,T,H))."""
    if q.device.type == "cpu":
        return mha_prefill_attn_plain(q, k_cache, v_cache, q_pos0, cache_pos0,
                                      softmax_scale, k_scale, v_scale, partials)
    if q.device.type != "cuda":
        raise ValueError(f"mha_prefill_attn runs on cuda or cpu, not {q.device}")
    B, T, H, Dh = q.shape
    S, Dv = k_cache.shape[1], v_cache.shape[-1]
    if k_cache.shape != (B, S, H, Dh) or v_cache.shape != (B, S, H, Dv):
        raise ValueError("mha_prefill_attn: inconsistent shapes "
                         f"{tuple(q.shape)} {tuple(k_cache.shape)} {tuple(v_cache.shape)}")
    if Dv not in _DV or Dh % 4:
        raise ValueError(f"mha_prefill_attn needs Dv in {_DV} and Dh % 4 == 0, "
                         f"got Dh={Dh} Dv={Dv}")
    _check_operands("mha_prefill_attn", (q,), (k_cache, v_cache))
    check_scales("mha_prefill_attn", k_cache, (k_scale, v_scale), (B, H, S))
    sb, sh, ss = head_major_strides("mha_prefill_attn", k_scale, v_scale)
    qf = q.float().contiguous()
    out = torch.empty((B, T, H, Dv), dtype=torch.float32, device=q.device)
    m_out, l_out = stats_outputs(partials, (B, T, H), q.device)
    n_split, span = prefill_splits(B, T, H, S, int(q_pos0), int(cache_pos0), False)
    scratch = _split_buffers(n_split, B * T * H, Dv, q.device)
    err = library("prefill_attn").mha_prefill(
        qf.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), data_ptr_or_0(k_scale),
        data_ptr_or_0(v_scale), out.data_ptr(), data_ptr_or_0(m_out),
        data_ptr_or_0(l_out), data_ptr_or_0(scratch), n_split, span,
        B, T, H, S, Dh, Dv, DTYPE_CODE[k_cache.dtype],
        int(q_pos0), int(cache_pos0), float(softmax_scale), sb, sh, ss,
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "mha_prefill")
    count_body(mha_prefill_attn, partials, k_cache.dtype)
    return (out, m_out, l_out) if partials else out


def mla_prefill_attn(q_c: torch.Tensor, q_rope: torch.Tensor,
                     ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
                     q_pos0: int, cache_pos0: int, softmax_scale: float,
                     ckv_scale=None, krope_scale=None,
                     partials: bool = False):
    """K10: q_c (B,T,H,R), q_rope (B,T,H,P), ckv_cache (B,S,R), krope_cache
    (B,S,P) in f32/f16/bf16, or int8 with ckv_scale/krope_scale (B,S) f32
    -> attended latents (B,T,H,R) float32; with ``partials`` (acc
    (B,T,H,R), m (B,T,H), l (B,T,H))."""
    if q_c.device.type == "cpu":
        return mla_prefill_attn_plain(q_c, q_rope, ckv_cache, krope_cache,
                                      q_pos0, cache_pos0, softmax_scale,
                                      ckv_scale, krope_scale, partials)
    if q_c.device.type != "cuda":
        raise ValueError(f"mla_prefill_attn runs on cuda or cpu, not {q_c.device}")
    B, T, H, R = q_c.shape
    S, P = ckv_cache.shape[1], q_rope.shape[-1]
    if (q_rope.shape != (B, T, H, P) or ckv_cache.shape != (B, S, R)
            or krope_cache.shape != (B, S, P)):
        raise ValueError("mla_prefill_attn: inconsistent shapes "
                         f"{tuple(q_c.shape)} {tuple(q_rope.shape)} "
                         f"{tuple(ckv_cache.shape)} {tuple(krope_cache.shape)}")
    if R not in _DV or (R + P) % 4:
        raise ValueError(f"mla_prefill_attn needs R in {_DV} and (R+P) % 4 == 0, "
                         f"got R={R} P={P}")
    _check_operands("mla_prefill_attn", (q_c, q_rope), (ckv_cache, krope_cache))
    check_scales("mla_prefill_attn", ckv_cache, (ckv_scale, krope_scale), (B, S))
    q8 = ckv_cache.dtype == torch.int8
    cs = ckv_scale.contiguous() if q8 else None
    rs = krope_scale.contiguous() if q8 else None
    qc = q_c.float().contiguous()
    qr = q_rope.float().contiguous()
    out = torch.empty((B, T, H, R), dtype=torch.float32, device=q_c.device)
    m_out, l_out = stats_outputs(partials, (B, T, H), q_c.device)
    n_split, span = prefill_splits(B, T, H, S, int(q_pos0), int(cache_pos0), True)
    scratch = _split_buffers(n_split, B * T * H, R, q_c.device)
    err = library("prefill_attn").mla_prefill(
        qc.data_ptr(), qr.data_ptr(), ckv_cache.data_ptr(),
        krope_cache.data_ptr(), data_ptr_or_0(cs), data_ptr_or_0(rs), out.data_ptr(),
        data_ptr_or_0(m_out), data_ptr_or_0(l_out), data_ptr_or_0(scratch), n_split,
        span, B, T, H, S, R, P,
        DTYPE_CODE[ckv_cache.dtype], int(q_pos0), int(cache_pos0),
        float(softmax_scale), torch.cuda.current_stream(q_c.device).cuda_stream)
    check(err, "mla_prefill")
    count_body(mla_prefill_attn, partials, ckv_cache.dtype)
    return (out, m_out, l_out) if partials else out


mha_prefill_attn.launches = 0
mla_prefill_attn.launches = 0
mha_prefill_attn.int8 = SimpleNamespace(launches=0)
mla_prefill_attn.int8 = SimpleNamespace(launches=0)
mha_prefill_attn.partials = launch_counters()
mla_prefill_attn.partials = launch_counters()
mha_prefill_attn.f16 = SimpleNamespace(launches=0)
mla_prefill_attn.f16 = SimpleNamespace(launches=0)
mha_prefill_attn.f32 = SimpleNamespace(launches=0)
mla_prefill_attn.f32 = SimpleNamespace(launches=0)
