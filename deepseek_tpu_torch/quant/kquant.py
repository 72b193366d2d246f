"""llama.cpp K-quant super-block formats (numpy): the port's copy of
``deepseek_tpu/quant/kquant.py``, the field decode the loader needs and the
converter's encoders, byte for byte the JAX package's (its vectorized
numpy search: every per-sub-block scalar loop of the scalar C version is
an array op over all sub-blocks at once). The native C++/OpenMP encoder
(``native/kquant.cpp``) is the converter's fast path.

Formats (QK_K = 256 weights per super-block, 16 sub-blocks of 16):

Q2_K (84 B/block, 2.625 bpw): x = d*sc*q - dmin*m, q in [0,3]
    scales[16] u8   -- low nibble: 4-bit sub-block scale, high nibble: 4-bit min
    qs[64]     u8   -- 2-bit quants
    d, dmin    f16  -- super-block scale for the quantized scales / mins

Q3_K (110 B/block, 3.4375 bpw): x = d*(sc-32)*(q-4), q in [0,7]
    hmask[32]  u8   -- high bit of each quant: byte j%32, bit j//32
    qs[64]     u8   -- low 2 bits of each quant (same layout as Q2_K)
    scales[12] u8   -- 16 six-bit scales, packed
    d          f16  -- super-block scale

Q8_K (292 B/block, activation format): x = d*q
    d          f32
    qs[256]    i8
    bsums[16]  i16 -- per-16 sums of qs

qs 2-bit layout: for each 128-weight half ``c``, byte ``qs[c*32 + l]`` holds
weights ``c*128 + shift*32 + l`` for shift in 0..3 at bit position 2*shift.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

QK_K = 256
Q2K_BLOCK_BYTES = 84
Q3K_BLOCK_BYTES = 110
Q8K_BLOCK_BYTES = 4 + QK_K + (QK_K // 16) * 2

GROUP_MAX_EPS = 1e-15


def _nearest_int(x: np.ndarray) -> np.ndarray:
    """Round half to even, like the reference's magic-constant nearest_int."""
    return np.rint(x).astype(np.int32)


def _f16(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16)


def _f16_to_f32(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32)


def _pack_qs_2bit(L: np.ndarray) -> np.ndarray:
    """(nb, 256) int values in [0,3] -> (nb, 64) packed bytes."""
    nb = L.shape[0]
    # (nb, 2 halves, 4 shifts, 32 lanes)
    L4 = L.reshape(nb, 2, 4, 32).astype(np.uint8)
    out = (L4[:, :, 0] | (L4[:, :, 1] << 2) | (L4[:, :, 2] << 4) | (L4[:, :, 3] << 6))
    return out.reshape(nb, 64)


def unpack_qs_2bit(qs: np.ndarray) -> np.ndarray:
    """(nb, 64) packed bytes -> (nb, 256) int32 values in [0,3]."""
    nb = qs.shape[0]
    q = qs.reshape(nb, 2, 1, 32)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8).reshape(1, 1, 4, 1)
    vals = (q >> shifts) & 3
    return vals.reshape(nb, 256).astype(np.int32)


def unpack_q3_scales(packed: np.ndarray) -> np.ndarray:
    """(nb, 12) packed bytes -> (nb, 16) six-bit ints."""
    packed = packed.astype(np.uint8)
    lo = np.concatenate([packed[:, :8] & 0xF, packed[:, :8] >> 4], axis=1)
    hi = np.empty_like(lo)
    for j in range(16):
        hi[:, j] = (packed[:, 8 + j % 4] >> (2 * (j // 4))) & 3
    return (lo | (hi << 4)).astype(np.int32)


def q2k_fields(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Split raw Q2_K bytes (..., nb*84) into
    (scales (..., nb, 16) u8, qs (..., nb, 64) u8, d (..., nb) f32, dmin (..., nb) f32)."""
    lead = raw.shape[:-1]
    blocks = raw.reshape(*lead, -1, Q2K_BLOCK_BYTES)
    scales = blocks[..., :16]
    qs = blocks[..., 16:80]
    d = np.ascontiguousarray(blocks[..., 80:82]).view(np.float16)[..., 0].astype(np.float32)
    dmin = np.ascontiguousarray(blocks[..., 82:84]).view(np.float16)[..., 0].astype(np.float32)
    return scales, qs, d, dmin


def q3k_fields(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Split raw Q3_K bytes into (hmask (..., nb, 32), qs (..., nb, 64),
    scales (..., nb, 12), d (..., nb) f32)."""
    lead = raw.shape[:-1]
    blocks = raw.reshape(*lead, -1, Q3K_BLOCK_BYTES)
    hmask = blocks[..., :32]
    qs = blocks[..., 32:96]
    scales = blocks[..., 96:108]
    d = np.ascontiguousarray(blocks[..., 108:110]).view(np.float16)[..., 0].astype(np.float32)
    return hmask, qs, scales, d


# ---------------------------------------------------------------------------
# Q8_K (activation quantization)
# ---------------------------------------------------------------------------

def quantize_q8_k(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize (..., k) floats, k % 256 == 0.

    Returns (d (nb,), qs (nb, 256) int8, bsums (nb, 16) int16) with
    nb = total blocks, matching quantize_row_q8_K_ref semantics.
    """
    x = np.asarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    amax_idx = np.abs(x).argmax(axis=1)
    maxval = x[np.arange(nb), amax_idx]
    amax = np.abs(maxval)
    nonzero = amax > 0

    iscale = np.where(nonzero, -127.0 / np.where(nonzero, maxval, 1.0), 0.0)
    q = _nearest_int(x * iscale[:, None])
    q = np.minimum(127, q)  # reference clamps only the top (min is -127 by construction)
    q = np.where(nonzero[:, None], q, 0).astype(np.int8)
    d = np.where(nonzero, 1.0 / np.where(nonzero, iscale, 1.0), 0.0).astype(np.float32)
    bsums = q.astype(np.int32).reshape(nb, 16, 16).sum(axis=2).astype(np.int16)
    return d, q, bsums


def dequantize_q8_k(d: np.ndarray, qs: np.ndarray) -> np.ndarray:
    return (d[:, None] * qs.astype(np.float32)).reshape(-1)


# ---------------------------------------------------------------------------
# Q2_K
# ---------------------------------------------------------------------------

def _make_qkx2_quants(x: np.ndarray, weights: np.ndarray, nmax: int,
                      rmin: float, rdelta: float, nstep: int,
                      use_mad: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Weighted min+scale fit for groups of values.

    x, weights: (g, 16). Returns (scale (g,), the_min (g,), L (g,16) ints).
    Vectorized port of the reference's make_qkx2_quants search: an initial
    round-to-grid fit followed by `nstep+1` candidate rescalings, each solved
    by weighted least squares, keeping the candidate with lowest weighted
    (absolute or squared) error.
    """
    g, n = x.shape
    vmin = np.minimum(x.min(axis=1), 0.0)
    vmax = x.max(axis=1)
    degenerate = vmax == vmin  # all-equal groups -> L=0, scale=0

    rng = np.where(degenerate, 1.0, vmax - vmin)
    sum_w = weights.sum(axis=1)
    sum_x = (weights * x).sum(axis=1)

    iscale = nmax / rng
    scale = 1.0 / iscale
    L = np.clip(_nearest_int(iscale[:, None] * (x - vmin[:, None])), 0, nmax)
    diff = scale[:, None] * L + vmin[:, None] - x
    err = np.abs(diff) if use_mad else diff * diff
    best_mad = (weights * err).sum(axis=1)

    best_L = L.copy()
    best_scale = scale.copy()
    best_min = vmin.copy()

    for step in range(nstep + 1):
        cand_iscale = (rmin + rdelta * step + nmax) / rng
        Laux = np.clip(_nearest_int(cand_iscale[:, None] * (x - vmin[:, None])), 0, nmax)
        lf = Laux.astype(np.float64)
        wf = weights.astype(np.float64)
        sum_l = (wf * lf).sum(axis=1)
        sum_l2 = (wf * lf * lf).sum(axis=1)
        sum_xl = (wf * lf * x).sum(axis=1)
        D = sum_w * sum_l2 - sum_l * sum_l
        ok = D > 0
        Dsafe = np.where(ok, D, 1.0)
        this_scale = (sum_w * sum_xl - sum_x * sum_l) / Dsafe
        this_min = (sum_l2 * sum_x - sum_l * sum_xl) / Dsafe
        clampmin = this_min > 0
        safe_l2 = np.where(sum_l2 > 0, sum_l2, 1.0)
        this_scale = np.where(clampmin, sum_xl / safe_l2, this_scale)
        this_min = np.where(clampmin, 0.0, this_min)
        diff = this_scale[:, None] * lf + this_min[:, None] - x
        err = np.abs(diff) if use_mad else diff * diff
        mad = (weights * err).sum(axis=1)
        upd = ok & (mad < best_mad)
        best_mad = np.where(upd, mad, best_mad)
        best_L = np.where(upd[:, None], Laux, best_L)
        best_scale = np.where(upd, this_scale, best_scale)
        best_min = np.where(upd, this_min, best_min)

    best_L = np.where(degenerate[:, None], 0, best_L)
    best_scale = np.where(degenerate, 0.0, best_scale).astype(np.float32)
    the_min = np.where(degenerate, -vmin, -best_min).astype(np.float32)
    return best_scale, the_min, best_L


def quantize_q2_k(x: np.ndarray) -> np.ndarray:
    """Quantize a 2-D (rows, cols) float array; cols % 256 == 0.

    Returns raw block bytes with shape (rows, cols//256 * 84) uint8 — the
    exact on-disk layout the reference engine mmaps.
    """
    x = np.asarray(x, dtype=np.float32)
    rows, cols = x.shape
    assert cols % QK_K == 0, f"cols {cols} not a multiple of {QK_K}"
    xb = x.reshape(-1, QK_K)            # (nb, 256)
    nb = xb.shape[0]
    groups = xb.reshape(nb * 16, 16)    # 16 sub-blocks of 16

    scales, mins, L = _make_qkx2_quants(
        groups, np.abs(groups), nmax=3, rmin=-0.5, rdelta=0.1, nstep=15, use_mad=True)
    scales = scales.reshape(nb, 16)
    mins = mins.reshape(nb, 16)
    L = L.reshape(nb, 256)

    q4scale = 15.0
    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)

    has_scale = max_scale > 0
    inv_s = np.where(has_scale, q4scale / np.where(has_scale, max_scale, 1.0), 0.0)
    sc_q = np.where(has_scale[:, None], _nearest_int(inv_s[:, None] * scales), 0)
    d = np.where(has_scale, _f16_to_f32(_f16(max_scale / q4scale)), 0.0).astype(np.float32)

    has_min = max_min > 0
    inv_m = np.where(has_min, q4scale / np.where(has_min, max_min, 1.0), 0.0)
    mn_q = np.where(has_min[:, None], _nearest_int(inv_m[:, None] * mins), 0)
    dmin = np.where(has_min, _f16_to_f32(_f16(max_min / q4scale)), 0.0).astype(np.float32)

    scale_bytes = (sc_q.astype(np.uint8) & 0xF) | ((mn_q.astype(np.uint8) & 0xF) << 4)

    # requantize against the 4-bit-quantized scales/mins
    dl = d[:, None] * (sc_q & 0xF).astype(np.float32)       # (nb, 16)
    ml = dmin[:, None] * (mn_q & 0xF).astype(np.float32)
    use = dl != 0
    dl_safe = np.where(use, dl, 1.0)
    L_new = np.clip(
        _nearest_int((xb.reshape(nb, 16, 16) + ml[:, :, None]) / dl_safe[:, :, None]), 0, 3)
    L = np.where(np.repeat(use, 16, axis=1).reshape(nb, 256), L_new.reshape(nb, 256), L)

    qs = _pack_qs_2bit(L)

    # assemble blocks: scales[16] | qs[64] | d (f16) | dmin (f16)
    out = np.empty((nb, Q2K_BLOCK_BYTES), dtype=np.uint8)
    out[:, :16] = scale_bytes
    out[:, 16:80] = qs
    out[:, 80:82] = _f16(d)[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 82:84] = _f16(dmin)[:, None].view(np.uint8).reshape(nb, 2)
    return out.reshape(rows, (cols // QK_K) * Q2K_BLOCK_BYTES)


def dequantize_q2_k(raw: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Dequantize raw Q2_K block bytes back to (rows, cols) float32."""
    scales, qs, d, dmin = q2k_fields(raw.reshape(rows, -1))
    nb_total = rows * (cols // QK_K)
    scales = scales.reshape(nb_total, 16)
    qs = qs.reshape(nb_total, 64)
    d = d.reshape(nb_total)
    dmin = dmin.reshape(nb_total)

    q = unpack_qs_2bit(qs)                                   # (nb, 256)
    sc = (scales & 0xF).astype(np.float32)
    mn = (scales >> 4).astype(np.float32)
    sidx = np.arange(QK_K) // 16                              # scale index per position
    y = d[:, None] * sc[:, sidx] * q - dmin[:, None] * mn[:, sidx]
    return y.reshape(rows, cols).astype(np.float32)


# ---------------------------------------------------------------------------
# Q3_K
# ---------------------------------------------------------------------------

def _make_q3_quants(x: np.ndarray, nmax: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """RMSE-refined symmetric fit. x: (g, 16). Returns (scale (g,), L (g,16) in [0, 2*nmax))."""
    g, n = x.shape
    amax_idx = np.abs(x).argmax(axis=1)
    maxval = x[np.arange(g), amax_idx]
    amax = np.abs(maxval)
    live = amax >= GROUP_MAX_EPS

    iscale = np.where(live, -nmax / np.where(live, maxval, 1.0), 0.0)
    L = np.clip(_nearest_int(iscale[:, None] * x), -nmax, nmax - 1)
    w = (x * x).astype(np.float64)
    xf = x.astype(np.float64)
    Lf = L.astype(np.float64)
    sumlx = (w * xf * Lf).sum(axis=1)
    suml2 = (w * Lf * Lf).sum(axis=1)

    # coordinate-descent refinement (5 sweeps), vectorized over groups with a
    # sequential inner loop over the 16 positions (order-dependent updates)
    for _ in range(5):
        changed = np.zeros(g, dtype=bool)
        for i in range(n):
            wi = w[:, i]
            xi = xf[:, i]
            Li = L[:, i].astype(np.float64)
            slx = sumlx - wi * xi * Li
            pos = slx > 0
            sl2 = suml2 - wi * Li * Li
            slx_safe = np.where(pos, slx, 1.0)
            new_l = np.clip(_nearest_int((xi * sl2 / slx_safe).astype(np.float32)), -nmax, nmax - 1)
            differs = pos & (new_l != L[:, i])
            nlf = new_l.astype(np.float64)
            slx2 = slx + wi * xi * nlf
            sl22 = sl2 + wi * nlf * nlf
            accept = differs & (sl22 > 0) & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            L[:, i] = np.where(accept, new_l, L[:, i])
            sumlx = np.where(accept, slx2, sumlx)
            suml2 = np.where(accept, sl22, suml2)
            changed |= accept
        if not changed.any():
            break

    suml2_safe = np.where(suml2 > 0, suml2, 1.0)
    scale = np.where(live, sumlx / suml2_safe, 0.0).astype(np.float32)
    L = np.where(live[:, None], L + nmax, 0)
    return scale, L


def _pack_q3_scales(sc6: np.ndarray) -> np.ndarray:
    """(nb, 16) six-bit values in [0, 64) -> (nb, 12) packed bytes."""
    nb = sc6.shape[0]
    out = np.zeros((nb, 12), dtype=np.uint8)
    lo = (sc6 & 0xF).astype(np.uint8)
    hi = (sc6 >> 4).astype(np.uint8)
    out[:, :8] = lo[:, :8] | (lo[:, 8:] << 4)
    for j in range(16):
        out[:, 8 + j % 4] |= hi[:, j] << (2 * (j // 4))
    return out


def quantize_q3_k(x: np.ndarray) -> np.ndarray:
    """Quantize (rows, cols) floats -> raw Q3_K bytes (rows, cols//256 * 110)."""
    x = np.asarray(x, dtype=np.float32)
    rows, cols = x.shape
    assert cols % QK_K == 0
    xb = x.reshape(-1, QK_K)
    nb = xb.shape[0]

    scales, L = _make_q3_quants(xb.reshape(nb * 16, 16), nmax=4)
    scales = scales.reshape(nb, 16)
    L = L.reshape(nb, 256)

    # super-block scale of scales
    amax_idx = np.abs(scales).argmax(axis=1)
    max_scale = scales[np.arange(nb), amax_idx]
    has = max_scale != 0
    inv = np.where(has, -32.0 / np.where(has, max_scale, 1.0), 0.0)
    sc6 = np.where(
        has[:, None],
        np.clip(_nearest_int(inv[:, None] * scales).astype(np.int8).astype(np.int32), -32, 31) + 32,
        32)  # note: the reference leaves scales[] zeroed when max_scale == 0
    sc6 = np.where(has[:, None], sc6, 0)
    d = np.where(has, _f16_to_f32(_f16(np.where(has, 1.0 / np.where(inv == 0, 1.0, inv), 0.0))), 0.0)
    d = d.astype(np.float32)

    scale_bytes = _pack_q3_scales(sc6)

    # requantize with the 6-bit scales
    sc_eff = (unpack_q3_scales(scale_bytes) - 32).astype(np.float32)   # (nb, 16)
    dl = d[:, None] * sc_eff
    use = dl != 0
    dl_safe = np.where(use, dl, 1.0)
    L_new = np.clip(_nearest_int(xb.reshape(nb, 16, 16) / dl_safe[:, :, None]), -4, 3) + 4
    L = np.where(np.repeat(use, 16, axis=1).reshape(nb, 256), L_new.reshape(nb, 256), L)

    # split into high bit (plane) + low 2 bits
    hbit = (L > 3).astype(np.uint8)          # (nb, 256)
    Llow = np.where(L > 3, L - 4, L)
    # hmask byte = pos % 32, bit = pos // 32
    hb = hbit.reshape(nb, 8, 32)             # (nb, bit, byte)
    hmask = np.zeros((nb, 32), dtype=np.uint8)
    for b in range(8):
        hmask |= (hb[:, b] << b).astype(np.uint8)

    qs = _pack_qs_2bit(Llow)

    out = np.empty((nb, Q3K_BLOCK_BYTES), dtype=np.uint8)
    out[:, :32] = hmask
    out[:, 32:96] = qs
    out[:, 96:108] = scale_bytes
    out[:, 108:110] = _f16(d)[:, None].view(np.uint8).reshape(nb, 2)
    return out.reshape(rows, (cols // QK_K) * Q3K_BLOCK_BYTES)


def dequantize_q3_k(raw: np.ndarray, rows: int, cols: int) -> np.ndarray:
    hmask, qs, scales, d = q3k_fields(raw.reshape(rows, -1))
    nb_total = rows * (cols // QK_K)
    hmask = hmask.reshape(nb_total, 32)
    qs = qs.reshape(nb_total, 64)
    scales = scales.reshape(nb_total, 12)
    d = d.reshape(nb_total)

    qlow = unpack_qs_2bit(qs)                                # (nb, 256)
    pos = np.arange(QK_K)
    hbit = (hmask[:, pos % 32] >> (pos // 32)[None, :]) & 1
    q = qlow - np.where(hbit > 0, 0, 4)
    sc = (unpack_q3_scales(scales) - 32).astype(np.float32)  # (nb, 16)
    sidx = pos // 16
    y = d[:, None] * sc[:, sidx] * q
    return y.reshape(rows, cols).astype(np.float32)


# ---------------------------------------------------------------------------
# integer-exact dot product (reference semantics for tests)
# ---------------------------------------------------------------------------

def vec_dot_q2_k_q8_k(raw_q2: np.ndarray, q8_d: np.ndarray, q8_qs: np.ndarray,
                      q8_bsums: np.ndarray) -> float:
    """Integer dot product of one Q2_K row with Q8_K activations
    (semantics of ggml_vec_dot_q2_K_q8_K)."""
    scales, qs, d, dmin = q2k_fields(raw_q2.reshape(1, -1))
    nb = scales.shape[1]
    scales = scales[0]
    qs = qs[0]
    q = unpack_qs_2bit(qs).reshape(nb, 256)
    sc = (scales & 0xF).astype(np.int32)
    mn = (scales >> 4).astype(np.int32)
    total = 0.0
    sidx = np.arange(QK_K) // 16
    for i in range(nb):
        isum = int(((q[i] * q8_qs[i].astype(np.int32)) * sc[i][sidx]).sum())
        summs = int((q8_bsums[i].astype(np.int32) * mn[i]).sum())
        total += float(q8_d[i]) * float(d[0, i]) * isum - float(q8_d[i]) * float(dmin[0, i]) * summs
    return total


def vec_dot_q3_k_q8_k(raw_q3: np.ndarray, q8_d: np.ndarray, q8_qs: np.ndarray) -> float:
    """Integer dot product of one Q3_K row with Q8_K activations."""
    hmask, qs, scales, d = q3k_fields(raw_q3.reshape(1, -1))
    nb = qs.shape[1]
    pos = np.arange(QK_K)
    total = 0.0
    for i in range(nb):
        qlow = unpack_qs_2bit(qs[0, i:i + 1]).reshape(256)
        hbit = (hmask[0, i][pos % 32] >> (pos // 32)) & 1
        q = qlow - np.where(hbit > 0, 0, 4)
        sc = (unpack_q3_scales(scales[0, i:i + 1]) - 32).astype(np.int32)[0]
        isum = int(((q * q8_qs[i].astype(np.int32)) * sc[pos // 16]).sum())
        total += float(q8_d[i]) * float(d[0, i]) * isum
    return total
