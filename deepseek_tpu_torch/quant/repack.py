"""Raw K-quant blocks -> stride-16 plane arrays (numpy), as
``deepseek_tpu/quant/repack.py`` lays them out.

Columns are stored in **stride-16 permuted order**: permuted position
``c' = o * (n/16) + g`` holds original column ``g*16 + o``, so the scale of
permuted column c' is ``S16[c' mod n/16]``.

    qs_plane[..., j]   holds permuted columns  j, j+n/4, j+2n/4, j+3n/4
    hm_plane[..., j]   holds permuted columns  j + b*n/8 for b in 0..7

The loader keeps these planes as ``quant.qtensor.Q2KTensor`` /
``Q3KTensor`` (the default runtime) or expands them to the nibble layout
(``q2k_to_nibble`` / ``q3k_to_nibble``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from deepseek_tpu_torch.quant.kquant import (
    QK_K, q2k_fields, q3k_fields, unpack_q3_scales,
)


def stride16_perm(n: int) -> np.ndarray:
    """perm[c'] = original column index for permuted position c'."""
    n16 = n // 16
    o = np.arange(16).repeat(n16)          # o = c' // n16
    g = np.tile(np.arange(n16), 16)        # g = c' %  n16
    return (g * 16 + o).astype(np.int64)


def stride16_inv_perm(n: int) -> np.ndarray:
    """inv[orig] = permuted position of original column orig."""
    return np.argsort(stride16_perm(n)).astype(np.int64)


def _perm16(q: np.ndarray) -> np.ndarray:
    """(..., n) -> the stride-16 permuted order (``q[..., stride16_perm(n)]``,
    as a (n/16, 16) transpose)."""
    *lead, n = q.shape
    return q.reshape(*lead, n // 16, 16).swapaxes(-1, -2).reshape(*lead, n)


def _unpack_2bit_u8(qs: np.ndarray) -> np.ndarray:
    """(..., 64) packed qs bytes -> (..., 256) uint8 values in [0,3]
    (``kquant.unpack_qs_2bit`` without its int32 widening)."""
    q = qs.reshape(*qs.shape[:-1], 2, 1, 32)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8).reshape(4, 1)
    return ((q >> shifts) & 3).reshape(*qs.shape[:-1], 256)


def _plane_pack_2bit(q: np.ndarray) -> np.ndarray:
    """(..., n) values in [0,3] -> (..., n//4) uint8 plane bytes."""
    n4 = q.shape[-1] // 4
    q = q.astype(np.uint8)
    return (q[..., :n4]
            | (q[..., n4:2 * n4] << 2)
            | (q[..., 2 * n4:3 * n4] << 4)
            | (q[..., 3 * n4:] << 6))


def _plane_pack_1bit(h: np.ndarray) -> np.ndarray:
    """(..., n) values in {0,1} -> (..., n//8) uint8 plane bytes."""
    n8 = h.shape[-1] // 8
    h = h.astype(np.uint8)
    out = np.zeros(h.shape[:-1] + (n8,), dtype=np.uint8)
    for b in range(8):
        out |= h[..., b * n8:(b + 1) * n8] << b
    return out


def repack_q2k(raw: np.ndarray, rows: int, cols: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Raw Q2_K block bytes (..., rows, row_bytes) -> plane arrays
    (qs (..., rows, cols//4) u8, sm (..., rows, cols//16) u8,
    d (..., rows, cols//256) f32, dmin same)."""
    lead = raw.shape[:-2]
    assert raw.shape[-2] == rows
    nbr = cols // QK_K
    scales, qs, d, dmin = q2k_fields(raw)
    q = _perm16(_unpack_2bit_u8(qs).reshape(*lead, rows, nbr * QK_K))
    sm = scales.reshape(*lead, rows, nbr * 16)
    return (_plane_pack_2bit(q),
            np.ascontiguousarray(sm),
            np.ascontiguousarray(d.reshape(*lead, rows, nbr)),
            np.ascontiguousarray(dmin.reshape(*lead, rows, nbr)))


def repack_q3k(raw: np.ndarray, rows: int, cols: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Raw Q3_K block bytes -> (qs (..., rows, cols//4) u8,
    hm (..., rows, cols//8) u8, sc (..., rows, cols//16) i8,
    d (..., rows, cols//256) f32)."""
    lead = raw.shape[:-2]
    assert raw.shape[-2] == rows
    nbr = cols // QK_K
    hmask, qs, scales, d = q3k_fields(raw)
    n = nbr * QK_K
    qlow = _perm16(_unpack_2bit_u8(qs).reshape(*lead, rows, n))
    pos = np.arange(QK_K)
    # high bit: byte pos%32, bit pos//32 within each super-block
    hb = ((hmask[..., pos % 32] >> (pos // 32).astype(np.uint8)) & 1)
    hb = _perm16(hb.reshape(*lead, rows, n))
    sc6 = unpack_q3_scales(scales.reshape(-1, 12)).reshape(*lead, rows, nbr * 16)
    return (_plane_pack_2bit(qlow),
            _plane_pack_1bit(hb),
            np.ascontiguousarray((sc6 - 32).astype(np.int8)),
            np.ascontiguousarray(d.reshape(*lead, rows, nbr)))
