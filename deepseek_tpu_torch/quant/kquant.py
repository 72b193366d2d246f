"""K-quant super-block fields (numpy): the decode half of
``deepseek_tpu/quant/kquant.py``, which is all the loader needs.

Formats (QK_K = 256 weights per super-block, 16 sub-blocks of 16):

Q2_K (84 B/block): x = d*sc*q - dmin*m, q in [0,3]
    scales[16] u8   -- low nibble: 4-bit sub-block scale, high nibble: 4-bit min
    qs[64]     u8   -- 2-bit quants
    d, dmin    f16  -- super-block scale for the quantized scales / mins

Q3_K (110 B/block): x = d*(sc-32)*(q-4), q in [0,7]
    hmask[32]  u8   -- high bit of each quant: byte j%32, bit j//32
    qs[64]     u8   -- low 2 bits of each quant (same layout as Q2_K)
    scales[12] u8   -- 16 six-bit scales, packed
    d          f16  -- super-block scale

qs 2-bit layout: for each 128-weight half ``c``, byte ``qs[c*32 + l]`` holds
weights ``c*128 + shift*32 + l`` for shift in 0..3 at bit position 2*shift.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

QK_K = 256
Q2K_BLOCK_BYTES = 84
Q3K_BLOCK_BYTES = 110


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
