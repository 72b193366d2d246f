"""ctypes bridge to the native K-quant encoder (``kquant.cpp``): the port's
copy of ``deepseek_tpu/native/kquant_native.py``.

The numpy encoder's block formats and fitting (``quant/kquant.py``), OpenMP
over rows; the converter's encoder for multi-GB tensors. It agrees with the
numpy encoder on most bytes, not all (their roundings differ at ties), and
byte for byte with the JAX package's native encoder (the same source and
flags).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from deepseek_tpu_torch.native.build import ERRORS, build_shared_lib
from deepseek_tpu_torch.quant.kquant import (
    QK_K, Q2K_BLOCK_BYTES, Q3K_BLOCK_BYTES, Q8K_BLOCK_BYTES,
)

_SRC = "kquant.cpp"
_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = build_shared_lib(_SRC)
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    fp = ctypes.POINTER(ctypes.c_float)
    up = ctypes.POINTER(ctypes.c_uint8)
    for name in ("dseek_quantize_q2k", "dseek_quantize_q3k", "dseek_quantize_q8k"):
        getattr(lib, name).argtypes = [fp, up, ctypes.c_int64, ctypes.c_int64]
        getattr(lib, name).restype = None
    for name in ("dseek_dequantize_q2k", "dseek_dequantize_q3k"):
        getattr(lib, name).argtypes = [up, fp, ctypes.c_int64, ctypes.c_int64]
        getattr(lib, name).restype = None
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library built and loaded (False under DSEEK_NO_NATIVE=1)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available, or None."""
    return None if available() else ERRORS.get(_SRC, "not built")


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native K-quant encoder is not available: {build_error()}")
    return lib


def quantize(x: np.ndarray, method: str) -> np.ndarray:
    """x (rows, cols) f32, cols % 256 == 0 -> raw block bytes (rows,
    blocks_per_row * block_bytes); ``method`` q2_k, q3_k or q8_k."""
    lib = _lib_or_raise()
    x = np.ascontiguousarray(x, dtype=np.float32)
    rows, cols = x.shape
    if cols % QK_K:
        raise ValueError(f"cols {cols} not a multiple of {QK_K}")
    bb = {"q2_k": Q2K_BLOCK_BYTES, "q3_k": Q3K_BLOCK_BYTES, "q8_k": Q8K_BLOCK_BYTES}[method]
    out = np.empty((rows, cols // QK_K * bb), dtype=np.uint8)
    fn = {"q2_k": lib.dseek_quantize_q2k, "q3_k": lib.dseek_quantize_q3k,
          "q8_k": lib.dseek_quantize_q8k}[method]
    fn(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), rows, cols)
    return out


def dequantize(raw: np.ndarray, method: str, rows: int, cols: int) -> np.ndarray:
    """Raw Q2_K/Q3_K block bytes -> (rows, cols) float32."""
    lib = _lib_or_raise()
    raw = np.ascontiguousarray(raw.reshape(rows, -1))
    out = np.empty((rows, cols), dtype=np.float32)
    fn = {"q2_k": lib.dseek_dequantize_q2k, "q3_k": lib.dseek_dequantize_q3k}[method]
    fn(raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols)
    return out
