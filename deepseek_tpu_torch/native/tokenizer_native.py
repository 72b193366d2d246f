"""ctypes bridge to the native trie tokenizer (``tokenizer.cpp``): the
port's copy of ``deepseek_tpu/native/tokenizer_native.py``."""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from deepseek_tpu_torch.native.build import ERRORS, build_shared_lib

_SRC = "tokenizer.cpp"
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
    up = ctypes.POINTER(ctypes.c_uint8)
    lib.dseek_tokenizer_create.argtypes = [up, ctypes.c_int64]
    lib.dseek_tokenizer_create.restype = ctypes.c_void_p
    lib.dseek_tokenizer_destroy.argtypes = [ctypes.c_void_p]
    lib.dseek_tokenizer_destroy.restype = None
    lib.dseek_tokenizer_encode.argtypes = [
        ctypes.c_void_p, up, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32]
    lib.dseek_tokenizer_encode.restype = ctypes.c_int64
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library built and loaded (False under DSEEK_NO_NATIVE=1)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available, or None."""
    return None if available() else ERRORS.get(_SRC, "not built")


class NativeEncoder:
    """Owns a native trie built from the vocab byte strings."""

    def __init__(self, vocab: Sequence[bytes], byte_fallback_start: int):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"the native tokenizer is not available: {build_error()}")
        self._lib = lib
        self._fallback = byte_fallback_start
        blob = b"\x00".join(vocab) + b"\x00"
        self._buf = np.frombuffer(blob, dtype=np.uint8)
        self._handle = lib.dseek_tokenizer_create(
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(blob))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.dseek_tokenizer_destroy(self._handle)
            self._handle = None

    def encode(self, data: bytes) -> List[int]:
        if not data:
            return []
        buf = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(len(data) + 1, dtype=np.int32)
        n = self._lib.dseek_tokenizer_encode(
            self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(out), self._fallback)
        return out[:n].tolist()
