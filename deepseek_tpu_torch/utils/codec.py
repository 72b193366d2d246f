"""`.dseek` checkpoint codec.

A checkpoint is a directory of ``shard_NNN.dseek`` files in the safetensors
wire format (u64-LE header length, JSON header, raw little-endian tensor
bytes), with the model metadata stored as string values under
``__metadata__`` of the first shard (sorted order) and the tokenizer vocab
embedded as a ``tokenizer.tokens`` uint8 tensor.

Format parity with the reference loader/converter:
  - ``src/codec.cpp:262-377`` of the C++ system (reader, dtype names)
  - its ``convert.py:582-588`` (writer, shard naming)

Reading is zero-copy via ``numpy.memmap``; the model loader slices views out
of the maps and only materializes when it copies a tensor to the device.
This is the port's own copy of ``deepseek_tpu/utils/codec.py`` (same wire
format, so checkpoints written by either package load in both).
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

try:
    import ml_dtypes

    _BF16 = np.dtype(ml_dtypes.bfloat16)
    _F8E5M2 = np.dtype(ml_dtypes.float8_e5m2)
    _F8E4M3 = np.dtype(ml_dtypes.float8_e4m3fn)
except ImportError:
    # without ml_dtypes a BF16 tensor maps to its raw 16-bit words and an
    # F8_E5M2 / F8_E4M3 tensor to its raw bytes, each in a one-field
    # record dtype so it stays distinct from U8; the loader and the
    # converter reinterpret them as torch.bfloat16 / torch.float8_e5m2 /
    # torch.float8_e4m3fn (models/loader.py, convert.py). Build such an
    # array as ``uint8 bytes .view(_DTYPE_TO_NP["F8_E5M2"])``, which works
    # with and without ml_dtypes.
    _BF16 = np.dtype(np.uint16)
    _F8E5M2 = np.dtype([("f8_e5m2", np.uint8)])
    _F8E4M3 = np.dtype([("f8_e4m3", np.uint8)])

# safetensors dtype-string <-> numpy dtype (codec.cpp:68-105)
_DTYPE_TO_NP = {
    "F32": np.dtype(np.float32),
    "F16": np.dtype(np.float16),
    "BF16": _BF16,
    "F8_E5M2": _F8E5M2,
    "F8_E4M3": _F8E4M3,
    "I32": np.dtype(np.int32),
    "I16": np.dtype(np.int16),
    "I8": np.dtype(np.int8),
    "U8": np.dtype(np.uint8),
    "I64": np.dtype(np.int64),
    "BOOL": np.dtype(np.bool_),
}


def np_to_dtype_str(dt: np.dtype) -> str:
    for name, nd in _DTYPE_TO_NP.items():
        if nd is not None and dt == nd:
            return name
    raise ValueError(f"unsupported numpy dtype for .dseek: {dt}")


@dataclass
class TensorView:
    """Zero-copy view of one tensor inside a mapped shard."""

    name: str
    dtype_str: str
    shape: Tuple[int, ...]
    array: np.ndarray  # memmap-backed view, already shaped

    @property
    def nbytes(self) -> int:
        return self.array.nbytes


@dataclass
class CheckpointData:
    """All shards of a `.dseek` checkpoint directory, lazily mapped."""

    metadata: Dict[str, str]
    tensors: Dict[str, TensorView]
    files: List[str] = field(default_factory=list)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.tensors[name].array

    def get(self, name: str) -> Optional[np.ndarray]:
        tv = self.tensors.get(name)
        return tv.array if tv is not None else None

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    @property
    def total_bytes(self) -> int:
        return sum(t.nbytes for t in self.tensors.values())


def read_safetensors_header(path: str) -> Tuple[dict, int]:
    """Return (parsed JSON header, byte offset where tensor data begins)."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        if header_len > 500 * 1024 * 1024:
            raise ValueError(f"{path}: implausible header size {header_len}")
        header = json.loads(f.read(header_len))
    return header, 8 + header_len


def load_shard(path: str, read_metadata: bool) -> Tuple[Dict[str, str], Dict[str, TensorView]]:
    header, data_start = read_safetensors_header(path)
    metadata: Dict[str, str] = {}
    tensors: Dict[str, TensorView] = {}

    mm = np.memmap(path, dtype=np.uint8, mode="r", offset=data_start)

    for name, spec in header.items():
        if name == "__metadata__":
            if read_metadata:
                metadata = dict(spec)
            continue
        dtype_str = spec["dtype"]
        np_dtype = _DTYPE_TO_NP.get(dtype_str)
        if np_dtype is None:
            raise ValueError(f"{path}: unsupported dtype {dtype_str} for tensor {name}")
        shape = tuple(int(s) for s in spec["shape"])
        start, end = spec["data_offsets"]
        nbytes = end - start
        expected = int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize if shape else np_dtype.itemsize
        if shape == ():
            expected = np_dtype.itemsize
        if nbytes != expected:
            raise ValueError(
                f"{path}: tensor {name} has {nbytes} bytes but shape {shape} "
                f"dtype {dtype_str} implies {expected}")
        arr = mm[start:end].view(np_dtype).reshape(shape)
        tensors[name] = TensorView(name=name, dtype_str=dtype_str, shape=shape, array=arr)

    return metadata, tensors


def load_checkpoint(dirname: str) -> CheckpointData:
    """Map every ``*.dseek`` file in a directory (sorted); metadata from the first."""
    if os.path.isfile(dirname):
        files = [dirname]
    else:
        files = sorted(
            os.path.join(dirname, f)
            for f in os.listdir(dirname)
            if f.endswith(".dseek") or f.endswith(".yalm")
        )
    if not files:
        raise FileNotFoundError(f"no .dseek shards found in {dirname}")

    metadata: Dict[str, str] = {}
    tensors: Dict[str, TensorView] = {}
    for i, path in enumerate(files):
        md, t = load_shard(path, read_metadata=(i == 0))
        if i == 0:
            metadata = md
        dup = set(t) & set(tensors)
        if dup:
            raise ValueError(f"duplicate tensors across shards: {sorted(dup)[:5]}")
        tensors.update(t)

    return CheckpointData(metadata=metadata, tensors=tensors, files=files)


def save_shard(path: str, tensors: Dict[str, np.ndarray], metadata: Optional[Dict[str, str]] = None) -> None:
    """Write one safetensors-format shard (used by the converter and tests)."""
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    offset = 0
    order: List[Tuple[str, np.ndarray]] = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        header[name] = {
            "dtype": np_to_dtype_str(arr.dtype),
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + arr.nbytes],
        }
        order.append((name, arr))
        offset += arr.nbytes

    header_bytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    # pad header to 8-byte alignment (safetensors convention)
    pad = (-len(header_bytes)) % 8
    header_bytes += b" " * pad

    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        for _, arr in order:
            f.write(arr.tobytes())


def save_checkpoint(dirname: str, shards: List[Dict[str, np.ndarray]], metadata: Dict[str, str]) -> None:
    """Write ``shard_NNN.dseek`` files; metadata goes into shard 0 only."""
    os.makedirs(dirname, exist_ok=True)
    for i, shard in enumerate(shards):
        save_shard(
            os.path.join(dirname, f"shard_{i:03d}.dseek"),
            shard,
            metadata=metadata if i == 0 else None,
        )


def pack_tokenizer_tokens(tokens: List[bytes]) -> np.ndarray:
    """Pack a vocab (list of token byte-strings) into the ``tokenizer.tokens``
    uint8 tensor: each token is NUL-terminated (tokenizer.h:18-49)."""
    blob = b"".join(t.replace(b"\x00", b"\x07") + b"\x00" for t in tokens)
    return np.frombuffer(blob, dtype=np.uint8).copy()


def unpack_tokenizer_tokens(arr: np.ndarray) -> List[bytes]:
    """Inverse of :func:`pack_tokenizer_tokens` (matches tokenizer.cpp:10-18)."""
    data = arr.tobytes()
    parts = data.split(b"\x00")
    if data.endswith(b"\x00"):
        parts = parts[:-1]
    return parts
