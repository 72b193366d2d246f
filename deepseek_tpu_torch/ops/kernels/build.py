"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), named by
a hash of its source and flags so an edited source rebuilds. The libraries
go to ``build/torch_kernels/`` at the root of the checkout. Nothing is
built when the package is imported: ``library()`` builds on first use, and
``build_all()`` starts one ``nvcc`` per source together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", *ARCH_FLAGS]

# C entry points and their argument types (pointers and the stream as
# c_void_p: ctypes would otherwise pass them as 32-bit ints)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "qmm": {"plain_matvec": [_P, _P, _I, _P, _P, _I, _I, _I, _P],
            "plain_mv": [_P, _P, _I, _P, _I, _I, _I, _P],
            "fp8_matvec": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
            "turbo_matvec": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P]},
    "nibble_mv": {"nibble_mv": [_P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                                _I, _I, _P]},
    "fp8_mv": {"fp8_mv": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "packed_mv": {"packed_mv": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I,
                                _I, _I, _I, _I, _P]},
    "mha_decode": {"mha_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                                  _I, _I, _P]},
    "qmm_tiles": {"tile_gemm": [_P, _I, _P, _P, _P, _I, _P, _I, _I, _P,
                                _P, _P, _P, _I, _I, _I, _I, _P]},
    "gmm": {"gmm": [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "expert_ffn": {"expert_ffn": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P,
                                  _P, _P, _I, _I, _I, _I, _I, _P]},
    "prefill_attn": {
        "mha_prefill": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P, _P],
        "mla_prefill": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P],
        "mla_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _I, _I, _F, _P]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}   # nvcc output per source (ptxas -v lines)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all(names: List[str] = None) -> Dict[str, ctypes.CDLL]:
    """Compile every named source (default: all) in parallel, one nvcc
    each, and load the results. Raises with the compiler output on error."""
    names = list(SIGNATURES) if names is None else names
    with _lock:
        todo = [n for n in names if n not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            out = _target(n)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
        failed = []
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOGS[n] = log
            if proc.returncode != 0:
                failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        for n in todo:
            _libs[n] = _load(n, _target(n))
        return {n: _libs[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all([name])[name]
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
