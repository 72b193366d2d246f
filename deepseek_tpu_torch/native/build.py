"""Build the native host libraries with g++ at first use.

Each ``native/*.cpp`` compiles on its own into a shared library under
``build/native/`` at the root of the checkout, named by a hash of its
source and flags (an edited source rebuilds; ``-march=native`` makes the
library machine-specific, so it is never committed). The compile goes to a
temporary file renamed into place, so concurrent processes never load a
half-written library. ``DSEEK_NO_NATIVE=1`` disables every native library
(the callers take their Python paths), as in the JAX package.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp", "-march=native"]

_LOCK = threading.Lock()
ERRORS: Dict[str, str] = {}      # why a library did not build, by source name


def disabled() -> bool:
    return os.environ.get("DSEEK_NO_NATIVE") == "1"


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_shared_lib(src_name: str) -> Optional[str]:
    """Compile ``native/<src_name>`` if needed; its library path, or None
    when native code is disabled or g++ fails (``ERRORS[src_name]`` says
    why)."""
    if disabled():
        ERRORS[src_name] = "DSEEK_NO_NATIVE=1"
        return None
    src = SRC_DIR / src_name
    out = _target(src)
    with _LOCK:
        if out.exists():
            return str(out)
        gxx = shutil.which("g++")
        if gxx is None:
            ERRORS[src_name] = "g++ not found"
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run([gxx, *FLAGS, str(src), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=300)
        except subprocess.TimeoutExpired:
            ERRORS[src_name] = "g++ timed out"
            return None
        if proc.returncode != 0:
            ERRORS[src_name] = f"g++ failed ({proc.returncode}): {proc.stderr[-2000:]}"
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, out)
        return str(out)
