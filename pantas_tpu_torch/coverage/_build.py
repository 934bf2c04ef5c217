"""Build the port's CUDA sources into one shared library and bind it.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into
``build/kernels/`` at the root of the checkout, once per content hash of the
sources and flags; the library has a plain C interface and is loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Nothing here runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory per kernel, kept in the .log
]

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (needs the CUDA toolkit) to build the port's kernels")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpantas_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; return its path.

    ``nvcc``'s own report (``-Xptxas -v``) is kept beside it as ``.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The bound kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp = ctypes.c_void_p
        lib.coverage_scatter_window.argtypes = []
        lib.coverage_scatter_window.restype = ctypes.c_int
        lib.coverage_scatter_error_string.argtypes = [ctypes.c_int]
        lib.coverage_scatter_error_string.restype = ctypes.c_char_p
        lib.coverage_scatter_sorted.argtypes = [vp, ctypes.c_int64, vp, vp, ctypes.c_int, vp]
        lib.coverage_scatter_sorted.restype = ctypes.c_int
        lib.coverage_direct_block.argtypes = []
        lib.coverage_direct_block.restype = ctypes.c_int
        lib.coverage_scatter_direct.argtypes = [vp, ctypes.c_int64, vp, ctypes.c_int64, vp]
        lib.coverage_scatter_direct.restype = ctypes.c_int
        _lib = lib
    return _lib
