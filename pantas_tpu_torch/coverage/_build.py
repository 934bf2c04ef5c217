"""Build the port's CUDA sources into one shared library and bind it.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links the objects into one library in
``build/kernels/`` at the root of the checkout, once per content hash of the
sources, the headers they include and the flags; the library has a plain C
interface and is loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds, not minutes).
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory per kernel, kept in the .log
]

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (needs the CUDA toolkit) to build the port's kernels")


def _hashed_files() -> list:
    """Every file of ``csrc/`` that a build reads: the sources and the
    headers they include (only ``*.cu`` is compiled)."""
    return sorted(f for pat in ("*.cu", "*.cuh", "*.h") for f in CSRC.glob(pat))


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _hashed_files():
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
    nvcc = _nvcc()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = tmp.with_suffix(".d")
    objs.mkdir(parents=True, exist_ok=True)
    try:
        jobs = [
            (src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(objs / f"{src.stem}.o"), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            for src in sorted(CSRC.glob("*.cu"))
        ]
        logs = [(src, proc.communicate()[0], proc.returncode) for src, proc in jobs]
        bad = [f"{src.name} ({rc}):\n{log[-4000:]}" for src, log, rc in logs if rc]
        if bad:
            raise RuntimeError("nvcc failed on " + "\n".join(bad))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(objs / f"{src.stem}.o") for src, _, _ in logs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
        out.with_suffix(".log").write_text("".join(log for _, log, _ in logs))
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(objs, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The bound kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp = ctypes.c_void_p
        i32, i64 = ctypes.c_int, ctypes.c_int64
        for name in ("coverage_scatter_window", "coverage_scatter_chunk",
                     "coverage_partition_cap", "coverage_direct_block"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        lib.coverage_scatter_error_string.argtypes = [i32]
        lib.coverage_scatter_error_string.restype = ctypes.c_char_p
        lib.coverage_histogram_grid.argtypes = [i32]
        lib.coverage_histogram_grid.restype = i32
        lib.coverage_window_partition.argtypes = [i32, vp, i64, i32, i32, vp, vp, vp, vp, vp]
        lib.coverage_window_partition.restype = i32
        lib.coverage_scatter_sorted.argtypes = [i32, vp, i64, vp, i64, i32, *[vp] * 7]
        lib.coverage_scatter_sorted.restype = i32
        lib.coverage_direct_grid.argtypes = [i32]
        lib.coverage_direct_grid.restype = i32
        lib.coverage_scatter_direct.argtypes = [i32, vp, i64, vp, i64, vp]
        lib.coverage_scatter_direct.restype = i32
        _lib = lib
    return _lib
