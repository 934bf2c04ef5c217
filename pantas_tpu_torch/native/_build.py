"""Build the port's host C++ sources with ``g++`` at first use.

The libraries go to ``build/native/`` at the root of the checkout, never
beside the sources, and are named by the content hash of their sources and
flags, so an edited source or another flag set gets a library of its own.
``-march=native`` is right because a library is built on the machine that
runs it: ``build/`` is never carried from one machine to another.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-pthread", "-shared", "-fPIC"]


def library_path(stem: str, sources: Sequence[Path], flags: Sequence[str]) -> Path:
    """Where the library for these sources and flags lives."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def build_shared(
    stem: str, sources: Sequence[Path], extra_flags: Sequence[str] = (), force: bool = False
) -> Path:
    """Compile ``sources`` into one shared library unless it exists; return
    its path. A failed compile raises ``subprocess.CalledProcessError``."""
    flags = [*CXX_FLAGS, *extra_flags]
    out = library_path(stem, sources, flags)
    if out.exists() and not force:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", *flags, *(str(s) for s in sources), "-o", str(tmp)],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out
