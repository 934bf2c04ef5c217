"""Self-building import shim for the native GFA loader extension.

Unlike the ctypes engines, ``gfaload`` is a real CPython extension (it
builds Python dicts/sets/objects directly), compiled on first use with g++
against the interpreter's headers into ``build/native/`` and loaded from its
file path.
"""

from __future__ import annotations

import importlib.util
import sysconfig
from pathlib import Path

from pantas_tpu_torch.native._build import SRC_DIR, build_shared

_SRC = SRC_DIR / "gfaload.cpp"

_mod = None
_failed = False


def build_extension(force: bool = False) -> Path:
    inc = sysconfig.get_paths()["include"]
    return build_shared("gfaload_ext", (_SRC,), extra_flags=(f"-I{inc}",), force=force)


def get_module():
    """The compiled extension module, or None if unavailable."""
    global _mod, _failed
    if _mod is not None or _failed:
        return _mod
    try:
        spec = importlib.util.spec_from_file_location("gfaload_ext", build_extension())
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _mod = mod
    except Exception:
        _failed = True
        _mod = None
    return _mod
