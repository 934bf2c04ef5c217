"""Streaming zstd through the system's ``libzstd``: the port's one route to
``*.zst``.

:func:`~pantas_tpu_torch.io.xopen.xopen` reads and writes ``*.zst`` through
:func:`open_zst`. ``libzstd.so.1`` ships with most Linux systems (a
dependency of systemd, curl and the package managers), while the
``zstandard`` Python module is a separate install that the card machine
lacks. The files are standard zstd frames, which any zstd decoder reads.

The writer compresses at ``LEVEL`` (the ``zstandard`` module's default)
and ends the frame when it closes. The reader decodes frame after frame
until the file ends; it cannot seek, and its ``tell()`` is the
decompressed position. Every call into the library goes through
``ctypes.CDLL``, which releases the GIL for it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import io

LEVEL = 3
_C_COMPRESSION_LEVEL = 100  # ZSTD_c_compressionLevel
_E_CONTINUE, _E_END = 0, 2  # ZSTD_EndDirective

_lib = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def _load():
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        raise RuntimeError(
            "libzstd is not available; use .gz or plain files"
        ) from e
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    for fn, res, args in (
        ("ZSTD_createCCtx", vp, []), ("ZSTD_freeCCtx", sz, [vp]),
        ("ZSTD_CCtx_setParameter", sz, [vp, ctypes.c_int, ctypes.c_int]),
        ("ZSTD_compressStream2", sz, [vp, ctypes.POINTER(_OutBuffer),
                                      ctypes.POINTER(_InBuffer), ctypes.c_int]),
        ("ZSTD_CStreamOutSize", sz, []),
        ("ZSTD_createDCtx", vp, []), ("ZSTD_freeDCtx", sz, [vp]),
        ("ZSTD_decompressStream", sz, [vp, ctypes.POINTER(_OutBuffer),
                                       ctypes.POINTER(_InBuffer)]),
        ("ZSTD_DStreamInSize", sz, []),
        ("ZSTD_isError", ctypes.c_uint, [sz]), ("ZSTD_getErrorName", ctypes.c_char_p, [sz]),
    ):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    _lib = lib
    return lib


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise OSError(f"{what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


class ZstdWriter(io.RawIOBase):
    """Compress what is written into one zstd frame in ``fh``, a binary
    file; closing ends the frame and closes ``fh``."""

    def __init__(self, fh, level: int = LEVEL):
        self._lib = _load()
        self._fh = fh
        self._ctx = self._lib.ZSTD_createCCtx()
        if not self._ctx:
            raise MemoryError("ZSTD_createCCtx failed")
        _check(self._lib, self._lib.ZSTD_CCtx_setParameter(self._ctx, _C_COMPRESSION_LEVEL,
                                                           level), "zstd level")
        self._out = ctypes.create_string_buffer(self._lib.ZSTD_CStreamOutSize())

    def writable(self):
        return True

    def _pump(self, data, directive) -> None:
        """Feed ``data`` (a bytes-like object or None) with ``directive``
        until the library has taken all of it (and, at the end, flushed)."""
        src = (ctypes.c_char * len(data)).from_buffer_copy(data) if data else None
        inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p) if src is not None else None,
                        len(data) if data else 0, 0)
        while True:
            outb = _OutBuffer(ctypes.cast(self._out, ctypes.c_void_p), len(self._out), 0)
            left = _check(self._lib, self._lib.ZSTD_compressStream2(
                self._ctx, ctypes.byref(outb), ctypes.byref(inb), directive), "zstd compress")
            if outb.pos:
                self._fh.write(self._out.raw[:outb.pos])
            if directive == _E_END and left == 0:
                return
            if directive == _E_CONTINUE and inb.pos == inb.size:
                return

    def write(self, b) -> int:
        data = memoryview(b).cast("B")
        if len(data):
            self._pump(data, _E_CONTINUE)
        return len(data)

    def close(self) -> None:
        if self.closed:
            return
        try:
            self._pump(None, _E_END)
        finally:
            try:
                self._fh.close()
            finally:
                self._lib.ZSTD_freeCCtx(self._ctx)
                super().close()


class ZstdReader(io.RawIOBase):
    """Decompress the zstd frames of ``fh``, a binary file, in order."""

    def __init__(self, fh):
        self._lib = _load()
        self._fh = fh
        self._ctx = self._lib.ZSTD_createDCtx()
        if not self._ctx:
            raise MemoryError("ZSTD_createDCtx failed")
        self._in_size = self._lib.ZSTD_DStreamInSize()
        self._src = b""
        self._inb = _InBuffer(None, 0, 0)
        self._pos = 0
        self._eof = False
        self._frame_done = True  # no frame begun: an empty file reads as empty

    def readable(self):
        return True

    def tell(self) -> int:
        return self._pos

    def readinto(self, b) -> int:
        view = memoryview(b).cast("B")
        if not len(view):
            return 0
        dst = (ctypes.c_char * len(view)).from_buffer(view)
        outb = _OutBuffer(ctypes.cast(dst, ctypes.c_void_p), len(view), 0)
        while outb.pos == 0:
            if self._inb.pos == self._inb.size and not self._eof:
                self._src = self._fh.read(self._in_size)
                self._eof = not self._src
                self._inb = _InBuffer(ctypes.cast(ctypes.c_char_p(self._src), ctypes.c_void_p),
                                      len(self._src), 0)
            taken = self._inb.pos
            hint = _check(self._lib, self._lib.ZSTD_decompressStream(
                self._ctx, ctypes.byref(outb), ctypes.byref(self._inb)), "zstd decompress")
            if outb.pos or self._inb.pos != taken:
                self._frame_done = hint == 0
            elif self._eof:  # the file has ended and the library holds nothing more
                if not self._frame_done:
                    raise OSError("zstd decompress: the file ends inside a frame")
                break
        del dst
        self._pos += outb.pos
        return outb.pos

    def close(self) -> None:
        if self.closed:
            return
        try:
            self._fh.close()
        finally:
            self._lib.ZSTD_freeDCtx(self._ctx)
            super().close()


def open_zst(path: str, mode: str):
    """``path`` opened as :func:`~pantas_tpu_torch.io.xopen.xopen` opens a
    ``.zst`` file, on ``libzstd``: buffered binary, or text when ``mode``
    has no ``b``."""
    if "r" in mode:
        stream = io.BufferedReader(ZstdReader(open(path, "rb")), 1 << 20)
    else:
        stream = io.BufferedWriter(ZstdWriter(open(path, "wb")), 1 << 20)
    return stream if "b" in mode else io.TextIOWrapper(stream)
