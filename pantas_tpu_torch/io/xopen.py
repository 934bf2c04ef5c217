"""Transparent compressed-file support for every stage boundary.

The reference pipeline exchanges plain-text stage files only (GFA / GAF /
GTF / CSV — SURVEY §1 data-flow). On this class of machine the measured
file-read ceiling (~180 MB/s, docs/PERFORMANCE.md) taxes every scan of a
multi-GB artifact, so the TPU-native framework accepts gzip (``.gz``) and
zstandard (``.zst``) transparently on every stage INPUT and offers
compressed stage OUTPUT opt-in (by naming the output ``*.gz``/``*.zst``).
Byte-identity contracts are defined on the DECOMPRESSED content — the
wire format is unchanged, only the at-rest encoding differs.

Two consumption modes:

* :func:`xopen` — streaming text/binary handle for line-oriented Python
  parsers (gzip via zlib, zstd via the system's libzstd:
  :mod:`~pantas_tpu_torch.io.zstd_ctypes`).
* :func:`materialized` — context manager yielding a PLAIN file path for
  the native mmap consumers (``gafcov``/``gfaload`` map the file and
  parse in place); compressed inputs are inflated once into ``/dev/shm``
  (RAM-backed, sized for this box) or ``$TMPDIR`` and removed on exit.

gzip WRITE defaults to level 1: the emitters are sequential-bandwidth
bound, and zlib level 1 compresses GFA/GAF text ~4-5x at ~200 MB/s —
past the measured disk ceiling, so compression is never the bottleneck
while the bytes written drop ~5x.
"""

from __future__ import annotations

import contextlib
import fcntl
import gzip
import io
import os
import shutil
import tempfile
import threading

from pantas_tpu_torch.io.zstd_ctypes import open_zst

GZ_WRITE_LEVEL = 1
DRAIN_CHUNK = 1 << 20  # bytes the drain thread moves from the pipe at a time


def is_compressed(path) -> bool:
    p = str(path)
    return p.endswith(".gz") or p.endswith(".zst")


def xopen(path, mode: str = "rt", **kw):
    """Open ``path`` transparently (plain / ``.gz`` / ``.zst``).

    Text mode by default, newline handling identical to ``open``. Write
    modes create compressed streams when the suffix asks for one.
    """
    p = str(path)
    if p.endswith(".gz"):
        if "w" in mode or "a" in mode or "x" in mode:
            kw.setdefault("compresslevel", GZ_WRITE_LEVEL)
        return gzip.open(p, mode, **kw)
    if p.endswith(".zst"):
        return open_zst(p, mode)
    return open(p, mode, **kw)


def _inflate_to(path: str, out_fh) -> None:
    if str(path).endswith(".gz") and shutil.which("gzip"):
        # the C inflater sustains ~2x the Python gzip-module loop on
        # multi-GB artifacts (measured on the 4.1 GB augmented GFA)
        import subprocess

        rc = subprocess.run(["gzip", "-dc", str(path)], stdout=out_fh).returncode
        if rc != 0:
            raise IOError(f"gzip -dc failed on {path} ({rc})")
        return
    with xopen(path, "rb") as src:
        shutil.copyfileobj(src, out_fh, 1 << 22)


def _scratch_dir() -> str:
    # RAM-backed when available: the consumers mmap the inflated file and
    # stream it exactly once, so paying the disk a second time is waste
    shm = "/dev/shm"
    if os.path.isdir(shm) and os.access(shm, os.W_OK):
        return shm
    return tempfile.gettempdir()


def _drain(read_fd: int, path: str, state: dict) -> None:
    """Copy the pipe into the compressor of ``path`` until the write end
    closes, then set ``state["done"]``. On an error the read end is closed
    at once, so a writer gets ``EPIPE`` instead of blocking on a full pipe;
    the error is kept in ``state["error"]`` for the caller."""
    try:
        with os.fdopen(read_fd, "rb", buffering=0) as src, xopen(path, "wb") as dst:
            while True:
                chunk = src.read(DRAIN_CHUNK)
                if not chunk:
                    break
                dst.write(chunk)
        state["done"] = True
    except Exception as e:  # reported by the caller after join()
        state["error"] = e


@contextlib.contextmanager
def _drained_pipe(path: str):
    """A text handle on the write end of a pipe whose read end a thread
    copies into ``xopen(path, "wb")``.

    The native emitters are called through ``ctypes.CDLL``, which releases
    the GIL for the call, so the drain thread runs while an emitter blocks
    on a full pipe: no deadlock. On a normal exit the handle is flushed and
    closed and the thread joined; a compressor error (a full disk, say)
    raises here, so the stage cannot exit 0 with a truncated file. When the
    body raises, the write end is closed, the thread joined, and the body's
    own exception goes on.
    """
    read_fd, write_fd = os.pipe()
    with contextlib.suppress(OSError):  # a larger pipe: fewer hand-offs to the drain thread
        fcntl.fcntl(write_fd, fcntl.F_SETPIPE_SZ, DRAIN_CHUNK)
    state = {"done": False, "error": None}
    thread = threading.Thread(target=_drain, args=(read_fd, path, state),
                              name=f"stage-output-drain:{os.path.basename(path)}", daemon=True)
    thread.start()
    out = open(write_fd, "w", buffering=DRAIN_CHUNK)
    try:
        yield out
    except BaseException as e:
        with contextlib.suppress(OSError):
            out.close()
        thread.join()
        if state["error"] is not None:  # the body's EPIPE or short write had this cause
            e.add_note(f"compressing {path} failed: {state['error']!r}")
        raise
    close_error = None
    try:
        out.close()  # flushes; the write end closes even when the flush fails
    except OSError as e:  # EPIPE: the drain thread failed and closed its end
        close_error = e
    thread.join()
    if state["error"] is not None:
        raise OSError(f"compressing {path} failed: {state['error']!r}") from state["error"]
    if close_error is not None:
        raise close_error
    if not state["done"]:
        raise OSError(f"compressing {path} stopped before the end of the output")


@contextlib.contextmanager
def open_stage_output(path):
    """Open a stage OUTPUT for text writing, compressed when the name
    asks for it (``*.gz`` / ``*.zst``).

    ``.gz`` pipes through a ``gzip -1`` subprocess when the binary exists:
    the yielded handle then has a real ``fileno()`` (the pipe), so the
    native emitters keep their zero-copy fd fast path and compression
    runs concurrently in the other process — on a 2-core box the emitter
    and the compressor overlap instead of serializing. ``.zst``, and
    ``.gz`` without the binary, go through :func:`_drained_pipe`: the
    handle is again a pipe, which a thread drains into the in-process
    compressor. The native emitters write plain bytes to ``fileno()``, so
    it is never the compressed file's own descriptor.
    """
    p = str(path)
    if p.endswith(".gz") and shutil.which("gzip"):
        import subprocess

        with open(p, "wb") as sink:
            proc = subprocess.Popen(
                ["gzip", f"-{GZ_WRITE_LEVEL}", "-c"],
                stdin=subprocess.PIPE, stdout=sink,
            )
            wrapper = io.TextIOWrapper(proc.stdin, write_through=True)
            try:
                yield wrapper
                wrapper.flush()
                wrapper.close()
                rc = proc.wait()
                if rc != 0:
                    raise IOError(f"gzip writer exited with {rc}")
            except BaseException:
                # body (or flush) failed: close the pipe so gzip exits —
                # a skipped close would leave proc.wait() blocked — and
                # re-raise the ORIGINAL exception, not a gzip exit code
                with contextlib.suppress(Exception):
                    wrapper.close()
                with contextlib.suppress(Exception):
                    proc.kill()
                proc.wait()
                raise
        return
    if is_compressed(p):
        with _drained_pipe(p) as fh:
            yield fh
        return
    with open(p, "w") as fh:
        yield fh


@contextlib.contextmanager
def materialized(path):
    """Yield a plain-file path for mmap-based native consumers.

    Plain inputs pass through untouched; compressed inputs inflate once
    into scratch space and the temp file is removed on exit.
    """
    p = str(path)
    if not is_compressed(p):
        yield p
        return
    fd, tmp = tempfile.mkstemp(
        prefix="pantas_inflate_", suffix=".plain", dir=_scratch_dir()
    )
    try:
        with os.fdopen(fd, "wb") as out:
            _inflate_to(p, out)
        yield tmp
    finally:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
