"""ctypes wrapper for the native GAF coverage engine (gafcov.cpp).

Produces the same flat counts vector as the device path and reconstructs
first-seen orders so the emitted augmented GFA stays byte-identical to the
reference augmenter.
"""

from __future__ import annotations

import ctypes
import io
import os
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from pantas_tpu_torch import trace
from pantas_tpu_torch.coverage.host import CoverageCounts, emit_augmented_gfa
from pantas_tpu_torch.graph.compiler import GraphTensors, compile_gfa, ids_dense

from pantas_tpu_torch.native._build import SRC_DIR, build_shared

_SOURCES = (SRC_DIR / "gafcov.cpp", SRC_DIR / "aligner.cpp")

_lib = None

# the slot session's totals (gafcov_slots_stats), as trace counters
SLOT_STATS = ("slots.parse_ns", "slots.handoff_ns", "slots.records", "slots.bytes",
              "slots.delivered", "slots.threads", "slots.waves", "slots.merge_ns")
# an emission's phases, in the order of gafcov_emit_stats's stamps, and its sizes
EMIT_PHASES = ("emit.bin", "emit.slurp", "emit.format", "emit.write", "emit.novel")
EMIT_COUNTS = ("emit.chunks", "emit.threads", "emit.bytes_out")


def build_library(force: bool = False) -> Path:
    """``gafcov.cpp`` and ``aligner.cpp`` as one library under
    ``build/native/`` (see :mod:`._build`)."""
    return build_shared("libgafcov", _SOURCES, force=force)


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    i64, i32, u64, f64 = (
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_uint64,
        ctypes.c_double,
    )
    P = ctypes.POINTER
    lib.gafcov_create.restype = ctypes.c_void_p
    lib.gafcov_create.argtypes = [
        i64, P(i64), P(i32), P(u64), i64, P(i64), P(i64), i64, i64, ctypes.c_int,
    ]
    lib.gafcov_process_file.restype = i64
    lib.gafcov_process_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, f64]
    lib.gafcov_process_file_mt.restype = i64
    lib.gafcov_process_file_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, f64, ctypes.c_int,
    ]
    lib.gafcov_counts.restype = P(i32)
    lib.gafcov_counts.argtypes = [ctypes.c_void_p]
    lib.gafcov_seen_count.restype = i64
    lib.gafcov_seen_count.argtypes = [ctypes.c_void_p]
    lib.gafcov_seen_order.restype = P(i64)
    lib.gafcov_seen_order.argtypes = [ctypes.c_void_p]
    lib.gafcov_novel_count.restype = i64
    lib.gafcov_novel_count.argtypes = [ctypes.c_void_p]
    lib.gafcov_novel_fill.restype = None
    lib.gafcov_novel_fill.argtypes = [ctypes.c_void_p, P(u64), P(i32)]
    for name in ("gafcov_rejected", "gafcov_skipped", "gafcov_accepted"):
        getattr(lib, name).restype = i64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.gafcov_emit.restype = i64
    lib.gafcov_emit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.gafcov_force_bins.restype = None
    lib.gafcov_force_bins.argtypes = [ctypes.c_void_p]
    lib.gafcov_slots_begin.restype = ctypes.c_void_p
    lib.gafcov_slots_begin.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64, i64, ctypes.c_int, f64, ctypes.c_int,
    ]
    lib.gafcov_slots_next.restype = i64
    lib.gafcov_slots_next.argtypes = [ctypes.c_void_p, P(i32), i64]
    lib.gafcov_slots_end.restype = None
    lib.gafcov_slots_end.argtypes = [ctypes.c_void_p]
    lib.gafcov_slots_pos.restype = i64
    lib.gafcov_slots_pos.argtypes = [ctypes.c_void_p]
    lib.gafcov_slots_take_pending.restype = i64
    lib.gafcov_slots_take_pending.argtypes = [ctypes.c_void_p, P(i32), i64]
    lib.gafcov_slots_stats.restype = None
    lib.gafcov_slots_stats.argtypes = [ctypes.c_void_p, P(i64)]
    lib.gafcov_emit_stats.restype = None
    lib.gafcov_emit_stats.argtypes = [ctypes.c_void_p, P(i64)]
    lib.gafcov_counts_set.restype = None
    lib.gafcov_counts_set.argtypes = [ctypes.c_void_p, P(i32)]
    lib.gafcov_seen_pos.restype = P(i64)
    lib.gafcov_seen_pos.argtypes = [ctypes.c_void_p]
    lib.gafcov_novel_pos_fill.restype = None
    lib.gafcov_novel_pos_fill.argtypes = [ctypes.c_void_p, P(i64)]
    lib.gafcov_destroy.restype = None
    lib.gafcov_destroy.argtypes = [ctypes.c_void_p]
    lib.aln_create.restype = ctypes.c_void_p
    lib.aln_create.argtypes = [
        ctypes.c_char_p, P(i64), P(i64), P(i64), P(i64), ctypes.c_int,
        P(u64), P(i32), P(i32), i64, ctypes.c_int, ctypes.c_int,
    ]
    lib.aln_destroy.restype = None
    lib.aln_destroy.argtypes = [ctypes.c_void_p]
    lib.aln_align.restype = ctypes.c_int
    lib.aln_align.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64, P(i64), P(i64),
        ctypes.c_char_p, i64,
    ]
    lib.aln_map_file.restype = i64
    lib.aln_map_file.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, P(i64),
    ]
    lib.aln_phase_stats.restype = None
    lib.aln_phase_stats.argtypes = [ctypes.c_void_p, P(i64)]
    lib.shk_filter_file.restype = i64
    lib.shk_filter_file.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, P(i64), ctypes.c_int,
        f64, ctypes.c_int, P(i64),
    ]
    lib.kidx_pack.restype = None
    lib.kidx_pack.argtypes = [ctypes.c_char_p, i64, ctypes.c_int, P(u64)]
    lib.kidx_sort.restype = None
    lib.kidx_sort.argtypes = [P(u64), P(i32), P(i32), i64]
    lib.gfa_scan.restype = ctypes.c_void_p
    lib.gfa_scan.argtypes = [ctypes.c_char_p]
    lib.gfa_scan_ok.restype = ctypes.c_int
    lib.gfa_scan_ok.argtypes = [ctypes.c_void_p]
    for name in ("gfa_scan_n_nodes", "gfa_scan_n_edges"):
        getattr(lib, name).restype = i64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name, ct in (
        ("gfa_scan_ids", i64), ("gfa_scan_lens", i32),
        ("gfa_scan_esrc", i64), ("gfa_scan_edst", i64),
    ):
        getattr(lib, name).restype = P(ct)
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.gfa_scan_free.restype = None
    lib.gfa_scan_free.argtypes = [ctypes.c_void_p]
    lib.clipsites_create.restype = ctypes.c_void_p
    lib.clipsites_create.argtypes = [i64, P(i64), P(i32)]
    lib.clipsites_process_file.restype = i64
    lib.clipsites_process_file.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, f64, ctypes.c_int,
    ]
    lib.clipsites_count.restype = i64
    lib.clipsites_count.argtypes = [ctypes.c_void_p]
    lib.clipsites_fill.restype = None
    lib.clipsites_fill.argtypes = [
        ctypes.c_void_p, P(i64), P(i32), ctypes.POINTER(ctypes.c_int8),
        P(i32), P(i32),
    ]
    lib.clipsites_destroy.restype = None
    lib.clipsites_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def clip_sites_native(
    gaf_path: str,
    node_ids,
    node_lens,
    mapq_thr: int = 20,
    max_dv: float = 0.1,
    min_clip: int = 5,
):
    """Native clip-boundary pile-up scan (the ``novel-sites`` hot loop).

    ``node_ids``/``node_lens``: int64/int32 numpy arrays. Returns
    ``{(side_str, node_id_str, offset): [count, clip_max]}`` — the same
    pile structure the Python detector builds (its oracle) — or ``None``
    when the graph exceeds the native pile-key packing (node length >=
    2^19 or id >= 2^43); the caller then uses the host scanner.
    """
    lib = _load()
    ids = np.ascontiguousarray(node_ids, dtype=np.int64)
    lens = np.ascontiguousarray(node_lens, dtype=np.int32)
    h = lib.clipsites_create(
        len(ids),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if not h:
        return None
    try:
        from pantas_tpu_torch.io.xopen import materialized

        with materialized(gaf_path) as plain:
            n = lib.clipsites_process_file(
                h, str(plain).encode(), mapq_thr, max_dv, min_clip
            )
        if n < 0:
            raise IOError(f"cannot scan {gaf_path}")
        m = lib.clipsites_count(h)
        node = np.empty(m, dtype=np.int64)
        off = np.empty(m, dtype=np.int32)
        side = np.empty(m, dtype=np.int8)
        count = np.empty(m, dtype=np.int32)
        clipmax = np.empty(m, dtype=np.int32)
        lib.clipsites_fill(
            h,
            node.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            off.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            side.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            clipmax.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    finally:
        lib.clipsites_destroy(h)
    sides = ("start", "end")
    return {
        (sides[side[i]], str(node[i]), int(off[i])): [int(count[i]), int(clipmax[i])]
        for i in range(m)
    }


def scan_gfa_structure(gfa_path: str):
    """Native structural GFA scan: (ids, lens, edge_src_ids, edge_dst_ids)
    as numpy arrays, or None if ids are not plain integers (caller falls
    back to the general Python parser)."""
    from pantas_tpu_torch.io.xopen import materialized

    lib = _load()
    with materialized(gfa_path) as plain:
        h = lib.gfa_scan(str(plain).encode())
    if not h:
        raise IOError(f"cannot scan {gfa_path}")
    try:
        if not lib.gfa_scan_ok(h):
            return None
        n = lib.gfa_scan_n_nodes(h)
        e = lib.gfa_scan_n_edges(h)
        ids = np.ctypeslib.as_array(lib.gfa_scan_ids(h), shape=(n,)).copy() if n else np.zeros(0, np.int64)
        lens = np.ctypeslib.as_array(lib.gfa_scan_lens(h), shape=(n,)).copy() if n else np.zeros(0, np.int32)
        esrc = np.ctypeslib.as_array(lib.gfa_scan_esrc(h), shape=(e,)).copy() if e else np.zeros(0, np.int64)
        edst = np.ctypeslib.as_array(lib.gfa_scan_edst(h), shape=(e,)).copy() if e else np.zeros(0, np.int64)
        return ids, lens, esrc, edst
    finally:
        lib.gfa_scan_free(h)


def host_threads(share: int = 1) -> int:
    """The CPUs this process may run on, divided among ``share`` processes
    of one host: the threads a native parse takes when none are named."""
    return max(1, len(os.sched_getaffinity(0)) // max(share, 1))


def _canonical_ids(names) -> np.ndarray:
    """The Python parser's segment names as int64 ids, or ValueError unless
    every one is a CANONICAL integer: '007' would int() onto segment '7' and
    silently merge both segments' counts into one slot (and novel-link
    emission would print the canonical form, breaking byte-identity). int()
    also tolerates '+7'/' 7'/'1_0', so require plain digits with no leading
    zero — equivalent to the str(int(n)) == n round trip but ~3x cheaper at
    5.5M names (same guard events/sites.py claims) — and an id within int64."""
    try:
        ids = np.asarray([int(n) for n in names], dtype=np.int64)
        if not all(n.isdigit() and (len(n) == 1 or n[0] != "0") for n in names):
            raise ValueError("non-canonical integer segment id")
    except (ValueError, OverflowError) as e:
        raise ValueError("native path requires integer segment ids") from e
    return ids


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeCoverage:
    """One accumulation session over a compiled graph."""

    def __init__(self, tensors: GraphTensors):
        lib = _load()
        self.lib = lib
        self.t = tensors
        with trace.span("native.ids_check"):
            ids = tensors.node_ids  # canonical already: the scan refuses others
            if ids is None:
                ids = _canonical_ids(tensors.node_names)
            if len(ids) > 1 and not np.all(ids[1:] >= ids[:-1]):
                raise ValueError("native path requires ids sorted in file order")
            dense = ids_dense(ids)
        with trace.span("native.create"):
            # keep every array alive for the lifetime of the handle
            self._ids = ids
            self._node_len = np.ascontiguousarray(tensors.node_len, dtype=np.int32)
            self._edge_key = np.ascontiguousarray(tensors.edge_key, dtype=np.uint64)
            self._il_base = np.ascontiguousarray(tensors.il_base, dtype=np.int64)
            self._ol_base = np.ascontiguousarray(tensors.ol_base, dtype=np.int64)
            self.handle = lib.gafcov_create(
                len(ids),
                _ptr(self._ids, ctypes.c_int64),
                _ptr(self._node_len, ctypes.c_int32),
                _ptr(self._edge_key, ctypes.c_uint64),
                len(self._edge_key),
                _ptr(self._il_base, ctypes.c_int64),
                _ptr(self._ol_base, ctypes.c_int64),
                tensors.rc_base,
                tensors.total_slots,
                1 if dense else 0,
            )
        if os.environ.get("PANTAS_FORCE_BINS"):
            # test hook: exercise the binned accumulator on small graphs
            # (it auto-enables only beyond 8M count slots)
            lib.gafcov_force_bins(self.handle)

    def process_file(
        self,
        gaf_path: str,
        mapq_thr: int = 20,
        max_dv: float = 0.1,
        threads: Optional[int] = 1,
    ) -> int:
        """Count a whole GAF on ``threads`` threads (``None``: host_threads())."""
        from pantas_tpu_torch.io.xopen import materialized

        threads = host_threads() if threads is None else threads
        with materialized(gaf_path) as plain:
            if threads > 1:
                n = self.lib.gafcov_process_file_mt(
                    self.handle, str(plain).encode(), mapq_thr, max_dv, threads
                )
            else:
                n = self.lib.gafcov_process_file(
                    self.handle, str(plain).encode(), mapq_thr, max_dv
                )
        if n < 0:
            raise IOError(f"cannot read {gaf_path}")
        return int(n)

    def counts_vector(self) -> np.ndarray:
        ptr = self.lib.gafcov_counts(self.handle)
        return np.ctypeslib.as_array(ptr, shape=(self.t.total_slots,)).copy()

    # -- slot-stream session (the native feed for the device engine) --------

    def slots_begin(
        self,
        gaf_path: str,
        lo: int = 0,
        hi: int = -1,
        mapq_thr: int = 20,
        max_dv: float = 0.1,
        threads: Optional[int] = None,
    ):
        """Open a slot-stream parse session over a GAF byte range.

        The session parses in waves of about one batch, each cut into up to
        ``threads`` line-aligned pieces parsed at once (``None``:
        host_threads()); a wave takes fewer pieces where the range has less
        than half a MiB a piece left. The batches are the one-thread walk's
        whatever the count.

        Compressed inputs inflate once into scratch (xopen.materialized
        semantics); byte offsets (``lo``/``hi``/``slots_pos``) always
        refer to the DECOMPRESSED stream, so checkpoint offsets stay
        valid across save/resume regardless of the at-rest encoding.
        The C session mmaps the file, so on Linux the inflated temp can
        be unlinked as soon as the session holds the mapping.
        """
        from pantas_tpu_torch.io.xopen import materialized

        with materialized(gaf_path) as plain:
            s = self.lib.gafcov_slots_begin(
                self.handle, str(plain).encode(), lo, hi, mapq_thr, max_dv,
                host_threads() if threads is None else threads,
            )
        if not s:
            raise IOError(f"cannot open slot session on {gaf_path}")
        return s

    def slots_next(self, session, buf: np.ndarray) -> int:
        """Fill ``buf`` (contiguous int32) with slot indices; 0 = drained."""
        return int(
            self.lib.gafcov_slots_next(
                session, _ptr(buf, ctypes.c_int32), len(buf)
            )
        )

    def slots_end(self, session) -> None:
        self.lib.gafcov_slots_end(session)

    def slots_pos(self, session) -> int:
        """Absolute byte offset of the next unparsed record."""
        return int(self.lib.gafcov_slots_pos(session))

    def slots_take_pending(self, session, buf: np.ndarray) -> int:
        """Drain already-parsed-but-undelivered slots (no further parsing)."""
        return int(
            self.lib.gafcov_slots_take_pending(
                session, _ptr(buf, ctypes.c_int32), len(buf)
            )
        )

    def slots_stats(self, session) -> dict:
        """The session's totals so far, by :data:`SLOT_STATS` name."""
        out = np.zeros(len(SLOT_STATS), np.int64)
        self.lib.gafcov_slots_stats(session, _ptr(out, ctypes.c_int64))
        return dict(zip(SLOT_STATS, out.tolist()))

    def set_counts(self, flat: np.ndarray) -> None:
        """Overwrite engine counts with the device-reduced vector (it then
        backs ``to_counts`` / ``emit``)."""
        arr = np.ascontiguousarray(flat, dtype=np.int32)
        assert len(arr) == self.t.total_slots
        self.lib.gafcov_counts_set(self.handle, _ptr(arr, ctypes.c_int32))

    def seen_sidecar(self):
        """(seen_slots, first_seen_byte_pos) in first-seen order."""
        n = int(self.lib.gafcov_seen_count(self.handle))
        if not n:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        order = np.ctypeslib.as_array(
            self.lib.gafcov_seen_order(self.handle), shape=(n,)
        ).copy()
        pos = np.ctypeslib.as_array(
            self.lib.gafcov_seen_pos(self.handle), shape=(n,)
        ).copy()
        return order, pos

    def novel_sidecar(self):
        """(packed_keys, counts, first_seen_byte_pos) in first-seen order."""
        n = int(self.lib.gafcov_novel_count(self.handle))
        keys = np.zeros(n, dtype=np.uint64)
        vals = np.zeros(n, dtype=np.int32)
        poss = np.zeros(n, dtype=np.int64)
        if n:
            self.lib.gafcov_novel_fill(
                self.handle, _ptr(keys, ctypes.c_uint64), _ptr(vals, ctypes.c_int32)
            )
            self.lib.gafcov_novel_pos_fill(self.handle, _ptr(poss, ctypes.c_int64))
        return keys, vals, poss

    def to_counts(self) -> CoverageCounts:
        t = self.t
        lib = self.lib
        flat = self.counts_vector()
        counts = CoverageCounts()
        counts.rejected = int(lib.gafcov_rejected(self.handle))
        counts.skipped = int(lib.gafcov_skipped(self.handle))
        counts.accepted = int(lib.gafcov_accepted(self.handle))
        counts.node_len = {n: int(l) for n, l in zip(t.node_names, t.node_len)}

        nc = flat[: t.n_nodes]
        for ni in np.nonzero(nc)[0]:
            counts.nc[t.node_names[ni]] = int(nc[ni])

        # reconstruct per-node IL/OL offset first-seen orders from the slot log
        n_seen = int(lib.gafcov_seen_count(self.handle))
        if n_seen:
            seen = np.ctypeslib.as_array(
                lib.gafcov_seen_order(self.handle), shape=(n_seen,)
            )
            hist_total = int(t.ol_base[0] - t.il_base[0]) if t.n_nodes else 0
            for slot in seen:
                slot = int(slot)
                # slot = base + offset + 1 (offsets span -1..len)
                if slot < t.il_base[0] + hist_total:  # IL section
                    ni = int(np.searchsorted(t.il_base, slot, side="right")) - 1
                    off = slot - int(t.il_base[ni]) - 1
                    counts.il.setdefault(t.node_names[ni], {})[off] = int(flat[slot])
                else:  # OL section
                    ni = int(np.searchsorted(t.ol_base, slot, side="right")) - 1
                    off = slot - int(t.ol_base[ni]) - 1
                    counts.ol.setdefault(t.node_names[ni], {})[off] = int(flat[slot])

        rc = flat[t.rc_base :]
        for e in np.nonzero(rc)[0]:
            a = t.node_names[int(t.edge_src[e])]
            b = t.node_names[int(t.edge_dst[e])]
            counts.edge[(a, b)] = int(rc[e])

        n_novel = int(lib.gafcov_novel_count(self.handle))
        if n_novel:
            keys = np.zeros(n_novel, dtype=np.uint64)
            vals = np.zeros(n_novel, dtype=np.int32)
            lib.gafcov_novel_fill(
                self.handle, _ptr(keys, ctypes.c_uint64), _ptr(vals, ctypes.c_int32)
            )
            for k, v in zip(keys, vals):
                a = t.node_names[int(k >> np.uint64(32))]
                b = t.node_names[int(k & np.uint64(0xFFFFFFFF))]
                counts.edge[(a, b)] = int(v)
        return counts

    def emit(self, gfa_in: str, out_fd: int) -> None:
        """Write the augmented GFA natively to a file descriptor. While
        tracing is on, its phases are spans (:data:`EMIT_PHASES`), its sizes
        counters (:data:`EMIT_COUNTS`), and ``emit.novel_links`` counts the
        novel links it appends, one a sidecar entry."""
        from pantas_tpu_torch.io.xopen import materialized

        with trace.span("native.emit"):
            with materialized(gfa_in) as plain:
                rc = self.lib.gafcov_emit(self.handle, str(plain).encode(), out_fd)
            if rc != 0:
                raise IOError(f"gafcov_emit failed ({rc})")
            if trace.enabled():
                phases, sizes = self.emit_stats()
                for name, (t0, t1) in phases.items():
                    trace.record(name, t0, t1)
                for name, n in sizes.items():
                    trace.add(name, n)
                trace.add("emit.novel_links", int(self.lib.gafcov_novel_count(self.handle)))

    def emit_stats(self):
        """The last emission's phases, ``{name: (t0, t1)}`` in
        ``CLOCK_MONOTONIC`` nanoseconds (:data:`EMIT_PHASES`), and its sizes
        (:data:`EMIT_COUNTS`)."""
        out = np.zeros(13, np.int64)
        self.lib.gafcov_emit_stats(self.handle, _ptr(out, ctypes.c_int64))
        v = out.tolist()
        return dict(zip(EMIT_PHASES, zip(v[0:10:2], v[1:10:2]))), dict(zip(EMIT_COUNTS, v[10:13]))

    def __del__(self):
        try:
            if getattr(self, "handle", None):
                self.lib.gafcov_destroy(self.handle)
                self.handle = None
        except Exception:
            pass


def augment_gfa_native(
    gaf_path: str,
    gfa_path: str,
    out,
    mapq_thr: int = 20,
    log=sys.stderr,
    tensors: Optional[GraphTensors] = None,
    threads: Optional[int] = 1,
) -> CoverageCounts:
    """Augment stage with the native engine (byte-identical output)."""
    print("Read GFA (tensorize)", file=log)
    if tensors is None:
        tensors = compile_gfa(gfa_path)
    eng = NativeCoverage(tensors)
    print("Augmentation by GAF alignments (native)", file=log)
    eng.process_file(gaf_path, mapq_thr, threads=threads)
    print(f"Rejected alignments: {int(eng.lib.gafcov_rejected(eng.handle))}", file=log)
    print("Annotating GFA", file=log)
    try:
        out.flush()
        fd = out.fileno()
    except (AttributeError, OSError, io.UnsupportedOperation):
        fd = None
    if fd is not None:
        eng.emit(gfa_path, fd)
        # stats-only view (emission already done natively)
        counts = CoverageCounts()
        counts.rejected = int(eng.lib.gafcov_rejected(eng.handle))
        counts.skipped = int(eng.lib.gafcov_skipped(eng.handle))
        counts.accepted = int(eng.lib.gafcov_accepted(eng.handle))
        return counts
    counts = eng.to_counts()
    emit_augmented_gfa(gfa_path, counts, out)
    return counts


def kidx_pack(seq: str, k: int, out: np.ndarray) -> None:
    """Native 2-bit k-mer packing into a preallocated uint64 array."""
    lib = _load()
    lib.kidx_pack(seq.encode(), len(seq), k, _ptr(out, ctypes.c_uint64))


def kidx_sort(kmers: np.ndarray, pids: np.ndarray, poss: np.ndarray) -> None:
    """Native stable argsort-by-kmer applied in place to three arrays."""
    lib = _load()
    lib.kidx_sort(
        _ptr(kmers, ctypes.c_uint64),
        _ptr(pids, ctypes.c_int32),
        _ptr(poss, ctypes.c_int32),
        len(kmers),
    )
