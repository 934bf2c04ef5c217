"""Device-side coverage accumulation (the port's augment engine).

Port of ``pantas_tpu/coverage/device.py``. The per-read semantics stay on
the host; what reaches the device is a flat stream of count-slot indices into
one counts vector (layout ``[NC | IL | OL | RC]``, see
:mod:`pantas_tpu_torch.graph.compiler`), and each batch of it is one step of
the scatter that ``PANTAS_SCATTER`` selects
(:func:`.scatter_impls.pantas_scatter`): by
default :func:`pantas_tpu_torch.coverage.kernels.sorted_coverage_scatter_add`,
on a CUDA device the hand-written kernel, on the CPU its plain version. Under
a mesh (:mod:`pantas_tpu_torch.parallel.mesh`) the same step runs on every
shard's private partial, and one reduction ends the stream.

The host side (``SlotEncoder``, ``counts_from_device``, the native parser and
emitter) is this package's own copy of the JAX package's host code.
Checkpoints use the JAX engine's pickle format (numpy arrays and builtins
only), so a run saved by either package resumes in the other.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pantas_tpu_torch import backend, trace
from pantas_tpu_torch.coverage import kernels, scatter_impls
from pantas_tpu_torch.coverage.host import CoverageCounts, emit_augmented_gfa
from pantas_tpu_torch.coverage.semantics import (
    DEFAULT_MAPQ_THR,
    REJECTED,
    SKIPPED,
    ReadEvents,
    read_events,
)
from pantas_tpu_torch.graph.compiler import GraphTensors, compile_gfa
from pantas_tpu_torch.io.gaf import parse_gaf_line
from pantas_tpu_torch.io.xopen import xopen
from pantas_tpu_torch.parallel import mesh as mesh_lib

class SlotEncoder:
    """Convert ReadEvents into count-slot indices + host-side order tracking."""

    def __init__(self, tensors: GraphTensors):
        self.t = tensors
        self.slots: List[int] = []
        # first-seen orders for byte-identical emission; the dict VALUES are
        # the first-seen stream position (cur_pos) — unused single-process
        # (key order carries the order), but the multi-process merge sorts
        # by them to reconstruct the global file order
        self.il_seen: Dict[int, Dict[int, Optional[int]]] = {}
        self.ol_seen: Dict[int, Dict[int, Optional[int]]] = {}
        self.novel: Dict[Tuple[int, int], int] = {}
        self.novel_order: List[Tuple[int, int]] = []
        self.novel_first: Dict[Tuple[int, int], Optional[int]] = {}
        self.cur_pos: Optional[int] = None  # byte offset of the current record
        self.rejected = 0
        self.skipped = 0
        self.accepted = 0

    def add(self, ev: ReadEvents) -> None:
        t = self.t
        idx = t.node_index
        slots = self.slots
        for name in ev.nodes:
            slots.append(idx[name])
        for name, off in ev.il:
            ni = idx[name]
            slots.append(int(t.il_base[ni]) + off + 1)
            self.il_seen.setdefault(ni, {}).setdefault(off, self.cur_pos)
        for name, off in ev.ol:
            ni = idx[name]
            slots.append(int(t.ol_base[ni]) + off + 1)
            self.ol_seen.setdefault(ni, {}).setdefault(off, self.cur_pos)
        for a, b in ev.edges:
            ai, bi = idx[a], idx[b]
            e = t.edge_lookup(ai, bi)
            if e >= 0:
                slots.append(t.rc_base + e)
            else:
                key = (ai, bi)
                if key not in self.novel:
                    self.novel[key] = 0
                    self.novel_order.append(key)
                    self.novel_first[key] = self.cur_pos
                self.novel[key] += 1

    def take_slots(self) -> np.ndarray:
        arr = np.asarray(self.slots, dtype=np.int32)
        self.slots = []
        return arr


class NativeFeedUnavailable(RuntimeError):
    """The native slot feed cannot serve this graph: the C++ engine did not
    build or load, or the graph's segment ids are not canonical integers in
    file order. Raised before anything is parsed, written or sent to the
    device; callers may fall back to the Python tokenizer on it alone."""


def counts_from_numpy(flat: np.ndarray, padded_slots: int, device) -> torch.Tensor:
    """A host counts vector (e.g. read back by the JAX engine) as this
    engine's zero-padded int32 device tensor of length ``padded_slots``."""
    out = torch.zeros(padded_slots, dtype=torch.int32, device=device)
    out[: len(flat)] = torch.from_numpy(np.array(flat, dtype=np.int32)).to(device)
    return out


def impl_label(name: str, device: torch.device) -> str:
    """The impl as logged: on the CPU a kernel's wrapper runs its plain
    version, so ``cuda-sorted`` shows as ``cpu-sorted-plain`` there."""
    if device.type == "cuda" or not name.startswith("cuda-"):
        return name
    return f"cpu-{name.removeprefix('cuda-')}-plain"


class DeviceCoverage:
    """Accumulate a slot stream on one device, or on a mesh of them.

    ``mesh=None``: one device, counts padded to a power-of-two bucket. 1-D
    mesh: data-parallel slot shards, one private full-length partial per
    shard. 2-D mesh (``data`` × ``node``): the partials are additionally
    sharded over the node axis, each device owning a contiguous slot range.
    Either way ``counts`` then holds the partials (``counts[d][k]``) and the
    one reduction happens in :meth:`merged`.

    The scatter step is chosen from ``PANTAS_SCATTER``
    (:func:`.scatter_impls.pantas_scatter`) as the JAX engine chooses it: a named impl at once, or ``race``/``auto``
    on the first batch that holds a real index, by
    :func:`.scatter_impls.pick_scatter_endtoend` with ``batches_hint``, the
    stage's expected batch count
    (:func:`_estimate_batches`); ``race`` forces
    a fresh race, ``auto`` decides from a cached verdict where one exists.
    Under a mesh the race is refused (:func:`.scatter_impls.mesh_scatter`):
    every shard runs the named step, ``cuda-sorted`` when nothing is named.
    """

    def __init__(self, tensors: GraphTensors, device=None, batches_hint=None, log=None,
                 mesh: Optional[mesh_lib.CoverageMesh] = None):
        with trace.span("device.init"):
            self.t = tensors
            self.mesh = mesh
            # results land on the mesh's first device; no device and no mesh: the first card
            self.device = backend.default_device(mesh.devices[0] if mesh is not None else device)
            self.log = sys.stderr if log is None else log
            self.batches = 0
            self._launches_at_start = sum(kernels.LAUNCHES.values())
            self._batches_hint = batches_hint
            if mesh is not None:
                choice, step = scatter_impls.mesh_scatter()
                self.n_shards = mesh.data
                if mesh.node is not None:
                    self._step, shard = mesh_lib.node_sharded_scatter_add(
                        mesh, tensors.total_slots, step
                    )
                    self._padded_slots = shard * mesh.node
                else:
                    self._step = mesh_lib.data_parallel_scatter_add(mesh, step)
                    shard = self._padded_slots = tensors.total_slots
                # the kernels take counts of any length (they mask at ``n``), so
                # the partials are not padded further
                self.counts = mesh_lib.new_parts(mesh, shard)
                label = f"{impl_label(choice, self.device)} on a {mesh} mesh"
            else:
                choice, self._force_race = scatter_impls.pantas_scatter()
                self.n_shards = 1
                # the JAX engine's power-of-two bucket, kept so both engines hold
                # the same padded vector (checkpoints and tests compare them)
                self._padded_slots = max(1 << 12, 1 << (tensors.total_slots - 1).bit_length())
                self.counts = torch.zeros(self._padded_slots, dtype=torch.int32, device=self.device)
                # resolved on the first real batch when racing
                self._step = None if choice == "race" else scatter_impls.SCATTER_IMPLS[choice]
                label = "race pending" if choice == "race" else impl_label(choice, self.device)
            print(
                f"[device] scatter impl: {label} ({self._padded_slots} slots, "
                f"~{batches_hint} batches expected)",
                file=self.log,
            )

    def add_slots(self, slots: np.ndarray, pad_to: Optional[int] = None) -> None:
        """Accumulate a slot batch, -1-padded to ``pad_to`` entries."""
        with trace.span("device.add_slots"):
            if pad_to is not None and len(slots) != pad_to:
                trace.add("device.pad_slots", pad_to - len(slots))
                padded = -np.ones(pad_to, dtype=np.int32)
                padded[: len(slots)] = slots
                slots = padded
            trace.add("device.batches")
            trace.add("device.h2d_bytes", len(slots) * 4)
            if self.mesh is not None:
                if len(slots) % self.n_shards != 0:
                    slots = mesh_lib.pad_to_multiple(slots, self.n_shards)
                # the batch stays on the host; the mesh step copies each shard
                with trace.span("device.launch"):
                    self._step(self.counts,
                               torch.from_numpy(np.ascontiguousarray(slots, dtype=np.int32)))
                self.batches += 1
                return
            step = self._step
            if step is None:
                if not (np.asarray(slots) >= 0).any():
                    # an all-padding batch must not decide the race: its empty
                    # stream verifies any impl and times none; it goes through
                    # the plain step and the race waits for a real batch
                    step = scatter_impls.SCATTER_IMPLS["plain"]
                else:
                    name, step = scatter_impls.pick_scatter_endtoend(
                        self._padded_slots, len(slots), sample=slots,
                        force_race=self._force_race, batches_hint=self._batches_hint,
                        device=self.device,
                    )
                    print(f"[device] scatter impl: {impl_label(name, self.device)}", file=self.log)
                    self._step = step
            with trace.span("device.h2d"):
                idx = torch.from_numpy(np.ascontiguousarray(slots, dtype=np.int32)).to(self.device)
            with trace.span("device.launch"):
                step(self.counts, idx)
            self.batches += 1

    def merged(self) -> torch.Tensor:
        """The counts as one tensor on :attr:`device`: the single-device
        vector itself, or the one reduction of a mesh's partials."""
        if self.mesh is None:
            return self.counts
        return mesh_lib.reduce_data_parts(self.counts)

    def restore(self, flat: np.ndarray) -> None:
        """Replace the counts by a host vector (a checkpoint's). Under a mesh
        it becomes data row 0's partials and every other row is zeroed, which
        sums to the same vector."""
        if self.mesh is None:
            self.counts = counts_from_numpy(flat, self._padded_slots, self.device)
            return
        restored = np.zeros(self._padded_slots, dtype=np.int32)
        restored[: len(flat)] = flat
        shard = self._padded_slots // self.mesh.columns
        self.counts = mesh_lib.new_parts(self.mesh, shard)
        for k, part in enumerate(self.counts[0]):
            part.copy_(torch.from_numpy(restored[k * shard : (k + 1) * shard]))

    def _sync(self) -> None:
        for dev in set(self.mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def result(self) -> np.ndarray:
        if self.mesh is None:
            merged = self.counts
        else:
            held = sum(p.numel() * p.element_size() for row in self.counts for p in row)
            if not trace.enabled():
                merged = self.merged()
                print(f"[device] mesh {self.mesh}: {held} bytes of partials reduced",
                      file=self.log)
            else:
                # the one reduction, timed on its own: the shards' queued
                # steps are waited for first
                self._sync()
                with trace.span("device.mesh_reduce") as reduce:
                    merged = self.merged()
                    self._sync()
                print(f"[device] mesh {self.mesh}: {held} bytes of partials reduced in "
                      f"{reduce.seconds:.4f}s", file=self.log)
        flat = self._read_back(merged)
        self.log_launches()
        return flat

    def log_launches(self) -> None:
        """The stream's closing line: kernel launches beside batches."""
        print(
            f"[device] kernel launches: {sum(kernels.LAUNCHES.values()) - self._launches_at_start} "
            f"(batches: {self.batches})",
            file=self.log,
        )

    def _read_back(self, counts: torch.Tensor) -> np.ndarray:
        """Copy the first ``total_slots`` counts to the host, sparsely when
        it pays: coverage is sparse (only touched slots are nonzero), and a
        genome-scale dense copy is 1 GiB. One scalar readback for the
        nonzero count, then (indices, values) unless the vector is dense
        (``4 * nnz >= total``, the JAX engine's rule)."""
        with trace.span("device.readback"):
            total = self.t.total_slots
            flat = counts[:total]
            if flat.device.type == "cpu":
                # host memory is the device memory: a dense copy is free
                with trace.span("device.readback_copy"):
                    out = flat.numpy().copy()
                trace.add("device.readback_bytes", out.nbytes)
                return out
            with trace.span("device.readback_sync"):  # waits for the queued kernels too
                nnz = int(torch.count_nonzero(flat))
            trace.add("device.readback_nnz", nnz)
            with trace.span("device.readback_copy"):
                if nnz == 0:
                    return np.zeros(total, dtype=np.int32)
                if 4 * nnz >= total:
                    out = flat.cpu().numpy()
                    trace.add("device.readback_bytes", out.nbytes)
                    return out
                idx = torch.nonzero(flat).flatten()
                out = np.zeros(total, dtype=np.int32)
                out[idx.cpu().numpy()] = flat[idx].cpu().numpy()
                trace.add("device.readback_bytes", 12 * nnz)  # int64 indices, int32 values
                return out


def _restore_counts(state: dict, dev: DeviceCoverage) -> None:
    """Place a checkpoint's counts (either encoding) on ``dev``'s device."""
    if "counts_nz" in state:
        idx, vals = state["counts_nz"]
        restored = np.zeros(dev.t.total_slots, dtype=np.int32)
        restored[idx] = vals
    else:
        restored = state["counts"]
    dev.restore(restored)


def _check_graph(state: dict, tensors: GraphTensors) -> None:
    if state.get("total_slots") != tensors.total_slots:
        raise ValueError(
            "checkpoint does not match this graph "
            f"(slots {state.get('total_slots')} != {tensors.total_slots})"
        )


def _encode_counts(state: dict, flat: np.ndarray) -> None:
    # sparse when it pays: a genome-scale dense counts vector is ~1 GB per
    # save, and coverage is sparse
    nz = np.nonzero(flat)[0]
    if len(nz) * 3 < len(flat):
        state["counts_nz"] = (nz.astype(np.int64), flat[nz])
    else:
        state["counts"] = flat


def _write_atomic(path: str, state: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(state, fh)
    os.replace(tmp, path)


def counts_from_device(
    tensors: GraphTensors, enc: SlotEncoder, flat: np.ndarray
) -> CoverageCounts:
    """Assemble host CoverageCounts (for emission) from the device vector."""
    t = tensors
    counts = CoverageCounts()
    counts.rejected = enc.rejected
    counts.skipped = enc.skipped
    counts.accepted = enc.accepted
    counts.node_len = {n: int(l) for n, l in zip(t.node_names, t.node_len)}

    nc = flat[: t.n_nodes]
    for ni in np.nonzero(nc)[0]:
        counts.nc[t.node_names[ni]] = int(nc[ni])

    for ni, seen in enc.il_seen.items():
        base = int(t.il_base[ni])
        counts.il[t.node_names[ni]] = {
            off: int(flat[base + off + 1]) for off in seen
        }
    for ni, seen in enc.ol_seen.items():
        base = int(t.ol_base[ni])
        counts.ol[t.node_names[ni]] = {
            off: int(flat[base + off + 1]) for off in seen
        }

    rc = flat[t.rc_base :]
    for e in np.nonzero(rc)[0]:
        a = t.node_names[int(t.edge_src[e])]
        b = t.node_names[int(t.edge_dst[e])]
        counts.edge[(a, b)] = int(rc[e])
    for ai, bi in enc.novel_order:
        counts.edge[(t.node_names[ai], t.node_names[bi])] = enc.novel[(ai, bi)]
    return counts


def _estimate_batches(gaf_path: str, flush_every: int) -> int:
    """Expected slot-batch count for a GAF, from its byte size.

    Calibration on the bench workload: ~160 bytes and ~23 count slots per
    record. Order-of-magnitude is all the scatter-impl projection needs
    (it separates 23-batch panel stages from 500-batch genome stages).
    """
    try:
        size = os.path.getsize(gaf_path)
        p = str(gaf_path)
        if p.endswith(".gz"):
            # gzip ISIZE trailer: decompressed size mod 2^32 — exact for
            # anything under 4 GiB, and a far better hint than the 4-5x
            # smaller compressed byte count
            with open(p, "rb") as fh:
                fh.seek(-4, os.SEEK_END)
                import struct

                isize = struct.unpack("<I", fh.read(4))[0]
            if isize:
                size = isize
        elif p.endswith(".zst"):
            size *= 4  # typical text ratio; a hint only
    except OSError:
        return 1
    return max(1, int(size * 23 / (160 * flush_every)))


def _save_checkpoint(path: str, enc: SlotEncoder, dev: DeviceCoverage, offset: int):
    """Atomic checkpoint of the Python-fed stage: device counts + encoder
    orders + the GAF byte offset of the next unprocessed record (the JAX
    engine's format). Accumulation is pure integer adds, so resuming from
    the saved offset reproduces the one-shot run exactly."""
    state = {
        "total_slots": dev.t.total_slots,
        "offset": offset,
        "rejected": enc.rejected,
        "skipped": enc.skipped,
        "accepted": enc.accepted,
        "il_seen": {ni: list(d) for ni, d in enc.il_seen.items()},
        "ol_seen": {ni: list(d) for ni, d in enc.ol_seen.items()},
        "novel": enc.novel,
        "novel_order": enc.novel_order,
    }
    _encode_counts(state, dev._read_back(dev.merged()))
    _write_atomic(path, state)


def _load_checkpoint(path: str, enc: SlotEncoder, dev: DeviceCoverage) -> int:
    with open(path, "rb") as fh:
        state = pickle.load(fh)
    _check_graph(state, dev.t)
    _restore_counts(state, dev)
    enc.rejected = state["rejected"]
    enc.skipped = state["skipped"]
    enc.accepted = state["accepted"]
    enc.il_seen = {ni: dict.fromkeys(offs) for ni, offs in state["il_seen"].items()}
    enc.ol_seen = {ni: dict.fromkeys(offs) for ni, offs in state["ol_seen"].items()}
    enc.novel = state["novel"]
    enc.novel_order = state["novel_order"]
    return int(state["offset"])


def _skip_to(fh, offset: int) -> None:
    """Move the GAF reader to the decompressed ``offset`` of a checkpoint:
    a seek where the stream can seek, else ``offset`` bytes read and
    dropped (the zstd reader cannot seek; its ``tell()`` is the
    decompressed position the checkpoint saved). Past the end, the reader
    is left at its end, as a seek there leaves a plain file."""
    if fh.seekable():
        fh.seek(offset)
        return
    left = offset
    while left:
        chunk = fh.read(min(left, 1 << 20))
        if not chunk:
            return
        left -= len(chunk)


def _save_native_checkpoint(path, dev, eng, tensors, offset, base_sidecars, flat=None):
    """Atomic checkpoint of the native-fed stage: the device counts (length
    ``total_slots``), the GAF byte offset of the next unparsed record, and
    the engine's first-seen sidecar chained after any sidecars inherited
    from prior resumes (the JAX engine's format)."""
    from pantas_tpu_torch.parallel.distributed import _native_sidecar

    if flat is None:
        flat = dev._read_back(dev.merged())
    state = {
        "total_slots": tensors.total_slots,
        "offset": int(offset),
        "sidecars": list(base_sidecars) + [_native_sidecar(tensors, eng)],
    }
    _encode_counts(state, flat)
    _write_atomic(path, state)


def _native_engine(tensors: GraphTensors):
    from pantas_tpu_torch.native.gafcov import NativeCoverage

    try:
        with trace.span("native.engine_init"):
            return NativeCoverage(tensors)
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        raise NativeFeedUnavailable(str(e)) from e


def augment_gfa_device_native(
    gaf_path: str,
    gfa_path: str,
    out,
    mapq_thr: int = DEFAULT_MAPQ_THR,
    device="cuda",
    flush_every: int = 1 << 20,
    log=None,
    tensors: Optional[GraphTensors] = None,
    mesh: Optional[mesh_lib.CoverageMesh] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 8,  # batches between checkpoints
    resume: bool = False,
    threads: Optional[int] = None,
    _stop_after: Optional[int] = None,  # test hook: simulate interruption
) -> CoverageCounts:
    """Augment with the native parser feeding the device scatter-add.

    The C++ GAF tokenizer (``native/gafcov.cpp`` slot session) emits
    fixed-size batches of flat slot indices; the device adds each batch into
    the counts while the host parses the next one. First-seen orders stay on
    the native engine, and the device counts are copied back into it for
    byte-identical emission, so the device result backs every printed count.

    With ``checkpoint_path`` the device counts + parse offset + first-seen
    sidecar persist atomically every ``checkpoint_every`` batches (the
    parser's pending residual is drained to the device first, so offset and
    counts agree); ``resume`` continues from the saved offset, and the
    result is identical to the uninterrupted run.

    With ``mesh`` the batches are sharded over its devices (``device`` is
    then ignored) and checkpoints hold the reduced vector, so a checkpoint
    carries between mesh shapes and to a single device.

    ``threads`` bounds the native parse's threads (``None``: every CPU the
    process may run on); the batches are the same whatever it is.

    Raises :class:`NativeFeedUnavailable` if the native engine cannot serve
    the graph; callers may then use :func:`augment_gfa_device`.
    """
    with trace.span("stage.augment"):
        log = sys.stderr if log is None else log
        print("Read GFA (tensorize)", file=log)
        if tensors is None:
            tensors = compile_gfa(gfa_path)
        eng = _native_engine(tensors)
        dev = DeviceCoverage(
            tensors, device, batches_hint=_estimate_batches(gaf_path, flush_every), log=log,
            mesh=mesh,
        )

        start_offset = 0
        base_sidecars: list = []
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            with open(checkpoint_path, "rb") as fh:
                state = pickle.load(fh)
            _check_graph(state, tensors)
            _restore_counts(state, dev)
            start_offset = state["offset"]
            base_sidecars = state["sidecars"]
            print(f"Resuming from checkpoint at offset {start_offset}", file=log)

        print("Augmentation by GAF alignments (native parse -> device)", file=log)
        with trace.span("native.stream"):
            sess = eng.slots_begin(gaf_path, start_offset, -1, mapq_thr, threads=threads)
            end_pos = start_offset
            try:
                batches = 0
                while True:
                    # a fresh host buffer per batch: the synchronous copy in
                    # add_slots has read it before the parser refills anything
                    buf = np.empty(flush_every, dtype=np.int32)
                    with trace.span("native.slots_next"):
                        n = eng.slots_next(sess, buf)
                    if n == 0:
                        end_pos = eng.slots_pos(sess)
                        break
                    if n < flush_every:
                        buf[n:] = -1  # pad the final partial batch
                        trace.add("device.pad_slots", flush_every - n)
                    dev.add_slots(buf, pad_to=flush_every)
                    batches += 1
                    if checkpoint_path and batches % max(checkpoint_every, 1) == 0:
                        # drain the parser's residual so (offset, counts) agree — one
                        # record can yield more slots than flush_every, so loop
                        pend = np.empty(flush_every, dtype=np.int32)
                        while (np_ := eng.slots_take_pending(sess, pend)):
                            pend[np_:] = -1
                            trace.add("device.pad_slots", flush_every - np_)
                            dev.add_slots(pend, pad_to=flush_every)
                        _save_native_checkpoint(
                            checkpoint_path, dev, eng, tensors,
                            eng.slots_pos(sess), base_sidecars,
                        )
                        if _stop_after is not None and batches >= _stop_after:
                            return None  # test hook: simulate a crash after a save
                flat = dev.result()
            finally:
                if trace.enabled():
                    for name, value in eng.slots_stats(sess).items():
                        trace.add(name, value)
                eng.slots_end(sess)
        if checkpoint_path:
            # the EOF offset is the parser's own (decompressed) end position, and
            # the counts are the ones result() just read back
            _save_native_checkpoint(
                checkpoint_path, dev, eng, tensors, end_pos, base_sidecars, flat=flat
            )

        if base_sidecars:
            # resumed run: rebuild the global first-seen orders by merging the
            # pre-interruption sidecars with this run's, then emit via the
            # encoder path
            from pantas_tpu_torch.parallel.distributed import _merge_sidecars, _native_sidecar

            enc = _merge_sidecars(tensors, base_sidecars + [_native_sidecar(tensors, eng)])
            counts = counts_from_device(tensors, enc, flat)
            print(f"Rejected alignments: {counts.rejected}", file=log)
            print("Annotating GFA", file=log)
            emit_augmented_gfa(gfa_path, counts, out)
            return counts

        eng.set_counts(flat)  # device values back the emission
        print(f"Rejected alignments: {int(eng.lib.gafcov_rejected(eng.handle))}", file=log)
        print("Annotating GFA", file=log)
        import io as _io

        try:
            out.flush()
            fd = out.fileno()
        except (AttributeError, OSError, _io.UnsupportedOperation):
            fd = None
        if fd is not None:
            eng.emit(gfa_path, fd)
            counts = CoverageCounts()
            counts.rejected = int(eng.lib.gafcov_rejected(eng.handle))
            counts.skipped = int(eng.lib.gafcov_skipped(eng.handle))
            counts.accepted = int(eng.lib.gafcov_accepted(eng.handle))
            return counts
        counts = eng.to_counts()
        emit_augmented_gfa(gfa_path, counts, out)
        return counts


def augment_gfa_device(
    gaf_path: str,
    gfa_path: str,
    out,
    mapq_thr: int = DEFAULT_MAPQ_THR,
    device="cuda",
    flush_every: int = 1 << 20,
    log=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,  # flushes between checkpoints
    resume: bool = False,
    mesh: Optional[mesh_lib.CoverageMesh] = None,
) -> CoverageCounts:
    """Full augment stage with device-side accumulation, fed by the
    pure-Python tokenizer (the portable variant; the native feed of
    :func:`augment_gfa_device_native` runs the same device step). With
    ``checkpoint_path``, the device counts and encoder state persist
    atomically every ``checkpoint_every`` flushes; ``resume=True`` continues
    a previous run from its saved GAF offset. ``mesh`` as in
    :func:`augment_gfa_device_native`."""
    log = sys.stderr if log is None else log
    print("Read GFA (tensorize)", file=log)
    tensors = compile_gfa(gfa_path)
    node_len = {n: int(l) for n, l in zip(tensors.node_names, tensors.node_len)}

    enc = SlotEncoder(tensors)
    dev = DeviceCoverage(
        tensors, device, batches_hint=_estimate_batches(gaf_path, flush_every), log=log,
        mesh=mesh,
    )

    start_offset = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        start_offset = _load_checkpoint(checkpoint_path, enc, dev)
        print(f"Resuming from checkpoint at offset {start_offset}", file=log)

    def flush():
        batch = enc.take_slots()
        for i in range(0, len(batch), flush_every):
            dev.add_slots(batch[i : i + flush_every], pad_to=flush_every)

    print("Augmentation by GAF alignments (device scatter-add)", file=log)
    flushes = 0
    with xopen(gaf_path, "rb") as fh:
        if start_offset > 0:
            _skip_to(fh, start_offset)
        pos = start_offset
        while True:
            raw = fh.readline()
            if not raw:
                break
            enc.cur_pos = pos
            pos += len(raw)
            line = raw.decode()
            if line.strip():
                ev = read_events(parse_gaf_line(line), node_len, mapq_thr)
                if ev is REJECTED:
                    enc.rejected += 1
                elif ev is SKIPPED:
                    enc.skipped += 1
                else:
                    enc.accepted += 1
                    enc.add(ev)
            if len(enc.slots) >= flush_every:
                flush()
                flushes += 1
                if checkpoint_path and flushes % max(checkpoint_every, 1) == 0:
                    _save_checkpoint(checkpoint_path, enc, dev, fh.tell())
    if enc.slots:
        flush()
    if checkpoint_path:
        # EOF marker = the reader's decompressed end offset
        _save_checkpoint(checkpoint_path, enc, dev, pos)

    counts = counts_from_device(tensors, enc, dev.result())
    print(f"Rejected alignments: {counts.rejected}", file=log)
    print("Annotating GFA", file=log)
    emit_augmented_gfa(gfa_path, counts, out)
    return counts
