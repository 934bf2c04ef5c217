"""Multi-process (multi-host) sharded augment with byte-identical emission.

Port of ``pantas_tpu/parallel/distributed.py`` on ``torch.distributed``. GAF
records are i.i.d. scatter-add work items, so each process streams a
contiguous byte range of the GAF, accumulates a private partial-counts vector
on its own device (the scatter ``PANTAS_SCATTER`` selects; on a CUDA device
the hand-written kernel), and the partials merge with ONE cross-process int32
``all_reduce``: bit-exact for any process count because integer adds are
associative.

Byte-identical GFA emission additionally needs the GLOBAL first-seen orders
(IL/OL offsets per node, novel edges) that the reference's single-stream
augmenter produces implicitly. Each process records the byte offset at which
it first saw each order-bearing item; process 0 merges the per-process
sidecars by minimum offset (contiguous ranges make that the exact global file
order) and emits. A resumed single-process device augment rebuilds its orders
with the same two sidecar helpers.

Run one process per host, or per card of a host (each rank takes the first
card it sees: give the ranks of one host their cards by
``CUDA_VISIBLE_DEVICES``):

    python -m pantas_tpu_torch augment-dist GAF GFA -o OUT \
        --coordinator HOST:PORT --nprocs N --procid I [--device cpu]
"""

from __future__ import annotations

import os
import pickle
import socket
import sys
import time
from collections import Counter
from datetime import timedelta
from typing import Optional

import numpy as np
import torch

from pantas_tpu_torch import backend

DEFAULT_MAPQ_THR = 20
# the JAX runtime's own initialisation timeout
GROUP_TIMEOUT = timedelta(seconds=300)


def shard_byte_ranges(path: str, n: int):
    """Split a file into n contiguous byte ranges at line boundaries."""
    size = os.path.getsize(path)
    bounds = [0]
    with open(path, "rb") as fh:
        for i in range(1, n):
            guess = size * i // n
            fh.seek(guess)
            fh.readline()  # advance to the next line start
            bounds.append(min(fh.tell(), size))
    bounds.append(size)
    return [(bounds[i], bounds[i + 1]) for i in range(n)]


def _init_group(coordinator: str, n_procs: int, proc_id: int) -> None:
    """The default process group: gloo over TCP, for the barriers, the
    object gather and, where NCCL cannot be used, the reduction."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", rank=proc_id, world_size=n_procs,
        timeout=GROUP_TIMEOUT,
    )


def initialize_distributed() -> bool:
    """Join a multi-process group when launch env vars are present: the
    coordinator from ``JAX_COORDINATOR_ADDRESS`` or ``COORDINATOR_ADDRESS``
    (the variables the JAX package reads), the process count and id from
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` or torch's ``WORLD_SIZE`` /
    ``RANK``.

    Returns True when the group was initialized.
    """
    env = os.environ
    addr = env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS")
    if not addr:
        return False
    n_procs = int(env.get("JAX_NUM_PROCESSES") or env["WORLD_SIZE"])
    proc_id = int(env.get("JAX_PROCESS_ID") or env["RANK"])
    _init_group(addr, n_procs, proc_id)
    return True


def _card_id(device: torch.device) -> str:
    """What tells two ranks that they hold one card: its uuid, or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    return uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"


def reduction_transport(ranks) -> tuple:
    """``("nccl" | "gloo", reason)`` for the one reduction, from what every
    rank reported as ``(hostname, card id, NCCL available)``. A pure function
    of the gathered list, so every rank decides alike. NCCL needs every rank
    on a CUDA card of its own: two ranks on one card cannot share a
    communicator, and asking for one aborts the process."""
    if any(card == "cpu" for _, card, _ in ranks):
        return "gloo", "the device is the CPU"
    if not all(nccl for _, _, nccl in ranks):
        return "gloo", "this torch has no NCCL"
    (host, card), sharing = Counter((h, c) for h, c, _ in ranks).most_common(1)[0]
    if sharing > 1:
        return "gloo", f"{sharing} ranks share {card}"
    return "nccl", ""


def _native_sidecar(tensors, eng) -> dict:
    """Convert the native engine's first-seen sidecars (slot order + byte
    positions) into the per-process dict format ``_merge_sidecars`` expects
    (the same structure the Python SlotEncoder records)."""
    il_seen: dict = {}
    ol_seen: dict = {}
    order, pos = eng.seen_sidecar()
    if len(order):
        t = tensors
        hist_total = int(t.ol_base[0] - t.il_base[0]) if t.n_nodes else 0
        il_end = int(t.il_base[0]) + hist_total
        for slot, p in zip(order, pos):
            slot = int(slot)
            if slot < il_end:
                ni = int(np.searchsorted(t.il_base, slot, side="right")) - 1
                il_seen.setdefault(ni, {})[slot - int(t.il_base[ni]) - 1] = int(p)
            else:
                ni = int(np.searchsorted(t.ol_base, slot, side="right")) - 1
                ol_seen.setdefault(ni, {})[slot - int(t.ol_base[ni]) - 1] = int(p)
    novel: dict = {}
    novel_first: dict = {}
    keys, vals, poss = eng.novel_sidecar()
    for k, v, p in zip(keys, vals, poss):
        key = (int(k >> np.uint64(32)), int(k & np.uint64(0xFFFFFFFF)))
        novel[key] = int(v)
        novel_first[key] = int(p)
    lib, h = eng.lib, eng.handle
    return {
        "rejected": int(lib.gafcov_rejected(h)),
        "skipped": int(lib.gafcov_skipped(h)),
        "accepted": int(lib.gafcov_accepted(h)),
        "il_seen": il_seen,
        "ol_seen": ol_seen,
        "novel": novel,
        "novel_first": novel_first,
    }


def _merge_sidecars(tensors, sidecars):
    """Rebuild the single-stream encoder state from per-process sidecars."""
    from pantas_tpu_torch.coverage.device import SlotEncoder

    enc = SlotEncoder(tensors)
    il: dict = {}
    ol: dict = {}
    for sc in sidecars:
        enc.rejected += sc["rejected"]
        enc.skipped += sc["skipped"]
        enc.accepted += sc["accepted"]
        for ni, d in sc["il_seen"].items():
            mine = il.setdefault(ni, {})
            for off, pos in d.items():
                if off not in mine or pos < mine[off]:
                    mine[off] = pos
        for ni, d in sc["ol_seen"].items():
            mine = ol.setdefault(ni, {})
            for off, pos in d.items():
                if off not in mine or pos < mine[off]:
                    mine[off] = pos
        for key, cnt in sc["novel"].items():
            if key not in enc.novel:
                enc.novel[key] = 0
                enc.novel_first[key] = sc["novel_first"][key]
            enc.novel[key] += cnt
            enc.novel_first[key] = min(enc.novel_first[key], sc["novel_first"][key])
    # global first-seen order = ascending first byte offset
    enc.il_seen = {
        ni: dict.fromkeys(sorted(d, key=d.__getitem__)) for ni, d in il.items()
    }
    enc.ol_seen = {
        ni: dict.fromkeys(sorted(d, key=d.__getitem__)) for ni, d in ol.items()
    }
    enc.novel_order = sorted(enc.novel, key=enc.novel_first.__getitem__)
    return enc


def _feed_python(gaf_path, lo, hi, tensors, enc, dev, mapq_thr, flush_every) -> None:
    """The Python tokenizer over the byte range ``[lo, hi)`` into ``dev``;
    ``enc`` records the first-seen orders with absolute byte offsets."""
    from pantas_tpu_torch.coverage.semantics import REJECTED, SKIPPED, read_events
    from pantas_tpu_torch.io.gaf import parse_gaf_line

    node_len = {n: int(l) for n, l in zip(tensors.node_names, tensors.node_len)}

    def flush():
        batch = enc.take_slots()
        for i in range(0, len(batch), flush_every):
            dev.add_slots(batch[i : i + flush_every], pad_to=flush_every)

    with open(gaf_path, "rb") as fh:
        fh.seek(lo)
        pos = lo
        while pos < hi:
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
    if enc.slots:
        flush()


def _feed_native(eng, gaf_path, lo, hi, dev, mapq_thr, flush_every, threads) -> None:
    """The native slot session over ``[lo, hi)`` into ``dev``, parsing with
    ``threads``; its sidecars carry absolute byte offsets for the global
    first-seen order merge."""
    sess = eng.slots_begin(gaf_path, lo, hi, mapq_thr, threads=threads)
    try:
        while True:
            buf = np.empty(flush_every, dtype=np.int32)
            n = eng.slots_next(sess, buf)
            if n == 0:
                break
            if n < flush_every:
                buf[n:] = -1
            dev.add_slots(buf, pad_to=flush_every)
    finally:
        eng.slots_end(sess)


def augment_gfa_distributed(
    gaf_path: str,
    gfa_path: str,
    out_path: str,
    coordinator: str,
    n_procs: int,
    proc_id: int,
    mapq_thr: int = DEFAULT_MAPQ_THR,
    workdir: Optional[str] = None,
    log=None,
    device="cuda",
):
    """One process of the sharded augment; process 0 writes ``out_path``.

    ``device`` is this rank's device: ``cuda`` (the first card the process
    sees) unless the caller asks for ``cpu``; CUDA without a card raises.
    Compressed input, an unknown ``PANTAS_SCATTER`` and a missing card are
    refused before the process group is initialised, so that a refusal waits
    for no peer. The one reduction runs over NCCL on the device when every
    rank holds a card of its own, else over gloo on the host vector
    (:func:`reduction_transport`); the log says which.

    Returns the per-process wall time of the accumulate phase (for the
    scaling-efficiency report).
    """
    import torch.distributed as dist

    from pantas_tpu_torch.coverage.device import (
        DeviceCoverage,
        NativeFeedUnavailable,
        SlotEncoder,
        _estimate_batches,
        _native_engine,
        counts_from_device,
    )
    from pantas_tpu_torch.coverage.host import emit_augmented_gfa
    from pantas_tpu_torch.coverage.scatter_impls import pantas_scatter
    from pantas_tpu_torch.graph.compiler import compile_gfa
    from pantas_tpu_torch.io.xopen import is_compressed, open_stage_output
    from pantas_tpu_torch.native.gafcov import host_threads

    log = sys.stderr if log is None else log
    if is_compressed(gaf_path):
        # shard_byte_ranges splits COMPRESSED bytes while the slot
        # sessions interpret lo/hi as DECOMPRESSED-stream offsets — the
        # shards would silently cover only a prefix of the stream.
        # (Single-process engines accept compressed input; decompress
        # first for the distributed path.)
        raise ValueError(
            "augment-dist does not support compressed GAF input; "
            "decompress first"
        )
    device = backend.device(device)
    pantas_scatter()
    workdir = workdir or os.path.dirname(os.path.abspath(out_path))
    flush_every = 1 << 20

    _init_group(coordinator, n_procs, proc_id)
    try:
        ranks = [None] * n_procs
        dist.all_gather_object(
            ranks, (socket.gethostname(), _card_id(device), dist.is_nccl_available())
        )
        transport, reason = reduction_transport(ranks)
        if transport == "nccl":
            nccl = dist.new_group(backend="nccl")
            card = torch.cuda.current_device() if device.index is None else device.index
            print(f"[augment-dist] reduction: nccl on cuda:{card}", file=log)
        else:
            print(f"[augment-dist] reduction: gloo on the host vector ({reason})", file=log)

        tensors = compile_gfa(gfa_path)
        enc = SlotEncoder(tensors)
        dev = DeviceCoverage(  # local accumulation; merge is global
            tensors, device, batches_hint=_estimate_batches(gaf_path, flush_every), log=log
        )
        lo, hi = shard_byte_ranges(gaf_path, n_procs)[proc_id]
        # build or load the kernel library before the timed accumulate phase
        # (an all-padding batch adds nothing; the build is per-process fixed
        # overhead, not scaling work)
        dev.add_slots(np.full(flush_every, -1, dtype=np.int32), pad_to=flush_every)
        t0 = time.time()
        native_eng = None
        try:
            native_eng = _native_engine(tensors)
        except NativeFeedUnavailable as e:  # non-canonical ids / no toolchain
            print(f"[augment-dist] python feed ({e})", file=log)
        if native_eng is not None:
            # the host's CPUs divided among the ranks it runs
            share = sum(r[0] == ranks[proc_id][0] for r in ranks)
            _feed_native(native_eng, gaf_path, lo, hi, dev, mapq_thr, flush_every,
                         host_threads(share))
        else:
            _feed_python(gaf_path, lo, hi, tensors, enc, dev, mapq_thr, flush_every)

        # ONE cross-process integer reduction (the framework's entire
        # multi-process communication for this stage)
        if transport == "nccl":
            torch.cuda.synchronize(device)
            dev.log_launches()
            accum_s = time.time() - t0
            reduced = dev.merged()
            dist.all_reduce(reduced, group=nccl)
            torch.cuda.synchronize(device)
            reduce_s = time.time() - t0 - accum_s
            # one read-back a rank, of the reduced vector
            global_counts = dev._read_back(reduced)
        else:
            global_counts = dev.result()
            accum_s = time.time() - t0
            reduced = torch.from_numpy(global_counts)
            dist.all_reduce(reduced)
            reduce_s = time.time() - t0 - accum_s
        print(
            f"[augment-dist] proc {proc_id}: {reduced.numel() * reduced.element_size()} bytes "
            f"reduced over {transport} in {reduce_s:.3f}s", file=log,
        )

        sidecar = os.path.join(workdir, f".augshard.{proc_id}.pkl")
        if native_eng is not None:
            sc = _native_sidecar(tensors, native_eng)
        else:
            sc = {
                "rejected": enc.rejected,
                "skipped": enc.skipped,
                "accepted": enc.accepted,
                "il_seen": enc.il_seen,
                "ol_seen": enc.ol_seen,
                "novel": enc.novel,
                "novel_first": enc.novel_first,
            }
        sc["accum_s"] = accum_s
        with open(sidecar + ".tmp", "wb") as fh:
            pickle.dump(sc, fh)
        os.replace(sidecar + ".tmp", sidecar)
        dist.barrier()  # every sidecar is written

        if proc_id == 0:
            t_emit = time.time()
            sidecars = []
            for i in range(n_procs):
                with open(os.path.join(workdir, f".augshard.{i}.pkl"), "rb") as fh:
                    sidecars.append(pickle.load(fh))
            merged = _merge_sidecars(tensors, sidecars)
            counts = counts_from_device(tensors, merged, global_counts)
            print(f"Rejected alignments: {counts.rejected}", file=log)
            # -o *.zst / *.gz compress, as the single-process stages' do
            with open_stage_output(out_path) as out:
                emit_augmented_gfa(gfa_path, counts, out)
            for i in range(n_procs):
                os.remove(os.path.join(workdir, f".augshard.{i}.pkl"))
            print(f"[augment-dist] proc 0: merge and emit {time.time() - t_emit:.2f}s", file=log)
        dist.barrier()  # no rank leaves before rank 0 has emitted
    finally:
        dist.destroy_process_group()
    return accum_s
