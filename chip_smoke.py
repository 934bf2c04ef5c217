#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card, and check it.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

1. Card: its name and power limit; build the hand-written kernels from
   ``pantas_tpu_torch/csrc`` (nvcc, sm_90a) into ``build/kernels/`` and the
   port's host C++ (the native GAF engine and the GFA loader extension, g++)
   into ``build/native/``, and time the builds.
2. Kernel vs plain at the main path's shapes: 2^25 count slots (a 10 Mbp
   graph's bucket) and 2^28 (genome scale, 1 GiB of counts), each with a
   batch of 2^20 indices. The kernel must equal ``index_add_`` exactly;
   median times over 25 warm calls each, by CUDA events, beside one bare
   ``index_add_`` call on prepared indices (the library yardstick, used
   nowhere in the port) and the kernel's bound from this batch's bytes. This
   phase holds
   the sorted kernel (kernel #1), then the direct kernel (kernel #2) on the
   same seeded batches. Then both kernels, the sorted kernel's window
   partition alone (``kernels.window_partition``) and ``index_add_`` once
   more at 2^25 and 2^28 on 2^20 uniform indices in [-1, n), which hold no
   long run, and on a batch whose 2^20 indices all name one slot, each beside
   one bare ``index_add_`` call and the batch's bound.
3. Main path end to end: the 10 Mbp synthetic pangenome and 1M reads of
   ``pantas_tpu_torch.eval.synth`` (built by the port's own ``build`` stage,
   cached under ``.bench/``; its sha256 is printed), augmented by
   ``augment --engine device`` through the port's CLI with ``PANTAS_SCATTER``
   unset. Its GFA must be sha256-identical to the native host engine's, its
   log must show the CUDA sorted scatter and no fallback, and the sorted
   kernel's launches counted in that run must equal its batches. Beside it,
   ``DeviceCoverage`` on the graph's tensors with no device named, as the
   JAX one is built: its counts must lie on ``cuda:0`` and one seeded batch
   must add as ``np.bincount`` does.
4. The raw race (``python -m pantas_tpu_torch.coverage.bench_scatter``, the
   path that reaches kernel #2) at 2^25 slots x 2^20 indices: all three
   impls verify, and each kernel's launches counted in that run rise.
5. The end-to-end race on the main path: ``PANTAS_SCATTER=race`` with a
   fresh ``PANTAS_TORCH_CACHE``; the verdict must hold measured stats for
   ``plain`` and ``cuda-sorted`` with ``explored`` true, the log must name
   the decision, and the sha256 must equal the native engine's. Then
   ``PANTAS_SCATTER=auto``: the cached verdict decides (the file is not
   rewritten), and the sorted kernel's launches equal the batches if it
   was chosen, 0 if ``plain`` was.
6. The call stage on phase 3's device-augmented GFA: ``call --rca 0``
   through the port's CLI on the host engine, then ``--engine device`` on
   the card. The sorted rows must be equal, with at least 5,000 events, and
   every finder with candidates must have evaluated them all on ``cuda``
   (``EVALS``), none on the CPU. The 10 Mbp graph has no novel junctions, so
   the micro fixtures of ``tests/fixtures_call.py`` then run with ``--rca 0
   --novel`` on both engines: equal rows, and the novel ES, novel exonic SS
   and CE finders evaluated on ``cuda``. Last, ``call_events_device(aug,
   gtf, CallOptions(rca=0))`` in process with no device named, as the JAX
   engine is called: ``EVALS`` must hold ``cuda`` entries only and the
   sorted rows must equal the host engine's. One ``[defaults]`` line
   reports it and phase 3's ``DeviceCoverage``.
7. ``torch.profiler`` gives the device time of each kernel on the uniform
   and the one-slot batch at 2^25 and 2^28: the sorted kernel's by pass (the
   partition's count, scan and scatter, then the histogram), the direct
   kernel's one launch. It runs last: launches after a profiled window were
   slower in the same process.

8. The mesh at the same 10 Mbp / 1M-read cell: ``augment --engine device
   --mesh 1`` and ``--mesh 1x1`` through the CLI, then through the Python
   API a logical mesh of 4 and one of 2x2 on the one card (every shard's
   private partial lives on it). Each GFA's sha256 must equal phase 3's, and
   the sorted kernel's launches must equal shards x batches. A logical mesh
   shows the sharding arithmetic on the card and measures nothing about
   scaling.
9. Real slot batches: the 1M-read GAF streamed through the native slot
   feed exactly as the stage streams it (2^20-index batches, the last
   padded), kept on the host. On zeroed counts of the stage's 2^25 bucket
   all of them go through kernel #2, kernel #1 and ``index_add_``: the three
   vectors must be equal. Then the first, a middle and the last batch are
   timed (both kernels, the plain version, one bare ``index_add_``) beside
   what the batch looks like (valid indices, distinct slots and sectors,
   longest run of equal neighbours, share equal to the left neighbour) and
   its bound. It decides nothing: the default scatter stays as it is.
10. Isolation: no module named ``pantas_tpu``, ``pantas_tpu.*``, ``jax`` or
    ``jax.*`` was loaded by anything above.
11. The multi-process augment at the same 10 Mbp / 1M-read cell: the ranks
    are subprocesses of ``python -m pantas_tpu_torch augment-dist`` (through
    a probe that reports each rank's foreign modules), first 1 rank, then 2
    ranks on the one card. Each GFA's sha256 must equal phase 3's; every rank
    must show the CUDA sorted scatter, no fallback, the native feed and as
    many kernel launches as batches (its warm-up batch included); the ranks'
    real batches must sum to at least phase 3's; the 1-rank log must name the
    NCCL reduction and the 2-rank log the gloo one with its reason; no
    sidecar file may be left. Two ranks on one card show the arithmetic, the
    barriers and two CUDA contexts sharing a card: nothing about scaling.
12. The other entry points: ``replicate --rca 0`` on the GAF, the
    un-augmented GFA and the GTF, its sorted rows equal to phase 6's host
    ``call`` rows of the augmented GFA (one process, so one hash seed);
    ``graft_entry.entry()`` on the card against ``np.bincount``;
    ``graft_entry.dryrun_multichip(4)`` on a logical mesh of the one card,
    and, asked for 4 cards where there are fewer, its refusal.
13. The mapped-reads path at the 10 Mbp graph, on reads the port makes and
    maps itself: ``sim -n 48 -r 500 -e 0.005`` on the graph's FASTA and GTF
    (48 events, about 128k read pairs a condition, each condition at least
    four whole 2^20-slot batches: deep coverage of few genes); ``map -t
    <cores> --index DIR`` on each condition, which must run the native
    alignment core (the mapper falls back to Python in silence, so the log is
    checked) and hit the index cache on the second; ``augment --engine
    device`` with ``PANTAS_SCATTER`` unset on each mapped GAF, sha256 equal to
    ``augment --engine native``, kernel #1's launches equal to the batches;
    both kernels on the first, a middle and the last slot batch of condition
    1's mapped GAF as in phase 9; ``call --rca 3 --novel --minintronsize 20``
    on the host engine and ``--engine device`` on the card, rows equal;
    ``quant -a``, ``remap -i 20`` and ``eval`` against the simulation's truth:
    every simulated ES and IR event must be recovered (the other rates are
    printed, not judged). The host tools run as subprocesses of the CLI
    through the probe of phase 11, so each reports the modules it loaded.
14. ``exp`` at the 10 Mbp graph on phase 13's reads: a JSON config with the
    pangenome pre-placed in its workdir (the build is skipped), conditions
    ``c1`` and ``c2`` of one paired replicate each, ``call`` ``w 3 --novel
    --minintronsize 20``, novel sites with their quantification, and
    ``eval`` with cuts 1, 3, 5, through the CLI and the probe under
    ``PYTHONHASHSEED=0``. Its log must name the native alignment core and
    hold no fallback; each replicate's GAF must equal phase 13's byte for
    byte; each replicate's event rows must equal the host ``call`` of phase
    13's device-augmented GFA, run through the probe under the same hash
    seed; every simulated ES and IR event must be recovered. A second run
    must reuse every stage. Then ``plot-pr --no-figure`` and ``latex-table``
    on its per-cut scores. ``exp`` is host code: it launches no kernel.
15. The repo's 100 Mbp graph, the genome-scale cell:
    ``synth.ensure_graph(100)`` (4 chromosomes, 4 build processes; 5.5M
    nodes, ~236M count slots, a 2^28 bucket: 1 GiB of int32 counts and
    16,384 windows of kernel #1, its shared-memory count path at its
    largest) and 1M reads of ``synth_gaf`` (seed 7), each step timed, the
    GFA's nodes, slots, bucket and sha256 printed. Then phase 9's
    ``real_batches`` on the 2^28 bucket (every batch through kernel #2,
    kernel #1 and ``index_add_``, equal; the first, middle and last timed
    beside one bare ``index_add_`` and the bound), and ``python -m
    pantas_tpu_torch.scripts.bench_scaling`` run in this process on a
    logical mesh of the card: bit-exact at every shard count, and kernel
    #1's launches counted in that run equal to its steps times its shards.
    The augment main path on this graph is driven by phase 16's bench.
16. The port's bench, ``python -m pantas_tpu_torch.bench --multiplier
    BENCH_MULTIPLIER`` in a process of its own, on phase 3's 10 Mbp graph (its
    synthetic example: reads of ``sim`` mapped by the port) and phase 15's
    100 Mbp graph and reads: it must exit 0 and print its one JSON line with
    the root bench's four keys; its log must hold the device call rows equal
    to the host caller's, every device augment's sha256 equal to the native
    engine's (the warm-up, three A/B pairs, the CPU run and the two runs on
    the 100 Mbp graph in its 2^28 bucket), the choice of ``auto`` on a fresh
    cache, and kernel #1's launches over the bench, which go into the
    kernels' record as ``bench_launches``. Each of the two 100 Mbp runs
    (``augment_gfa_device_native`` with ``PANTAS_SCATTER`` unset, the counts
    zeroed just before it) must show the CUDA sorted scatter on 2^28 slots,
    kernel #1's launches equal to its batches and none of kernel #2; the
    first run's launches go into the record as ``launches_2p28``. The bench
    splits each run by the program's own spans (tensorize, engine, stream,
    the batches' host time, read-back, emission) and its parse counter.
17. The full-scale protocol's staged layout on the device engines at a cut
    size: ``python -m pantas_tpu_torch.scripts.run_fullscale_experiment
    --mode both --engine device`` at ``FULLSCALE_ARGS`` (100,000 pairs, one
    replicate a condition) on phase 3's 10 Mbp graph, which it must reuse,
    as a subprocess with ``PANTAS_SCATTER`` unset. It must exit 0; each
    replicate's device augment must be held by the script (the sorted
    kernel's scatter, no fallback, kernel launches = batches, sha256 equal
    to ``augment --engine native``'s: its ``<tag>.device.json``), the
    device-staged rows must equal the fused host rows, and quant-remap must
    report events. Kernel #1's launches are read from each replicate's
    ``<tag>.device.json``. Then :func:`replicate_kernels`, as a real
    replicate's run on the card uses it: one device augment of condition 1's
    mapped GAF split by stage in this process (sha256 equal to the script's
    native one, launches = batches), and phase 9's ``real_batches`` on its slot
    batches. It runs before phase 15, while phase 15's inputs are still being
    made, so that it does not lengthen the script's wall.
18. Compressed stage files on phase 3's inputs (after phase 14, before phases
    17 and 15): ``augment --engine device`` through the port's CLI with ``-o
    *.zst`` (the system's libzstd through ``io/zstd_ctypes.py``), then ``-o
    *.gz`` with the ``gzip`` binary taken off ``PATH`` (both in-process
    compressors are fed by the pipe of ``io/xopen.py::open_stage_output``).
    Each file must decompress to phase 3's sha256 and be smaller than it (the
    ``.zst`` also through libzstd's one-shot ``ZSTD_decompress``, none of the
    port's streaming reader), and kernel
    #1's launches must equal the batches. Then ``augment --engine device-py``
    on the first ``COMPRESSED_LINES`` lines of the GAF, plain and as a
    ``.zst``: the two GFAs must be byte-equal, launches equal to batches. One
    ``[compressed]`` line gives the walls beside phase 3's plain wall.

Every failure raises, so the exit code is non-zero and no result is printed.
The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
N_READS = 1_000_000
BATCH = 1 << 20
REPS = 25
WARM = 3
RANKS_TIMEOUT_S = 420  # one augment-dist run, every rank together
# NVIDIA's data sheet for the H100 SXM: device memory rate, and the float32
# rate outside the tensor cores, taken for the kernels' int32 adds
HBM_BYTES_PER_S = 3.35e12
PLAIN_OPS_PER_S = 67e12
SECTOR_SLOTS = 8  # int32 counts in one 32-byte sector of device memory


def _timed_ms(fns: dict) -> dict:
    """Median ms of each callable over REPS calls, in turns (the order flips
    every round), after WARM untimed calls each."""
    for f in fns.values():
        for _ in range(WARM):
            f()
    times = {k: [] for k in fns}
    names = list(fns)
    for r in range(REPS):
        for k in names if r % 2 == 0 else names[::-1]:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[k]()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in times.items()}


def _library_args(d_idx):
    """What one bare ``index_add_`` call needs to compute a batch's sum: the
    valid indices as int64 and as many ones (prepared outside the timing)."""
    valid = d_idx[d_idx >= 0].long()
    return valid, torch.ones(valid.numel(), dtype=torch.int32, device=d_idx.device)


def _bound(d_idx) -> dict:
    """The least time the card could take for ``counts[idx] += 1`` on this
    batch: the larger of its bytes over the memory rate and its adds over
    the plain arithmetic rate. Bytes: every index read once, and every
    32-byte sector of ``counts`` that the batch names read once and written
    once."""
    valid = d_idx[d_idx >= 0]
    sectors = int(torch.unique(valid // SECTOR_SLOTS).numel())
    bytes_ms = (4 * d_idx.numel() + 2 * 32 * sectors) / HBM_BYTES_PER_S * 1e3
    ops_ms = int(valid.numel()) / PLAIN_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _seeded_batch(log2_slots: int, seed: int):
    """(n, indices, preloaded counts) on the card: 2^20 indices with 10%
    padding and one 10,000-long run on the last slot."""
    n = 1 << log2_slots
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=BATCH, dtype=np.int32)
    idx[rng.random(BATCH) < 0.10] = -1  # padding
    run = rng.integers(0, BATCH - 10_000)
    idx[run : run + 10_000] = n - 1  # one run of heavy duplicates, on the last slot
    d_idx = torch.from_numpy(idx).cuda()
    base = torch.from_numpy(rng.integers(0, 8, size=n, dtype=np.int32)).cuda()
    return n, d_idx, base


def kernel_vs_plain(log2_slots: int, seed: int, label: str) -> dict:
    from pantas_tpu_torch.coverage import kernels
    from pantas_tpu_torch.parallel.mesh import scatter_add_counts

    n, d_idx, base = _seeded_batch(log2_slots, seed)
    k_counts, p_counts = base.clone(), base.clone()
    del base

    before = kernels.LAUNCHES["sorted_coverage_scatter_add"]
    kernels.sorted_coverage_scatter_add(k_counts, d_idx)
    scatter_add_counts(p_counts, d_idx)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["sorted_coverage_scatter_add"] != before + 1:
        raise RuntimeError("sorted_coverage_scatter_add did not launch its kernel")
    err = int((k_counts - p_counts).abs().max())
    if err != 0 or not torch.equal(k_counts, p_counts):
        raise RuntimeError(f"kernel != plain at 2^{log2_slots} slots (max abs err {err})")

    l_counts = k_counts.clone()
    l_idx, l_ones = _library_args(d_idx)
    ms = _timed_ms({
        "kernel": lambda: kernels.sorted_coverage_scatter_add(k_counts, d_idx),
        "plain": lambda: scatter_add_counts(p_counts, d_idx),
        "partition": lambda: kernels.window_partition(d_idx, n),
        "library": lambda: l_counts.index_add_(0, l_idx, l_ones),
    })
    torch.cuda.synchronize()
    # all received the same batches the same number of times
    if not (torch.equal(k_counts, p_counts) and torch.equal(l_counts, p_counts)):
        raise RuntimeError(f"kernel != plain after the timed calls at 2^{log2_slots}")
    bound = _bound(d_idx)
    print(
        f"[kernel] 2^{log2_slots} slots, 2^20 indices: equal, max_abs_err {err}; "
        f"kernel {ms['kernel']:.4f} ms (its window partition alone {ms['partition']:.4f} ms), "
        f"plain index_add_ {ms['plain']:.4f} ms, one bare index_add_ call "
        f"{ms['library']:.4f} ms, bound {bound['bound_ms']:.5f} ms by {bound['bound_by']}; "
        f"median of {REPS} [{label}]",
        flush=True,
    )
    del k_counts, p_counts, l_counts, d_idx
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], **bound}


def direct_vs_plain(log2_slots: int, seed: int, label: str) -> dict:
    """Kernel #2 against its plain version on ``kernel_vs_plain``'s batch."""
    from pantas_tpu_torch.coverage import kernels

    _, d_idx, base = _seeded_batch(log2_slots, seed)
    k_counts, p_counts = base.clone(), base.clone()
    del base

    before = kernels.LAUNCHES["coverage_scatter_add"]
    kernels.coverage_scatter_add(k_counts, d_idx)
    kernels.coverage_scatter_add_plain(p_counts, d_idx)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["coverage_scatter_add"] != before + 1:
        raise RuntimeError("coverage_scatter_add did not launch its kernel")
    err = int((k_counts - p_counts).abs().max())
    if err != 0 or not torch.equal(k_counts, p_counts):
        raise RuntimeError(f"direct kernel != plain at 2^{log2_slots} slots (max abs err {err})")

    l_counts = k_counts.clone()
    l_idx, l_ones = _library_args(d_idx)
    ms = _timed_ms({
        "kernel": lambda: kernels.coverage_scatter_add(k_counts, d_idx),
        "plain": lambda: kernels.coverage_scatter_add_plain(p_counts, d_idx),
        "library": lambda: l_counts.index_add_(0, l_idx, l_ones),
    })
    torch.cuda.synchronize()
    if not (torch.equal(k_counts, p_counts) and torch.equal(l_counts, p_counts)):
        raise RuntimeError(f"direct kernel != plain after the timed calls at 2^{log2_slots}")
    bound = _bound(d_idx)
    print(
        f"[direct] 2^{log2_slots} slots, 2^20 indices: equal, max_abs_err {err}; "
        f"kernel {ms['kernel']:.4f} ms, plain masked index_add_ {ms['plain']:.4f} ms, one "
        f"bare index_add_ call {ms['library']:.4f} ms, bound {bound['bound_ms']:.5f} ms by "
        f"{bound['bound_by']}; median of {REPS} [{label}]",
        flush=True,
    )
    del k_counts, p_counts, l_counts, d_idx
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], **bound}


def _batch_vs_plain(n: int, d_idx, what: str, label: str) -> dict:
    """Both kernels, the sorted kernel's window partition alone, the plain
    ``index_add_`` and one bare ``index_add_`` call on prepared indices, on
    one batch and zeroed counts; all four scatters must end equal."""
    from pantas_tpu_torch.coverage import kernels
    from pantas_tpu_torch.parallel.mesh import scatter_add_counts

    counts = {k: torch.zeros(n, dtype=torch.int32, device="cuda")
              for k in ("sorted", "direct", "plain", "library")}
    l_idx, l_ones = _library_args(d_idx)
    ms = _timed_ms({
        "sorted": lambda: kernels.sorted_coverage_scatter_add(counts["sorted"], d_idx),
        "partition": lambda: kernels.window_partition(d_idx, n),
        "direct": lambda: kernels.coverage_scatter_add(counts["direct"], d_idx),
        "plain": lambda: scatter_add_counts(counts["plain"], d_idx),
        "library": lambda: counts["library"].index_add_(0, l_idx, l_ones),
    })
    torch.cuda.synchronize()
    # each scatter ran the same batch WARM + REPS times
    err = max(int((counts[k] - counts["plain"]).abs().max()) for k in counts)
    if err or int(counts["plain"].sum()) != (WARM + REPS) * int((d_idx >= 0).sum()):
        raise RuntimeError(f"kernels != index_add_ on {what} (max abs err {err})")
    bound = _bound(d_idx)
    print(
        f"[{what}] 2^{n.bit_length() - 1} slots, 2^20 indices: equal, max_abs_err 0; "
        f"sorted kernel {ms['sorted']:.4f} ms (its window partition alone {ms['partition']:.4f} ms), "
        f"direct kernel {ms['direct']:.4f} ms, plain index_add_ {ms['plain']:.4f} ms, one bare "
        f"index_add_ call {ms['library']:.4f} ms, bound {bound['bound_ms']:.5f} ms by "
        f"{bound['bound_by']}; median of {REPS} [{label}]",
        flush=True,
    )
    del counts
    torch.cuda.empty_cache()
    return {**ms, **bound}


def uniform_vs_plain(log2_slots: int, label: str) -> dict:
    """``_batch_vs_plain`` on 2^20 uniform indices in [-1, n): a batch with
    no long run, unlike the smoke batch."""
    n = 1 << log2_slots
    rng = np.random.default_rng(log2_slots + 1)
    d_idx = torch.from_numpy(rng.integers(-1, n, size=BATCH, dtype=np.int32)).cuda()
    return _batch_vs_plain(n, d_idx, "uniform", label)


def one_slot_vs_plain(log2_slots: int, label: str) -> dict:
    """``_batch_vs_plain`` on 2^20 indices that all name one slot: the
    heaviest window there is."""
    n = 1 << log2_slots
    d_idx = torch.full((BATCH,), n // 3, dtype=torch.int32, device="cuda")
    return _batch_vs_plain(n, d_idx, "one-slot", label)


def profile_split(log2_slots: int, label: str) -> dict:
    """Device microseconds per call by ``torch.profiler`` on the uniform and
    the one-slot batch: of each pass of the sorted kernel, and of the direct
    kernel's launch; ``None`` where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    from pantas_tpu_torch.coverage import kernels

    n, calls = 1 << log2_slots, 10
    rng = np.random.default_rng(log2_slots + 1)
    batches = {
        "uniform": torch.from_numpy(rng.integers(-1, n, size=BATCH, dtype=np.int32)).cuda(),
        "one-slot": torch.full((BATCH,), n // 3, dtype=torch.int32, device="cuda"),
    }
    scatters = {
        "sorted": (kernels.sorted_coverage_scatter_add,
                   ("window_count", "window_scan", "window_scatter", "window_histogram")),
        "direct": (kernels.coverage_scatter_add, ("direct_scatter",)),
    }
    counts = torch.zeros(n, dtype=torch.int32, device="cuda")
    out = {}
    for what, d_idx in batches.items():
        out[what] = {}
        for name, (scatter, parts) in scatters.items():
            for _ in range(WARM):
                scatter(counts, d_idx)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    scatter(counts, d_idx)
                torch.cuda.synchronize()
            split = {}
            for ev in prof.key_averages():
                dev_us = getattr(ev, "device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(ev, "cuda_time_total", 0)
                for part in parts:
                    if part in ev.key and dev_us:
                        split[part] = split.get(part, 0.0) + dev_us / calls
            out[what][name] = {k: round(v, 1) for k, v in split.items()} or None
    print(f"[profile] device us per call, sorted kernel by pass and direct kernel, "
          f"2^{log2_slots} slots, 2^20 indices, {calls} calls: {json.dumps(out)} [{label}]",
          flush=True)
    del counts, batches
    torch.cuda.empty_cache()
    return out


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _inputs():
    """The 10 Mbp graph and 1M-read GAF (built once under ``.bench/``)."""
    from pantas_tpu_torch.eval.synth import ensure_graph, synth_gaf

    t0 = time.perf_counter()
    wd = ensure_graph(10)
    gfa = wd / "out" / "pantranscriptome-annotated.gfa"
    gaf = wd / f"reads_{N_READS}.gaf"
    if not gaf.exists():
        tmp = gaf.with_suffix(".tmp")
        synth_gaf(gfa, N_READS, tmp)
        os.replace(tmp, gaf)
    print(f"[main] inputs ready in {time.perf_counter() - t0:.1f} s: {gfa.stat().st_size} B GFA "
          f"(sha256 {_sha256(gfa)}), {gaf.stat().st_size} B GAF (sha256 {_sha256(gaf)})",
          flush=True)
    return wd, gfa, gaf


def _device_augment(gaf: Path, gfa: Path, out: Path, env: dict, run=None):
    """``augment --engine device`` through the port's CLI under ``env``
    (None unsets a variable), or ``run(out)`` in its place when given; the
    launch counts are zeroed just before and read just after. Returns (log,
    launches by kernel, seconds, batches)."""
    from pantas_tpu_torch import cli
    from pantas_tpu_torch.coverage import kernels

    if run is None:
        def run(out):
            return cli.main(["augment", "--engine", "device", str(gaf), str(gfa), "-o", str(out)])

    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    captured = io.StringIO()
    try:
        kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(_Tee(sys.stderr, captured)):
            rc = run(out)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc:
        raise RuntimeError(f"device augment exited {rc}")
    log = captured.getvalue()
    if "fallback" in log:
        raise RuntimeError("device augment fell back")
    line = next(ln for ln in log.splitlines() if ln.startswith("[device] kernel launches:"))
    batches = int(line.rsplit("batches:", 1)[1].strip(" )"))
    return log, launches, seconds, batches


def _decision(log: str) -> str:
    """The last ``[device] scatter impl:`` name the log shows."""
    names = [ln.split(": ", 1)[1].split(" (")[0] for ln in log.splitlines()
             if ln.startswith("[device] scatter impl: ")]
    if not names or names[-1] == "race pending":
        raise RuntimeError(f"the log names no scatter decision: {names}")
    return names[-1]


def main_path(label: str, wd: Path, gfa: Path, gaf: Path) -> tuple:
    """Run the device augment with ``PANTAS_SCATTER`` unset; return (its
    sorted-kernel launches, the native engine's sha256, the device GFA,
    which the caller deletes after phase 6 has called events on it, its
    wall in seconds)."""
    from pantas_tpu_torch import cli

    ref_out, dev_out = wd / "smoke_native.gfa", wd / "smoke_device.gfa"
    t0 = time.perf_counter()
    if cli.main(["augment", "--engine", "native", str(gaf), str(gfa), "-o", str(ref_out)]):
        raise RuntimeError("native augment failed")
    native_s = time.perf_counter() - t0

    log, counted, device_s, batches = _device_augment(gaf, gfa, dev_out, {"PANTAS_SCATTER": None})
    launches = counted["sorted_coverage_scatter_add"]
    if _decision(log) != "cuda-sorted":
        raise RuntimeError("device augment did not run the CUDA scatter")
    if not (launches == batches >= 1) or counted["coverage_scatter_add"]:
        raise RuntimeError(f"{counted} kernel launches for {batches} batches")
    ref_sha, dev_sha = _sha256(ref_out), _sha256(dev_out)
    if ref_sha != dev_sha:
        raise RuntimeError(f"device GFA {dev_sha} != native GFA {ref_sha}")
    print(
        f"[main] augment --engine device, 10 Mbp graph, {N_READS} reads: {device_s:.3f} s "
        f"({N_READS / device_s:.0f} reads/s), {launches} kernel launches = {batches} batches, "
        f"sha256 {dev_sha} == native engine's ({native_s:.3f} s) [{label}]",
        flush=True,
    )
    ref_out.unlink()
    return launches, ref_sha, dev_out, device_s


COMPRESSED_LINES = 20_000


def _decompressed_sha256(path: Path) -> tuple:
    """(sha256, bytes) of the decompressed content of ``path``."""
    from pantas_tpu_torch.io.xopen import xopen

    h, n = hashlib.sha256(), 0
    with xopen(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 22), b""):
            h.update(chunk)
            n += len(chunk)
    return h.hexdigest(), n


def _without_gzip() -> str:
    """``PATH`` with every directory that holds a ``gzip`` left out."""
    dirs = os.environ.get("PATH", "").split(os.pathsep)
    return os.pathsep.join(d for d in dirs if d and not os.access(os.path.join(d, "gzip"), os.X_OK))


def _one_shot_sha256(path: Path, size: int) -> str:
    """sha256 of ``path`` decoded by libzstd's one-shot ``ZSTD_decompress``
    into a buffer of the plain file's ``size``: a decoder beside the port's
    streaming reader (``io/zstd_ctypes.py``), which wrote the file."""
    import ctypes
    import ctypes.util

    lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                                    ctypes.c_size_t]
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    data = path.read_bytes()
    dst = ctypes.create_string_buffer(size)
    n = lib.ZSTD_decompress(dst, size, data, len(data))
    if lib.ZSTD_isError(n) or n != size:
        raise RuntimeError(f"ZSTD_decompress of {path.name}: {n} of {size} bytes")
    return hashlib.sha256(memoryview(dst)[:n]).hexdigest()


def _kernel1_checked(counted: dict, batches: int, what: str) -> int:
    launches = counted["sorted_coverage_scatter_add"]
    if not (launches == batches >= 1) or counted["coverage_scatter_add"]:
        raise RuntimeError(f"{what}: {counted} kernel launches for {batches} batches")
    return launches


def compressed_path(label: str, wd: Path, gfa: Path, gaf: Path, ref_sha: str,
                    plain_s: float) -> int:
    """Phase 18: compressed outputs of the device engine, and a ``.zst`` GAF
    read by ``device-py``. Returns kernel #1's launches over its four runs."""
    from pantas_tpu_torch import cli
    from pantas_tpu_torch.io.xopen import xopen

    t0 = time.perf_counter()
    total, walls = 0, {}
    for suffix, env in (("zst", {}), ("gz", {"PATH": _without_gzip()})):
        out = wd / f"smoke_compressed.gfa.{suffix}"

        def run(out, hidden=bool(env)):
            if hidden and shutil.which("gzip"):
                raise RuntimeError("gzip is still on PATH")
            return cli.main(["augment", "--engine", "device", str(gaf), str(gfa), "-o", str(out)])

        try:
            log, counted, seconds, batches = _device_augment(gaf, gfa, out, env, run)
            if _decision(log) != "cuda-sorted":
                raise RuntimeError(f"-o *.{suffix}: the augment did not run the CUDA scatter")
            total += _kernel1_checked(counted, batches, f"-o *.{suffix}")
            sha, plain_bytes = _decompressed_sha256(out)
            size = out.stat().st_size
            if suffix == "zst" and _one_shot_sha256(out, plain_bytes) != sha:
                raise RuntimeError("-o *.zst: the one-shot decode differs from the reader's")
        finally:
            out.unlink(missing_ok=True)
        if sha != ref_sha or not size < plain_bytes:
            raise RuntimeError(f"-o *.{suffix}: decompressed sha256 {sha} ({plain_bytes} B, "
                               f"{size} B compressed), phase 3's {ref_sha}")
        walls[suffix] = (seconds, size, plain_bytes, batches)

    head, packed = wd / "smoke_head.gaf", wd / "smoke_head.gaf.zst"
    outs = {name: wd / f"smoke_head_{name}.gfa" for name in ("plain", "zst")}
    try:
        with open(gaf, "rb") as src, open(head, "wb") as dst, xopen(packed, "wb") as z:
            for _, line in zip(range(COMPRESSED_LINES), src):
                dst.write(line)
                z.write(line)
        for name, source in (("plain", head), ("zst", packed)):
            def run(out, source=source):
                return cli.main(["augment", "--engine", "device-py", str(source), str(gfa),
                                 "-o", str(out)])

            log, counted, seconds, batches = _device_augment(source, gfa, outs[name], {}, run)
            total += _kernel1_checked(counted, batches, f"device-py on a {name} GAF")
            walls[f"py-{name}"] = (seconds, batches)
        py_sha = _sha256(outs["plain"])
        if _sha256(outs["zst"]) != py_sha:
            raise RuntimeError("device-py on the .zst GAF differs from the plain run")
    finally:
        for path in (head, packed, *outs.values()):
            path.unlink(missing_ok=True)
    zst, gz = walls["zst"], walls["gz"]
    print(
        f"[compressed] augment --engine device, 10 Mbp, {N_READS} reads: -o *.zst by "
        f"libzstd {zst[0]:.3f} s ({zst[1]} B), -o *.gz without the gzip binary "
        f"{gz[0]:.3f} s ({gz[1]} B), beside phase 3's plain {plain_s:.3f} s ({zst[2]} B); both "
        f"decompress to sha256 {ref_sha} (the .zst by the port's reader and by "
        f"ZSTD_decompress), kernel #1 "
        f"launches = batches ({zst[3]}, {gz[3]}); device-py on the first {COMPRESSED_LINES} "
        f"lines: .zst GAF {walls['py-zst'][0]:.3f} s == plain GAF {walls['py-plain'][0]:.3f} s "
        f"byte for byte (sha256 {py_sha}, {walls['py-zst'][1]} batches); the phase "
        f"{time.perf_counter() - t0:.1f} s [{label}]",
        flush=True,
    )
    return total


def default_coverage(gfa: Path) -> dict:
    """Beside phase 3: ``DeviceCoverage`` on the graph's tensors with no
    device named. Its counts must lie on ``cuda:0``, and one seeded batch of
    ``BATCH`` slots must add as ``np.bincount`` does."""
    from pantas_tpu_torch.coverage import kernels
    from pantas_tpu_torch.coverage.device import DeviceCoverage
    from pantas_tpu_torch.graph.compiler import compile_gfa

    tensors = compile_gfa(str(gfa))
    dev = DeviceCoverage(tensors, log=io.StringIO())
    if dev.counts.device != torch.device("cuda", 0):
        raise RuntimeError(f"DeviceCoverage with no device holds its counts on {dev.counts.device}")
    idx = np.random.default_rng(3).integers(-1, tensors.total_slots, size=BATCH, dtype=np.int32)
    before = dict(kernels.LAUNCHES)
    dev.add_slots(idx)
    got = dev.result()
    if not np.array_equal(got, np.bincount(idx[idx >= 0], minlength=tensors.total_slots)):
        raise RuntimeError("DeviceCoverage with no device counted a seeded batch wrong")
    return {"counts_device": str(dev.counts.device), "slots": tensors.total_slots,
            "launches": {k: v - before[k] for k, v in kernels.LAUNCHES.items()}}


def raw_race(label: str) -> dict:
    """``bench_scatter`` at 2^25 slots x 2^20 indices; return the launches
    counted in that run, by kernel."""
    from pantas_tpu_torch import backend
    from pantas_tpu_torch.coverage import bench_scatter, kernels, scatter_impls

    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    if bench_scatter.main([str(1 << 25), str(BATCH)]):
        raise RuntimeError("bench_scatter failed")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if not all(launches.values()):
        raise RuntimeError(f"the raw race did not launch every kernel: {launches}")
    name, _ = scatter_impls.pick_scatter_impl(1 << 25, BATCH, device=backend.device("cuda"))
    print(f"[race] raw race at 2^25 slots x 2^20 indices: all 3 impls verified, launches "
          f"{launches}; pick_scatter_impl picks {name} [{label}]", flush=True)
    return launches


def race_path(label: str, wd: Path, gfa: Path, gaf: Path, ref_sha: str) -> None:
    """The end-to-end race on the main path, then its cached verdict."""
    from pantas_tpu_torch.coverage import scatter_impls

    out = wd / "smoke_race.gfa"
    with tempfile.TemporaryDirectory(dir=wd) as cache:
        env = {"PANTAS_SCATTER": "race", "PANTAS_TORCH_CACHE": cache}
        log, counted, raced_s, batches = _device_augment(gaf, gfa, out, env)
        name = _decision(log)
        vf = Path(cache) / "scatter_verdict.json"
        (key, entry), = json.loads(vf.read_text()).items()
        stats = entry["stats"]
        if not (entry["explored"] and all(stats.get(k, {}).get("times")
                                          for k in ("plain", "cuda-sorted"))):
            raise RuntimeError(f"the race did not measure plain and cuda-sorted: {entry}")
        if name != entry["impl"] or _sha256(out) != ref_sha:
            raise RuntimeError(f"raced augment: decision {name}, verdict {entry['impl']}, "
                               "or its GFA differs from the native engine's")
        medians = {k: round(v["median_s"] * 1e3, 4) for k, v in stats.items()}
        firsts = {k: round(v["first_s"] * 1e3, 4) for k, v in stats.items()}
        print(f"[race] PANTAS_SCATTER=race: {raced_s:.3f} s, decision {name} "
              f"(~{entry['batches_hint']} batches expected, {batches} run); median step ms "
              f"{medians}, first call ms {firsts}; launches {counted}; verdict key {key}; "
              f"sha256 == native engine's [{label}]", flush=True)

        verdict = vf.read_bytes()
        env["PANTAS_SCATTER"] = "auto"
        log, counted, cached_s, batches = _device_augment(gaf, gfa, out, env)
        cached = _decision(log)
        if vf.read_bytes() != verdict:
            raise RuntimeError("PANTAS_SCATTER=auto raced again instead of using the verdict")
        if cached != scatter_impls._decide(stats, entry["batches_hint"]):
            raise RuntimeError(f"auto chose {cached}; the cached verdict decides otherwise")
        want = batches if cached == "cuda-sorted" else 0
        if counted != {"sorted_coverage_scatter_add": want, "coverage_scatter_add": 0}:
            raise RuntimeError(f"auto chose {cached}: {counted} launches for {batches} batches")
        if _sha256(out) != ref_sha:
            raise RuntimeError("the auto run's GFA differs from the native engine's")
        print(f"[race] PANTAS_SCATTER=auto: {cached_s:.3f} s, cached verdict decides {cached} "
              f"without a race, launches {counted} for {batches} batches, sha256 == native "
              f"engine's [{label}]", flush=True)
    out.unlink()


def mesh_path(label: str, wd: Path, gfa: Path, gaf: Path, ref_sha: str) -> int:
    """Phase 8: the mesh on the main path's cell. ``--mesh 1`` and ``--mesh
    1x1`` through the CLI, then a logical mesh of 4 and of 2x2 on the one
    card through the Python API. Returns the sorted kernel's launches summed
    over the four runs."""
    from pantas_tpu_torch import backend, cli
    from pantas_tpu_torch.coverage.device import augment_gfa_device_native
    from pantas_tpu_torch.parallel.mesh import coverage_mesh, coverage_mesh_2d

    card = backend.device("cuda")
    out = wd / "smoke_mesh.gfa"

    def by_cli(spec):
        return lambda out: cli.main(["augment", "--engine", "device", "--mesh", spec,
                                     str(gaf), str(gfa), "-o", str(out)])

    def by_api(mesh):
        def run(out):
            with open(out, "w") as fh:
                augment_gfa_device_native(str(gaf), str(gfa), out=fh, mesh=mesh)
            return 0
        return run

    runs = [
        ("--mesh 1 (CLI)", 1, by_cli("1")),
        ("--mesh 1x1 (CLI)", 1, by_cli("1x1")),
        ("logical 4 on one card (API)", 4, by_api(coverage_mesh([card] * 4))),
        ("logical 2x2 on one card (API)", 4, by_api(coverage_mesh_2d([card] * 4, 2, 2))),
    ]
    total = 0
    for what, shards, run in runs:
        log, counted, seconds, batches = _device_augment(
            gaf, gfa, out, {"PANTAS_SCATTER": None}, run=run)
        launches = counted["sorted_coverage_scatter_add"]
        if not (launches == shards * batches >= 1) or counted["coverage_scatter_add"]:
            raise RuntimeError(f"mesh {what}: {counted} launches for {batches} batches "
                               f"on {shards} shards")
        if "cuda-sorted on a" not in log:
            raise RuntimeError(f"mesh {what}: the log does not show the CUDA scatter on a mesh")
        sha = _sha256(out)
        if sha != ref_sha:
            raise RuntimeError(f"mesh {what}: GFA {sha} != native engine's {ref_sha}")
        reduced = next(ln for ln in log.splitlines() if ln.startswith("[device] mesh "))
        print(f"[mesh] {what}: {seconds:.3f} s, {batches} batches, {launches} kernel launches "
              f"= {shards} shards x batches, {reduced.split(': ', 1)[1]}, sha256 == native "
              f"engine's; a logical mesh shows the sharding arithmetic on the card and "
              f"measures nothing about scaling [{label}]", flush=True)
        total += launches
    out.unlink()
    return total


def real_batches(label: str, gfa: Path, gaf: Path, tag: str = "real",
                 source: str = "the 1M-read GAF", min_whole: int = 1, tensors=None) -> dict:
    """Phase 9: the stage's own slot batches through both kernels and
    ``index_add_``. Returns, by picked batch, the timings, the batch's
    statistics and its bound. Phase 13 calls it on a mapped GAF (``tag``
    names the lines, ``source`` the reads) and asks for ``min_whole`` batches
    without padding; phase 15 passes the graph's ``tensors`` it holds."""
    from pantas_tpu_torch.coverage import bench_scatter, kernels
    from pantas_tpu_torch.graph.compiler import compile_gfa
    from pantas_tpu_torch.parallel.mesh import scatter_add_counts

    t0 = time.perf_counter()
    tensors = compile_gfa(str(gfa)) if tensors is None else tensors
    batches = bench_scatter.slot_batches(str(gaf), tensors, BATCH)
    n = max(1 << 12, 1 << (tensors.total_slots - 1).bit_length())  # the stage's bucket
    parse_s = time.perf_counter() - t0
    whole = sum(1 for b in batches if b[-1] >= 0)
    if whole < min_whole:
        raise RuntimeError(f"{source} fills {whole} whole slot batches, {min_whole} are asked for")
    scatters = {
        "direct": kernels.coverage_scatter_add,
        "sorted": kernels.sorted_coverage_scatter_add,
        "plain": scatter_add_counts,
    }
    counts = {k: torch.zeros(n, dtype=torch.int32, device="cuda") for k in scatters}
    before = dict(kernels.LAUNCHES)
    for batch in batches:
        d_idx = torch.from_numpy(batch).cuda()
        for k, scatter in scatters.items():
            scatter(counts[k], d_idx)
    torch.cuda.synchronize()
    rose = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    if set(rose.values()) != {len(batches)}:
        raise RuntimeError(f"{rose} kernel launches for {len(batches)} real batches")
    valid = sum(int((b >= 0).sum()) for b in batches)
    if not (torch.equal(counts["direct"], counts["plain"])
            and torch.equal(counts["sorted"], counts["plain"])
            and int(counts["plain"].sum()) == valid):
        raise RuntimeError(f"kernels != index_add_ on the slot batches of {source}")
    print(f"[{tag}] {len(batches)} slot batches of 2^20 ({whole} of them whole) from {source} "
          f"({parse_s:.2f} s with the tensorize), {valid} valid indices, "
          f"{tensors.total_slots} slots in a 2^"
          f"{n.bit_length() - 1} bucket: direct kernel == sorted kernel == index_add_ "
          f"[{label}]", flush=True)

    out = {}
    picks = {"first": 0, "middle": len(batches) // 2, "last": len(batches) - 1}
    for which, i in picks.items():
        d_idx = torch.from_numpy(batches[i]).cuda()
        counts["library"] = counts["plain"].clone()
        l_idx, l_ones = _library_args(d_idx)
        ms = _timed_ms({
            **{k: (lambda k=k: scatters[k](counts[k], d_idx)) for k in scatters},
            "library": lambda: counts["library"].index_add_(0, l_idx, l_ones),
        })
        torch.cuda.synchronize()
        if not all(torch.equal(counts[k], counts["plain"]) for k in counts):
            raise RuntimeError(f"kernels != index_add_ after the timed calls on batch {i} "
                               f"of {source}")
        stats, bound = bench_scatter.batch_stats(batches[i]), _bound(d_idx)
        print(f"[{tag}] batch {i} ({which}): direct kernel {ms['direct']:.4f} ms, sorted kernel "
              f"{ms['sorted']:.4f} ms, plain index_add_ {ms['plain']:.4f} ms, one bare "
              f"index_add_ call {ms['library']:.4f} ms, bound {bound['bound_ms']:.5f} ms by "
              f"{bound['bound_by']}; {json.dumps(stats)}; median of {REPS} [{label}]", flush=True)
        out[which] = {"batch": i, **ms, **bound, **stats}
    del counts
    torch.cuda.empty_cache()
    return out


def isolation() -> None:
    """Phase 10: nothing of the JAX package, and no jax, was loaded."""
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("pantas_tpu", "jax"))
    print(json.dumps({"phase": "isolation", "ok": not foreign,
                      "foreign_modules": foreign[:10],
                      "checked": ["pantas_tpu", "pantas_tpu.*", "jax", "jax.*"]}), flush=True)
    if foreign:
        raise RuntimeError(f"the port loaded modules it must not: {foreign[:10]}")


def _device_call(argv: list) -> tuple:
    """``call --engine device`` through the port's CLI on the card, traced
    (``bench.traced``): each finder's evaluations (copy to the card, match,
    read-back) are timed by its ``call.<finder>.match`` spans. ``EVALS`` is
    zeroed just before and read just after; every evaluation must have run
    on ``cuda``. Returns (per-finder record, bytes copied to the card, wall
    seconds)."""
    from pantas_tpu_torch import cli
    from pantas_tpu_torch.bench import device_evals, traced
    from pantas_tpu_torch.events import batched

    batched.EVALS.clear()
    with traced() as got:
        t0 = time.perf_counter()
        rc = cli.main(["call", "--engine", "device", "--device", "cuda", *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc:
        raise RuntimeError(f"call --engine device exited {rc}")
    return device_evals(got, "cuda"), got["counters"].get("call.h2d_bytes", 0), wall


def _sorted_rows(path: Path) -> list:
    """The CSV's lines, sorted; the file is deleted."""
    rows = sorted(path.read_text().splitlines())
    path.unlink()
    return rows


def call_path(label: str, wd: Path, aug: Path, coverage: dict) -> list:
    """Phase 6: events on the device-augmented 10 Mbp GFA, host engine then
    device engine through the port's CLI; then the micro fixtures with
    ``--novel``, so that the novel finders run on the card too; then the
    library's call engine with no device named, reported with phase 3's
    ``coverage`` (:func:`default_coverage`). Returns the host engine's sorted
    rows on the 10 Mbp GFA."""
    from pantas_tpu_torch import cli

    gtf = wd / "g.gtf"
    host_csv, dev_csv = wd / "smoke_call_host.csv", wd / "smoke_call_device.csv"
    t0 = time.perf_counter()
    if cli.main(["call", "--rca", "0", str(aug), str(gtf), "-o", str(host_csv)]):
        raise RuntimeError("host call failed")
    host_s = time.perf_counter() - t0
    seen, h2d, dev_s = _device_call(["--rca", "0", str(aug), str(gtf), "-o", str(dev_csv)])
    host, dev = _sorted_rows(host_csv), _sorted_rows(dev_csv)
    if dev != host:
        raise RuntimeError(f"device call rows differ from the host caller's "
                           f"({len(dev)} vs {len(host)} lines)")
    events = [r for r in host if not r.startswith("event_type,")]
    if len(events) < 5000:
        raise RuntimeError(f"only {len(events)} events on the 10 Mbp graph")
    by_type = dict(sorted(Counter(",".join(r.split(",")[:2]) for r in events).items()))
    in_eval = sum(rec["eval_s"] for rec in seen.values())
    print(f"[call] call --rca 0 on the device-augmented 10 Mbp GFA: device engine "
          f"{dev_s:.3f} s, host engine {host_s:.3f} s, rows equal; {len(events)} events "
          f"{by_type}; in the call.<finder>.match spans {in_eval:.3f} s "
          f"({100 * in_eval / dev_s:.1f}% of the device wall), {h2d} B copied to the card; "
          f"per finder {json.dumps(seen)} [{label}]", flush=True)

    sys.path.insert(0, str(REPO / "tests"))
    from fixtures_call import write_call_fixtures

    novel = {}
    with tempfile.TemporaryDirectory(dir=wd) as tmp:
        for name, (gfa, gtf) in write_call_fixtures(Path(tmp)).items():
            h, d = Path(tmp) / f"{name}_h.csv", Path(tmp) / f"{name}_d.csv"
            flags = ["--rca", "0", "--novel", gfa, gtf]
            if cli.main(["call", *flags, "-o", str(h)]):
                raise RuntimeError(f"host call failed on the {name} fixture")
            seen, _, _ = _device_call([*flags, "-o", str(d)])
            if _sorted_rows(d) != _sorted_rows(h):
                raise RuntimeError(f"device call rows differ from the host's on the {name} fixture")
            for f, rec in seen.items():
                novel[f] = novel.get(f, 0) + rec["candidates"]
    missing = {"novel_es", "novel_ss_exonic", "novel_ce"} - set(novel)
    if missing:
        raise RuntimeError(f"the micro fixtures evaluated no {sorted(missing)} on the card")
    print(f"[call] micro fixtures splice, cassette with --rca 0 --novel: rows equal to the "
          f"host's; candidates on cuda {novel} [{label}]", flush=True)

    from pantas_tpu_torch.events import batched
    from pantas_tpu_torch.events.caller import CallOptions

    batched.EVALS.clear()
    t0 = time.perf_counter()
    rows = sorted(batched.call_events_device(str(aug), str(wd / "g.gtf"), CallOptions(rca=0),
                                             log=io.StringIO()))
    torch.cuda.synchronize()
    lib_s = time.perf_counter() - t0
    evals = dict(batched.EVALS)
    if not evals or {dev for _, dev in evals} != {"cuda"}:
        raise RuntimeError(f"call_events_device with no device evaluated on {evals}")
    if rows != host:
        raise RuntimeError(f"call_events_device with no device: rows differ from the host "
                           f"caller's ({len(rows)} vs {len(host)} lines)")
    print(f"[defaults] no device named: call_events_device(aug, gtf, CallOptions(rca=0)) "
          f"{lib_s:.3f} s, candidates by (finder, device) "
          f"{json.dumps({f'{f}:{d}': n for (f, d), n in sorted(evals.items())})}, rows equal to "
          f"the host caller's ({len(events)} events); DeviceCoverage(compile_gfa(gfa)) counts "
          f"on {coverage['counts_device']} ({coverage['slots']} slots), a seeded batch equal "
          f"to np.bincount, launches {coverage['launches']} [{label}]", flush=True)
    return host


# what a rank runs: the port's CLI, then a report of what it loaded
RANK_PROBE = """
import json, sys
from pantas_tpu_torch import cli
rc = cli.main(json.loads(sys.argv[1]))
foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("pantas_tpu", "jax"))
print(json.dumps({"rc": rc, "foreign": foreign}), file=sys.stderr)
sys.exit(rc)
"""


def _run_ranks(n: int, gaf: Path, gfa: Path, out: Path) -> tuple:
    """One ``augment-dist`` run of ``n`` ranks, each a subprocess on the first
    card. The first rank that fails, or the time limit, kills the others.
    Returns (each rank's log, wall seconds)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("PANTAS_SCATTER", None)
    logs = [out.with_name(f"{out.name}.rank{i}.log") for i in range(n)]
    t0 = time.perf_counter()
    procs = []
    try:
        for i, path in enumerate(logs):
            argv = ["augment-dist", str(gaf), str(gfa), "-o", str(out), "--coordinator",
                    f"127.0.0.1:{port}", "--nprocs", str(n), "--procid", str(i)]
            with open(path, "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", RANK_PROBE, json.dumps(argv)], env=env, cwd=REPO,
                    stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL, stderr=fh))
        while any(p.poll() is None for p in procs):
            failed = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.perf_counter() - t0 > RANKS_TIMEOUT_S:
                why = f"rank {failed[0]} failed" if failed else "timed out"
                raise RuntimeError(f"augment-dist with {n} ranks {why}: "
                                   + " | ".join(p.read_text()[-1500:] for p in logs))
            time.sleep(0.1)
        wall = time.perf_counter() - t0
        texts = [p.read_text() for p in logs]
        if any(p.returncode for p in procs):
            raise RuntimeError(f"augment-dist with {n} ranks: exit codes "
                               f"{[p.returncode for p in procs]}: {texts[-1][-1500:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for path in logs:
            path.unlink(missing_ok=True)
    return texts, wall


def dist_path(label: str, wd: Path, gfa: Path, gaf: Path, ref_sha: str, batches: int) -> int:
    """Phase 11: ``augment-dist`` with 1 rank, then with 2 ranks on the one
    card. Returns the ranks' kernel launches of both runs together."""
    out = wd / "smoke_dist.gfa"
    reductions = {1: "reduction: nccl on cuda:0",
                  2: "reduction: gloo on the host vector (2 ranks share GPU-"}
    total = 0
    for n, reduction in reductions.items():
        logs, wall = _run_ranks(n, gaf, gfa, out)
        sha = _sha256(out)
        out.unlink()
        if sha != ref_sha:
            raise RuntimeError(f"augment-dist, {n} ranks: GFA {sha} != native engine's {ref_sha}")
        left = sorted(p.name for p in wd.iterdir() if p.name.startswith(".augshard"))
        if left:
            raise RuntimeError(f"augment-dist, {n} ranks: sidecar files left: {left}")
        ranks = []
        for i, log in enumerate(logs):
            report = json.loads(log.strip().splitlines()[-1])
            if report != {"rc": 0, "foreign": []}:
                raise RuntimeError(f"augment-dist rank {i} of {n}: {report}")
            if ("[device] scatter impl: cuda-sorted (" not in log or "fallback" in log
                    or "python feed" in log or f"[augment-dist] {reduction}" not in log):
                raise RuntimeError(f"augment-dist rank {i} of {n}: the log does not show the "
                                   f"CUDA scatter, the native feed and '{reduction}': {log[-1500:]}")
            launched, fed = map(int, re.search(
                r"\[device\] kernel launches: (\d+) \(batches: (\d+)\)", log).groups())
            if not launched == fed >= 2:
                raise RuntimeError(f"augment-dist rank {i} of {n}: {launched} kernel launches "
                                   f"for {fed} batches")
            accum_s = float(re.search(
                rf"\[augment-dist\] proc {i}: accumulate ([0-9.]+)s", log).group(1))
            reduced = re.search(rf"proc {i}: (\d+) bytes reduced over \w+ in ([0-9.]+)s", log)
            ranks.append({"launches": launched, "accum_s": accum_s,
                          "reduced_bytes": int(reduced.group(1)),
                          "reduce_s": float(reduced.group(2))})
        real = sum(r["launches"] - 1 for r in ranks)  # without each rank's warm-up batch
        if real < batches:
            raise RuntimeError(f"augment-dist, {n} ranks: {real} real batches, the single "
                               f"device ran {batches}")
        emit_s = float(re.search(r"proc 0: merge and emit ([0-9.]+)s", logs[0]).group(1))
        line = next(ln for ln in logs[0].splitlines() if "[augment-dist] reduction:" in ln)
        print(f"[dist] augment-dist, {n} rank(s) on one card: stage wall {wall:.3f} s, per rank "
              f"{json.dumps(ranks)} (launches = batches, the warm-up batch included; {real} real "
              f"batches, {batches} on the single device), rank 0 merge and emit {emit_s:.2f} s, "
              f"{line.split('] ', 1)[1]}, no sidecar left, no foreign module, sha256 == native "
              f"engine's; ranks sharing a card measure nothing about scaling [{label}]",
              flush=True)
        total += sum(r["launches"] for r in ranks)
    return total


def entry_points(label: str, wd: Path, gfa: Path, gaf: Path, call_rows: list) -> None:
    """Phase 12: ``replicate`` against phase 6's host rows, then the
    entry points of ``graft_entry`` on the card."""
    from pantas_tpu_torch import cli, graft_entry
    from pantas_tpu_torch.coverage import kernels

    rows = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(rows):
        rc = cli.main(["replicate", "--rca", "0", str(gaf), str(gfa), str(wd / "g.gtf")])
    replicate_s = time.perf_counter() - t0
    got = sorted(rows.getvalue().splitlines())
    if rc or got != call_rows:
        raise RuntimeError(f"replicate exited {rc}; {len(got)} rows, the staged augment and "
                           f"call gave {len(call_rows)}")
    print(f"[entry] replicate --rca 0 on the un-augmented 10 Mbp GFA: {replicate_s:.3f} s, "
          f"{len(got)} sorted rows equal to the host call's on the augmented GFA [{label}]",
          flush=True)

    fn, (counts, idx) = graft_entry.entry()
    if counts.device.type != "cuda" or idx.device.type != "cuda":
        raise RuntimeError("graft_entry.entry() did not place its arguments on the card")
    got = fn(counts, idx).cpu().numpy()
    raw = idx.cpu().numpy()
    if not np.array_equal(got, np.bincount(raw[raw >= 0], minlength=counts.numel())):
        raise RuntimeError("graft_entry.entry(): one step differs from np.bincount")

    card = torch.device("cuda", 0)
    before = kernels.LAUNCHES["sorted_coverage_scatter_add"]
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        graft_entry.dryrun_multichip(4, devices=[card] * 4)
    launched = kernels.LAUNCHES["sorted_coverage_scatter_add"] - before
    if "dryrun_multichip(4): OK" not in said.getvalue() or launched < 8:
        raise RuntimeError(f"dryrun_multichip(4) on a logical mesh: {said.getvalue()!r}, "
                           f"{launched} kernel launches")
    have = torch.cuda.device_count()
    refusal = f"not checked: {have} cards are present"
    if have < 4:
        try:
            graft_entry.dryrun_multichip(4)
        except RuntimeError as e:
            refusal = f"refused ({e})"
        else:
            raise RuntimeError(f"dryrun_multichip(4) ran with {have} card(s)")
    print(f"[entry] graft_entry.entry() on cuda: one step == np.bincount ({int(got.sum())} "
          f"counts); {said.getvalue().strip()} ({launched} sorted-kernel launches on a logical "
          f"mesh of 4 x cuda:0); dryrun_multichip(4) on {have} card(s): {refusal} [{label}]",
          flush=True)


# phase 13's simulation: events and depth per isoform, chosen so that each
# condition fills at least four whole 2^20-slot batches (about 128k read pairs
# of 150 bp, ~30 slots a read) from 48 genes: deep coverage of few exons
MAPPED_EVENTS = 48
MAPPED_DEPTH = 500
MAPPED_MIN_WHOLE = 4
MAPPED_CALL_FLAGS = ["--rca", "3", "--novel", "--minintronsize", "20"]
MAPPED_DIR = "smoke_mapped"  # phase 13's directory, read by phase 14 and deleted by it
HOST_TOOL_TIMEOUT_S = 300


def _port_cli(argv: list, stdout=None) -> tuple:
    """One subcommand of the port's CLI in a subprocess, through the probe
    that reports what it loaded. Returns (its log, wall seconds)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONHASHSEED="0")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", RANK_PROBE, json.dumps([str(a) for a in argv])], env=env, cwd=REPO,
        stdin=subprocess.DEVNULL, stdout=stdout or subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, timeout=HOST_TOOL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"{argv[0]} exited {proc.returncode}: {proc.stderr[-1500:]}")
    report = json.loads(proc.stderr.strip().splitlines()[-1])
    if report != {"rc": 0, "foreign": []}:
        raise RuntimeError(f"{argv[0]}: {report}")
    return proc.stderr, wall


def mapped_path(label: str, wd: Path, gfa: Path) -> tuple:
    """Phase 13: simulated reads with errors, mapped by the port's mapper,
    through kernel #1 on the card, then called, quantified, remapped and
    scored. Leaves ``MAPPED_DIR`` (reads, GAFs, device-augmented GFAs) for
    phase 14, which deletes it. Returns (kernel #1's launches over both
    conditions, the mapped batches' record of ``real_batches``)."""
    from pantas_tpu_torch import cli
    from pantas_tpu_torch.eval.compare import parse_truth

    md = wd / MAPPED_DIR
    shutil.rmtree(md, ignore_errors=True)
    md.mkdir()
    fa, gtf = wd / "g.fa", wd / "g.gtf"

    log, sim_s = _port_cli(["sim", fa, gtf, "-o", md / "sim", "-n", MAPPED_EVENTS,
                            "-r", MAPPED_DEPTH, "-e", "0.005"])
    n_events, n_pairs = map(int, re.search(r"\[simulate\] (\d+) events, (\d+) read pairs",
                                           log).groups())
    truth = parse_truth(str(md / "sim_truth.csv"))
    by_type = dict(sorted(Counter(t.etype for t in truth).items()))
    if n_events != MAPPED_EVENTS or len(truth) != n_events:
        raise RuntimeError(f"sim made {n_events} events, {len(truth)} truth rows")
    print(f"[mapped] sim -n {MAPPED_EVENTS} -r {MAPPED_DEPTH} -e 0.005 on the 10 Mbp FASTA and "
          f"GTF: {n_events} events {by_type}, {n_pairs} read pairs over two conditions, "
          f"{sim_s:.2f} s [{label}]", flush=True)

    threads = os.cpu_count() or 1
    total_launches = 0
    for cond in ("c1", "c2"):
        gaf = md / f"{cond}.gaf"
        log, map_s = _port_cli(["map", gfa, md / f"sim_{cond}_1.fq", md / f"sim_{cond}_2.fq",
                                "-t", threads, "--index", md / "index", "-o", gaf])
        # the mapper falls back to its Python path in silence: the log tells
        first = cond == "c1"
        if ("[map] phases" not in log or "python path" in log or "unusable" in log
                or ("[map] native alignment core" in log) != first
                or ("[map] index cached ->" in log) != first
                or ("[map] index cache hit" in log) == first):
            raise RuntimeError(f"map {cond}: the native core or the index cache did not run as "
                               f"expected: {log[-1500:]}")
        mapped, total, spliced = map(int, re.search(
            r"\[map\] mapped (\d+)/(\d+) reads \((\d+) spliced joins\)", log).groups())
        phases = next(ln for ln in log.splitlines() if ln.startswith("[map] phases"))
        if not (0 < mapped <= total) or gaf.read_bytes().count(b"\n") != total:
            raise RuntimeError(f"map {cond}: {mapped}/{total} reads, GAF lines differ")
        print(f"[mapped] map {cond} -t {threads} --index ({'built and saved' if first else 'cache hit'}"
              f"): {mapped}/{total} reads mapped, {spliced} spliced joins, {map_s:.2f} s "
              f"({total / map_s:.0f} reads/s with the process start and the index); native "
              f"core; {phases.split(': ', 1)[1]} [{label}]", flush=True)

        native_out, dev_out = md / f"{cond}.native.gfa", md / f"{cond}.aug.gfa"
        _, native_s = _port_cli(["augment", "--engine", "native", gaf, gfa, "-o", native_out])
        log, counted, device_s, batches = _device_augment(gaf, gfa, dev_out,
                                                          {"PANTAS_SCATTER": None})
        launches = counted["sorted_coverage_scatter_add"]
        if _decision(log) != "cuda-sorted":
            raise RuntimeError(f"mapped {cond}: device augment did not run the CUDA scatter")
        if not (launches == batches > MAPPED_MIN_WHOLE) or counted["coverage_scatter_add"]:
            raise RuntimeError(f"mapped {cond}: {counted} kernel launches for {batches} batches")
        ref_sha, dev_sha = _sha256(native_out), _sha256(dev_out)
        native_out.unlink()
        if ref_sha != dev_sha:
            raise RuntimeError(f"mapped {cond}: device GFA {dev_sha} != native GFA {ref_sha}")
        rejected = next(ln for ln in log.splitlines() if ln.startswith("Rejected alignments"))
        print(f"[mapped] augment --engine device on {cond}'s mapped GAF: {device_s:.3f} s "
              f"({total / device_s:.0f} reads/s), {launches} kernel launches = {batches} batches, "
              f"{rejected}, sha256 {dev_sha} == native engine's ({native_s:.2f} s in its own "
              f"process) [{label}]", flush=True)
        total_launches += launches

    batches = real_batches(label, gfa, md / "c1.gaf", tag="mapped", min_whole=MAPPED_MIN_WHOLE,
                           source="condition 1's mapped GAF")

    for cond in ("c1", "c2"):
        aug = md / f"{cond}.aug.gfa"
        host_csv, dev_csv = md / f"{cond}.host.csv", md / f"{cond}.events.csv"
        t0 = time.perf_counter()
        if cli.main(["call", *MAPPED_CALL_FLAGS, str(aug), str(gtf), "-o", str(host_csv)]):
            raise RuntimeError(f"mapped {cond}: host call failed")
        host_s = time.perf_counter() - t0
        seen, _, dev_s = _device_call([*MAPPED_CALL_FLAGS, str(aug), str(gtf), "-o",
                                       str(dev_csv)])
        host, dev = _sorted_rows(host_csv), sorted(dev_csv.read_text().splitlines())
        if dev != host:
            raise RuntimeError(f"mapped {cond}: device call rows differ from the host caller's "
                               f"({len(dev)} vs {len(host)} lines)")
        events = [r for r in host if not r.startswith("event_type,")]
        kinds = dict(sorted(Counter(",".join(r.split(",")[:2]) for r in events).items()))
        print(f"[mapped] call {' '.join(MAPPED_CALL_FLAGS)} on {cond}: device engine {dev_s:.3f} s, "
              f"host engine {host_s:.3f} s, {len(events)} rows equal {kinds}; candidates on "
              f"cuda {({f: rec['candidates'] for f, rec in seen.items()})} [{label}]", flush=True)

    _port_cli(["quant", "-a", "--c1", md / "c1.events.csv", "--c2", md / "c2.events.csv",
               "-o", md / "quant.csv"])
    _port_cli(["remap", md / "quant.csv", gtf, "-i", "20", "-o", md / "remap.csv"])
    with open(md / "scores.csv", "w") as fh:
        _port_cli(["eval", md / "sim_truth.csv", md / "remap.csv", "--relax", "5",
                   "--min-dpsi", "0.1"], stdout=fh)
    table = _recovered(md / "scores.csv", truth, "mapped")
    print(f"[mapped] quant -a, remap -i 20, eval --relax 5 --min-dpsi 0.1 against sim's truth: "
          f"every simulated ES and IR event recovered; {table} [{label}]", flush=True)
    return total_launches, batches


def _recovered(scores_csv: Path, truth: list, label: str) -> str:
    """Every simulated ES and IR event in ``eval``'s table; returns the table
    on one line."""
    table = scores_csv.read_text().strip().splitlines()
    tp = {row.split(",")[0]: int(row.split(",")[1]) for row in table[1:]}
    for etype in ("ES", "IR"):  # the kinds a graph junction can express
        want = sum(1 for t in truth if t.etype == etype)
        if not want or tp.get(etype) != want:
            raise RuntimeError(f"{label}: {tp.get(etype)} of {want} simulated {etype} events "
                               f"recovered: {table}")
    return " | ".join(table)


def exp_path(label: str, wd: Path, gfa: Path) -> None:
    """Phase 14: ``exp`` on phase 13's reads at the 10 Mbp graph, from a JSON
    config, with the pangenome pre-placed so the build is skipped; then its
    rerun, and ``plot-pr --no-figure`` and ``latex-table`` on its scores."""
    from pantas_tpu_torch.eval.compare import parse_truth

    md = wd / MAPPED_DIR
    ed = md / "exp"
    ed.mkdir()
    try:
        os.link(gfa, ed / "pantranscriptome-annotated.gfa")
    except OSError:
        shutil.copyfile(gfa, ed / "pantranscriptome-annotated.gfa")
    threads = os.cpu_count() or 1
    config = md / "exp.json"
    config.write_text(json.dumps({
        "fa": str(wd / "g.fa"), "gtf": str(wd / "g.gtf"), "vcf": str(wd / "g.vcf"),
        "workdir": str(ed),
        "conditions": {c: [[str(md / f"sim_{c}_1.fq"), str(md / f"sim_{c}_2.fq")]]
                       for c in ("c1", "c2")},
        "call": {"w": 3, "novel": True, "minintronsize": 20},
        "remap": {"min_intron_size": 20},
        "novel_sites": {"quant": True},
        "eval": {"truth": str(md / "sim_truth.csv"), "min_dpsi": 0.1, "relax": 5,
                 "cuts": [1, 3, 5]},
        "threads": threads,
    }))
    log, first_s = _port_cli(["exp", config])
    # the mapper and the coverage engine both fall back in silence: the log tells
    if ("build: reusing existing pangenome" not in log
            or log.count("[map] native alignment core") != 2 or "python path" in log
            or "native coverage unavailable" in log):
        raise RuntimeError(f"exp: the build was not skipped, or the native alignment core or "
                           f"the native coverage engine did not run: {log[-2000:]}")
    walls = dict(re.findall(r"\[exp\] (c[12]_r1): map\+call ([0-9.]+)s", log))
    for cond in ("c1", "c2"):
        if (ed / f"{cond}_r1.gaf").read_bytes() != (md / f"{cond}.gaf").read_bytes():
            raise RuntimeError(f"exp: {cond}_r1.gaf differs from phase 13's {cond}.gaf")
        host_csv = md / f"{cond}.exp_host.csv"
        with open(host_csv, "w") as fh:  # under the probe's hash seed, as exp runs
            _port_cli(["call", *MAPPED_CALL_FLAGS, md / f"{cond}.aug.gfa", wd / "g.gtf"],
                      stdout=fh)
        rows = sorted((ed / f"{cond}_r1.events.csv").read_text().splitlines())
        if rows != _sorted_rows(host_csv) or len(rows) < 2:
            raise RuntimeError(f"exp: {cond}_r1.events.csv ({len(rows)} rows) differs from "
                               f"the host call on phase 13's device-augmented GFA")
    missing = [n for n in ("sites_quant.csv", "scores.csv", "scores_by_cut.csv", "c1_r1.sites.csv",
                           "c2_r1.sites.csv") if not (ed / n).exists()]
    if missing:
        raise RuntimeError(f"exp wrote no {missing}")
    scores = _recovered(ed / "scores.csv", parse_truth(str(md / "sim_truth.csv")), "exp")
    n_events = re.search(r"quant-remap: (\d+) events", log).group(1)

    again, rerun_s = _port_cli(["exp", config])
    if "map+call" in again or again.count("reusing") != 3:
        raise RuntimeError(f"exp rerun did not reuse every stage: {again[-2000:]}")

    tables = {}
    for argv in (["plot-pr", ed / "cmp.csv", "--scores", f"3={ed / 'scores_by_cut.csv'}",
                  "--no-figure"], ["latex-table", ed / "cmp.csv"]):
        out = md / f"{argv[0]}.txt"
        with open(out, "w") as fh:
            _port_cli(argv, stdout=fh)
        tables[argv[0]] = out.read_text().strip().splitlines()
        if len(tables[argv[0]]) < 2:
            raise RuntimeError(f"{argv[0]} printed {tables[argv[0]]}")
    print(f"[exp] exp at the 10 Mbp graph on phase 13's reads, -t {threads}: first run "
          f"{first_s:.2f} s (map+call c1 {walls.get('c1_r1')} s, c2 {walls.get('c2_r1')} s), "
          f"rerun {rerun_s:.2f} s (every stage reused); build skipped, native alignment core "
          f"and native coverage engine, GAFs byte-equal to phase 13's, events rows equal to "
          f"the host call's under one hash seed, {n_events} quant-remap events, every "
          f"simulated ES and IR event recovered; {scores} [{label}]", flush=True)
    for name, lines in tables.items():
        print(f"[exp] {name}: " + " | ".join(lines) + f" [{label}]", flush=True)


# phase 15: the repo's 100 Mbp graph (ensure_graph's own shape at that size) and its reads,
# made by a process of their own while phases 2-14 and 17 run (~10 min on 8 cores)
BIG_MBP = 100
BIG_READS = 1_000_000
BIG_BUCKET = 1 << 28
BIG_INPUTS_TIMEOUT_S = 1000  # from the start of that process
BIG_INPUTS = """
import os, sys, time
from pantas_tpu_torch.eval.synth import ensure_graph, synth_gaf
mbp, reads = float(sys.argv[1]), int(sys.argv[2])
t0 = time.perf_counter()
wd = ensure_graph(mbp)
print(f"[big-inputs] ensure_graph {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
gaf = wd / f"reads_{reads}.gaf"
t0 = time.perf_counter()
if not gaf.exists():
    synth_gaf(wd / "out" / "pantranscriptome-annotated.gfa", reads, gaf.with_suffix(".tmp"))
    os.replace(gaf.with_suffix(".tmp"), gaf)
print(f"[big-inputs] synth_gaf {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
"""


def start_big_inputs() -> tuple:
    """Start the process that makes phase 15's graph and reads, in a session
    of its own so that :func:`stop_big_inputs` also reaches its build
    workers (its stderr in ``.bench/big_inputs.log``); returns (it, its log,
    when it started)."""
    log = REPO / ".bench" / "big_inputs.log"
    log.parent.mkdir(exist_ok=True)
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c", BIG_INPUTS, str(BIG_MBP), str(BIG_READS)], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=str(REPO)), stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, stderr=fh, start_new_session=True)
    return proc, log, time.perf_counter()


def stop_big_inputs(proc) -> None:
    """Kill the inputs' process and its workers if it is still running."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def big_path(label: str, inputs: tuple) -> dict:
    """Phase 15: the 100 Mbp graph in its 2^28 bucket: its inputs (from the
    process of :func:`start_big_inputs`), the real batches through both
    kernels, and ``bench_scaling`` on a logical mesh of the card. Returns
    kernel #1's launches in the scaling bench and the real batches' record of
    ``real_batches``."""
    import runpy

    from pantas_tpu_torch.coverage import kernels
    from pantas_tpu_torch.eval.synth import ensure_graph
    from pantas_tpu_torch.graph.compiler import compile_gfa

    proc, log_path, started = inputs
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=max(1.0, BIG_INPUTS_TIMEOUT_S - (t0 - started)))
    except subprocess.TimeoutExpired:
        stop_big_inputs(proc)
        raise RuntimeError(f"the {BIG_MBP} Mbp inputs took over {BIG_INPUTS_TIMEOUT_S} s: "
                           f"{log_path.read_text()[-1500:]}") from None
    waited_s = time.perf_counter() - t0
    made = log_path.read_text()
    if rc:
        raise RuntimeError(f"the {BIG_MBP} Mbp inputs failed ({rc}): {made[-1500:]}")
    graph_s, reads_s = (float(x) for x in re.findall(r"\[big-inputs\] \w+ ([0-9.]+) s", made))
    wd = ensure_graph(BIG_MBP)  # made: this returns at once
    gfa = wd / "out" / "pantranscriptome-annotated.gfa"
    gaf = wd / f"reads_{BIG_READS}.gaf"
    t0 = time.perf_counter()
    gfa_sha = _sha256(gfa)
    hash_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tensors = compile_gfa(str(gfa))
    tensorize_s = time.perf_counter() - t0
    bucket = max(1 << 12, 1 << (tensors.total_slots - 1).bit_length())
    if bucket != BIG_BUCKET:
        raise RuntimeError(f"{tensors.total_slots} slots fall in a 2^{bucket.bit_length() - 1} "
                           f"bucket, not 2^{BIG_BUCKET.bit_length() - 1}")
    print(f"[big] inputs, made while phases 2-14 and 17 ran: ensure_graph({BIG_MBP}) {graph_s:.1f} s, "
          f"synth_gaf {BIG_READS} reads {reads_s:.1f} s, phase 15 waited {waited_s:.1f} s; GFA "
          f"{gfa.stat().st_size} B, {tensors.n_nodes} nodes, "
          f"{tensors.total_slots} count slots in a 2^{BIG_BUCKET.bit_length() - 1} bucket "
          f"({-(-BIG_BUCKET // kernels.WINDOW)} windows), sha256 {gfa_sha} ({hash_s:.1f} s); "
          f"GAF {gaf.stat().st_size} B; tensorize {tensorize_s:.1f} s [{label}]", flush=True)

    real = real_batches(label, gfa, gaf, tag="real100", tensors=tensors,
                        source=f"the {BIG_MBP} Mbp graph's {BIG_READS}-read GAF")
    del tensors

    said = io.StringIO()
    saved_argv = sys.argv
    saved_env = os.environ.pop("PANTAS_SCATTER", None)
    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    t0 = time.perf_counter()
    try:
        sys.argv = ["bench_scaling"]
        with contextlib.redirect_stdout(_Tee(sys.stdout, said)):
            runpy.run_module("pantas_tpu_torch.scripts.bench_scaling", run_name="__main__")
        torch.cuda.synchronize()
    finally:
        sys.argv = saved_argv
        if saved_env is not None:
            os.environ["PANTAS_SCATTER"] = saved_env
    scale_s = time.perf_counter() - t0
    scale_launches = kernels.LAUNCHES["sorted_coverage_scatter_add"]
    report = json.loads(said.getvalue().strip().splitlines()[-1])
    shards = [r["devices"] for r in report["scaling"]]
    if (shards != [1, 2, 4, 8] or not all(r["bit_exact"] for r in report["scaling"])
            or report["platform"] != "cuda" or kernels.LAUNCHES["coverage_scatter_add"]
            or scale_launches != 4 * sum(shards)):
        raise RuntimeError(f"bench_scaling on a logical mesh of the card: {report}, "
                           f"{dict(kernels.LAUNCHES)} launches")
    print(f"[big] python -m pantas_tpu_torch.scripts.bench_scaling (8 shards, 2^23 indices, "
          f"2^20 slots) on a logical mesh of the card: bit-exact at d = {shards}, "
          f"{scale_launches} kernel launches = 4 steps x shards, {scale_s:.2f} s; shards sharing "
          f"a card measure nothing about scaling [{label}]", flush=True)
    return {"scale_launches": scale_launches, "real": real}


# phase 16: the port's bench at a cut multiplier (the root bench's is 2000; the stage's
# work barely moves with it, the process starts and the 100 Mbp runs do not)
BENCH_MULTIPLIER = 200
BENCH_TIMEOUT_S = 420
BENCH_DEVICE_RUNS = 10  # the warm-up, three A/B pairs, the CPU run, two at 100 Mbp
BENCH_KERNEL_RUNS = 5  # of which kernel #1 runs in the three unset and the two at 100 Mbp


def _genome_runs(log: str) -> list:
    """The bench's two device augments on the 100 Mbp graph, from its log:
    each must have run the CUDA sorted scatter on 2^28 slots, launched kernel
    #1 once a batch and kernel #2 never. Returns, for each, its seconds,
    kernel #1's launches, batches and predicted batches."""
    runs = []
    for line in log.splitlines():
        if "genome-scale device augment run" not in line:
            continue
        impl = re.search(r"scatter impl: (\S+) \((\d+) slots, ~(\d+) batches expected", line)
        batches = int(re.search(r"for (\d+) batches", line)[1])
        first, second = (int(re.search(rf"'{k}': (\d+)", line)[1])
                         for k in ("sorted_coverage_scatter_add", "coverage_scatter_add"))
        if (impl is None or impl[1] != "cuda-sorted" or int(impl[2]) != BIG_BUCKET
                or not first == batches >= 1 or second):
            raise RuntimeError(f"the bench's {BIG_MBP} Mbp device run is not kernel #1 once a "
                               f"batch on {BIG_BUCKET} slots: {line}")
        runs.append({"s": float(re.search(r"reads in ([0-9.]+)s", line)[1]),
                     "launches": batches, "batches": batches, "predicted": int(impl[3])})
    if len(runs) != 2:
        raise RuntimeError(f"the bench's log holds {len(runs)} {BIG_MBP} Mbp device runs, not 2")
    return runs


def bench_path(label: str) -> dict:
    """Phase 16: ``python -m pantas_tpu_torch.bench`` on the card, checked by
    its exit code, its last line and the checks its log reports. Returns
    kernel #1's launches over the bench and in its first 100 Mbp run."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pantas_tpu_torch.bench", "--multiplier", str(BENCH_MULTIPLIER)],
        capture_output=True, text=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        stdin=subprocess.DEVNULL, timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    log = proc.stderr
    if proc.returncode:
        raise RuntimeError(f"the bench exited {proc.returncode}: {log[-3000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    if list(result) != ["metric", "value", "unit", "vs_baseline"] or not result["value"] > 0:
        raise RuntimeError(f"the bench's last line is {result}")
    launches, runs = map(int, re.search(
        r"kernel #1 launches over the bench: (\d+), one a batch in each of the (\d+) device",
        log).groups())
    chose = re.search(r"auto on a fresh cache chose (\S+)", log)
    said = {
        "device call rows equal": "rows equal to the host caller's" in log,
        "device runs sha256-equal": log.count("sha256 == native engine's") == BENCH_DEVICE_RUNS,
        "2^28 bucket": f"bucket {BIG_BUCKET})" in log,
        "auto choice logged": chose is not None,
        "100 Mbp cache read": "cached 100 Mbp workload absent" not in log,
        "kernel #1 launched, one a batch": launches > 0 and runs == BENCH_KERNEL_RUNS,
    }
    if not all(said.values()):
        raise RuntimeError(f"the bench's log fails {[k for k, v in said.items() if not v]}: "
                           f"{log[-3000:]}")
    genome = _genome_runs(log)
    keep = ("call (ours)", "call --novel", "call --engine device", "auto on a fresh cache",
            "device path", "genome", "native best-of-3", "kernel #1 launches over")
    for line in log.splitlines():
        if line.startswith("[bench] ") and any(k in line for k in keep):
            print(line, flush=True)
    print(f"[bench] python -m pantas_tpu_torch.bench --multiplier {BENCH_MULTIPLIER}: exit 0 "
          f"in {seconds:.1f} s, {json.dumps(result)}; checks held: {sorted(said)}; auto on a "
          f"fresh cache chose {chose.group(1)}; kernel #1 launches {launches} = the batches "
          f"of the {runs} runs that chose it; at {BIG_MBP} Mbp in the 2^28 bucket "
          f"{[r['launches'] for r in genome]} launches = batches (~{genome[0]['predicted']} "
          f"predicted), {[r['s'] for r in genome]} s [{label}]", flush=True)
    return {"launches": launches, "launches_2p28": genome[0]["launches"]}


# phase 17: the full-scale experiment on the device engines at a cut size (pairs per
# replicate, replicates per condition, Mbp: phase 3's graph)
FULLSCALE_ARGS = ["100000", "1", "10"]
FULLSCALE_DIR = "smoke_fullscale"
FULLSCALE_TIMEOUT_S = 600


def replicate_kernels(label: str, wd: Path, gfa: Path) -> dict:
    """Condition 1's mapped reads of a ``run_fullscale_experiment --engine
    device`` work dir ``wd`` on the kernels: one device augment of
    ``c1_r1.gaf`` in this process by ``bench.device_run`` (with
    ``PANTAS_SCATTER`` unset: the sorted kernel, launches = batches, sha256
    equal to the native engine's in the script's ``c1_r1.device.json``; its
    split by the program's spans), then phase 9's ``real_batches`` on its
    slot batches. Returns the run's record and that of ``real_batches``."""
    from pantas_tpu_torch.bench import device_run

    gaf, out = wd / "c1_r1.gaf", wd / "c1_r1.kernels.gfa"
    held = json.loads((wd / "c1_r1.device.json").read_text())
    saved = os.environ.pop("PANTAS_SCATTER", None)
    try:
        rec = device_run(gaf, gfa, out, "cuda")
    finally:
        if saved is not None:
            os.environ["PANTAS_SCATTER"] = saved
    sha = _sha256(out)
    out.unlink()
    launches = rec["launches"]["sorted_coverage_scatter_add"]
    if (rec["impl"][-1].split(" (")[0] != "cuda-sorted" or launches != rec["batches"]
            or rec["launches"]["coverage_scatter_add"] or rec["batches"] != held["batches"]):
        raise RuntimeError(f"{wd.name}: device augment of c1_r1 in process: {rec}, the "
                           f"script's record {held}")
    if sha != held["native_sha256"]:
        raise RuntimeError(f"{wd.name}: c1_r1's device GFA {sha} != native engine's "
                           f"{held['native_sha256']}")
    print(f"[replicate] {wd.name}: augment --engine device of c1_r1 ({gaf.stat().st_size} B "
          f"GAF) in a process's first device augment here: {rec['s']:.3f} s, {launches} kernel "
          f"launches = {rec['batches']} batches (~{held['batches_expected']} expected), "
          f"sha256 == native engine's; split {json.dumps(rec['split'])} [{label}]", flush=True)
    real = real_batches(label, gfa, gaf, tag="replicate",
                        source=f"{wd.name}'s c1_r1 mapped reads")
    return {"run": rec, "real": real}


def compressed_big(label: str) -> dict:
    """Not a phase: after a run of this script, whose phase 15 leaves the
    100 Mbp graph and its 1M reads under ``.bench/stress100m``, ``augment
    --engine device`` on them through the port's CLI with a plain ``-o`` and
    with ``-o *.zst``. The decompressed sha256 (by the port's reader and by
    libzstd's one-shot ``ZSTD_decompress``) must equal the plain one,
    kernel #1's launches the batches, and the native emitter must have
    written every byte of the GFA (its span ``native.emit`` and its counter
    ``emit.bytes_out``, traced by ``bench.traced``). Run it as ``python3 -c "import chip_smoke as s;
    from pantas_tpu_torch import backend; s.compressed_big(backend.card_label())"``."""
    from pantas_tpu_torch import cli
    from pantas_tpu_torch.bench import traced

    wd = REPO / ".bench" / f"stress{BIG_MBP}m"
    gfa, gaf = wd / "out" / "pantranscriptome-annotated.gfa", wd / f"reads_{BIG_READS}.gaf"
    if not (gfa.exists() and gaf.exists()):
        raise RuntimeError(f"{gfa} or {gaf} is missing: run chip_smoke.py first")
    rec = {}
    for name in ("plain", "zst"):
        out = wd / ("smoke_big.gfa" if name == "plain" else "smoke_big.gfa.zst")

        def run(out):
            return cli.main(["augment", "--engine", "device", str(gaf), str(gfa),
                             "-o", str(out)])

        try:
            with traced() as got:
                log, counted, seconds, batches = _device_augment(gaf, gfa, out, {}, run)
            launches = _kernel1_checked(counted, batches, f"100 Mbp -o {out.name}")
            t0 = time.perf_counter()
            sha, plain_bytes = _decompressed_sha256(out)
            rec[name] = {"s": seconds, "launches": launches, "batches": batches,
                         "bytes": out.stat().st_size, "sha256": sha,
                         "plain_bytes": plain_bytes, "hash_s": time.perf_counter() - t0,
                         "native_emit_bytes": got["counters"].get("emit.bytes_out")}
            if name == "zst" and _one_shot_sha256(out, plain_bytes) != sha:
                raise RuntimeError("100 Mbp -o *.zst: the one-shot decode differs")
        finally:
            out.unlink(missing_ok=True)
        if (_decision(log) != "cuda-sorted" or "native.emit" not in got["spans"]
                or rec[name]["native_emit_bytes"] != plain_bytes):
            raise RuntimeError(f"100 Mbp -o {out.name}: {_decision(log)}, the native emitter "
                               f"wrote {rec[name]['native_emit_bytes']} of {plain_bytes} B")
    plain, zst = rec["plain"], rec["zst"]
    if zst["sha256"] != plain["sha256"]:
        raise RuntimeError(f"100 Mbp: -o *.zst {zst}, plain {plain}")
    print(f"[compressed-100m] augment --engine device, {BIG_MBP} Mbp graph, {BIG_READS} reads: "
          f"plain -o {plain['s']:.3f} s ({plain['bytes']} B), -o *.zst by libzstd "
          f"{zst['s']:.3f} s "
          f"({zst['bytes']} B, decompressed and hashed in {zst['hash_s']:.3f} s; the same sha256 "
          f"by ZSTD_decompress), both sha256 "
          f"{plain['sha256']}; kernel #1 launches = batches ({plain['batches']}, "
          f"{zst['batches']}); the native emitter wrote every byte of both [{label}]",
          flush=True)
    return rec


def fullscale_path(label: str) -> dict:
    """Phase 17: ``run_fullscale_experiment --mode both --engine device`` at
    ``FULLSCALE_ARGS`` as a subprocess, checked by its exit code, its log and
    its records; then :func:`replicate_kernels` on its work dir, which is
    deleted after. Returns kernel #1's launches over the script's device
    augments (from their ``<tag>.device.json``) and the record of
    :func:`replicate_kernels`."""
    from pantas_tpu_torch.eval.synth import ensure_graph

    wd = REPO / ".bench" / FULLSCALE_DIR
    shutil.rmtree(wd, ignore_errors=True)
    gfa = ensure_graph(float(FULLSCALE_ARGS[2])) / "out" / "pantranscriptome-annotated.gfa"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("PANTAS_SCATTER", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pantas_tpu_torch.scripts.run_fullscale_experiment", "--mode",
         "both", "--engine", "device", "--wd", FULLSCALE_DIR, *FULLSCALE_ARGS],
        capture_output=True, text=True, cwd=REPO, env=env, stdin=subprocess.DEVNULL,
        timeout=FULLSCALE_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    log = proc.stderr
    try:
        if proc.returncode:
            raise RuntimeError(f"run_fullscale_experiment exited {proc.returncode}: {log[-3000:]}")
        if "generating" in log:
            raise RuntimeError("run_fullscale_experiment built its own graph: phase 3's is not "
                               "where bench_call_scale.ensure_graph looks")
        # the script held each device augment (scatter, no fallback, launches = batches,
        # sha256) and fused == staged, or it would not have exited 0: read its records
        records = [json.loads((wd / f"{tag}.device.json").read_text())
                   for tag in ("c1_r1", "c2_r1")]
        launches = sum(rec["launches"] for rec in records)
        rows = re.findall(r"(c[12]_r1): fused == staged \((\d+) events\)", log)
        said = [f"{rec['tag']} {rec['launches']} launches = {rec['batches']} batches "
                f"(~{rec['batches_expected']} expected)" for rec in records]
        remapped = re.search(r"quant-remap: (\d+) events", log)
        if remapped is None or int(remapped[1]) < 1:
            raise RuntimeError(f"quant-remap reported no events: {log[-1500:]}")
        walls = {}  # stage: wall seconds of each run, from the script's bench.csv
        for ln in (wd / "bench.csv").read_text().splitlines()[1:]:
            f = ln.split(",")
            walls.setdefault(f[1], []).append(float(f[5]))
        if {k: len(v) for k, v in walls.items()} != {
                "map": 2, "augment": 2, "augment-native": 2, "call": 2, "replicate": 2,
                "quant": 1, "remap": 1}:
            raise RuntimeError(f"bench.csv stages {walls}")
        print(f"[fullscale] run_fullscale_experiment --mode both --engine device "
              f"{' '.join(FULLSCALE_ARGS)} (phase 3's graph): exit 0 in {seconds:.1f} s; "
              f"{'; '.join(said)}; every device GFA sha256 == native engine's, device-staged "
              f"rows == fused host rows {dict(rows)}; quant-remap {remapped[1]} events; stage "
              f"walls s {json.dumps(walls)} [{label}]", flush=True)
        kernels_rec = replicate_kernels(label, wd, gfa)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    return {"launches": launches, **kernels_rec}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card", file=sys.stderr)
        return 1
    from pantas_tpu_torch import backend
    from pantas_tpu_torch.coverage import _build

    label = backend.card_label()
    kind = torch.cuda.get_device_name(0)
    print(label, flush=True)
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: {kind}",
          flush=True)

    t0 = time.perf_counter()
    cached = _build.library_path().exists()
    lib = _build.build()
    grid = _build.load().coverage_histogram_grid(torch.cuda.current_device())
    direct_grid = _build.load().coverage_direct_grid(torch.cuda.current_device())
    if grid <= 0 or direct_grid <= 0:
        raise RuntimeError(f"coverage_histogram_grid ({grid}) or coverage_direct_grid "
                           f"({direct_grid}) failed")
    print(f"[build] {lib.relative_to(REPO)} in {time.perf_counter() - t0:.2f} s"
          f"{' (already built)' if cached else ''}; persistent grids: histogram {grid} CTAs, "
          f"direct kernel {direct_grid} CTAs, "
          f"on {torch.cuda.get_device_properties(0).multi_processor_count} SMs", flush=True)
    ptxas = lib.with_suffix(".log")
    if ptxas.exists():
        print(ptxas.read_text().strip(), flush=True)
    from pantas_tpu_torch.native import gafcov, gfaload

    t0 = time.perf_counter()
    native = gafcov.build_library()
    native_s = time.perf_counter() - t0
    ext = gfaload.get_module()
    loader = (Path(ext.__file__).relative_to(REPO) if ext is not None
              else "not built: the pure-Python GFA loader is used")
    print(f"[build] native engine {native.relative_to(REPO)} in {native_s:.2f} s; GFA loader "
          f"extension {loader} in {time.perf_counter() - t0 - native_s:.2f} s", flush=True)
    big_inputs = start_big_inputs()
    try:
        return _phases(label, kind, big_inputs)
    finally:
        stop_big_inputs(big_inputs[0])


def _phases(label: str, kind: str, big_inputs: tuple) -> int:
    """Phases 2-18, then the kernels' record and the last line."""
    shapes = [kernel_vs_plain(25, 25, label), kernel_vs_plain(28, 28, label)]
    direct = [direct_vs_plain(25, 25, label), direct_vs_plain(28, 28, label)]
    uniform = [uniform_vs_plain(25, label), uniform_vs_plain(28, label)]
    one_slot = [one_slot_vs_plain(25, label), one_slot_vs_plain(28, label)]
    wd, gfa, gaf = _inputs()
    launches, ref_sha, aug, plain_s = main_path(label, wd, gfa, gaf)
    try:
        coverage = default_coverage(gfa)
        raw_launches = raw_race(label)
        race_path(label, wd, gfa, gaf, ref_sha)
        call_rows = call_path(label, wd, aug, coverage)
        mesh_launches = mesh_path(label, wd, gfa, gaf, ref_sha)
        real = real_batches(label, gfa, gaf)
    finally:
        aug.unlink()
    dist_launches = dist_path(label, wd, gfa, gaf, ref_sha, launches)
    entry_points(label, wd, gfa, gaf, call_rows)
    try:
        mapped_launches, mapped = mapped_path(label, wd, gfa)
        exp_path(label, wd, gfa)
    finally:
        shutil.rmtree(wd / MAPPED_DIR, ignore_errors=True)
    compressed_launches = compressed_path(label, wd, gfa, gaf, ref_sha, plain_s)
    fullscale = fullscale_path(label)  # on the 10 Mbp graph while the 100 Mbp inputs are made
    big = big_path(label, big_inputs)
    bench = bench_path(label)
    device_us = profile_split(25, label)
    profile_split(28, label)
    isolation()

    print(json.dumps({"kernels": [{
        "name": "sorted_coverage_scatter_add",
        "route": "cuda",
        "source": "pantas_tpu_torch/csrc/coverage_scatter.cu",
        "replaces": "pantas_tpu/coverage/pallas_kernel.py:129",
        "launches": launches,  # the single-device main path (phase 3)
        "mesh_launches": mesh_launches,  # phase 8's four runs together
        "dist_launches": dist_launches,  # phase 11's ranks, both runs together
        "mapped_launches": mapped_launches,  # phase 13's two conditions together
        "compressed_launches": compressed_launches,  # phase 18's four runs together
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": shapes[0]["ms"],  # the main path's 2^25 bucket
        "plain_ms": shapes[0]["plain_ms"],
        "bound_ms": shapes[0]["bound_ms"],
        "bound_by": shapes[0]["bound_by"],
        "library_ms": shapes[0]["library_ms"],
        # the stage's own batches at 2^25: [kernel, one bare index_add_, bound] ms
        "real_batch_ms": {k: [v["sorted"], v["library"], v["bound_ms"]] for k, v in real.items()},
        "mapped_batch_ms": {k: [v["sorted"], v["library"], v["bound_ms"]]
                            for k, v in mapped.items()},
        # phase 16's first 100 Mbp stage's launches; phase 15: its real batches at 2^28
        # ([kernel, one bare index_add_, bound] ms) and bench_scaling's launches
        "launches_2p28": bench["launches_2p28"],
        "real_batch_2p28_ms": {k: [v["sorted"], v["library"], v["bound_ms"]]
                               for k, v in big["real"].items()},
        "scale_launches": big["scale_launches"],
        "bench_launches": bench["launches"],  # phase 16: python -m pantas_tpu_torch.bench
        # phase 17: the full-scale experiment's device augments (from their logs), the
        # in-process run of condition 1, and its mapped batches at 2^25
        "fullscale_launches": fullscale["launches"],
        "fullscale_probe_launches": fullscale["run"]["launches"]["sorted_coverage_scatter_add"],
        "fullscale_batch_ms": {k: [v["sorted"], v["library"], v["bound_ms"]]
                               for k, v in fullscale["real"].items()},
    }, {
        "name": "coverage_scatter_add",
        "route": "cuda",
        "source": "pantas_tpu_torch/csrc/coverage_direct.cu",
        "replaces": "pantas_tpu/coverage/pallas_kernel.py:36",
        "launches": raw_launches["coverage_scatter_add"],  # its path: the raw race
        "max_abs_err": max(s["max_abs_err"] for s in direct),
        "ms": direct[0]["ms"],
        "plain_ms": direct[0]["plain_ms"],
        "bound_ms": direct[0]["bound_ms"],
        "bound_by": direct[0]["bound_by"],
        "library_ms": direct[0]["library_ms"],
        # beyond the smoke batch, at 2^25: [kernel, one bare index_add_, bound] ms
        "uniform_ms": [uniform[0]["direct"], uniform[0]["library"], uniform[0]["bound_ms"]],
        "one_slot_ms": [one_slot[0]["direct"], one_slot[0]["library"], one_slot[0]["bound_ms"]],
        "real_batch_ms": {k: [v["direct"], v["library"], v["bound_ms"]] for k, v in real.items()},
        "mapped_batch_ms": {k: [v["direct"], v["library"], v["bound_ms"]]
                            for k, v in mapped.items()},
        "real_batch_2p28_ms": {k: [v["direct"], v["library"], v["bound_ms"]]
                               for k, v in big["real"].items()},
        "fullscale_batch_ms": {k: [v["direct"], v["library"], v["bound_ms"]]
                               for k, v in fullscale["real"].items()},
        "device_us": {k: (v["direct"] or {}).get("direct_scatter") for k, v in device_us.items()},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
