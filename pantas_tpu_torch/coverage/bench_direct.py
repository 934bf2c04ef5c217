"""Time the direct kernel on the card by device time, on the batches that matter.

``kernels.coverage_scatter_add`` beside one bare ``index_add_`` call on
prepared indices (the library yardstick, used nowhere in the port), each held
exactly against ``index_add_`` first. It is also how the kernel's design
alternatives were compared while the source held them (a combining table in
shared memory, four consecutive indices a lane, coalesced 4-byte loads, caps
on the grid): PERF.md has their times. Run from the root of a checkout, on a
machine with a CUDA card:

    python -m pantas_tpu_torch.coverage.bench_direct [--real]

Batches of 2^20 indices: uniform in [-1, n) at 2^25 and 2^28 count slots; at
2^25 the smoke batch (10% padding, one 10,000-long run) and all indices on one
slot; with ``--real`` the first, a middle and the last slot batch of the
10 Mbp synthetic pangenome with 1M reads (``eval.synth``, built under
``.bench/`` if absent, about two minutes), as the augment stage streams them.

It prints the card's ``name, power.limit``; the persistent grid and what the
compiled kernel does with its atomics (``RED*`` waits for no result,
``ATOM*`` does; from ``cuobjdump -sass``); one JSON line per batch with what
the batch looks like and, for the kernel and for ``index_add_``, ``call_ms``
(median of 25 single calls by CUDA events, which includes the host time of
the call) and ``device_ms`` (per launch of 20 captured in a CUDA graph and
replayed, which leaves the host out); and the host microseconds one call
takes to queue, through the wrapper and through the bare C entry point.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from pantas_tpu_torch import backend
from pantas_tpu_torch.coverage import _build, bench_scatter, kernels

BATCH = 1 << 20
REPS, WARM, QUEUED = 25, 3, 20


def _events_ms(fn) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _captured(fn) -> torch.cuda.CUDAGraph:
    """QUEUED launches of ``fn`` as one CUDA graph: its replay queues them
    with no host work in between."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(QUEUED):
            fn()
    return graph


def _timed(fns: dict) -> dict:
    """Per callable: the median ms of REPS single calls, and of REPS replays
    of QUEUED captured launches per launch, taken in turns (the order flips
    every round)."""
    for f in fns.values():
        for _ in range(WARM):
            f()
    torch.cuda.synchronize()
    graphs = {k: _captured(f) for k, f in fns.items()}
    names = list(fns)
    one, many = {k: [] for k in fns}, {k: [] for k in fns}
    for r in range(REPS):
        for k in names if r % 2 == 0 else names[::-1]:
            one[k].append(_events_ms(fns[k]))
            many[k].append(_events_ms(graphs[k].replay) / QUEUED)
    return {k: {"call_ms": round(statistics.median(one[k]), 5),
                "device_ms": round(statistics.median(many[k]), 5)} for k in fns}


def time_batch(what: str, n: int, idx: np.ndarray) -> dict:
    """The kernel on one batch: exact against ``index_add_``, then timed."""
    d_idx = torch.from_numpy(idx).cuda()
    valid = d_idx[d_idx >= 0].long()
    ones = torch.ones(valid.numel(), dtype=torch.int32, device="cuda")
    want = torch.zeros(n, dtype=torch.int32, device="cuda").index_add_(0, valid, ones)
    counts = torch.zeros(n, dtype=torch.int32, device="cuda")
    kernels.coverage_scatter_add(counts, d_idx)
    if not torch.equal(counts, want):
        raise RuntimeError(f"direct kernel != index_add_ on the {what} batch")
    fns = {"kernel": lambda: kernels.coverage_scatter_add(counts, d_idx),
           "index_add_": lambda: want.index_add_(0, valid, ones)}
    rec = {"batch": what, "log2_slots": n.bit_length() - 1, **bench_scatter.batch_stats(idx),
           "ms": _timed(fns)}
    del counts, want
    torch.cuda.empty_cache()
    return rec


def host_us(n: int = 1 << 25, calls: int = 2000) -> dict:
    """Host microseconds to queue one call on the one-slot batch (a few
    microseconds of device time, so the queue never fills): through the
    wrapper, and through the bare C entry point with its arguments ready."""
    d_idx = torch.full((BATCH,), n // 3, dtype=torch.int32, device="cuda")
    counts = torch.zeros(n, dtype=torch.int32, device="cuda")
    kernels.coverage_scatter_add(counts, d_idx)
    lib = _build.load()
    args = (counts.device.index, counts.data_ptr(), n, d_idx.data_ptr(), d_idx.numel(),
            torch.cuda.current_stream().cuda_stream)
    out = {}
    for name, fn in (("wrapper", lambda: kernels.coverage_scatter_add(counts, d_idx)),
                     ("bare_c_call", lambda: lib.coverage_scatter_direct(*args))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = round((time.perf_counter() - t0) / calls * 1e6, 2)
        torch.cuda.synchronize()
    return out


def sass_atomics() -> dict:
    """Per compiled ``direct_scatter`` kernel, its atomic instructions by
    opcode (``RED*`` returns nothing, ``ATOM*`` returns the old value;
    ``ATOMS`` is shared memory's)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.access(tool, os.X_OK):
        return {"error": "cuobjdump not found"}
    sass = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if "direct_scatter" in name else None
            if name:
                out[name] = {}
        elif name:
            for word in line.replace(";", " ").split():
                if word.startswith(("RED", "ATOM")):
                    out[name][word] = out[name].get(word, 0) + 1
    return out


def _real_batches() -> dict:
    """first / middle / last slot batch of the 10 Mbp cell, and its bucket."""
    from pantas_tpu_torch.eval.synth import ensure_graph, synth_gaf
    from pantas_tpu_torch.graph.compiler import compile_gfa

    wd = ensure_graph(10)
    gfa = wd / "out" / "pantranscriptome-annotated.gfa"
    gaf = wd / "reads_1000000.gaf"
    if not gaf.exists():
        tmp = gaf.with_suffix(".tmp")
        synth_gaf(gfa, 1_000_000, tmp)
        os.replace(tmp, gaf)
    tensors = compile_gfa(str(gfa))
    batches = bench_scatter.slot_batches(str(gaf), tensors, BATCH)
    n = 1 << (tensors.total_slots - 1).bit_length()
    picks = {"first": 0, "middle": len(batches) // 2, "last": len(batches) - 1}
    return {f"real-{k}-of-{len(batches)}": (n, batches[i]) for k, i in picks.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pantas_tpu_torch.coverage.bench_direct")
    ap.add_argument("--real", action="store_true",
                    help="also the 10 Mbp cell's real slot batches (builds its inputs if absent)")
    args = ap.parse_args(argv)
    backend.device("cuda")
    print(backend.card_label(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _build.load()
    print(json.dumps({"sms": sms, "persistent_grid_ctas": lib.coverage_direct_grid(0),
                      "sass": sass_atomics()}), flush=True)

    rng = np.random.default_rng(26)
    n25, n28 = 1 << 25, 1 << 28
    smoke = rng.integers(0, n25, size=BATCH, dtype=np.int32)
    smoke[rng.random(BATCH) < 0.10] = -1
    smoke[5000:15000] = n25 - 1
    batches = {
        "uniform": (n25, rng.integers(-1, n25, size=BATCH, dtype=np.int32)),
        "uniform-2^28": (n28, rng.integers(-1, n28, size=BATCH, dtype=np.int32)),
        "smoke": (n25, smoke),
        "one-slot": (n25, np.full(BATCH, n25 // 3, dtype=np.int32)),
    }
    if args.real:
        batches.update(_real_batches())
    for what, (n, idx) in batches.items():
        print(json.dumps(time_batch(what, n, idx)), flush=True)
    print(json.dumps({"host_us_per_call": host_us()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
