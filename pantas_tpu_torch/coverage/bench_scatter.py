"""Race the coverage scatter-add implementations on the card.

Counterpart of ``scripts/bench_scatter_tpu.py``: every impl of
:data:`.scatter_impls.SCATTER_IMPLS` (``plain`` ``index_add_``, the sorted
kernel, the direct kernel) on the same seeded batch, verified by 4096 probed
slots and the sum, then timed as the best of three host-clocked calls that
end in a synchronise. Run from the root of a checkout, on a machine with a
CUDA card:

    python -m pantas_tpu_torch.coverage.bench_scatter [n_slots] [streams...]

It prints the card's ``name, power.limit``, then one JSON line per impl and
stream size. An impl that fails or verifies wrong raises: the exit code is
non-zero.

:func:`slot_batches` and :func:`batch_stats` serve the measurements on real
traffic (``chip_smoke.py``, ``bench_direct``): the slot batches of a GAF as the
augment stage would hand them to the scatter, and what a batch looks like.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from pantas_tpu_torch import backend
from pantas_tpu_torch.coverage.scatter_impls import raw_race


def run(n_slots: int, streams, device):
    """One record per impl and stream size, as printed by :func:`main`."""
    for m in streams:
        for name, t in raw_race(n_slots, m, device).items():
            yield {
                "metric": "scatter_add", "impl": name, "n_slots": n_slots, "stream": m,
                "correct": True,  # raw_race raised otherwise
                "first_run_s": round(t["first_run_s"], 6),
                "best_s": round(t["best_s"], 6),
                "m_idx_per_s": round(m / t["best_s"] / 1e6, 1),
            }


def slot_batches(gaf_path: str, tensors, flush_every: int = 1 << 20, mapq_thr=None) -> list:
    """The int32 slot batches of ``gaf_path`` on the graph ``tensors``, on the
    host, exactly as ``augment --engine device`` streams them to the scatter
    (``coverage.device.augment_gfa_device_native``): the native parser
    fills buffers of ``flush_every`` indices, the last padded with ``-1``."""
    from pantas_tpu_torch.coverage import device

    eng = device._native_engine(tensors)
    thr = device.DEFAULT_MAPQ_THR if mapq_thr is None else mapq_thr
    sess = eng.slots_begin(gaf_path, 0, -1, thr)
    batches = []
    try:
        while True:
            buf = np.empty(flush_every, dtype=np.int32)
            n = eng.slots_next(sess, buf)
            if n == 0:
                return batches
            buf[n:] = -1
            batches.append(buf)
    finally:
        eng.slots_end(sess)


def batch_stats(idx: np.ndarray) -> dict:
    """What a slot batch looks like to a scatter: its valid indices, distinct
    slots, distinct 32-byte sectors of int32 counts, the longest run of equal
    neighbours, and the share of valid indices that equal their left
    neighbour."""
    valid = idx >= 0
    slots = np.unique(idx[valid])
    change = np.flatnonzero(np.diff(idx) != 0) + 1
    starts = np.concatenate([[0], change])
    lengths = np.diff(np.concatenate([starts, [len(idx)]]))
    kept = valid[starts]  # a run of padding is no run of slots
    n_valid = int(valid.sum())
    repeats = int((valid[1:] & (idx[1:] == idx[:-1])).sum())
    return {
        "valid": n_valid,
        "distinct_slots": int(len(slots)),
        "distinct_sectors": int(len(np.unique(slots >> 3))),
        "longest_run": int(lengths[kept].max()) if kept.any() else 0,
        "equal_left_share": round(repeats / n_valid, 4) if n_valid else 0.0,
    }


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    n_slots = int(argv[0]) if argv else 1 << 21
    streams = [int(x) for x in argv[1:]] or [1 << 20, 1 << 22, 1 << 25]
    device = backend.device("cuda")
    print(backend.card_label(), flush=True)
    for rec in run(n_slots, streams, device):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
