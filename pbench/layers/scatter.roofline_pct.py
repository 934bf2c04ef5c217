"""The scatter kernels' share of their roofline over the window.

The least time of a batch (``chip_smoke.py::_bound``, copied): every index
read once (4 bytes, padding included) and every distinct 32-byte sector of
``counts`` that the batch names read and written once, over the H100's
3.35 TB/s, or its adds over 67 TFLOP/s of plain arithmetic where that is
longer. It is counted on the warm-up job's batches, which every job of the
window repeats (one GAF, one graph), times the jobs; the time is the device
time of the scatter kernels (``csrc/coverage_scatter.cu`` and
``csrc/coverage_direct.cu``) in the profiler's trace.
"""

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PLAIN_OPS_PER_S = 67e12
SECTOR_SLOTS = 8  # int32 counts in one 32-byte sector
KERNELS = ("window_count", "window_scan", "window_scatter", "window_histogram", "direct_scatter")


def bound_s(slots: np.ndarray) -> float:
    valid = slots[slots >= 0]
    sectors = len(np.unique(valid // SECTOR_SLOTS))
    return max((4 * len(slots) + 2 * 32 * sectors) / HBM_BYTES_PER_S,
               len(valid) / PLAIN_OPS_PER_S)


def install(ctx):
    from pantas_tpu_torch.coverage.device import DeviceCoverage

    tr = ctx.tracer
    tr.counters["scatter.bound_s_per_job"] = 0.0

    def count(self, slots, pad_to=None):
        if tr.phase == "warmup":
            batch = np.asarray(slots, np.int32)
            if pad_to is not None and len(batch) < pad_to:
                batch = np.concatenate([batch, np.full(pad_to - len(batch), -1, np.int32)])
            tr.counters["scatter.bound_s_per_job"] += bound_s(batch)

    tr.tap(DeviceCoverage, "add_slots", count)


def read(run):
    d = run.device
    kernel_s = sum(f - s for name, s, f in (d["ops"] if d else ())
                   if any(k in name for k in KERNELS))
    if kernel_s <= 0.0:
        return None
    return 100.0 * run.tracer.counters["scatter.bound_s_per_job"] * run.jobs / kernel_s
