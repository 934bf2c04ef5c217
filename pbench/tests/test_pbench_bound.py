"""The scatter roofline's count (``chip_smoke.py::_bound``, copied) on a
hand-made batch."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pbench.run import load

ROOFLINE = load(Path(__file__).resolve().parents[1] / "layers" / "scatter.roofline_pct.py")


def test_bound_counts_indices_and_distinct_sectors():
    # 16 indices (4 of them padding); slots 0, 1, 7 share sector 0, slot 8 is
    # sector 1 (twice), slot 100 sector 12, 2**25 - 1 the last sector
    batch = np.array([0, 1, 7, -1, 8, 8, 100, -1, 2**25 - 1, -1, 0, 0, 1, -1, 100, 7],
                     np.int32)
    want = (4 * 16 + 2 * 32 * 4) / 3.35e12
    assert ROOFLINE.bound_s(batch) == want


def test_bound_of_padding_alone_is_the_index_read():
    assert ROOFLINE.bound_s(np.full(1 << 20, -1, np.int32)) == 4 * (1 << 20) / 3.35e12


def test_roofline_reads_nothing_without_kernels():
    from types import SimpleNamespace

    tracer = SimpleNamespace(counters={"scatter.bound_s_per_job": 1e-3})
    run = SimpleNamespace(jobs=2, tracer=tracer,
                          device={"ops": [("Memcpy HtoD (Pageable -> Device)", 0.0, 1.0)]})
    assert ROOFLINE.read(run) is None
    run.device["ops"].append(("void window_histogram(int*, long)", 1.0, 1.5))
    run.device["ops"].append(("void window_count<true>(int const*)", 2.0, 2.5))
    assert abs(ROOFLINE.read(run) - 100.0 * 2e-3 / 1.0) < 1e-12
