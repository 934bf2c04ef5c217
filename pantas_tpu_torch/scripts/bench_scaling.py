#!/usr/bin/env python3
"""Data-parallel coverage scaling harness.

Measures the sharded scatter-add + one-reduction step over an N-device mesh
at fixed TOTAL work, reporting throughput and scaling efficiency vs 1 device.
On several cards this is the ≥80%-efficiency check from BASELINE.md; with
fewer cards than shards the mesh is logical (shards share a card, every
shard launches the selected scatter), and with ``--device cpu`` it runs on
the CPU device: methodology and correctness, nothing about scaling.

Usage: python -m pantas_tpu_torch.scripts.bench_scaling [max_devices] [stream_size] [--device cpu]
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from pantas_tpu_torch.scripts.stress_build import pop_device  # noqa: E402

DEVICE = pop_device(sys.argv)

MAX_DEV = int(sys.argv[1]) if len(sys.argv) > 1 else 8
STREAM = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 23

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pantas_tpu_torch import backend  # noqa: E402
from pantas_tpu_torch.coverage.scatter_impls import mesh_scatter  # noqa: E402
from pantas_tpu_torch.parallel.mesh import (  # noqa: E402
    coverage_mesh,
    data_parallel_scatter_add,
    new_parts,
)


def _sync(mesh):
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def main():
    cards = backend.mesh_devices(DEVICE, MAX_DEV)  # fewer: a logical mesh over them
    devices = [cards[i % len(cards)] for i in range(MAX_DEV)]
    _, scatter = mesh_scatter()
    n_slots = 1 << 20
    rng = np.random.default_rng(0)
    idx_np = rng.integers(0, n_slots, size=STREAM, dtype=np.int32)
    expect = np.bincount(idx_np, minlength=n_slots).astype(np.int32)

    base_rate = None
    results = []
    d = 1
    while d <= len(devices):
        mesh = coverage_mesh(devices[:d])
        step = data_parallel_scatter_add(mesh, scatter)
        counts = new_parts(mesh, n_slots)  # private partials
        idx = torch.from_numpy(idx_np).to(devices[0])  # STREAM % d == 0 for powers of two
        from pantas_tpu_torch.parallel.mesh import reduce_data_parts

        reduce = reduce_data_parts
        out = reduce(step(counts, idx))
        _sync(mesh)
        assert np.array_equal(out.cpu().numpy(), expect), f"mismatch at d={d}"
        ts = []
        for _ in range(3):
            t0 = time.time()
            step(counts, idx)
            _sync(mesh)
            ts.append(time.time() - t0)
        rate = STREAM / min(ts)
        if base_rate is None:
            base_rate = rate
        results.append(
            {
                "devices": d,
                "m_idx_per_s": round(rate / 1e6, 2),
                "efficiency": round(rate / (base_rate * d), 3),
                "bit_exact": True,
            }
        )
        d *= 2

    print(json.dumps({"scaling": results, "platform": devices[0].type}))


if __name__ == "__main__":
    main()
