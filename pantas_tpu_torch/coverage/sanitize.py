"""Drive both hand-written kernels for ``compute-sanitizer``.

Each kernel (``kernels.sorted_coverage_scatter_add``, kernel #1, and
``kernels.coverage_scatter_add``, kernel #2) runs once on zeroed counts and is
held exactly against one ``index_add_`` of the batch's valid indices: on 2^20
uniform indices in [-1, n) at 2^25 count slots and, with ``--real GAF GFA``,
on the first whole slot batch of that GAF on that graph, as the device
augment streams it (``bench_scatter.slot_batches``). Kernel #1's
claim-and-clear histogram (``atomicExch``, then a global ``atomicAdd``) and
kernel #2's shared-memory transpose are where a race would hide. Run from the
root of a checkout, on a machine with a CUDA card, under each tool:

    compute-sanitizer --tool memcheck --error-exitcode 1 \\
        python -m pantas_tpu_torch.coverage.sanitize [--real GAF GFA]

(likewise ``racecheck`` and ``synccheck``). It prints one JSON line per batch
and exits non-zero when a kernel disagrees with ``index_add_``; the tool's
``--error-exitcode`` makes a reported hazard fail the run too.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

BATCH = 1 << 20
UNIFORM_LOG2_SLOTS = 25


def batches(real=None) -> dict:
    """``{name: (n_slots, host int32 batch)}``: the uniform batch, and the
    first whole slot batch of ``real = (gaf, gfa)`` in that graph's bucket."""
    rng = np.random.default_rng(UNIFORM_LOG2_SLOTS + 1)  # chip_smoke.py's uniform batch
    n = 1 << UNIFORM_LOG2_SLOTS
    out = {"uniform": (n, rng.integers(-1, n, size=BATCH, dtype=np.int32))}
    if real is not None:
        from pantas_tpu_torch.coverage.bench_scatter import slot_batches
        from pantas_tpu_torch.graph.compiler import compile_gfa

        gaf, gfa = real
        tensors = compile_gfa(gfa)
        bucket = max(1 << 12, 1 << (tensors.total_slots - 1).bit_length())
        first = next((b for b in slot_batches(gaf, tensors, BATCH) if (b >= 0).all()), None)
        if first is None:
            raise RuntimeError(f"{gaf} holds no whole batch of {BATCH} slots")
        out["real"] = (bucket, first)
    return out


def check(n: int, idx_np: np.ndarray, device) -> dict:
    """Each kernel once on zeroed counts against ``index_add_``; raises on a
    difference or a kernel that did not launch."""
    from pantas_tpu_torch.coverage import kernels

    idx = torch.from_numpy(idx_np).to(device)
    valid = idx[idx >= 0].long()
    want = torch.zeros(n, dtype=torch.int32, device=device)
    want.index_add_(0, valid, torch.ones(valid.numel(), dtype=torch.int32, device=device))
    record = {}
    for name, fn in (("sorted_coverage_scatter_add", kernels.sorted_coverage_scatter_add),
                     ("coverage_scatter_add", kernels.coverage_scatter_add)):
        before = kernels.LAUNCHES[name]
        got = fn(torch.zeros(n, dtype=torch.int32, device=device), idx)
        torch.cuda.synchronize(device)
        if kernels.LAUNCHES[name] != before + 1:
            raise RuntimeError(f"{name} did not launch its kernel")
        err = int((got - want).abs().max())
        if err:
            raise RuntimeError(f"{name} != index_add_ (max abs err {err})")
        record[name] = {"max_abs_err": err}
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pantas_tpu_torch.coverage.sanitize")
    ap.add_argument("--real", nargs=2, metavar=("GAF", "GFA"),
                    help="also the first whole slot batch of GAF on GFA")
    args = ap.parse_args(argv)
    from pantas_tpu_torch import backend

    device = backend.device("cuda")
    for name, (n, idx) in batches(args.real).items():
        record = check(n, idx, device)
        print(json.dumps({"batch": name, "slots": n, "valid": int((idx >= 0).sum()),
                          "kernels": record}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
