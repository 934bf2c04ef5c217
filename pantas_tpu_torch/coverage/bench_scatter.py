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
"""

from __future__ import annotations

import json
import sys

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
