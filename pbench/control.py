"""The control of each cell's comparison: the plain reference put in the
program's place with the counts held in float16, the half-width type a
device accumulator would be tempted to use. A float16 counter stops at 2,048
(2,049 is not representable and rounds back to 2,048), so every count above
it is wrong, and the cell's comparison has to say so.

    python3 -m pbench.control --workload <name> --seeds <n> [<n> ...]

prints one JSON line a seed with the numbers the comparison reads and their
limits, as a run's ``checks``. It never imports the program, and the
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

from pbench.run import ROOT, cell, context

FLOAT16_STOP = 2048  # the largest count a float16 counter reaches by adding 1


def held_in_float16(c):
    """The reference's counts as a float16 accumulator leaves them."""
    from pbench.reference.augment import Counts

    def stop(a):
        return np.minimum(a, FLOAT16_STOP)

    return Counts(nc=stop(c.nc), il=stop(c.il), ol=stop(c.ol), link_rc=stop(c.link_rc),
                  novel=[(a, b, min(w, FLOAT16_STOP)) for a, b, w in c.novel])


def control_augment(ctx, state):
    from pbench.reference import augment

    def digest(counts):
        h, size = hashlib.sha256(), [0]

        def write(text):
            data = text.encode()
            h.update(data)
            size[0] += len(data)

        augment.emit(ctx.tables, counts, write)
        return h.hexdigest(), size[0]

    exact = augment.counts(ctx.tables, state.reads)
    control = held_in_float16(exact)
    above = int(sum((a > FLOAT16_STOP).sum() for a in (exact.nc, exact.il, exact.ol, exact.link_rc)))
    results = [digest(control)]
    return ctx.stage.check(ctx, state, results), {"counts_above_stop": above,
                                                  "max_count": int(exact.nc.max())}


def main(argv=None, root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m pbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    w, _, _ = cell(json.loads((root / "BENCHMARK.json").read_text()), args.workload)
    failed_all = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = context(root, w, seed, "cpu")
        state = ctx.stage.setup(ctx)
        checks, seen = control_augment(ctx, state)
        correct = all(v <= lim for v, lim in checks.values())
        failed_all &= not correct
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": correct,
                          "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
                          "seen": seen, "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
