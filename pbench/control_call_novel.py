"""The control of the novel call cell's comparison: the plain references put
in the program's place with the augment's counts held in float16, the
half-width type a device accumulator would be tempted to use (see
:mod:`pbench.control`). The counts stop at 2,048, novel links' ``RC`` among
them, so the augmented GFA differs wherever a count passes it, and so does
every row of the novel pass that prints such a link's ``RC`` or reads such a
node's ``NC``. The cell's comparison has to say so.

    python3 -m pbench.control_call_novel --workload <name> --seeds <n> [<n> ...]

prints one JSON line a seed with the numbers the comparison reads and their
limits, as a run's ``checks``. It never imports the program, and the
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import sys
import time
from pathlib import Path

from pbench.control import FLOAT16_STOP, held_in_float16
from pbench.run import ROOT, cell, context


def control_call_novel(ctx, state):
    """The stage's check of one job made by the references from float16
    counts; returns (checks, what the control saw)."""
    from pbench.reference import augment, call_novel, first_seen

    chunks = []
    exact = first_seen.counts(ctx.tables, state.reads)
    augment.emit(ctx.tables, held_in_float16(exact), chunks.append)
    text = "".join(chunks)
    data = text.encode()
    call = state.call
    rows = call_novel.novel_rows(io.StringIO(text), state.gtf, rca=call["rca"],
                                 events=call["events"], isw=call["isw"],
                                 minintronsize=call["minintronsize"])
    result = ((hashlib.sha256(data).hexdigest(), len(data)), ctx.stage.rows_digest(rows))
    novel_rc = [w for _, _, w in exact.novel]
    return ctx.stage.check(ctx, state, [result]), {
        "novel_links": len(novel_rc),
        "novel_rc_above_stop": sum(w > FLOAT16_STOP for w in novel_rc),
        "max_novel_rc": max(novel_rc, default=0),
        "link_rc_above_stop": int((exact.link_rc > FLOAT16_STOP).sum()),
    }


def main(argv=None, root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m pbench.control_call_novel")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    w, _, _ = cell(json.loads((root / "BENCHMARK.json").read_text()), args.workload)
    failed_all = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = context(root, w, seed, "cpu")
        state = ctx.stage.setup(ctx)
        checks, seen = control_call_novel(ctx, state)
        correct = all(v <= lim for v, lim in checks.values())
        failed_all &= not correct
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": correct,
                          "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
                          "seen": seen, "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
