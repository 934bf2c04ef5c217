"""The call stage: one replicate through both device stages, as a user runs
them, ``augment -o`` and then ``call -w 3`` on that file.

A job is ``augment_gfa_device_native(gaf, gfa, out=<file>, device=...)``,
then ``call_events_device(<file>, gtf, opts, devices=[the card])`` (what
``call --engine device`` runs) with every row consumed. It returns the
augmented GFA's sha256 and size, and the sorted rows' sha256 with the rows
by event type. The check holds every job's GFA against the NumPy augment
reference's, byte for byte, and its rows, as a multiset, against the plain
call reference's rows of the reference's own GFA, computed in this process
(the reference's IR walk follows the process's string hashes, as upstream's
and the program's do).
"""

from __future__ import annotations

import hashlib
import io
import sys
from collections import Counter

from pbench.reference import augment as reference_augment
from pbench.reference import call as reference_call
from pbench.reference import inputs, rotated


class State:
    def __init__(self, gaf, gfa, gtf, reads, call):
        self.gaf, self.gfa, self.gtf, self.reads, self.call = gaf, gfa, gtf, reads, call


def setup(ctx):
    """The seed's reads and GAF; with ``"recipe": "rotated"`` in the
    configuration, on the graph of :mod:`pbench.reference.rotated`, built
    on a checkout's first run beside the harness's own."""
    call = ctx.config["call"]
    if call["novel"]:
        raise ValueError("the call reference holds the annotated pass only")
    if ctx.config.get("recipe") == "rotated":
        name = f"{ctx.config['name']}-rotated"
        ctx.tables = inputs.GraphTables(rotated.ensure_graph(name, ctx.config["graph"],
                                                             ctx.run_dir.parent))
    reads = ctx.generator.generate(ctx.tables, ctx.config, ctx.mix, ctx.seed)
    gaf = ctx.run_dir / "reads.gaf"
    ctx.generator.write_gaf(ctx.tables, reads, gaf)
    return State(str(gaf), str(ctx.tables.gfa), str(ctx.tables.dir / "g.gtf"), reads, call)


def _file_digest(path):
    digest, size = hashlib.sha256(), 0
    with open(path, "rb") as fh:
        while block := fh.read(1 << 20):
            digest.update(block)
            size += len(block)
    return digest.hexdigest(), size


def rows_digest(rows):
    """The sha256 of the rows sorted, one a line, and the rows by event type."""
    digest = hashlib.sha256()
    for row in sorted(rows):
        digest.update(row.encode() + b"\n")
    return digest.hexdigest(), dict(Counter(row.split(",", 1)[0] for row in rows))


def job(ctx, state, warmup=False):
    """One device augment into a file, then the device call of that file;
    returns ((GFA sha256, bytes), (rows sha256, rows by type))."""
    from pantas_tpu_torch.coverage.device import augment_gfa_device_native
    from pantas_tpu_torch.events.batched import call_events_device
    from pantas_tpu_torch.events.caller import CallOptions

    log = sys.stderr if warmup else io.StringIO()
    augmented = ctx.run_dir / "augmented.gfa"
    with open(augmented, "w") as out:
        augment_gfa_device_native(state.gaf, state.gfa, out=out, device=ctx.device, log=log)
    opts = CallOptions(rca=state.call["rca"], events=list(state.call["events"]))
    rows = list(call_events_device(str(augmented), state.gtf, opts, log=log, devices=[ctx.device]))
    return _file_digest(augmented), rows_digest(rows)


def finish(ctx, state):
    return {"records": len(state.reads)}


def check(ctx, state, results):
    """Jobs whose augmented GFA differs from the reference's, byte for byte,
    and jobs whose rows differ from the call reference's, as multisets."""
    chunks = []
    reference_augment.emit(ctx.tables, reference_augment.counts(ctx.tables, state.reads),
                           chunks.append)
    text = "".join(chunks)
    del chunks
    data = text.encode()
    want_gfa = (hashlib.sha256(data).hexdigest(), len(data))
    del data
    rows = reference_call.annotated_rows(io.StringIO(text), state.gtf, rca=state.call["rca"],
                                         events=state.call["events"])
    want_rows = rows_digest(rows)
    print(f"[pbench] reference rows by type {want_rows[1]}; jobs' rows by type "
          f"{sorted({tuple(sorted(r[1][1].items())) for r in results})}", file=sys.stderr, flush=True)
    return {"gfa_jobs_differ": (sum(r[0] != want_gfa for r in results), 0),
            "call_jobs_differ": (sum(r[1] != want_rows for r in results), 0)}
