"""The novel call stage: one replicate through both device stages, as a user
runs them in the novel mode of a simulation, ``augment -o`` and then
``call -n -a -w 3 -l 25`` on that file.

A job is the job of :mod:`pbench.stages.call` with the configuration's
novel options: ``augment_gfa_device_native(gaf, gfa, out=<file>,
threads=host_threads(share), ...)``, its native parse on the configuration's
share of the CPUs (``parse_threads``),
then ``call_events_device(<file>, gtf, CallOptions(novel=True,
no_annotated=True, rca=..., isw=..., minintronsize=...), devices=[the
card])`` with every row consumed. The graph is
:mod:`pbench.reference.novel`'s, served without the event isoforms that the
reads walk, so the augment appends novel links and the call finds the events
in its novel pass. The check holds every job's GFA against the NumPy augment
reference's, byte for byte, its novel links in upstream's first-seen order
(:mod:`pbench.reference.first_seen`), and its rows, as a multiset, against the
rows of the plain reference of the novel pass
(:mod:`pbench.reference.call_novel`) of the reference's own GFA, computed in
this process (the reference's intronic walk and its IR rows follow the
process's string hashes, as upstream's and the program's do).
"""

from __future__ import annotations

import hashlib
import io
import sys

from pbench.reference import augment as reference_augment
from pbench.reference import call_novel as reference_novel
from pbench.reference import first_seen, inputs, novel
from pbench.stages.call import State, _file_digest, rows_digest

COUNTERS = ("emit.novel_links", "call.novel_junctions")


def setup(ctx):
    """The seed's reads and GAF on the graph of :mod:`pbench.reference.novel`,
    built on a checkout's first run beside the harness's own."""
    call = ctx.config["call"]
    if not (call["novel"] and call["no_annotated"]):
        raise ValueError("the novel call reference holds the novel pass alone (call -n -a)")
    if ctx.config.get("recipe") != "novel":
        raise ValueError("the novel call runs on the novel recipe's graph")
    name = f"{ctx.config['name']}-novel"
    ctx.tables = inputs.GraphTables(novel.ensure_graph(name, ctx.config["graph"], ctx.run_dir.parent))
    reads = ctx.generator.generate(ctx.tables, ctx.config, ctx.mix, ctx.seed)
    gaf = ctx.run_dir / "reads.gaf"
    ctx.generator.write_gaf(ctx.tables, reads, gaf)
    state = State(str(gaf), str(ctx.tables.gfa), str(ctx.tables.dir / "g.gtf"), reads, call)
    state.jobs = 0
    return state


def options(call):
    from pantas_tpu_torch.events.caller import CallOptions

    return CallOptions(rca=call["rca"], events=list(call["events"]), novel=True, no_annotated=True,
                       isw=call["isw"], minintronsize=call["minintronsize"])


def job(ctx, state, warmup=False):
    """One device augment into a file, then the device call's novel pass of
    that file; returns ((GFA sha256, bytes), (rows sha256, rows by type))."""
    from pantas_tpu_torch.coverage.device import augment_gfa_device_native
    from pantas_tpu_torch.events.batched import call_events_device
    from pantas_tpu_torch.native.gafcov import host_threads

    threads = host_threads(ctx.config.get("parse_threads", {}).get("share", 1))
    log = sys.stderr if warmup else io.StringIO()
    augmented = ctx.run_dir / "augmented.gfa"
    with open(augmented, "w") as out:
        augment_gfa_device_native(state.gaf, state.gfa, out=out, device=ctx.device, log=log,
                                  threads=threads)
    rows = list(call_events_device(str(augmented), state.gtf, options(state.call), log=log,
                                   devices=[ctx.device]))
    if not warmup:
        state.jobs += 1
    return _file_digest(augmented), rows_digest(rows)


def finish(ctx, state):
    """The work's size; in a traced run the novel links a job emitted and the
    call's graph held, from the program's counters, go to the log."""
    seen = {k: ctx.tracer.counters[k] / state.jobs for k in COUNTERS
            if k in ctx.tracer.counters and state.jobs}
    if seen:
        print(f"[pbench] a job's counters {seen}", file=sys.stderr, flush=True)
    return {"records": len(state.reads)}


def check(ctx, state, results):
    """Jobs whose augmented GFA differs from the reference's, byte for byte,
    and jobs whose rows differ from the novel call reference's, as
    multisets."""
    chunks = []
    counts = first_seen.counts(ctx.tables, state.reads)
    reference_augment.emit(ctx.tables, counts, chunks.append)
    text = "".join(chunks)
    del chunks
    data = text.encode()
    want_gfa = (hashlib.sha256(data).hexdigest(), len(data))
    del data
    call = state.call
    rows = reference_novel.novel_rows(io.StringIO(text), state.gtf, rca=call["rca"],
                                      events=call["events"], isw=call["isw"],
                                      minintronsize=call["minintronsize"])
    want_rows = rows_digest(rows)
    print(f"[pbench] reference novel links {len(counts.novel)}; rows by type {want_rows[1]}; "
          f"jobs' rows by type {sorted({tuple(sorted(r[1][1].items())) for r in results})}",
          file=sys.stderr, flush=True)
    return {"gfa_jobs_differ": (sum(r[0] != want_gfa for r in results), 0),
            "call_jobs_differ": (sum(r[1] != want_rows for r in results), 0)}
