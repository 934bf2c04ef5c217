"""The augment stage: one replicate's GAF through the device augment.

A job is ``augment_gfa_device_native(gaf, gfa, out=<pipe>, device=...)`` with
``PANTAS_SCATTER`` as the environment leaves it, its augmented GFA drained
from the pipe and hashed by a thread of the benchmark, so nothing is written
to disk. The check holds every job's bytes against the NumPy reference's.
"""

from __future__ import annotations

import fcntl
import hashlib
import io
import os
import sys
import threading

from pbench.reference import augment as reference

PIPE_BYTES = 1 << 20


class State:
    def __init__(self, gaf, gfa, reads):
        self.gaf, self.gfa, self.reads = gaf, gfa, reads


def setup(ctx):
    reads = ctx.generator.generate(ctx.tables, ctx.config, ctx.mix, ctx.seed)
    gaf = ctx.run_dir / "reads.gaf"
    ctx.generator.write_gaf(ctx.tables, reads, gaf)
    return State(str(gaf), str(ctx.tables.gfa), reads)


def _drain(fd, digest, size):
    while True:
        block = os.read(fd, PIPE_BYTES)
        if not block:
            return
        digest.update(block)
        size[0] += len(block)


def job(ctx, state, warmup=False):
    """One device augment; returns (sha256 of the GFA written, its bytes)."""
    from pantas_tpu_torch.coverage.device import augment_gfa_device_native

    r, w = os.pipe()
    try:
        fcntl.fcntl(w, fcntl.F_SETPIPE_SZ, PIPE_BYTES)
    except OSError:
        pass  # the pipe keeps its default size
    digest, size = hashlib.sha256(), [0]
    drain = threading.Thread(target=_drain, args=(r, digest, size), daemon=True)
    drain.start()
    try:
        with os.fdopen(w, "w") as out:
            augment_gfa_device_native(state.gaf, state.gfa, out=out, device=ctx.device,
                                      log=sys.stderr if warmup else io.StringIO())
    finally:
        drain.join()
        os.close(r)
    return digest.hexdigest(), size[0]


def finish(ctx, state):
    return {"records": len(state.reads)}


def check(ctx, state, results):
    """Jobs whose augmented GFA differs from the reference's, byte for byte."""
    digest, size = hashlib.sha256(), [0]

    def write(text):
        data = text.encode()
        digest.update(data)
        size[0] += len(data)

    reference.emit(ctx.tables, reference.counts(ctx.tables, state.reads), write)
    want = (digest.hexdigest(), size[0])
    differ = sum(r != want for r in results)
    return {"gfa_jobs_differ": (differ, 0)}
