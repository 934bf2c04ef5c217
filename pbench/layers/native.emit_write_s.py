"""Seconds a job spends writing the augmented GFA to its descriptor, the
program's span ``emit.write``, stamped inside ``gafcov_emit_mt``: the time
blocked on whoever reads the output."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "emit.write")
