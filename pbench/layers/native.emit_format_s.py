"""Seconds a job spends formatting the GFA's lines in the native emission,
the program's span ``emit.format``, stamped inside ``gafcov_emit_mt``."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "emit.format")
