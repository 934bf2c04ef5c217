"""Seconds a job spends in the native emission of the augmented GFA, the
program's span ``native.emit`` (``native/gafcov.py::NativeCoverage.emit``)."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "native.emit")
