"""Seconds a job spends in the tensorize, the program's span
``graph.compile_gfa`` (``graph/compiler.py::compile_gfa``): the native scan,
the names and their index, the assembly of the tables."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "graph.compile_gfa")
