"""Segments a job whose string names the tensorize built, the program's
counter ``graph.names_built`` (``graph/compiler.py``): 0 where the native
scan's integer ids carry the graph to the native engine, the graph's
segment count wherever a reader asks for names."""

from pbench.program_trace import install, counter  # noqa: F401 (install: the layer's hook)


def read(run):
    return counter(run, "graph.names_built")
