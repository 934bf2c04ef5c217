"""Seconds a job spends loading the augmented GFA into the call's graph, the
program's span ``call.graph_load`` (``SplicingGraph.from_gfa``)."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "call.graph_load")
