"""Seconds a job spends finding the novel pass's cassette exons, the
program's span ``call.novel_ce``: its host half lists the pairs of novel
junctions around each annotated one (``call.novel_ce.candidates``) and the
match compares them on the card (``call.novel_ce.match``); the rows come in
``call.novel_walk``."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "call.novel_ce")
