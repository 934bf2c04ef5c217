"""Seconds a job spends finding the novel pass's exonic splice sites, the
program's span ``call.novel_ss``: its host half lists the candidates
(``call.novel_ss_exonic.candidates``) and the match evaluates them on the
card (``call.novel_ss_exonic.match``); the rows come in ``call.novel_walk``."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "call.novel_ss")
