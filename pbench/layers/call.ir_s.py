"""Seconds a job spends in the call's finder of annotated retained introns, the
program's span ``call.ir``: its host half lists the candidates
(``call.ir.candidates``), the match evaluates them on the card
(``call.ir.match``), then the host walks each hit's path into a row
(``call.rows``)."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "call.ir")
