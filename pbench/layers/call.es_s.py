"""Seconds a job spends in the call's finder of annotated exon skips, the
program's span ``call.es``: its host half lists the candidates
(``call.es.candidates``), the match evaluates them on the card
(``call.es.match``), then the rows are made (``call.rows``)."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "call.es")
