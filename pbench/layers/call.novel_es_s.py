"""Seconds a job spends in the novel pass's exon skips, the program's span
``call.novel_es``: its host half lists the candidates
(``call.novel_es.candidates``), the match evaluates them on the card
(``call.novel_es.match``), then the rows are made."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "call.novel_es")
