"""Seconds a job spends in the call's finder of annotated alternative donors and
acceptors (A5, A3), the program's span ``call.ss``: its host half lists the
candidates (``call.ss.candidates``), the match evaluates them on the card
(``call.ss.match``), then the rows are made (``call.rows``)."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "call.ss")
