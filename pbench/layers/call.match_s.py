"""Seconds a job spends in the call's matches, the program's spans
``call.<finder>.match`` summed (``_eval_match``: the tables and indices to
the card, the ``match_*`` ops and the read-back of the hits)."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    names = {n for n, _, _ in run.tracer.spans if n.startswith("call.") and n.endswith(".match")}
    if not names:
        return None
    return sum(span_s(run, n) for n in names)
