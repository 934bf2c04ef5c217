"""Seconds a job spends formatting the novel links of the augmented GFA in
the native emission, the program's span ``emit.novel`` (a phase of
``gafcov_emit``, stamped natively: the sidecar's links in first-seen order)."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "emit.novel")
