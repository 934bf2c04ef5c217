"""Seconds a job spends in the native parse's line loop, the program's
counter ``slots.parse_ns``: nanoseconds that ``gafcov_slots_next`` measures
around its tokenize and ``process_line``, hand-off excluded."""

from pbench.program_trace import install, counter  # noqa: F401 (install: the layer's hook)


def read(run):
    return counter(run, "slots.parse_ns", 1e-9)
