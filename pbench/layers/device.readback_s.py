"""Seconds a job spends reading the counts back from the card, the program's
span ``device.readback`` (``DeviceCoverage._read_back``): the nonzero count,
which waits for the queued kernels, and the copy."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "device.readback")
