"""Seconds a job spends copying its slot batches to the card, the program's
span ``device.h2d`` inside ``DeviceCoverage.add_slots``: a blocking copy
from pageable host memory."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "device.h2d")
