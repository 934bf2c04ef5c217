"""Seconds a job's host spends in the device feed's batches, the program's
span ``device.add_slots`` (``coverage/device.py::DeviceCoverage.add_slots``):
padding, the copy to the card and the launches."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "device.add_slots")
