"""Seconds a job spends creating the native engine, the program's span
``native.engine_init`` (``coverage/device.py::_native_engine``): the ids'
conversion and check in Python, then ``gafcov_create``."""

from pbench.program_trace import install, span_s  # noqa: F401 (install: the layer's hook)


def read(run):
    return span_s(run, "native.engine_init")
