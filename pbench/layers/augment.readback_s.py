"""Seconds a job spends reading the counts back from the card,
``coverage/device.py::DeviceCoverage._read_back``."""


def install(ctx):
    from pantas_tpu_torch.coverage.device import DeviceCoverage

    ctx.tracer.wrap(DeviceCoverage, "_read_back", "augment.readback")


def read(run):
    return run.tracer.total("augment.readback") / run.jobs
