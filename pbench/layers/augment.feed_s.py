"""Seconds a job's host spends in the device feed's batches,
``coverage/device.py::DeviceCoverage.add_slots``: the host side of each step,
the copy to the card and the launches."""


def install(ctx):
    from pantas_tpu_torch.coverage.device import DeviceCoverage

    ctx.tracer.wrap(DeviceCoverage, "add_slots", "augment.feed")


def read(run):
    return run.tracer.total("augment.feed") / run.jobs
