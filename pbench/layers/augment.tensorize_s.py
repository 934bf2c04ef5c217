"""Seconds a job spends in the tensorize, ``graph/compiler.py::compile_gfa``,
as the device augment calls it."""


def install(ctx):
    from pantas_tpu_torch.coverage import device

    ctx.tracer.wrap(device, "compile_gfa", "augment.tensorize")


def read(run):
    return run.tracer.total("augment.tensorize") / run.jobs
