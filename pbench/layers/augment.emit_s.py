"""Seconds a job spends in the native emission of the augmented GFA,
``native/gafcov.py::NativeCoverage.emit``."""


def install(ctx):
    from pantas_tpu_torch.native.gafcov import NativeCoverage

    ctx.tracer.wrap(NativeCoverage, "emit", "augment.emit")


def read(run):
    return run.tracer.total("augment.emit") / run.jobs
