"""Seconds a job spends in the native parse (``native/gafcov`` slot session):
the stream's wall, from the first batch handed to the device feed to the
feed's ``result``, less the feed's own host time in it."""


def install(ctx):
    from pantas_tpu_torch.coverage.device import DeviceCoverage

    tr = ctx.tracer
    tr.wrap(DeviceCoverage, "add_slots", "augment.feed")
    tr.tap(DeviceCoverage, "add_slots", lambda *a, **k: tr.open("augment.stream"))
    tr.tap(DeviceCoverage, "result", lambda *a, **k: tr.close("augment.stream"))


def read(run):
    tr = run.tracer
    return (tr.total("augment.stream") - tr.total("augment.feed")) / run.jobs
