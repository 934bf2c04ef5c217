"""The program's own spans and counters (``pantas_tpu_torch/trace.py``) in
the benchmark's tracer.

:func:`install` turns the program's tracing on once a run, forgets what it
recorded before the window when the window opens, and, when it closes,
appends the program's spans, in seconds, to ``ctx.tracer.spans`` and its
counters to ``ctx.tracer.counters``, then turns the tracing off. Both clocks
are ``CLOCK_MONOTONIC``, so the breakdown's idle gaps are named by the
program's innermost span. A program without the module records nothing: the
readers of its spans and counters then return None.
"""

from __future__ import annotations

import importlib


def install(ctx) -> None:
    if getattr(ctx, "program_trace", False):
        return
    ctx.program_trace = True
    try:
        trace = importlib.import_module("pantas_tpu_torch.trace")
    except ImportError:
        return
    tr = ctx.tracer

    def on_window(opening: bool) -> None:
        if opening:
            trace.reset()
            return
        snap = trace.snapshot()
        trace.disable()
        tr.spans.extend((name, t0 / 1e9, t1 / 1e9) for name, t0, t1, _, _ in snap["spans"]
                        if t1 is not None)
        for name, value in snap["counters"].items():
            tr.counters[name] = tr.counters.get(name, 0) + value

    trace.enable()
    tr.on_window.append(on_window)


def span_s(run, name: str):
    """Seconds a job spends in the program's span ``name``; None where the
    program recorded no such span."""
    if not any(n == name for n, _, _ in run.tracer.spans):
        return None
    return run.tracer.total(name) / run.jobs


def counter(run, name: str, scale: float = 1.0):
    """Counter ``name`` a job, times ``scale``; None where the program kept
    no such counter."""
    value = run.tracer.counters.get(name)
    return None if value is None else value * scale / run.jobs
