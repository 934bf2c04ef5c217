"""Spans and counters of the port's own work, kept in memory.

Tracing is off by default. :func:`span` then returns one shared object that
does nothing: no clock read and no allocation, one check of a module global.
Turned on by :func:`enable`, every span records ``(name, t0, t1, parent,
thread)``:

- ``t0`` and ``t1`` in nanoseconds of ``time.perf_counter_ns()``, which is
  ``CLOCK_MONOTONIC`` on Linux, the clock the native engine stamps its
  phases with (``steady_clock`` under libstdc++), so native stamps need no
  offset;
- ``parent``, the index in :func:`snapshot`'s span list of the span that was
  open on the same thread when it started, -1 for a root;
- ``thread``, ``threading.get_ident()`` of the thread that opened it.

While a ``torch.profiler`` records, each span also enters
``torch.profiler.record_function(name)``, so a Chrome trace exported from
that profiler shows the spans beside the kernels and copies. Spans stamped
inside a native call (:func:`record`) have no such twin.

Nothing is written from here: :func:`snapshot` hands the spans and counters
to the caller. Kernel launches and the call's candidates are not counted
twice: the snapshot reports those since :func:`reset` from
``coverage.kernels.LAUNCHES``, the port's one launch counter, and from
``events.batched.EVALS``, its one count of candidates evaluated.

    from pantas_tpu_torch import trace
    trace.enable()
    ...  # augment_gfa_device_native(...)
    snap = trace.snapshot()  # {"spans": [...], "counters": {...}}
    trace.span_totals(snap)  # {name: seconds}
"""

from __future__ import annotations

import sys
import threading
import time

_enabled = False
_spans: list = []  # [name, t0, t1, parent, thread]; t1 is None while the span is open
_counters: dict = {}
_lock = threading.Lock()
_local = threading.local()
_launch_base = 0
_candidate_base: dict = {}
_profiling = None  # torch's check for a recording profiler, bound by enable()

KERNELS_MODULE = "pantas_tpu_torch.coverage.kernels"
EVENTS_MODULE = "pantas_tpu_torch.events.batched"


def _launches() -> int:
    kernels = sys.modules.get(KERNELS_MODULE)
    return sum(kernels.LAUNCHES.values()) if kernels is not None else 0


def _candidates() -> dict:
    """``call.candidates.<finder>``: the candidates each finder of the call
    has evaluated in this process, on every device."""
    batched = sys.modules.get(EVENTS_MODULE)
    out: dict = {}
    if batched is not None:
        for (finder, _device), n in batched.EVALS.items():
            name = "call.candidates." + batched.finder_label(finder)
            out[name] = out.get(name, 0) + n
    return out


def enable() -> None:
    """Turn tracing on (the spans and counters so far are kept)."""
    global _enabled, _profiling
    import torch

    _profiling = torch._C._autograd._profiler_enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Forget every span and counter; launches count from here. Call it
    between jobs: a span open across it is recorded into the old list."""
    global _spans, _launch_base, _candidate_base
    with _lock:
        _spans = []
        _counters.clear()
        _launch_base = _launches()
        _candidate_base = _candidates()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rec", "twin")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.rec = rec = [self.name, 0, None, stack[-1] if stack else -1, threading.get_ident()]
        with _lock:
            stack.append(len(_spans))
            _spans.append(rec)
        self.twin = None
        if _profiling():
            from torch.profiler import record_function

            self.twin = record_function(self.name)
            self.twin.__enter__()
        rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        if self.twin is not None:
            self.twin.__exit__(*exc)
        _stack().pop()
        return False

    @property
    def seconds(self) -> float:
        """The span's length once it has closed."""
        return (self.rec[2] - self.rec[1]) / 1e9


def span(name: str):
    """A context manager that records span ``name`` while tracing is on."""
    if not _enabled:
        return _OFF
    return _Span(name)


def record(name: str, t0: int, t1: int) -> None:
    """A span stamped elsewhere on the same clock (a native call's phase),
    as a child of the span open on this thread."""
    if not _enabled:
        return
    stack = _stack()
    rec = [name, int(t0), int(t1), stack[-1] if stack else -1, threading.get_ident()]
    with _lock:
        _spans.append(rec)


def add(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def snapshot() -> dict:
    """``{"spans": [(name, t0, t1, parent, thread)], "counters": {...}}``;
    the counters hold ``kernels.launches``, the launches since :func:`reset`,
    and ``call.candidates.<finder>`` for each finder that has evaluated
    candidates since then."""
    with _lock:
        spans = [tuple(r) for r in _spans]
        counters = dict(_counters)
    counters["kernels.launches"] = _launches() - _launch_base
    for name, n in _candidates().items():
        n -= _candidate_base.get(name, 0)
        if n > 0:
            counters[name] = n
    return {"spans": spans, "counters": counters}


def span_totals(snap: dict) -> dict:
    """Seconds in each span name of a :func:`snapshot`, summed over its
    closed spans."""
    out: dict = {}
    for name, t0, t1, _, _ in snap["spans"]:
        if t1 is not None:
            out[name] = out.get(name, 0.0) + (t1 - t0) / 1e9
    return out
