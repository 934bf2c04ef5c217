"""Spans around the program's calls and the device timeline of a window.

:class:`Tracer` replaces a function of the program by a wrapper that records
``(name, start, end)`` on the host clock while the window is open, and puts
every original back when it closes. :func:`device_window` runs the window
under ``torch.profiler`` and reduces its trace to the device's busy time, its
operations by name, and its idle gaps named by the host span they fell in.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path


class Tracer:
    def __init__(self):
        self.spans: list = []  # (name, t0, t1), window only
        self.phase = "setup"  # "setup", "warmup", "window", "closed"
        self.counters: dict = {}
        self.on_window: list = []  # callables run with True at the window's start, False at its end
        self._saved: list = []
        self._wrapped: set = set()
        self._open: dict = {}

    # -- wrappers -----------------------------------------------------------
    def _replace(self, owner, attr, make):
        original = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        self._saved.append((owner, attr, original))
        setattr(owner, attr, make(getattr(owner, attr)))

    def wrap(self, owner, attr, name, sync=None):
        """Record a span ``name`` around every call of ``owner.attr`` in the
        window; ``sync()`` runs before the span ends (a device's queue)."""
        if (id(owner), attr, name) in self._wrapped:
            return
        self._wrapped.add((id(owner), attr, name))

        def make(inner):
            def wrapper(*args, **kwargs):
                if self.phase != "window":
                    return inner(*args, **kwargs)
                t0 = time.perf_counter()
                try:
                    out = inner(*args, **kwargs)
                    if sync is not None:
                        sync()
                    return out
                finally:
                    self.spans.append((name, t0, time.perf_counter()))
            return wrapper
        self._replace(owner, attr, make)

    def tap(self, owner, attr, fn):
        """Call ``fn(*args, **kwargs)`` before every call of ``owner.attr``."""
        def make(inner):
            def wrapper(*args, **kwargs):
                fn(*args, **kwargs)
                return inner(*args, **kwargs)
            return wrapper
        self._replace(owner, attr, make)

    def open(self, name):
        """Start span ``name`` unless it is open already."""
        if self.phase == "window" and name not in self._open:
            self._open[name] = time.perf_counter()

    def close(self, name):
        t0 = self._open.pop(name, None)
        if t0 is not None:
            self.spans.append((name, t0, time.perf_counter()))

    def restore(self):
        for owner, attr, original in reversed(self._saved):
            setattr(owner, attr, original)
        self._saved.clear()
        self._wrapped.clear()

    # -- the window ---------------------------------------------------------
    @contextlib.contextmanager
    def window(self):
        for fn in self.on_window:
            fn(True)
        self.phase = "window"
        try:
            yield
        finally:
            self.phase = "closed"
            for fn in self.on_window:
                fn(False)

    def total(self, name) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.spans if n == name)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "pbench.window"


@contextlib.contextmanager
def device_window(trace_path: Path, result: dict):
    """Profile the block on the host and the device; on exit fill ``result``
    with the window's device timeline (see :func:`reduce_trace`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_MARK):
            t0 = time.perf_counter()
            yield
            t1 = time.perf_counter()
    prof.export_chrome_trace(str(trace_path))
    result.update(reduce_trace(trace_path, t0, t1))
    trace_path.unlink()


def reduce_trace(trace_path: Path, t0: float, t1: float) -> dict:
    """Device operations inside the window of a Chrome trace, on the host
    clock: ``ops`` [(name, start, end)], ``busy_s`` (their union),
    ``window_s``."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    mark = next(e for e in events if e.get("name") == WINDOW_MARK and e.get("ph") == "X")
    # the mark spans t0..t1 on the host clock: map trace microseconds onto it
    base = float(mark["ts"]) - t0 * 1e6
    lo, hi = t0, t1
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = (float(e["ts"]) - base) / 1e6
        f = s + float(e.get("dur", 0.0)) / 1e6
        s, f = max(s, lo), min(f, hi)
        if f > s:
            ops.append((e["name"], s, f))
    ops.sort(key=lambda o: o[1])
    busy, end = 0.0, lo
    for _, s, f in ops:
        if f > end:
            busy += f - max(s, end)
            end = f
    return {"ops": ops, "busy_s": busy, "window_s": hi - lo, "t0": lo, "t1": hi}


def idle_gaps(device: dict, spans: list):
    """The device's idle time inside the window, summed by the innermost
    host span open at each moment of it (``host`` where none is open)."""
    gaps, end = [], device["t0"]
    for _, s, f in device["ops"]:
        if s > end:
            gaps.append((end, s))
        end = max(end, f)
    if device["t1"] > end:
        gaps.append((end, device["t1"]))
    # cut the window at every span boundary; each piece belongs to the
    # shortest span that covers it
    inside = [t for _, s, f in spans for t in (s, f) if device["t0"] <= t <= device["t1"]]
    cuts = sorted({device["t0"], device["t1"], *inside})
    by_len = sorted(spans, key=lambda sp: sp[2] - sp[1])
    owner = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        owner.append((a, b, next((n for n, s, f in by_len if s <= mid <= f), "host")))
    by_span: dict = {}
    i = 0
    for a, b in gaps:
        while i < len(owner) and owner[i][1] <= a:
            i += 1
        j = i
        while j < len(owner) and owner[j][0] < b:
            lo, hi = max(a, owner[j][0]), min(b, owner[j][1])
            if hi > lo:
                by_span[owner[j][2]] = by_span.get(owner[j][2], 0.0) + (hi - lo)
            j += 1
    return sorted(by_span.items(), key=lambda kv: -kv[1])


def top_ops(device: dict, n: int = 10):
    by_name: dict = {}
    for name, s, f in device["ops"]:
        by_name[name] = by_name.get(name, 0.0) + (f - s)
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
