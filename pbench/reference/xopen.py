"""Plain or gzip text files: what the frozen build code reads and writes."""

from __future__ import annotations

import gzip


def xopen(path, mode: str = "rt", **kw):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, mode if "b" in mode or "t" in mode else mode + "t", **kw)
    return open(p, mode, **kw)
