"""Gene-panel graph reduction (hp=2 mode).

Replaces the reference's ``build/reduce.py``: keep only nodes whose id falls
inside the [min, max] id interval of some transcript path (± k), and split
the reference path into kept sub-paths named ``{name}.N``
(``reduce.py:12-67``).
"""

from __future__ import annotations

from bisect import bisect_right
from typing import List, Sequence, Tuple


class IdIntervals:
    """Merged integer intervals with O(log n) membership."""

    def __init__(self, intervals: Sequence[Tuple[int, int]]):
        merged: List[Tuple[int, int]] = []
        for s, e in sorted(intervals):
            if merged and s <= merged[-1][1] + 1:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]

    def __contains__(self, x: int) -> bool:
        i = bisect_right(self.starts, x) - 1
        return i >= 0 and x <= self.ends[i]

    def __len__(self) -> int:
        return len(self.starts)


def transcript_intervals(paths: Sequence[Sequence[int]], k: int = 0) -> IdIntervals:
    """One id interval per transcript path, extended by k, merged."""
    return IdIntervals(
        [(min(p) - k, max(p) + k) for p in paths if p]
    )


def reduce_gfa(gfa_path: str, out, tridx: str = "ENST", k: int = 0, log=None) -> None:
    """Standalone GFA reducer, byte-compatible with the reference tool.

    Replicates ``build/reduce.py`` stdout exactly:

    - every P line whose name does NOT start with ``tridx`` is a reference-
      path candidate; the LAST one seen wins, earlier ones vanish from the
      output entirely (``reduce.py:14-18`` overwrite semantics);
    - transcript paths contribute the id interval [min-k, max+k]
      (``reduce.py:21-27``; half-open ``tree[min-k : max+k+1]``);
    - S lines kept iff the id is covered, L lines iff both endpoints are
      (``reduce.py:37-46``); transcript P lines pass through verbatim
      (``reduce.py:47-50``);
    - the kept reference path is split into ``{name}.N`` sub-paths at
      dropped nodes — and the FINAL sub-path is never flushed after the
      loop, so a reference path that ends inside a kept interval loses its
      last segment (QUIRK, ``reduce.py:52-67``: no flush after the for).
    - reverse-orientation transcript paths must be ascending once reversed
      (assert at ``reduce.py:22-25``).
    """
    import sys

    log = sys.stderr if log is None else log
    ref_name = ""
    ref_path: List[int] = []
    intervals: List[Tuple[int, int]] = []
    with open(gfa_path) as fh:
        for line in fh:
            if not line.startswith("P"):
                continue
            _, name, nodes, _ = line.rstrip("\n").split("\t")
            if not name.startswith(tridx):
                ref_name = name
                ref_path = [int(x[:-1]) for x in nodes.split(",")]
                continue
            plus = nodes[-1] == "+"
            ids = [int(x[:-1]) for x in nodes.split(",")]
            lo, hi = min(ids), max(ids)
            if not plus:
                ids.reverse()
            assert all(b >= a for a, b in zip(ids[:-1], ids[1:]))
            intervals.append((lo - k, hi + k))

    print(f"We have {len(intervals)} unique transcripts", file=log)
    tree = IdIntervals(intervals)
    print(f"We have {len(tree)} genic regions", file=log)

    w = out.write
    with open(gfa_path) as fh:
        for line in fh:
            if line.startswith("S"):
                _, idx, _ = line.rstrip("\n").split("\t")
                if int(idx) in tree:
                    w(line)
            elif line.startswith("L"):
                _, a, _, b, _, _ = line.rstrip("\n").split("\t")
                if int(a) in tree and int(b) in tree:
                    w(line)
            elif line.startswith("P"):
                _, name, _, _ = line.rstrip("\n").split("\t")
                if name.startswith(tridx):
                    w(line)

    sub: List[int] = []
    i = 0
    for n in ref_path:
        if n in tree:
            sub.append(n)
        elif sub:
            steps = ",".join(f"{x}+" for x in sub)
            w(f"P\t{ref_name}.{i}\t{steps}\t*\n")
            i += 1
            sub = []
    # QUIRK preserved: trailing `sub` intentionally not flushed (reference
    # drops the final kept sub-path, reduce.py:52-67).
