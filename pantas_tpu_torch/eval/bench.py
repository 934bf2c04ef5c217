"""Stage benchmark records: GNU ``time -v`` parsing, timing runner, tables.

Equivalent of the reference's bench machinery: every pipeline stage in the
exps workflows is wrapped in ``/usr/bin/time --verbose`` and the resulting
``.time`` files are folded into one CSV by
``exps/2-dm-real/workflow/scripts/compare_bench.py``. Here:

* :func:`parse_time_verbose` — same field extraction as
  ``compare_bench.py:10-29`` (differential-tested against it), including
  the base-60 wall-clock fold and the leading-character strip;
* :func:`run_timed` — runs a command and writes a ``time -v``-format
  ``.time`` file from ``os.wait4`` rusage (no GNU time dependency);
* :func:`collect` — walks a bench dir of ``<tool>/<stage>[...].time``
  files into one CSV with the same columns as the reference's
  ``bench.csv`` (``compare_bench.py:44-46,184``), with ``w`` recovered
  from a ``.w<N>.time`` suffix instead of the snakemake-side Ws list.
"""

from __future__ import annotations

import csv
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

COLUMNS = ["tool", "file_name", "w", "user_time", "sys_time", "wall_clock", "max_mem"]


def parse_time_verbose(time_file: str, tool: str) -> Dict[str, list]:
    """Extract user/sys/wall/maxRSS from a ``time -v`` log.

    Field-for-field the reference's parser (``compare_bench.py:10-29``):
    each line loses its first character (the tab indent) and its last (the
    newline), splits on ``:``, and the wall clock folds the trailing
    tokens base-60 (``h:mm:ss`` or ``m:ss`` both work).
    """
    res: Dict[str, list] = {}
    res["tool"] = [tool]
    res["file_name"] = [time_file.split("/")[-1].split(".")[0]]
    res["w"] = ["none"]
    for line in open(time_file):
        line = line[1:-1]
        tokens = line.split(sep=":")
        if tokens[0] == "User time (seconds)":
            res["user_time"] = [float(tokens[1].lstrip())]
        if tokens[0] == "System time (seconds)":
            res["sys_time"] = [float(tokens[1].lstrip())]
        if tokens[0] == "Maximum resident set size (kbytes)":
            res["max_mem"] = [int(tokens[1].lstrip())]
        if tokens[0] == "Elapsed (wall clock) time (h":
            tot = 0.0
            for x in tokens[4:]:
                tot = tot * 60 + float(x.lstrip())
                res["wall_clock"] = [tot]
    return res


def _format_wall(seconds: float) -> str:
    """GNU time's elapsed format: ``h:mm:ss`` or ``m:ss.cc``."""
    h = int(seconds // 3600)
    m = int((seconds % 3600) // 60)
    s = seconds % 60
    if h:
        return f"{h}:{m:02d}:{int(s):02d}"
    return f"{m}:{s:05.2f}"


def run_timed(cmd: Sequence[str], time_file: str, stdout=None, stderr=None) -> int:
    """Run ``cmd`` and write a ``time -v``-format log to ``time_file``.

    Uses ``os.wait4`` rusage, so it needs no GNU time binary; the emitted
    file round-trips through :func:`parse_time_verbose` (and through the
    reference's parser — same line grammar).
    """
    t0 = time.monotonic()
    proc = subprocess.Popen(list(cmd), stdout=stdout, stderr=stderr)
    _, status, ru = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    wall = time.monotonic() - t0
    with open(time_file, "w") as fh:
        shown = " ".join(cmd)
        fh.write(f'\tCommand being timed: "{shown}"\n')
        fh.write(f"\tUser time (seconds): {ru.ru_utime:.2f}\n")
        fh.write(f"\tSystem time (seconds): {ru.ru_stime:.2f}\n")
        fh.write(
            f"\tElapsed (wall clock) time (h:mm:ss or m:ss): {_format_wall(wall)}\n"
        )
        fh.write(f"\tMaximum resident set size (kbytes): {ru.ru_maxrss}\n")
        fh.write(f"\tExit status: {proc.returncode}\n")
    return proc.returncode


def _w_from_name(name: str) -> str:
    """Recover the ``-w`` setting from a ``stage.….w<N>.time`` file name."""
    parts = name.split(".")
    for p in parts[1:]:
        if len(p) > 1 and p[0] == "w" and p[1:].isdigit():
            return p[1:]
    return "none"


def collect(bench_dir: str, out=sys.stdout) -> List[Dict[str, object]]:
    """Fold every ``.time`` file under ``bench_dir`` into one CSV table.

    Tool = the file's directory relative to ``bench_dir`` (files directly
    in ``bench_dir`` use their stage name as tool, matching the reference's
    top-level ``rmats.time``), rows sorted by path for determinism.
    """
    root = Path(bench_dir)
    rows: List[Dict[str, object]] = []
    for path in sorted(root.rglob("*.time")):
        rel = path.relative_to(root)
        tool = str(rel.parent) if str(rel.parent) != "." else rel.name.split(".")[0]
        rec = parse_time_verbose(str(path), tool)
        rec["w"] = [_w_from_name(rel.name)]
        rows.append({k: v[0] for k, v in rec.items()})
    writer = csv.DictWriter(out, fieldnames=COLUMNS)
    writer.writeheader()
    for row in rows:
        writer.writerow({k: row.get(k, "") for k in COLUMNS})
    return rows
