"""Per-chromosome GFA merge with monotone node-id shifting.

Replaces the reference's ``build/combine.py``: assumes each input GFA's ids
start at 1 and are topologically sorted; shifts each file's ids by the
running maximum so the combined graph keeps globally sorted ids
(``combine.py:5-6``).
"""

from __future__ import annotations

import sys
from typing import Sequence, TextIO


def combine_gfas(paths: Sequence[str], out: TextIO, log=sys.stderr) -> None:
    shift = 0
    max_id = 0
    print("H", "VN:Z:1.1", sep="\t", file=out)
    for path in paths:
        for line in open(path):
            kind = line[0] if line else ""
            if kind == "H":
                continue
            if kind == "S":
                _, sid, seq, *rest = line.rstrip("\n").split("\t")
                sid = int(sid) + shift
                max_id = max(sid, max_id)
                fields = ["S", str(sid), seq] + rest
                print("\t".join(fields), file=out)
            elif kind == "L":
                _, a, ao, b, bo, *rest = line.rstrip("\n").split("\t")
                print(
                    "\t".join(["L", str(int(a) + shift), ao, str(int(b) + shift), bo] + rest),
                    file=out,
                )
            elif kind == "P":
                _, name, steps, *rest = line.rstrip("\n").split("\t")
                shifted = ",".join(
                    str(int(s[:-1]) + shift) + s[-1] for s in steps.split(",")
                )
                print("\t".join(["P", name, shifted] + rest), file=out)
            elif kind == "W":
                _, wname, i1, i2, i3, i4, walk = line.rstrip("\n").split("\t")
                # mixed-orientation walks: shift every step id, keep orients
                parts = []
                i = 0
                while i < len(walk):
                    orient = walk[i]
                    j = i + 1
                    while j < len(walk) and walk[j] not in "><":
                        j += 1
                    parts.append(orient + str(int(walk[i + 1 : j]) + shift))
                    i = j
                if i2 == "":
                    i2 = "-"
                print("\t".join(["W", wname, i1, i2, i3, i4, "".join(parts)]), file=out)
            else:
                print(line.rstrip("\n"), file=out)
        print(f"[combine] merged {path} at shift {shift}; next shift {max_id}", file=log)
        shift = max_id
