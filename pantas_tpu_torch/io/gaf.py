"""GAF (graph alignment format) records and the cs-CIGAR tokenizer.

The tokenizer reproduces the reference augmenter's exact cs parsing
semantics (``scripts/alignments_augmentation_from_gaf.py:10-50``), operand
quirks included:

* ``*`` (substitution) always contributes length 1 per token,
* ``~`` (splice) contributes ``len(operand)`` — NOT the intron length
  encoded in the operand (a reference quirk we must match),
* an empty operand after a non-``*`` op contributes length 0,
* consecutive op characters drop the earlier op.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

_OP_SPLIT = re.compile(r"(=|:|\*|\+|\-|\~)")
_OPS = frozenset("=:*+-~")
_CS_TAG = re.compile(r"cs:.*?(?=\s|$)")
_DV_TAG = re.compile(r"dv:f:(\d+(\.\d+)?)")

CsOp = Tuple[str, int]


def tokenize_cs(cs: str) -> List[CsOp]:
    """cs string -> [(op, length)] with reference-identical semantics."""
    out: List[CsOp] = []
    op: Optional[str] = None
    for tok in _OP_SPLIT.split(cs):
        if tok in _OPS:
            op = tok
        elif op is not None:
            if op == "*":
                out.append(("*", 1))
            elif tok.isdigit():
                out.append((op, int(tok)))
            else:
                out.append((op, len(tok)))
            op = None
    return out


def clip_two_op_cs(ops: List[CsOp], start_pos: int, end_pos_rel: int):
    """Clip a 2-op cs of the form (+,:) or (:,+) to its match run.

    A leading insertion advances the path start by its length; a trailing
    insertion is dropped (reference ``cigar_clipping`` semantics).
    Returns (ops, start_pos, end_pos_rel), possibly unchanged.
    """
    if ops[0][0] == "+" and ops[1][0] == ":":
        return [ops[1]], start_pos + ops[0][1], end_pos_rel
    if ops[0][0] == ":" and ops[1][0] == "+":
        return [ops[0]], start_pos, end_pos_rel
    return ops, start_pos, end_pos_rel


@dataclass
class GafRecord:
    name: str
    query_len: int
    query_start: int
    query_end: int
    strand: str
    path: str  # raw path string, e.g. ">1>2>5" or "<9<7"
    path_len: int
    path_start: int
    path_end: int
    matches: int
    block_len: int
    mapq: int
    cs: str  # cs string without the "cs:Z:" prefix, or "*" if absent
    dv: Optional[float]  # divergence, None if absent
    tags_raw: str  # the joined tag fields (for passthrough)

    def walk(self) -> Tuple[List[str], bool]:
        """Path string -> (node ids with consecutive duplicates removed, reverse?).

        Matches the reference walk extraction: the orientation of the FIRST
        step decides forward/reverse, and the path is split only on that
        orientation character (mixed-orientation paths are not supported by
        the reference either).
        """
        nodes: List[str] = []
        rev = self.path[0] == "<"
        sep = "<" if rev else ">"
        for n in self.path.split(sep)[1:]:
            if not nodes or nodes[-1] != n:
                nodes.append(n)
        return nodes, rev


def parse_gaf_line(line: str) -> GafRecord:
    tokens = line.strip().split()
    tags_raw = " ".join(tokens[12:])
    m = _CS_TAG.search(tags_raw)
    cs = m.group(0).replace("cs:Z:", "") if m else "*"
    dm = _DV_TAG.search(tags_raw)
    dv = float(dm.group(1)) if dm else None
    return GafRecord(
        name=tokens[0],
        query_len=int(tokens[1]),
        query_start=int(tokens[2]),
        query_end=int(tokens[3]),
        strand=tokens[4],
        path=tokens[5],
        path_len=int(tokens[6]),
        path_start=int(tokens[7]),
        path_end=int(tokens[8]),
        matches=int(tokens[9]),
        block_len=int(tokens[10]),
        mapq=int(tokens[11]),
        cs=cs,
        dv=dv,
        tags_raw=tags_raw,
    )


def format_gaf_line(
    name: str,
    query_len: int,
    query_start: int,
    query_end: int,
    strand: str,
    path: str,
    path_len: int,
    path_start: int,
    path_end: int,
    matches: int,
    block_len: int,
    mapq: int,
    cs: str,
    dv: float,
) -> str:
    return "\t".join(
        map(
            str,
            [
                name,
                query_len,
                query_start,
                query_end,
                strand,
                path,
                path_len,
                path_start,
                path_end,
                matches,
                block_len,
                mapq,
                f"cs:Z:{cs}",
                f"dv:f:{dv}",
            ],
        )
    )
