"""Per-read coverage semantics: GAF record -> contribution events.

This module is the behavioral contract of the reference augmenter's hot loop
(``scripts/alignments_augmentation_from_gaf.py:134-371``), factored so the
same event stream can feed either the byte-exact host accumulator or the
device scatter-add batches.

Contract notes (reference quirks preserved deliberately):

* mapq filter rejects ``mapq < thr`` (default 20) and counts rejections;
  ``path == '*'`` records and ``dv > 0.1`` records are silently skipped.
* A 2-op cs of (+,:)/(:,+) is clipped to the match run; a leading insertion
  advances ``path_start``.
* The op lengths are distributed over the walk's node spans in order; the
  first node's span is shortened by ``path_start`` and the last node's span
  by ``path_len - path_end - 1`` (the reference's off-by-one: it subtracts
  ``end_pos_rel - 1``).
* Insertions (``+``) consume path span like matches — a reference quirk.
* Nodes whose local alignment is a single pure indel op are dropped before
  any counting; leading substitutions merge into the following op with +1.
* If the cs ops run out before the walk is fully covered, distribution
  stops (the reference raises IndexError on the *next* node; no valid
  input reaches that state).
* IL (entry-offset) / OL (exit-offset) histogram updates fire per
  *compacted op*, not per node, with forward/reverse asymmetry exactly as
  the reference (``:276-356``).
* Edge events are consecutive surviving-node pairs, endpoint-swapped for
  reverse-strand walks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from pantas_tpu_torch.io.gaf import CsOp, GafRecord, clip_two_op_cs, tokenize_cs

DEFAULT_MAPQ_THR = 20
DEFAULT_MAX_DIVERGENCE = 0.1

REJECTED = "rejected"  # mapq below threshold (counted by the reference)
SKIPPED = "skipped"  # unplaced / high divergence (not counted)


@dataclass
class ReadEvents:
    """Coverage contributions of one accepted alignment."""

    nodes: List[str] = field(default_factory=list)  # NC +1 each (dups count twice)
    il: List[Tuple[str, int]] = field(default_factory=list)  # (node, entry offset)
    ol: List[Tuple[str, int]] = field(default_factory=list)  # (node, exit offset)
    edges: List[Tuple[str, str]] = field(default_factory=list)  # RC +1 each


def _spread_ops(
    nodes: List[str],
    node_len: Dict[str, int],
    ops: List[CsOp],
    start_pos: int,
    end_pos_rel: int,
) -> List[Tuple[str, List[CsOp]]]:
    """Distribute op lengths over per-node path spans (destructive on ops)."""
    per_node: List[Tuple[str, List[CsOp]]] = []
    last = len(nodes) - 1
    for i, nid in enumerate(nodes):
        span = node_len[nid]
        if i == 0:
            span -= start_pos
        if i == last:
            span -= end_pos_rel - 1
        local: Optional[List[CsOp]] = None
        while span > 0:
            if not ops:
                # ops exhausted mid-walk: stop (see contract notes)
                return per_node
            op, ln = ops[0]
            if span <= ln:
                piece = (op, span)
                if ln - span == 0:
                    ops.pop(0)
                else:
                    ops[0] = (op, ln - span)
                span = 0
            else:
                piece = (op, ln)
                ops.pop(0)
                span -= ln
            if local is None:
                local = [piece]
                per_node.append((nid, local))
            else:
                local.append(piece)
    return per_node


def _compact(oplist: List[CsOp]) -> List[CsOp]:
    """Merge runs; absorb substitutions into the neighboring op."""
    out: List[CsOp] = []
    for i, (op, ln) in enumerate(oplist):
        if i == 0:
            if op == "*":
                continue  # merged into the next op with +1 below
            out.append((op, ln))
        elif not out:
            out.append((op, ln + 1))
        elif op == out[-1][0] or op == "*":
            out[-1] = (out[-1][0], out[-1][1] + ln)
        else:
            out.append((op, ln))
    return out


def _clean(per_node: List[Tuple[str, List[CsOp]]]) -> List[Tuple[str, List[CsOp]]]:
    """Drop single pure-indel nodes, compact the rest."""
    out = []
    for nid, oplist in per_node:
        if len(oplist) == 1 and oplist[0][0] in ("-", "+"):
            continue
        out.append((nid, _compact(oplist)))
    return out


def read_events(
    rec: GafRecord,
    node_len: Dict[str, int],
    mapq_thr: int = DEFAULT_MAPQ_THR,
    max_dv: float = DEFAULT_MAX_DIVERGENCE,
):
    """Compute one alignment's coverage events.

    Returns a :class:`ReadEvents`, or the sentinel strings :data:`REJECTED`
    (mapq too low) / :data:`SKIPPED` (unplaced or too divergent).
    """
    if rec.mapq < mapq_thr:
        return REJECTED
    if rec.path == "*":
        return SKIPPED

    start_pos = rec.path_start
    end_pos_rel = rec.path_len - rec.path_end
    ops = tokenize_cs(rec.cs)
    if len(ops) == 2:
        ops, start_pos, end_pos_rel = clip_two_op_cs(ops, start_pos, end_pos_rel)
    if rec.dv is not None and rec.dv > max_dv:
        return SKIPPED

    nodes, rev = rec.walk()
    assert len(nodes) > 0

    aligned = _clean(_spread_ops(nodes, node_len, ops, start_pos, end_pos_rel))

    ev = ReadEvents()
    ev.nodes = [nid for nid, _ in aligned]

    last_i = len(aligned) - 1
    for i, (nid, oplist) in enumerate(aligned):
        length = node_len[nid]
        last_j = len(oplist) - 1
        for j, (op, ln) in enumerate(oplist):
            if op == "-":
                if not rev:
                    if i != 0 and j == 0:
                        ev.il.append((nid, ln))
                    if i != last_i and j == last_j:
                        ev.ol.append((nid, length - ln - 1))
                else:
                    if i != 0 and j == 0:
                        ev.ol.append((nid, length - 1 - ln))
                    if i != last_i and j == last_j:
                        ev.il.append((nid, ln))
            elif op != "*":
                if not rev:
                    if i != 0:
                        ev.il.append((nid, 0))
                    if i != last_i:
                        ev.ol.append((nid, length))
                else:
                    if i != last_i:
                        ev.il.append((nid, 0))
                    if i != 0:
                        ev.ol.append((nid, length))

    for a, b in zip(ev.nodes, ev.nodes[1:]):
        ev.edges.append((b, a) if rev else (a, b))
    return ev
