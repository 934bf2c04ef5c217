"""Project graph alignments (GAF) to linear SAM records.

Equivalent of the reference's manual verification tool
``exps/3-homo-real/workflow/scripts/gaf2sam.py`` (invoked by hand for IGV
inspection, ``exps/3-homo-real/README.md:58-61`` neighborhood): each GAF
walk is converted to a spliced linear alignment (M runs over node lengths,
N gaps where consecutive nodes are not adjacent on the reference) against
per-node linear positions.

Two position sources:

* **positions file** (faithful mode) — the reference script's third argv: a
  TSV ``path_name\\tpos1,pos2,...`` giving the linear position of every node
  of every (non ``_R1``) P line (``gaf2sam.py:36-48``). Output records are
  byte-identical to the reference script's stdout (differential-tested);
  the reference's hardcoded hg38 ``@SQ`` header (``gaf2sam.py:11-30``) is
  available via ``sq="hg38"``.
* **from-graph mode** — node positions derived from the graph's own
  chromosome reference paths by cumulative node length (our build layer
  emits the full chromosome as a P line, start position 1), with ``@SQ``
  lengths summed from the same walk. This removes the reference's external
  positions-file dependency and hardcoded header.

Replicated reference quirks (load-bearing for the differential):

* a node whose stored position is ``.`` or absent inherits
  ``last_p + node_len - 1`` (``gaf2sam.py:79-81``);
* a non-positive reference gap drops the node's M run entirely and does not
  advance ``last_p`` (``skipped_n`` counter, ``gaf2sam.py:83-87``);
* ``total`` counts only placed alignments (``*`` walks skip before the
  counter, ``gaf2sam.py:59-61``).
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, List, Optional, Tuple

# The reference script's hardcoded header, same order (gaf2sam.py:11-30).
HG38_SQ: List[Tuple[str, int]] = [
    ("chr13", 114364328), ("chr6", 170805979), ("chrX", 156040895),
    ("chr21", 46709983), ("chr16", 90338345), ("chr7", 159345973),
    ("chr1", 248956422), ("chr9", 138394717), ("chr14", 107043718),
    ("chr20", 64444167), ("chr17", 83257441), ("chr4", 190214555),
    ("chr11", 135086622), ("chr15", 101991189), ("chr12", 133275309),
    ("chr5", 181538259), ("chr10", 133797422), ("chr2", 242193529),
    ("chr8", 145138636), ("chr3", 198295559),
]


def load_positions(path: str) -> Dict[str, list]:
    """Parse the ``path\\tpos,pos,...`` file (gaf2sam.py:36-38)."""
    ref_positions: Dict[str, list] = {}
    for line in open(path):
        pname, rpos = line.strip("\n").split("\t")
        ref_positions[pname] = [int(x) if x != "." else x for x in rpos.split(",")]
    return ref_positions


def _is_transcript_path(name: str) -> bool:
    """``T_R1`` / ``T_H3`` transcript-copy suffixes from our build layer."""
    if "_" not in name:
        return False
    tail = name.rsplit("_", 1)[1]
    return len(tail) > 1 and tail[0] in "RH" and tail[1:].isdigit()


def index_graph(
    gfa_path: str,
    ref_positions: Optional[Dict[str, list]] = None,
) -> Tuple[Dict[int, object], Dict[int, int], Dict[int, str], List[Tuple[str, int]]]:
    """Build node->position / node->length / node->path maps.

    With ``ref_positions`` given, mirrors gaf2sam.py:39-48: every P line
    whose name does not end in ``_R1`` assigns its nodes positions from the
    file (later paths overwrite earlier, same dict semantics). Without it,
    only chromosome paths (non-transcript names) are used and positions are
    the 1-based cumulative node-length offsets along the walk.

    Returns (nodes, nodes_l, nodes_to_path, sq) where sq is the derived
    ``@SQ`` table (empty in faithful mode — caller picks the header).
    """
    nodes: Dict[int, object] = {}
    nodes_l: Dict[int, int] = {}
    nodes_to_path: Dict[int, str] = {}
    sq: List[Tuple[str, int]] = []
    for line in open(gfa_path):
        if line.startswith("S"):
            _, idx, seq, *attrs = line.strip("\n").split("\t")
            nodes_l[int(idx)] = len(seq)
        elif line.startswith("P"):
            fields = line.strip("\n").split("\t")
            pname, Ns = fields[1], fields[2]
            walk = [int(n[:-1]) for n in Ns.split(",")]
            if ref_positions is not None:
                if pname.endswith("_R1"):
                    continue
                for i, node in enumerate(walk):
                    nodes[node] = ref_positions[pname][i]
                    nodes_to_path[node] = pname
            else:
                if _is_transcript_path(pname):
                    continue
                pos = 1
                for node in walk:
                    nodes[node] = pos
                    nodes_to_path[node] = pname
                    pos += nodes_l[node]
                sq.append((pname, pos - 1))
    return nodes, nodes_l, nodes_to_path, sq


def gaf_to_sam(
    gaf_path: str,
    gfa_path: str,
    positions_path: Optional[str] = None,
    out=sys.stdout,
    sq: object = None,
    log=None,
) -> Tuple[int, int, int]:
    """Convert GAF records to SAM; returns (skipped, skipped_n, total).

    ``sq``: ``"hg38"`` for the reference's hardcoded header, an explicit
    ``[(name, length), ...]`` list, or None to derive from the graph's
    chromosome paths (from-graph mode only).
    """
    ref_positions = load_positions(positions_path) if positions_path else None
    nodes, nodes_l, nodes_to_path, derived_sq = index_graph(gfa_path, ref_positions)

    if sq == "hg38":
        sq_table = HG38_SQ
    elif sq is not None:
        sq_table = list(sq)
    else:
        sq_table = derived_sq

    print("@HD", "VN:1.5", sep="\t", file=out)
    for name, length in sq_table:
        print("@SQ", f"SN:{name}", f"LN:{length}", sep="\t", file=out)

    skipped = 0
    skipped_n = 0
    total = 0
    for line in open(gaf_path):
        rname, rl, rs, re_, strand, path, pl, ps, pe, _, _, mapq, *attrs = (
            line.strip("\n").split("\t")
        )
        if path == "*":
            continue
        total += 1
        if log:
            print(rname, path, mapq, file=log)
        if "<" in path:
            walk = [int(x) for x in path[1:].split("<")]
            walk.reverse()
        else:
            walk = [int(x) for x in path[1:].split(">")]
        if walk[0] not in nodes_to_path or nodes[walk[0]] == ".":
            skipped += 1
            continue
        rpos = [nodes[x] if x in nodes else -1 for x in walk]
        Ls = [nodes_l[x] for x in walk]
        last_p = rpos[0]
        cigar = []
        for n, l, p in zip(walk, Ls, rpos):
            if p == -1 or p == ".":
                # unplaced node inherits its end-anchored guess (gaf2sam.py:79-81)
                p = last_p + l - 1
            if p != last_p:
                gap = p - last_p
                if gap <= 0:
                    # QUIRK gaf2sam.py:83-87: the node's M run is dropped and
                    # last_p does not advance
                    skipped_n += 1
                    continue
                cigar.append((gap, "N"))
            cigar.append((l, "M"))
            last_p = p + l
        compact_cigar = [cigar[0]]
        for l, op in cigar[1:]:
            if op == compact_cigar[-1][1]:
                compact_cigar[-1] = (compact_cigar[-1][0] + l, op)
            else:
                compact_cigar.append((l, op))
        cigar_s = "".join([f"{l}{op}" for l, op in compact_cigar])
        print(
            rname,
            0 if strand == "+" else 16,
            nodes_to_path[walk[0]],
            rpos[0],
            mapq,
            cigar_s,
            "*",
            0,
            0,
            "*",
            "*",
            sep="\t",
            file=out,
        )
    if log:
        print(f"Skipped {skipped} - {skipped_n} over {total} alignments.", file=log)
    return skipped, skipped_n, total
