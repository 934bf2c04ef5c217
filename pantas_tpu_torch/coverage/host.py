"""Stream-order coverage accumulator + byte-identical augmented-GFA emission.

Insertion orders are semantically irrelevant but preserved so the emitted
GFA is byte-identical to the reference augmenter on the same inputs:

* IL/OL offsets print in first-seen order per node,
* novel links print in first-seen order of the (from, to) pair,
* known-link RC consumes (pops) the accumulated weight, leftovers become
  novel ``L .. RC:i:w ID:Z:N`` lines.
"""

from __future__ import annotations
from pantas_tpu_torch.io.xopen import xopen

import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, TextIO, Tuple

from pantas_tpu_torch.coverage.semantics import (
    DEFAULT_MAPQ_THR,
    REJECTED,
    SKIPPED,
    ReadEvents,
    read_events,
)
from pantas_tpu_torch.io.gaf import parse_gaf_line


@dataclass
class CoverageCounts:
    """Accumulated coverage with first-seen insertion orders."""

    node_len: Dict[str, int] = field(default_factory=dict)
    nc: Dict[str, int] = field(default_factory=dict)
    il: Dict[str, Dict[int, int]] = field(default_factory=dict)
    ol: Dict[str, Dict[int, int]] = field(default_factory=dict)
    edge: Dict[Tuple[str, str], int] = field(default_factory=dict)
    rejected: int = 0
    accepted: int = 0
    skipped: int = 0

    def add(self, ev: ReadEvents) -> None:
        for n in ev.nodes:
            self.nc[n] = self.nc.get(n, 0) + 1
        for n, off in ev.il:
            d = self.il.setdefault(n, {})
            d[off] = d.get(off, 0) + 1
        for n, off in ev.ol:
            d = self.ol.setdefault(n, {})
            d[off] = d.get(off, 0) + 1
        for pair in ev.edges:
            self.edge[pair] = self.edge.get(pair, 0) + 1


def load_node_lengths(gfa_path: str) -> Dict[str, int]:
    """Pass 1: segment id -> sequence length (file order preserved)."""
    lens: Dict[str, int] = {}
    with xopen(gfa_path) as fh:
        for line in fh:
            if line.startswith("S"):
                tokens = line.strip().split()
                lens[tokens[1]] = len(tokens[2])
    return lens


def accumulate_gaf(
    gaf_lines: Iterable[str],
    node_len: Dict[str, int],
    mapq_thr: int = DEFAULT_MAPQ_THR,
    counts: Optional[CoverageCounts] = None,
) -> CoverageCounts:
    """Accumulate coverage events over a GAF line stream."""
    if counts is None:
        counts = CoverageCounts(node_len=node_len)
    for line in gaf_lines:
        if not line.strip():
            continue
        ev = read_events(parse_gaf_line(line), node_len, mapq_thr)
        if ev is REJECTED:
            counts.rejected += 1
        elif ev is SKIPPED:
            counts.skipped += 1
        else:
            counts.accepted += 1
            counts.add(ev)
    return counts


def _offset_list(d: Dict[int, int]) -> str:
    return ",".join(f"{off}.{cnt}" for off, cnt in d.items())


def emit_augmented_gfa(gfa_path: str, counts: CoverageCounts, out: TextIO) -> None:
    """Pass 2: re-emit the GFA with NC/IL/OL on S lines and RC on L lines."""
    edge_left = dict(counts.edge)
    with xopen(gfa_path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("S"):
                tokens = line.split()
                nid = tokens[1]
                tail = f"\tNC:i:{counts.nc.get(nid, 0)}"
                il = counts.il.get(nid)
                ol = counts.ol.get(nid)
                if il:
                    tail += f"\tIL:Z:{_offset_list(il)}"
                if ol:
                    tail += f"\tOL:Z:{_offset_list(ol)}"
                print(f"{line}{tail}", file=out)
            elif line.startswith("L"):
                if len(line) == 1:
                    continue
                tokens = line.split()
                w = edge_left.pop((tokens[1], tokens[3]), 0)
                print(f"{line}\tRC:i:{w}", file=out)
            else:
                print(line, file=out)
    for (a, b), w in edge_left.items():
        print(f"L\t{a}\t+\t{b}\t+\t*\tRC:i:{w}\tID:Z:N", file=out)


def augment_gfa(
    gaf_path: str,
    gfa_path: str,
    out: TextIO = sys.stdout,
    mapq_thr: int = DEFAULT_MAPQ_THR,
    log: TextIO = sys.stderr,
) -> CoverageCounts:
    """Full augment stage: GAF + GFA -> augmented GFA on ``out``."""
    print("Read GFA", file=log)
    node_len = load_node_lengths(gfa_path)
    print("Augmentation by GAF alignments", file=log)
    with xopen(gaf_path) as fh:
        counts = accumulate_gaf(fh, node_len, mapq_thr)
    print(f"Rejected alignments: {counts.rejected}", file=log)
    print("Annotating GFA", file=log)
    emit_augmented_gfa(gfa_path, counts, out)
    return counts
