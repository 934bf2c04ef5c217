"""GTF parsing.

Two consumers with different needs:

* the event caller needs transcript→gene / gene→strand / gene→chrom maps for
  a fixed set of RNA feature types (reference semantics:
  ``scripts/call.py:188-216``),
* the remapper and the graph build stage need per-transcript sorted exon spans
  (reference semantics: ``scripts/remap.py:49-65``).
"""

from __future__ import annotations
from pbench.reference.xopen import xopen

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

# Feature types that define a transcript record (reference: call.py:196-204).
TRANSCRIPT_FEATURES = frozenset(
    ["mRNA", "transcript", "miRNA", "ncRNA", "pre_miRNA", "snoRNA", "pseudogene"]
)

_GENE_ID_RE = re.compile('gene_id "[A-Za-z0-9_]+";')
_TRANSCRIPT_ID_RE = re.compile('transcript_id "[A-Za-z0-9_]+";')


def parse_transcript_maps(
    gtf_path: str,
) -> Tuple[Dict[str, str], Dict[str, str], Dict[str, str]]:
    """Return (transcript→gene, gene→strand, gene→chrom).

    Matches the reference caller's attribute extraction exactly, including
    the restricted ``[A-Za-z0-9_]+`` id character class.
    """
    transcript2gene: Dict[str, str] = {}
    genestrand: Dict[str, str] = {}
    genechr: Dict[str, str] = {}
    for line in xopen(gtf_path):
        if line.startswith("#"):
            continue
        cols = line.strip("\n").split("\t")
        if cols[2] in TRANSCRIPT_FEATURES:
            gid = _GENE_ID_RE.search(cols[-1]).group(0).split('"')[-2]
            tid = _TRANSCRIPT_ID_RE.search(cols[-1]).group(0).split('"')[-2]
            transcript2gene[tid] = gid
            genestrand[gid] = cols[6]
            genechr[gid] = cols[0]
    return transcript2gene, genestrand, genechr


def parse_exons(
    gtf_path: str, wanted: Optional[Iterable[str]] = None
) -> Dict[str, List[Tuple[int, int]]]:
    """Per-transcript sorted exon (start, end) spans, 1-based inclusive.

    If ``wanted`` is given, only those transcript ids are collected
    (remap semantics); otherwise all transcripts.
    """
    want = set(wanted) if wanted is not None else None
    exons: Dict[str, List[Tuple[int, int]]] = {}
    if want is not None:
        for t in want:
            exons[t] = []
    for line in xopen(gtf_path):
        if line.startswith("#"):
            continue
        cols = line.strip("\n").split("\t")
        if cols[2] != "exon":
            continue
        tid = _TRANSCRIPT_ID_RE.search(cols[-1]).group(0).split('"')[-2]
        if want is not None and tid not in want:
            continue
        exons.setdefault(tid, []).append((int(cols[3]), int(cols[4])))
    for spans in exons.values():
        spans.sort()
    return exons


@dataclass
class Transcript:
    tid: str
    gene: str
    chrom: str
    strand: str
    exons: List[Tuple[int, int]] = field(default_factory=list)  # sorted, 1-based incl.


def parse_transcript_models(gtf_path: str) -> Dict[str, Transcript]:
    """Full transcript models for the graph build stage (chrom/strand/gene/exons)."""
    t2g, gstrand, gchr = parse_transcript_maps(gtf_path)
    exons = parse_exons(gtf_path)
    out: Dict[str, Transcript] = {}
    for tid, gene in t2g.items():
        if tid not in exons or not exons[tid]:
            continue
        out[tid] = Transcript(
            tid=tid,
            gene=gene,
            chrom=gchr[gene],
            strand=gstrand[gene],
            exons=exons[tid],
        )
    return out


def chromosomes(gtf_path: str) -> List[str]:
    """Distinct chromosome names in file order (build scatter axis)."""
    seen: Dict[str, None] = {}
    for line in xopen(gtf_path):
        if line.startswith("#") or not line.strip():
            continue  # a blank line is not a chromosome named "\n"
        seen.setdefault(line.split("\t", 1)[0], None)
    return list(seen)
