"""Exon-skipping support checks against linear alignments (SAM text).

Equivalents of the reference's manual verification tools for the human
experiment (``exps/3-homo-real/README.md:58-61``):

* ``check_coverage.py`` — for each true skipped exon, enumerate the
  flanking exon triples from the GTF and count alignments whose spliced
  CIGAR ``N`` gaps match the upstream intron, downstream intron, or the
  skipping intron (``check_coverage.py:37-80``). The reference reads BAMs
  via pysam; here plain SAM text (e.g. the ``gaf2sam`` subcommand's
  output) is parsed directly — no pysam dependency.
* ``check_novel.py`` — classify each true skipped exon as novel (no
  annotated transcript contains the skipping intron) or annotated
  (``check_novel.py:31-60``). DIVERGENCE: the reference keeps a single
  ``skipped_exon`` variable per gene, so with several true events in one
  gene only the last is reported (``check_novel.py:44,59-60``); we report
  every event.

Region strings are ``chrom:start-end`` (1-based inclusive, GTF exon
coordinates), as in the reference's truth files.
"""

from __future__ import annotations

import re
import sys
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from pantas_tpu_torch.io.gtf import parse_transcript_models

_N_RE = re.compile(r"([0-9]+)N")
_CIG_RE = re.compile(r"([0-9]+)([MIDNSHP=X])")
_REF_CONSUMING = set("MDN=X")


def flanking_triples(
    gtf_path: str, events: Set[str]
) -> Dict[str, Set[Tuple[str, int, int, int, int]]]:
    """Per skipped-exon region: the (chrom, c1, c2, c3, c4) flank tuples.

    c1 = upstream exon end, (c2, c3) = the skipped exon, c4 = downstream
    exon start — one tuple per transcript triple whose middle exon equals
    the event (``check_coverage.py:48-62``).
    """
    out: Dict[str, Set[Tuple[str, int, int, int, int]]] = defaultdict(set)
    for tx in parse_transcript_models(gtf_path).values():
        exons = sorted(tx.exons)
        for e1, e2, e3 in zip(exons[:-2], exons[1:-1], exons[2:]):
            key = f"{tx.chrom}:{e2[0]}-{e2[1]}"
            if key in events:
                out[key].add((tx.chrom, e1[1], e2[0], e2[1], e3[0]))
    return dict(out)


def _ref_span(pos: int, cigar: str) -> int:
    """1-based inclusive reference end of an alignment."""
    span = 0
    for n, op in _CIG_RE.findall(cigar):
        if op in _REF_CONSUMING:
            span += int(n)
    return pos + span - 1


def count_junction_support(
    sam_path: str, chrom: str, lo: int, hi: int, intron_lengths: Iterable[int]
) -> Dict[int, int]:
    """Count spliced alignments whose ``N`` gap equals a wanted length.

    Scans SAM text for reads on ``chrom`` overlapping [lo, hi]; every
    ``<n>N`` CIGAR token matching a wanted length bumps that length's
    counter (each occurrence counts, as the reference's findall loop does,
    ``check_coverage.py:69-75``).
    """
    introns: Dict[int, int] = {int(l): 0 for l in intron_lengths}
    with open(sam_path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 6 or fields[2] != chrom:
                continue
            cigar = fields[5]
            if "N" not in cigar or cigar == "*":
                continue
            pos = int(fields[3])
            if pos > hi or _ref_span(pos, cigar) < lo:
                continue
            for m in _N_RE.findall(cigar):
                n = int(m)
                if n in introns:
                    introns[n] += 1
    return introns


def check_skipping_support(
    events_path: str, gtf_path: str, sam_paths: Sequence[str], out=sys.stdout
) -> int:
    """The ``check_coverage.py`` flow: events file (one region per line) +
    GTF + alignment files -> per-event per-file support counts."""
    events = {line.strip("\n") for line in open(events_path) if line.strip()}
    triples = flanking_triples(gtf_path, events)
    flat: Set[Tuple[str, int, int, int, int]] = set()
    for tuples in triples.values():
        flat.update(tuples)
    n_rows = 0
    for chrom, c1, c2, c3, c4 in sorted(flat):
        # upstream intron, downstream intron, skipping intron
        wanted = {c2 - c1 - 1, c4 - c3 - 1, c4 - c1 - 1}
        for sam in sam_paths:
            counts = count_junction_support(sam, chrom, c1, c4, wanted)
            print(
                f"{chrom}:{c2}-{c3}",
                sam,
                " ".join(str(counts[k]) for k in sorted(counts)),
                file=out,
            )
            n_rows += 1
    return n_rows


def classify_novel_skips(
    regions: Iterable[str], gtf_path: str
) -> Dict[str, bool]:
    """For each skipped-exon region: True if NO annotated transcript
    contains an intron that skips it (``check_novel.py:31-60``)."""
    regions = set(regions)
    gene_tx: Dict[str, List] = defaultdict(list)
    for tx in parse_transcript_models(gtf_path).values():
        gene_tx[tx.gene].append(tx)
    out: Dict[str, bool] = {}
    for gene, txs in gene_tx.items():
        skipping: Dict[str, Set[Tuple[int, int]]] = defaultdict(set)
        all_introns: Set[Tuple[int, int]] = set()
        for tx in txs:
            exons = sorted(tx.exons)
            introns = [(a[1], b[0]) for a, b in zip(exons[:-1], exons[1:])]
            all_introns.update(introns)
            for i1, i2 in zip(introns[:-1], introns[1:]):
                key = f"{tx.chrom}:{i1[1]}-{i2[0]}"
                if key in regions:
                    skipping[key].add((i1[0], i2[1]))
        for key, skips in skipping.items():
            out[key] = not (skips & all_introns)
    return out
