"""Small exps-workflow helpers (1-dm-sim scripts).

Behavioral contracts, with reference quirks preserved and cited:

* :func:`filter_reads` — ``exps/1-dm-sim/scripts/filter_reads.py``: drop
  read pairs whose name carries ``mate1Start:1;mate2Start:1`` (ASimulatoR
  edge artifacts) and patch 'N' bases. QUIRK kept: ONE random base is
  drawn per record and replaces ALL of that record's N's
  (``filter_reads.py:30-32``); the reference seeds nothing, so outputs are
  nondeterministic — we accept an optional seed for reproducibility.
* :func:`fix_vidx` — ``scripts/fix_vidx.py``: rewrite VCF ids to
  ``{contig}-{pos}.{i}`` with ``chr`` prefixes stripped. QUIRKS kept: the
  per-position counter is broken (``last_pos`` is never updated and ``i``
  never increments, so every id ends ``.1``, ``fix_vidx.py:20-26``);
  records whose contig does NOT start with ``chr`` are silently dropped
  (``:27-28``); ``replace("chr", "")`` hits every occurrence in ##contig
  header lines. (The reference uses pysam, unavailable here; this is a
  text-level reimplementation of the same transform.)
* :func:`clean_gtf` — ``scripts/clean_gtf.py``: keep only the GTF lines of
  genes that overlap no other gene. QUIRKS kept: the overlap flag stored
  per gene is "did an overlapping gene PRECEDE it in file order", so of an
  overlapping pair the FIRST gene still passes the data check but fails
  the exactly-one-hit check (both genes drop — net behavior preserved);
  lines before the first ``gene`` record crash the reference with an
  unbound ``pflag`` (``clean_gtf.py:28-31``) — mirrored.
"""

from __future__ import annotations

import random
import sys
from typing import Dict, List, Optional, Tuple


def filter_reads(
    fq1_path: str,
    fq2_path: str,
    out1_path: Optional[str] = None,
    out2_path: Optional[str] = None,
    seed: Optional[int] = None,
) -> Tuple[str, str]:
    import os

    rng = random.Random(seed) if seed is not None else random
    out1_path = out1_path or os.path.splitext(fq1_path)[0] + ".clean.fq"
    out2_path = out2_path or os.path.splitext(fq2_path)[0] + ".clean.fq"

    def records(path):
        with open(path) as fh:
            while True:
                h = fh.readline()
                if not h:
                    break
                seq = fh.readline().rstrip("\n")
                plus = fh.readline().rstrip("\n")
                qual = fh.readline().rstrip("\n")
                yield h[1:].strip().split(" ")[0], seq, qual

    drop = set()
    for path in (fq1_path, fq2_path):
        for rid, _seq, _q in records(path):
            if "mate1Start:1;mate2Start:1" in rid:
                drop.add(rid.split("/")[0])

    for path, out_path in ((fq1_path, out1_path), (fq2_path, out2_path)):
        with open(out_path, "w") as out:
            for rid, seq, qual in records(path):
                if rid.split("/")[0] in drop:
                    continue
                if "N" in seq:
                    # QUIRK: one base replaces ALL N's of the record
                    seq = seq.replace("N", rng.choice(["A", "C", "G", "T"]))
                out.write(f"@{rid}\n{seq}\n+\n{qual}\n")
    return out1_path, out2_path


def fix_vidx(in_fh, out=sys.stdout) -> None:
    p = lambda s: print(s, file=out)
    for line in in_fh:
        line = line.rstrip("\n")
        if line.startswith("##"):
            if line.startswith("##contig="):
                line = line.replace("chr", "")
            p(line)
            continue
        if line.startswith("#CHROM"):
            p(line)
            continue
        cols = line.split("\t")
        contig, pos = cols[0], cols[1]
        # QUIRK: the reference's counter never advances — every id ends .1
        cols[2] = contig.replace("chr", "") + "-" + pos + ".1"
        if contig.startswith("chr"):
            p("\t".join(cols)[3:])


def clean_gtf(gtf_path: str, out=sys.stdout) -> None:
    # first pass: per-gene "an overlapping gene preceded me" flags
    trees: Dict[str, List[Tuple[int, int, bool]]] = {}
    for line in open(gtf_path):
        if line.startswith("#"):
            continue
        chrom, _, t, s, e = line.split("\t")[0:5]
        if t != "gene":
            continue
        s, e = int(s), int(e) + 1
        ivs = trees.setdefault(chrom, [])
        overlapped = any(a < e and b > s for a, b, _ in ivs)
        if (s, e, overlapped) not in ivs:  # set-insert dedupe semantics
            ivs.append((s, e, overlapped))

    pflag = None
    for line in open(gtf_path):
        if line.startswith("#"):
            continue
        chrom, _, t, s, e = line.split("\t")[0:5]
        s, e = int(s), int(e) + 1
        hits = [iv for iv in trees.get(chrom, []) if iv[0] < e and iv[1] > s]
        if t == "gene":
            pflag = len(hits) == 1
        if pflag is None:
            # QUIRK: the reference reads `pflag` before any gene line and
            # crashes with UnboundLocalError — mirror the failure loudly
            raise RuntimeError("GTF line precedes the first 'gene' record")
        if pflag:
            if not sorted(hits)[0][2]:
                print(line, end="", file=out)
