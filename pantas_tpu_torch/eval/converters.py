"""Competitor-tool output converters feeding the ``cmp`` comparator.

Equivalents of the reference's ``exps/2-dm-real/workflow/scripts/
build_rmats.py`` and ``build_suppa.py``: convert rMATS ``*.MATS.JC.txt``
directories and SUPPA2 ``.dpsi`` files into the 13-column comparison CSV
(``etype,annotated,chrom,gene,strand,j1,j2,j3,W1,w2,psi1,psi2,dpsi[,pv]``)
consumed by ``eval/cmp_tools.py`` (EventRmats rows). Byte-identical to the
reference converters (differential-tested), which requires preserving their
quirks:

* rMATS rows missing the statistics columns (annotation-only runs) are
  accepted via the short unpack, and the p-value / inclusion levels then
  LEAK from the previous full row (``build_rmats.py:18-63`` — the except
  branch never rebinds them) with no p-value filtering;
* A3SS/A5SS apply ``sex_s += 1`` twice (``build_rmats.py:158-161,268-271``)
  and on ``+`` strand emit 11 payload fields (no trailing p-value) vs 12 on
  ``-`` (``build_rmats.py:183-214,288-321``);
* the ``chr`` prefix is stripped by position (``chrom[3:]``);
* inclusion levels are per-condition means, ``NAN`` if any replicate is
  ``NA`` (``statistics.mean`` float repr);
* output event order is the parse dict's insertion order — ES, IR, A3, A5
  for rMATS (``build_rmats.py:414-427``) and ES, A3, A5, IR for SUPPA2
  (``build_suppa.py:21,126-132``); every field passes through
  ``str(x).strip('"')``.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List

ETYPES = ["ES", "IR", "A3", "A5"]


def _iv(c: str, s, e) -> str:
    return f"{c}:{s}-{e}"


def _mean_or_nan(csv_field: str):
    vals = csv_field.split(",")
    if "NA" in vals:
        return "NAN"
    return statistics.mean([float(i) for i in vals])


def _parse_rmats(fpath: str, kind: str, pvalue: float) -> List[list]:
    """One ``<KIND>.MATS.JC.txt`` file -> comparator rows.

    ``kind`` in {SE, A3SS, A5SS, RI}; coordinate algebra per kind follows
    ``build_rmats.py`` (SE :16-105, A3SS :107-218, A5SS :221-327,
    RI :330-409) including the leaked-statistics short-row branch.
    """
    events: List[list] = []
    pv = inclvl_1 = inclvl_2 = delta_incl = None  # leak across rows (quirk)
    for line in open(fpath):
        if line.startswith("ID"):
            continue
        tokens = line.strip("\n").split("\t")
        full = len(tokens) != 11
        if full:
            (_, gene, _sym, chrom, strand, a_s, a_e, b_s, b_e, c_s, c_e,
             _i, _j1, _j2, _j3, _j4, _l1, _l2, pv, _fdr,
             inclvl_1, inclvl_2, delta_incl) = tokens
            pv = float(pv)
            if pv > pvalue:
                continue
        else:
            (_, gene, _sym, chrom, strand, a_s, a_e, b_s, b_e, c_s, c_e) = tokens
        a_s, b_s, c_s = int(a_s), int(b_s), int(c_s)
        a_e, b_e, c_e = int(a_e), int(b_e), int(c_e)
        chrom = chrom[3:]
        # converted in common code so leaked short-row values re-convert
        # with the reference's exact crash/NaN semantics (build_rmats.py:77-86)
        inclvl_1 = _mean_or_nan(inclvl_1)
        inclvl_2 = _mean_or_nan(inclvl_2)

        if kind == "SE":
            # a = skipped exon, b = upstream exon, c = downstream exon
            b_s += 1
            intron1 = (b_e, a_s)
            intron2 = (a_e, c_s)
            row = [chrom, gene, strand,
                   _iv(chrom, intron1[0] + 1, intron2[1]),
                   _iv(chrom, intron1[0] + 1, intron1[1]),
                   _iv(chrom, intron2[0] + 1, intron2[1]),
                   "W1", "w2", inclvl_1, inclvl_2, delta_incl, pv]
        elif kind in ("A3SS", "A5SS"):
            # a = long exon, b = short exon, c = flanking exon
            c_s += 1
            b_s += 2  # applied twice in the reference
            if kind == "A3SS":
                if strand == "+":
                    longer, shorter = (c_e, b_s), (c_e, a_s)
                else:
                    longer, shorter = (b_e, c_s), (a_e, c_s)
            else:  # A5SS
                if strand == "+":
                    longer, shorter = (b_e, c_s), (a_e, c_s)
                else:
                    longer, shorter = (c_e, b_s), (c_e, a_s)
            if kind == "A3SS" and strand == "+":
                row = [chrom, gene, strand,
                       _iv(chrom, longer[0] + 1, longer[1] - 2),
                       _iv(chrom, shorter[0] + 1, shorter[1]),
                       ".", "W1", "w2", inclvl_1, inclvl_2, delta_incl]
            elif kind == "A3SS":
                row = [chrom, gene, strand,
                       _iv(chrom, longer[0] + 1, longer[1] - 1),
                       _iv(chrom, shorter[0] + 1, shorter[1] - 1),
                       ".", "W1", "w2", inclvl_1, inclvl_2, delta_incl, pv]
            elif strand == "+":
                row = [chrom, gene, strand,
                       _iv(chrom, longer[0] + 1, longer[1] - 1),
                       _iv(chrom, shorter[0] + 1, shorter[1] - 1),
                       ".", "W1", "w2", inclvl_1, inclvl_2, delta_incl]
            else:
                row = [chrom, gene, strand,
                       _iv(chrom, shorter[0] + 1, longer[1] - 2),
                       _iv(chrom, longer[0] + 1, shorter[1]),
                       ".", "W1", "w2", inclvl_1, inclvl_2, delta_incl, pv]
        else:  # RI: a = retained exon, b = first exon, c = second exon
            a_s += 1
            c_s += 1
            b_s += 1
            assert a_s == b_s and a_e == c_e
            row = [chrom, gene, strand,
                   _iv(chrom, b_e + 1, c_s - 1),
                   ".", ".", "W1", "w2", inclvl_1, inclvl_2, delta_incl, pv]
        events.append(row)
    return events


def rmats_to_csv(rmats_dir: str, out_path: str, pvalue: float = 0.05) -> None:
    """An rMATS output directory -> comparator CSV (build_rmats.py main)."""
    rmats: Dict[str, list] = {x: [] for x in ETYPES}
    rmats["ES"] = _parse_rmats(f"{rmats_dir}/SE.MATS.JC.txt", "SE", pvalue)
    rmats["A3"] = _parse_rmats(f"{rmats_dir}/A3SS.MATS.JC.txt", "A3SS", pvalue)
    rmats["A5"] = _parse_rmats(f"{rmats_dir}/A5SS.MATS.JC.txt", "A5SS", pvalue)
    rmats["IR"] = _parse_rmats(f"{rmats_dir}/RI.MATS.JC.txt", "RI", pvalue)
    with open(out_path, "w") as f:
        for etype in rmats:  # insertion order: ES, IR, A3, A5
            for e in rmats[etype]:
                print(etype, "annotated",
                      *map(lambda x: str(x).strip('"'), e), sep=",", file=f)


def suppa_to_csv(dpsi_path: str, out_path: str, pvalue: float = 0.05) -> None:
    """A SUPPA2 ``.dpsi`` file -> comparator CSV (build_suppa.py)."""
    events: Dict[str, list] = {"ES": [], "A3": [], "A5": [], "IR": []}
    for i, line in enumerate(open(dpsi_path)):
        if i == 0:
            continue
        idx, dpsi, pv = line.strip("\n").split("\t")
        dpsi, pv = float(dpsi), float(pv)
        if pv > pvalue:
            continue
        gene, rest = idx.split(";")
        etype, chrom, *positions, strand = rest.split(":")
        if etype == "SE":
            ab, cd = positions
            i1 = tuple(int(x) for x in ab.split("-"))
            i1 = (i1[0], i1[1] - 1)
            i2 = tuple(int(x) for x in cd.split("-"))
            i2 = (i2[0], i2[1] - 1)
            events["ES"].append(
                [chrom, gene, strand,
                 _iv(chrom, i1[0] + 1, i2[1]),
                 _iv(chrom, i1[0] + 1, i1[1]),
                 _iv(chrom, i2[0] + 1, i2[1]),
                 "W1", "w2", "NAN", "NAN", dpsi, pv])
        elif (etype == "A5" and strand == "+") or (etype == "A3" and strand == "-"):
            ab, cd = positions
            shorter = tuple(int(x) for x in ab.split("-"))
            longer = tuple(int(x) for x in cd.split("-"))
            events[etype].append(
                [chrom, gene, strand,
                 _iv(chrom, longer[0] + 1, longer[1] - 1),
                 _iv(chrom, shorter[0] + 1, shorter[1] - 1),
                 ".", "W1", "w2", "NAN", "NAN", dpsi, pv])
        elif (etype == "A3" and strand == "+") or (etype == "A5" and strand == "-"):
            ab, cd = positions
            shorter = tuple(int(x) for x in ab.split("-"))
            shorter = (shorter[0], shorter[1] - 1)
            longer = tuple(int(x) for x in cd.split("-"))
            longer = (longer[0], longer[1] - 1)
            events[etype].append(
                [chrom, gene, strand,
                 _iv(chrom, longer[0] + 1, longer[1]),
                 _iv(chrom, shorter[0] + 1, shorter[1]),
                 ".", "W1", "w2", "NAN", "NAN", dpsi, pv])
        elif etype == "RI":
            a, bc, d = positions
            intron = tuple(int(x) for x in bc.split("-"))
            intron = (intron[0] + 1, intron[1] - 1)
            events["IR"].append(
                [chrom, gene, strand,
                 _iv(chrom, intron[0], intron[1]),
                 ".", ".", "W1", "w2", "NAN", "NAN", dpsi, pv])
    with open(out_path, "w") as f:
        for etype in events:  # insertion order: ES, A3, A5, IR
            for e in events[etype]:
                print(etype, "annotated",
                      *map(lambda x: str(x).strip('"'), e), sep=",", file=f)
