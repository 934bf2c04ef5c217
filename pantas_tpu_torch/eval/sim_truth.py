"""Simulation ground-truth pipeline: read counts -> truth events CSV.

Behavioral contracts (byte-identical stdout differentials in
``tests/test_sim_truth.py``):

* :func:`simrc` — ``exps/1-dm-sim/scripts/simrc.py:1-187`` of the reference:
  count simulated reads on exons and junctions of every (gene, transcript)
  from the simulator's exon-junction table, using the mate coordinates
  embedded in read names; emit the per-sample read-counts CSV. Preserved
  quirks: exon iteration in FILE order (junction rows pair consecutive
  file-order exons), and the retained-intron row prints the LEAKED ``s, e``
  loop variables from the read loop as its tr coordinates
  (``simrc.py:165-179``).
* :func:`merge_rc` — the workflow's ``merge_rc.py`` is REFERENCED but
  absent from the reference repo (``rules/simulation.smk:98-110`` calls a
  script that does not exist); the contract is inferred from
  ``build_truth.py:36-54``'s 12-column input and the rule's argument order
  (h1c1, h2c1, h1c2, h2c2): per-condition read counts are summed across
  the two haplotype simulations, keyed by the 10 id columns.
* :func:`build_truth` — ``scripts/build_truth.py:1-274``: per event
  isoform, find the defining template/alternate junction rows and emit the
  truth CSV with per-condition PSI (inclusion/shorter/spliced isoform is
  canonical).
"""

from __future__ import annotations

import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# simrc
# ---------------------------------------------------------------------------


def _iter_fastq_names(fq_path: str) -> Iterable[str]:
    with open(fq_path) as fh:
        while True:
            header = fh.readline()
            if not header:
                break
            fh.readline()
            fh.readline()
            fh.readline()
            yield header[1:].strip().split(" ")[0].split("\t")[0]


def simrc(fq_path: str, jun_path: str, ann_path: str, out=sys.stdout) -> None:
    """Per-sample exon/junction read counts (reference simrc.py semantics)."""
    p = lambda *a, **k: print(*a, file=out, **k)

    # exon table: per (gene, transcript), exons in FILE order with genome
    # coords, transcriptomic spans, strand
    exonscount: Dict[str, Dict[str, Dict[str, int]]] = defaultdict(dict)
    exonsinfo: Dict[str, Dict[str, Dict[str, dict]]] = defaultdict(dict)
    junctionscount: Dict[str, Dict[str, Dict[tuple, int]]] = defaultdict(dict)
    # transcriptomic exon spans for interval lookup: (start, end, exon_num)
    spans: Dict[str, Dict[str, List[Tuple[int, int, str]]]] = defaultdict(dict)

    header = True
    for line in open(jun_path):
        if header:
            header = False
            continue
        data = line.strip().split("\t")
        geneid, transcriptid = data[9], data[10]
        if transcriptid not in exonsinfo[geneid]:
            exonscount[geneid][transcriptid] = defaultdict(int)
            exonsinfo[geneid][transcriptid] = defaultdict(dict)
            junctionscount[geneid][transcriptid] = defaultdict(int)
            spans[geneid][transcriptid] = []
        exon_num = data[12]
        exonsinfo[geneid][transcriptid]["strand"] = data[4]
        if exon_num:
            trstart, trend = int(data[13]), int(data[14])
            exonsinfo[geneid][transcriptid][exon_num]["genome"] = data[:3]
            exonsinfo[geneid][transcriptid][exon_num]["tr"] = [trstart, trend]
            # reference stores tree[trstart:trend+1] = exon_num (half-open)
            spans[geneid][transcriptid].append((trstart, trend + 1, exon_num))

    retainedintrons: Dict[str, Dict[str, List[int]]] = defaultdict(dict)
    for line in open(ann_path):
        if line.startswith("event"):
            continue
        etype, transcript, template, gs, ge, ts, te = line.strip("\n").split("\t")
        if etype != "ir":
            continue
        geneid = template.split("_")[0]
        retainedintrons[geneid][transcript] = [int(ts), int(te), int(gs), int(ge), 0]

    # leaked read-loop coordinates (reference simrc.py:84-88,176): the
    # retained-intron output row prints whatever s/e held last
    leak_s: Optional[int] = None
    leak_e: Optional[int] = None

    for rname_full in _iter_fastq_names(fq_path):
        rname, mate1, mate2 = rname_full.split(";")
        transcriptid = rname.split("/")[1]
        geneid = "_".join(transcriptid.split("_")[:-1])
        for m in [mate1, mate2]:
            se = m.split(":")[1].split("-")
            if len(se) != 2:
                print("Read mate with -", file=sys.stderr)
                continue
            s, e = int(se[0]), int(se[1])
            leak_s, leak_e = s, e
            # intervals overlapping the half-open query [s, e), sorted by
            # (begin, end) — intervaltree slice-query semantics
            qres = sorted(
                (b, t, num)
                for (b, t, num) in spans[geneid][transcriptid]
                if b < e and t > s
            )
            if len(qres) == 1:
                exonscount[geneid][transcriptid][qres[0][2]] += 1
            else:
                for i, j in zip(qres, qres[1:]):
                    junctionscount[geneid][transcriptid][(i[2], j[2])] += 1
            if transcriptid not in retainedintrons[geneid]:
                continue
            ts, te = retainedintrons[geneid][transcriptid][:2]
            if (ts <= s <= te) or (ts <= e <= te):
                retainedintrons[geneid][transcriptid][4] += 1

    p(
        "seqnames,start,end,strand,type,gene_id,transcript_id,"
        "gene_exon_number,tr_start,tr_end,read_count"
    )
    for geneid in exonsinfo:
        for transcriptid in exonsinfo[geneid]:
            info = exonsinfo[geneid][transcriptid]
            strand = info["strand"]
            prevex = None
            for exon in info:
                if exon == "strand":
                    continue
                if prevex:
                    _seq = info[exon]["genome"][0]
                    if strand == "-":
                        _jstart = info[exon]["genome"][2]
                        _jend = info[prevex]["genome"][1]
                    else:
                        _jstart = info[prevex]["genome"][2]
                        _jend = info[exon]["genome"][1]
                    p(
                        _seq, _jstart, _jend, strand, "junction",
                        geneid, transcriptid, f"{prevex}-{exon}", ".", ".",
                        junctionscount[geneid][transcriptid][(prevex, exon)],
                        sep=",",
                    )
                prevex = exon
                p(
                    *info[exon]["genome"], strand, "exon",
                    geneid, transcriptid, exon, *info[exon]["tr"],
                    exonscount[geneid][transcriptid][exon],
                    sep=",",
                )
            if transcriptid not in retainedintrons[geneid]:
                continue
            ts, te, gs, ge, c = retainedintrons[geneid][transcriptid]
            # QUIRK: the reference prints the leaked read-loop s/e here
            p(
                info["1"]["genome"][0], gs, ge, strand, "-exon",
                geneid, transcriptid, 0, leak_s, leak_e, c,
                sep=",",
            )


# ---------------------------------------------------------------------------
# merge_rc (inferred contract — the reference's script is missing)
# ---------------------------------------------------------------------------


def merge_rc(
    cond1_csvs: Sequence[str], cond2_csvs: Sequence[str], out=sys.stdout
) -> None:
    """Merge per-sample read-count CSVs into the 2-condition counts table.

    Output columns = the 10 id columns + read_count_1 + read_count_2, rows
    in first-file order; per-condition counts sum across the given files
    (the workflow passes one file per simulated haplotype)."""

    def load(path):
        rows = []
        for line in open(path):
            if line.startswith("seqnames"):
                continue
            cols = line.strip("\n").split(",")
            # key on the 8 feature-identity columns only: the tr_start /
            # tr_end columns of '-exon' rows carry simrc's leaked
            # read-loop coordinates and differ between samples
            rows.append((tuple(cols[:8]), tuple(cols[8:10]), int(cols[10])))
        return rows

    order: List[tuple] = []
    tr: Dict[tuple, tuple] = {}
    c1: Dict[tuple, int] = {}
    c2: Dict[tuple, int] = {}
    for path in cond1_csvs:
        for key, trc, n in load(path):
            if key not in c1:
                c1[key] = 0
                order.append(key)
                tr[key] = trc
            c1[key] += n
    for path in cond2_csvs:
        for key, trc, n in load(path):
            if key not in c2:
                c2[key] = 0
                if key not in tr:
                    order.append(key)
                    tr[key] = trc
            c2[key] += n

    print(
        "seqnames,start,end,strand,type,gene_id,transcript_id,"
        "gene_exon_number,tr_start,tr_end,read_count_1,read_count_2",
        file=out,
    )
    for key in order:
        print(*key, *tr[key], c1.get(key, 0), c2.get(key, 0), sep=",", file=out)


# ---------------------------------------------------------------------------
# build_truth
# ---------------------------------------------------------------------------


def _psi(a: float, b: float):
    try:
        return a / (a + b)
    except ZeroDivisionError:
        return "NaN"


def build_truth(ann_path: str, counts_path: str, out=sys.stdout) -> None:
    """Truth events CSV from event annotation + merged read counts."""
    p = lambda *a, **k: print(*a, file=out, **k)
    min_supp = -1

    events: Dict[str, Tuple[int, int]] = {}
    for line in open(ann_path):
        if line.startswith("event"):
            continue
        _etype, tvar, _templ, gs, ge, _ts, _te = line.strip("\n").split("\t")
        events[tvar] = (int(gs), int(ge))

    templates: Dict[str, list] = {}
    alternates: Dict[str, Dict[str, list]] = {}
    strands: Dict[str, str] = {}
    for line in open(counts_path):
        if line.startswith("seqnames"):
            continue
        (
            chrom, gs, ge, strand, feature, gene_id, transcript_id,
            _exon_number, _tr_start, _tr_end, rc1, rc2,
        ) = line.strip("\n").split(",")
        row = (feature, chrom, int(gs), int(ge), int(rc1), int(rc2))
        if gene_id not in templates:
            templates[gene_id] = []
            strands[gene_id] = strand
            alternates[gene_id] = {}
        if transcript_id.endswith("template"):
            templates[gene_id].append(row)
        else:
            alternates[gene_id].setdefault(transcript_id, []).append(row)

    def junctions(rows):
        return [(s, e, rc1, rc2) for t, _c, s, e, rc1, rc2 in rows if t == "junction"]

    def chrom_of(rows):
        c = None
        for _t, chrom, *_ in rows:
            c = chrom
        return c

    for gene_id, template in templates.items():
        strand = strands[gene_id]
        for transcript_id, alternate in alternates[gene_id].items():
            if transcript_id not in events:
                continue
            gs, ge = events[transcript_id]
            chrom = chrom_of(template)

            if transcript_id.endswith("es"):
                j1 = j2 = jj = None
                for s, e, rc1, rc2 in junctions(template):
                    if e == gs:
                        j1 = (s, e, rc1, rc2)
                    elif s == ge:
                        j2 = (s, e, rc1, rc2)
                for s, e, rc1, rc2 in junctions(alternate):
                    if j1 is not None and j2 is not None and s == j1[0] and e == j2[1]:
                        jj = (s, e, rc1, rc2)
                assert j1 is not None and j2 is not None and jj is not None
                if any(
                    x < min_supp
                    for x in [j1[2], j2[2], jj[2], j1[3], j2[3], jj[3]]
                ):
                    continue
                psi1 = _psi((j1[2] + j2[2]) / 2, jj[2])
                psi2 = _psi((j1[3] + j2[3]) / 2, jj[3])
                p(
                    "ES", chrom, gene_id, strand,
                    f"{chrom}:{j1[0]}-{j1[1]}",
                    f"{chrom}:{j2[0]}-{j2[1]}",
                    f"{chrom}:{jj[0]}-{jj[1]}",
                    f"{j1[2]}/{j2[2]}/{jj[2]}",
                    f"{j1[3]}/{j2[3]}/{jj[3]}",
                    psi1, psi2, sep=",",
                )
            elif (strand == "+" and transcript_id.endswith("a5")) or (
                strand == "-" and transcript_id.endswith("a3")
            ):
                sj = lj = None
                for s, e, rc1, rc2 in junctions(template):
                    if s == ge:
                        sj = (s, e, rc1, rc2)
                for s, e, rc1, rc2 in junctions(alternate):
                    if s == gs - 1:
                        lj = (s, e, rc1, rc2)
                assert sj is not None and lj is not None
                assert sj[1] == lj[1]
                if any(x < min_supp for x in [sj[2], lj[2], sj[3], lj[3]]):
                    continue
                p(
                    "A3" if transcript_id.endswith("a3") else "A5",
                    chrom, gene_id, strand,
                    f"{chrom}:{sj[0]}-{sj[1]}",
                    f"{chrom}:{lj[0]}-{lj[1]}",
                    ".",
                    f"{sj[2]}/{lj[2]}",
                    f"{sj[3]}/{lj[3]}",
                    _psi(sj[2], lj[2]), _psi(sj[3], lj[3]), sep=",",
                )
            elif (strand == "-" and transcript_id.endswith("a5")) or (
                strand == "+" and transcript_id.endswith("a3")
            ):
                sj = lj = None
                for s, e, rc1, rc2 in junctions(template):
                    if e == gs:
                        sj = (s, e, rc1, rc2)
                for s, e, rc1, rc2 in junctions(alternate):
                    if e == ge + 1:
                        lj = (s, e, rc1, rc2)
                assert sj is not None and lj is not None
                assert sj[0] == lj[0]
                if any(x < min_supp for x in [sj[2], lj[2], sj[3], lj[3]]):
                    continue
                p(
                    "A3" if transcript_id.endswith("a3") else "A5",
                    chrom, gene_id, strand,
                    f"{chrom}:{sj[0]}-{sj[1]}",
                    f"{chrom}:{lj[0]}-{lj[1]}",
                    ".",
                    f"{sj[2]}/{lj[2]}",
                    f"{sj[3]}/{lj[3]}",
                    _psi(sj[2], lj[2]), _psi(sj[3], lj[3]), sep=",",
                )
            elif transcript_id.endswith("ir"):
                sj, exon = None, (0, 0, 0, 0)
                for s, e, rc1, rc2 in junctions(template):
                    if s == gs - 1 and e == ge + 1:
                        sj = (s, e, rc1, rc2)
                for t, _c, s, e, rc1, rc2 in alternate:
                    if t == "exon" and s < gs and ge < e:
                        exon = (s, e, exon[2], exon[3])
                    if t == "-exon" and s == gs and e == ge:
                        exon = (exon[0], exon[1], rc1, rc2)
                assert sj is not None and exon != (0, 0, 0, 0)
                assert exon[0] < sj[0] and sj[0] < sj[1] and sj[1] < exon[1]
                if any(x < min_supp for x in [sj[2], exon[2], sj[3], exon[3]]):
                    continue
                p(
                    "IR", chrom, gene_id, strand,
                    f"{chrom}:{sj[0]}-{sj[1]}",
                    f"{chrom}:{exon[0]}-{exon[1]}",
                    ".",
                    f"{sj[2]}/{exon[2]}",
                    f"{sj[3]}/{exon[3]}",
                    _psi(sj[2], exon[2]), _psi(sj[3], exon[3]), sep=",",
                )
