"""The plain reference of the call stage's annotated pass, in plain Python.

It computes the rows that upstream ``scripts/call.py`` writes for an
augmented GFA and a GTF with ``--rca W`` and none of ``--novel``,
``--no-annotated`` and ``--junction``: its ``check_nonnovel``
(``call.py:239-524``). For every junction ``J`` (a link with a non-empty
``JN`` tag) whose ``RC`` is at least ``W`` and whose transcripts belong to
one gene:

- ES: every pair (j1, j2) of the gene's other junctions, j1 leaving J's head
  and j2 entering J's tail, whose transcripts share one that J lacks, where
  the exons of j1's tail or j2's head hold a label the gene's exons of J's
  two nodes do not: one row;
- A5/A3: every node n after J's head (but J's tail) whose exons meet the
  gene's exons of J's head, and every junction j2 into J's tail whose head
  holds one of those labels of a transcript J lacks: one row, A5 on ``+``
  and A3 on ``-``; the mirror (n before J's tail, j1 out of J's head) gives
  A3 on ``+`` and A5 on ``-``;
- IR: the first pair (n1 after J's head, n2 before J's tail), in the order
  of the two adjacency lists, with ``n1 <= n2`` as strings, whose exons and
  the gene's exons of both J's nodes share a label; the path from n1 to n2
  that stays on one such label, and the ceiling of its mean ``NC``.

Upstream's quirks are kept, each where it acts:

- node ids compare as strings (the IR pair and the IR walk);
- a link with an empty ``JN`` tag is no junction;
- the IR walk takes the first label of the shared set in the set's own
  iteration order, and where no next node stays on the label it goes on to
  the last one. The set's order follows the process's string hashes, so its
  sets are built as upstream builds them (a node's labels as
  ``set(tag.split(","))``, a gene's labels of a node by a walk over that set,
  the shared set as ``exset(n1) & exset(n2) & (ex1 & ex2)``): in one process
  the reference then walks the path the program walks.

It reads the augmented GFA's text and the GTF, never the program's output or
state, and imports nothing of the program.
"""

from __future__ import annotations

import re
from itertools import product
from math import ceil

HEADER = ("event_type,annotated/novel,chrom,gene,strand,transcripts1,transcripts2,transcripts3,"
          "nodes1,coverage1,nodes2,coverage2,nodes3,coverage3")
TRANSCRIPT_FEATURES = {"mRNA", "transcript", "miRNA", "ncRNA", "pre_miRNA", "snoRNA", "pseudogene"}
GENE_ID = re.compile('gene_id "[A-Za-z0-9_]+";')
TRANSCRIPT_ID = re.compile('transcript_id "[A-Za-z0-9_]+";')


def read_gtf(path):
    """(transcript -> gene, gene -> strand, gene -> chromosome), as upstream's
    ``call.py:188-216`` reads them."""
    t2g, strand, chrom = {}, {}, {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            cols = line.strip("\n").split("\t")
            if cols[2] in TRANSCRIPT_FEATURES:
                gene = GENE_ID.search(cols[-1]).group(0).split('"')[-2]
                tx = TRANSCRIPT_ID.search(cols[-1]).group(0).split('"')[-2]
                t2g[tx] = gene
                strand[gene] = cols[6]
                chrom[gene] = cols[0]
    return t2g, strand, chrom


def _tag(fields, key):
    for f in fields:
        if f.startswith(key):
            return f[len(key):]
    return None


class Graph:
    """The segments and links of an augmented GFA."""

    def __init__(self, lines):
        self.ex_raw, self.nc = {}, {}
        self.out, self.inc = {}, {}
        self.rc, self.jn = {}, {}
        self.junctions = set()
        for line in lines:
            if line.startswith("S\t"):
                f = line.rstrip("\n").split("\t")
                self.ex_raw[f[1]] = _tag(f[3:], "EX:Z:")
                nc = _tag(f[3:], "NC:i:")
                self.nc[f[1]] = None if nc is None else int(nc)
                self.out[f[1]], self.inc[f[1]] = [], []
            elif line.startswith("L\t"):
                f = line.rstrip("\n").split("\t")
                pair = (f[1], f[3])
                rc = _tag(f[5:], "RC:i:")
                self.rc[pair] = None if rc is None else int(rc)
                self.jn[pair] = _tag(f[5:], "JN:Z:")
                self.out[f[1]].append(f[3])
                self.inc[f[3]].append(f[1])
                if self.jn[pair]:  # an empty JN tag registers nothing
                    self.junctions.add(pair)
        self.by_head, self.by_tail = {}, {}
        for j in self.junctions:
            self.by_head.setdefault(j[0], set()).add(j)
            self.by_tail.setdefault(j[1], set()).add(j)
        self._exset = {}

    def exset(self, n):
        """The node's exon labels, built once as ``set(tag.split(","))``."""
        s = self._exset.get(n)
        if s is None:
            raw = self.ex_raw.get(n)
            s = set(raw.split(",")) if raw else set()
            self._exset[n] = s
        return s

    def labels(self, j):
        return self.jn[j].split(",")

    def get_rc(self, j):
        if self.rc[j] is None:
            raise KeyError(f"link {j} has no RC tag")
        return self.rc[j]

    def get_nc(self, n):
        if self.nc[n] is None:
            raise KeyError(f"segment {n} has no NC tag")
        return self.nc[n]


def _transcript_of_exon(label):
    """``T_H.e`` -> ``T``: the transcript of an exon label."""
    return label.rpartition(".")[0].rpartition("_")[0]


def _transcript_of_junction(label):
    """``T_H.e1.e2`` -> ``T``: the transcript of a junction label."""
    return label.rpartition(".")[0].rpartition(".")[0].rpartition("_")[0]


def _printed_transcript(label):
    """Upstream's filter of printed labels, ``"_".join(x.split("_")[:-1])``
    on the whole label: the exon numbers ride on the last ``_`` token."""
    return "_".join(label.split("_")[:-1])


def _row(*fields):
    return ",".join(str(x) for x in fields)


def annotated_rows(gfa_lines, gtf_path, rca=-1, events=("ES", "SS", "IR")):
    """The header and every row of the annotated pass, in no fixed order."""
    g = Graph(gfa_lines)
    t2g, genestrand, genechr = read_gtf(gtf_path)
    rows = [HEADER]
    keys = {j: {_transcript_of_junction(x) for x in g.labels(j)} for j in g.junctions}
    genes = {}

    def genes_of(j):
        if j not in genes:
            genes[j] = {t2g[t] for t in keys[j]}
        return genes[j]

    for J in g.junctions:
        if g.get_rc(J) < rca:
            continue
        jn, ht = g.labels(J), keys[J]
        if len(genes_of(J)) > 1:
            continue
        (gene,) = genes_of(J)
        ex1 = {e for e in g.exset(J[0]) if t2g[_transcript_of_exon(e)] == gene}
        ex2 = {e for e in g.exset(J[1]) if t2g[_transcript_of_exon(e)] == gene}
        assert ex1 and ex2
        js1 = {x for x in g.by_head.get(J[0], ()) if x != J and gene in genes_of(x)}
        js2 = {x for x in g.by_tail.get(J[1], ()) if x != J and gene in genes_of(x)}
        strand, chrom = genestrand[gene], genechr[gene]
        head = (chrom, gene, strand)

        if "ES" in events:
            for j1, j2 in product(js1, js2):
                inclusion = (keys[j1] & keys[j2]) - ht
                if not inclusion:
                    continue
                if (g.exset(j1[1]) | g.exset(j2[0])) - (ex1 | ex2):
                    rows.append(_row(
                        "ES", "annotated", *head, "|".join(jn),
                        "|".join(x for x in g.labels(j1) if _printed_transcript(x) in inclusion),
                        "|".join(x for x in g.labels(j2) if _printed_transcript(x) in inclusion),
                        ">".join(J), g.get_rc(J), ">".join(j1), g.get_rc(j1),
                        ">".join(j2), g.get_rc(j2)))

        if "SS" in events:
            # the exon goes on past J's head: A5 on '+', A3 on '-'
            for n in (g.out[J[0]] if js2 else ()):
                if n == J[1]:
                    continue
                on_n = g.exset(n) & ex1
                for j2 in js2 if on_n else ():
                    shared = g.exset(j2[0]) & on_n
                    if not shared or {_transcript_of_exon(e) for e in shared} <= ht:
                        continue
                    assert not set(jn) & set(g.labels(j2))
                    rows.append(_row(
                        "A5" if strand == "+" else "A3", "annotated", *head, "|".join(jn),
                        "|".join(g.labels(j2)), ".", ">".join(J), g.get_rc(J),
                        ">".join(j2), g.get_rc(j2), ".", "."))
            # the exon starts before J's tail: A3 on '+', A5 on '-'
            for n in (g.inc[J[1]] if js1 else ()):
                if n == J[0]:
                    continue
                on_n = g.exset(n) & ex2
                for j1 in js1 if on_n else ():
                    shared = g.exset(j1[1]) & on_n
                    if not shared or {_transcript_of_exon(e) for e in shared} <= ht:
                        continue
                    rows.append(_row(
                        "A3" if strand == "+" else "A5", "annotated", *head, "|".join(jn),
                        "|".join(g.labels(j1)), ".", ">".join(J), g.get_rc(J),
                        ">".join(j1), g.get_rc(j1), ".", "."))

        if "IR" in events:
            both = ex1 & ex2
            for n1, n2 in product(g.out[J[0]], g.inc[J[1]]):
                if n1 == J[1] or n2 == J[0] or n2 < n1:
                    continue
                shared = g.exset(n1) & g.exset(n2) & both
                if not shared:
                    continue
                label = next(iter(shared))
                path, n = [n1], n1
                while n != n2:
                    if not g.out[n]:
                        raise AssertionError("Error while reconstructing IR path")
                    step = g.out[n][-1]  # none stays on the label: the last one
                    for nn in g.out[n]:
                        if nn <= n2 and label in g.exset(nn):
                            step = nn
                            break
                    path.append(step)
                    n = step
                cov = ceil(sum(g.get_nc(x) for x in path) / len(path))
                rows.append(_row("IR", "annotated", *head, "|".join(jn), ".", ".", ">".join(J),
                                 g.get_rc(J), ">".join(path), cov, ".", "."))
                break
    return rows
