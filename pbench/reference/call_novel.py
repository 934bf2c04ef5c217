"""The plain reference of the call stage's novel pass, in plain Python.

It computes the rows that upstream ``scripts/call.py`` writes for an
augmented GFA and a GTF with ``--novel --no-annotated --rca W --isw I
--minintronsize L``: its ``check_novel`` (``call.py:529-1105``). A novel
junction is a link with an ``ID:Z:`` tag (the augment's ``ID:Z:N``); a
junction, a link with a non-empty ``JN`` tag. Labels name a transcript copy
and an exon (``T_H.e``) or a junction (``T_H.e1.e2``); a node's transcripts
are those of its exon labels, haplotype dropped.

For every novel junction ``J = (a, b)`` with ``RC`` at least ``W`` whose
nodes hold an exon label, with ``cap`` the transcripts of both ``a`` and
``b``:

- ES: where ``a`` and ``b`` both hold exons and ``a``'s are not all ``b``'s,
  every pair of junctions ``(a, n)``, ``(q, b)`` sharing a transcript of one
  gene: one row;
- exonic A3/A5: each junction ``(a, n)`` whose ``n`` holds an exon of ``b``
  (the spliced exon) of a transcript in ``cap``: one row, A3 on ``+``; the
  mirror, each junction ``(q, b)`` whose ``q`` holds an exon of ``a``: A5
  on ``+``;
- intronic A3/A5: where ``b`` holds no exon, a walk from ``b`` of at most
  ``I`` levels that reaches the tail of a junction out of ``a``; the mirror
  backward from ``a`` where ``a`` holds none: one row, A3 on ``+``;
- IR: where ``a`` and ``b`` share exons, the path from ``a`` to ``b`` that
  stays on them, when its bases are at least ``L``: one row with the
  ceiling of its mean ``NC``.

Then for every junction ``J = (a, b)`` with ``RC`` at least ``W`` of one
gene:

- CE: each pair of novel junctions ``(a, s)``, ``(e, b)`` other than ``J``
  with ``s <= e``: one row a pair ``(s, e)``;
- IR-2: where a plain link from ``a`` to one of the three ids after it, and
  one to ``b`` from one of the three ids before it, have ``RC`` at least
  ``W``, and an exon ending at ``a`` and one starting at ``b`` belong to one
  transcript: the greedy path from ``a`` to ``b`` (at each node the
  successor with the highest ``NC``), when its inner bases are at least
  ``L``: one row.

Upstream's quirks are kept, each where it acts:

- node ids compare as strings (the IR walks and the CE pair);
- the novel IR walk takes the last successor where none stays on the
  shared exons (the loop variable left after the loop);
- the loop variables ``p`` and ``n`` of the exonic SS blocks leak from one
  block into the next and from one junction to the next (``call.py:630,685``):
  ``p`` is kept across both. The blocks read it only where ``a`` is not
  among ``b``'s predecessors, which a link's own ends always are, so no row
  of a GFA depends on it;
- the intronic walk is upstream's ``set.pop()`` walk, not a breadth-first
  search: it pops one node of the set at a time and counts a level each time
  it has popped as many nodes as the set held at the level's start; the
  node returned is the first of the set's reached targets in the set's own
  order;
- the IR-2 row lists its exon pairs in the order of the sets of the gene's
  exons of ``a`` and of ``b``, and the novel IR row the shared exons in the
  order of their set.

The set orders follow the process's string hashes, so every set is built as
upstream builds it: a node's labels as ``set(tag.split(","))``, a gene's
labels of a node by a walk over that set, the intronic walk's set from
``set([b])`` and ``|= set(successors)``, the junction sets in file order.
In one process the reference then takes the nodes and writes the labels the
program takes and writes.

Where upstream stops with an error, on the IR-2 walk's node with no
successor ``<= b`` that has successors itself (``max()`` of an empty list,
``call.py:1049``), the reference makes no row for that junction and goes on.

It reads the augmented GFA's text and the GTF, never the program's output or
state, and imports nothing of the program.
"""

from __future__ import annotations

from itertools import product
from math import ceil

from pbench.reference.call import (
    HEADER,
    _printed_transcript,
    _row,
    _tag,
    _transcript_of_exon,
    _transcript_of_junction,
    read_gtf,
)


class Graph:
    """The segments and links of an augmented GFA, with the lengths and the
    novel links the novel pass reads."""

    def __init__(self, lines):
        self.ex_raw, self.nc, self.length = {}, {}, {}
        self.out, self.inc = {}, {}
        self.rc, self.jn = {}, {}
        self.junctions, self.novel = set(), set()
        for line in lines:
            if line.startswith("S\t"):
                f = line.rstrip("\n").split("\t")
                self.ex_raw[f[1]] = _tag(f[3:], "EX:Z:")
                nc = _tag(f[3:], "NC:i:")
                self.nc[f[1]] = None if nc is None else int(nc)
                self.length[f[1]] = len(f[2])
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
                if _tag(f[5:], "ID:Z:") is not None:
                    self.novel.add(pair)
        self.novel_by_head, self.novel_by_tail = {}, {}
        for j in self.novel:
            self.novel_by_head.setdefault(j[0], set()).add(j)
            self.novel_by_tail.setdefault(j[1], set()).add(j)
        self._exset = {}

    def exset(self, n):
        """The node's exon labels, built once as ``set(tag.split(","))``;
        the empty set for no node."""
        if n is None:
            return set()
        s = self._exset.get(n)
        if s is None:
            raw = self.ex_raw.get(n)
            s = set(raw.split(",")) if raw else set()
            self._exset[n] = s
        return s

    def labels(self, j):
        raw = self.jn[j]
        return raw.split(",") if raw else []

    def get_rc(self, j):
        if self.rc[j] is None:
            raise KeyError(f"link {j} has no RC tag")
        return self.rc[j]

    def get_nc(self, n):
        if self.nc[n] is None:
            raise KeyError(f"segment {n} has no NC tag")
        return self.nc[n]


def _transcripts(labels):
    return {_transcript_of_exon(e) for e in labels}


def _junction_transcripts(g, j):
    return {_transcript_of_junction(x) for x in g.labels(j)}


def _one_gene(transcripts, t2g):
    """The transcripts' gene, or None where they belong to several."""
    genes = {t2g[t] for t in transcripts}
    return next(iter(genes)) if len(genes) == 1 else None


def intronic_walk(g, start, targets, levels, forward):
    """Upstream's ``set.pop()`` walk from ``start`` (``call.py:734-751``):
    the first target reached within ``levels`` levels, else None."""
    visit = set([start])
    left = 1  # nodes of the level still to pop
    level = 0
    while len(visit & targets) == 0 and level < levels:
        if len(visit) == 0:
            return None
        n = visit.pop()
        left -= 1
        visit |= set(g.out[n] if forward else g.inc[n])
        if left == 0:
            level += 1
            left = len(visit)
    if level < levels:
        return next(iter(visit & targets))
    return None


def novel_rows(gfa_lines, gtf_path, rca=-1, events=("ES", "SS", "IR"), isw=5, minintronsize=100):
    """The header and every row of the novel pass, in no fixed order."""
    g = Graph(gfa_lines)
    t2g, genestrand, genechr = read_gtf(gtf_path)
    rows = [HEADER]
    p = None  # upstream's leaked loop variable

    for J in g.novel:
        if g.get_rc(J) < rca:
            continue
        a, b = J
        ex_a, ex_b = g.exset(a), g.exset(b)
        if not ex_a and not ex_b:
            continue
        cap = _transcripts(ex_a) & _transcripts(ex_b)
        succ, pred = g.out[a], g.inc[b]

        if "ES" in events and ex_a and ex_b and len(ex_a & ex_b) != len(ex_a):
            into = [n for n in succ if (a, n) in g.junctions]
            outof = [q for q in pred if (q, b) in g.junctions]
            for n, q in product(into, outof):
                j1, j2 = (a, n), (q, b)
                shared = _junction_transcripts(g, j1) & _junction_transcripts(g, j2)
                if not shared:
                    continue
                gene = _one_gene(shared, t2g)
                if gene is None:
                    continue
                rows.append(_row(
                    "ES", "novel", genechr[gene], gene, genestrand[gene], "?",
                    "|".join(x for x in g.labels(j1) if _printed_transcript(x) in shared),
                    "|".join(x for x in g.labels(j2) if _printed_transcript(x) in shared),
                    ">".join(J), g.get_rc(J), ">".join(j1), g.get_rc(j1),
                    ">".join(j2), g.get_rc(j2)))

        if "SS" in events:
            if cap:
                # b's exon spliced into: the junctions out of a that reach it
                spliced = set()
                if a in g.inc[b]:
                    spliced = ex_b
                else:
                    for p in pred:
                        spliced = g.exset(p) & ex_b
                if spliced:
                    for n in succ:
                        on = g.exset(n) & spliced
                        if not on:
                            continue
                        tx = _transcripts(on) & cap
                        if (a, n) in g.junctions and tx:
                            gene = _one_gene(tx, t2g)
                            if gene is not None:
                                rows.append(_row(
                                    "A3" if genestrand[gene] == "+" else "A5", "novel",
                                    genechr[gene], gene, genestrand[gene], "?",
                                    "|".join(g.labels((a, n))), ".", ">".join(J), g.get_rc(J),
                                    f"{a}>{n}", g.get_rc((a, n)), ".", "."))
                # a's exon spliced out of: the junctions into b that leave it
                spliced = set()
                if b in g.out[a]:
                    spliced = ex_a
                else:
                    for _ in succ:
                        spliced = g.exset(p) & ex_a
                if spliced:
                    found = []
                    for p in pred:
                        on = g.exset(p) & spliced
                        if not on:
                            continue
                        tx = _transcripts(on) & cap
                        if (p, b) in g.junctions and tx:
                            found.append(((p, b), tx))
                    for j1, tx in found:
                        gene = _one_gene(tx, t2g)
                        if gene is not None:
                            rows.append(_row(
                                "A5" if genestrand[gene] == "+" else "A3", "novel",
                                genechr[gene], gene, genestrand[gene], "?",
                                "|".join(g.labels(j1)), ".", ">".join(J), g.get_rc(J),
                                ">".join(j1), g.get_rc(j1), ".", "."))
            if ex_a and not ex_b:
                hit = intronic_walk(g, b, set(n for n in succ if (a, n) in g.junctions),
                                    isw, forward=True)
                j1 = None if hit is None else (a, hit)
            elif ex_b and not ex_a:
                hit = intronic_walk(g, a, set(q for q in pred if (q, b) in g.junctions),
                                    isw, forward=False)
                j1 = None if hit is None else (hit, b)
            else:
                j1 = None
            if j1 is not None:
                gene = _one_gene(_junction_transcripts(g, j1), t2g)
                if gene is not None:
                    rows.append(_row(
                        "A3" if genestrand[gene] == "+" else "A5", "novel", genechr[gene],
                        gene, genestrand[gene], "|".join(g.labels(j1)), "?", ".",
                        ">".join(j1), g.get_rc(j1), ">".join(J), g.get_rc(J), ".", "."))

        if "IR" in events and cap:
            shared = ex_a & ex_b
            if shared:
                path = [a]
                while path[-1] != b:
                    step = "-1"
                    for step in g.out[path[-1]]:
                        if step <= b and shared & g.exset(step):
                            break
                    if step == "-1":
                        raise AssertionError("Error while reconstructing novel IR path")
                    path.append(step)
                if sum(g.length[x] for x in path) >= minintronsize:
                    gene = _one_gene(_transcripts(shared), t2g)
                    if gene is not None:
                        cov = ceil(sum(g.get_nc(x) for x in path) / len(path))
                        rows.append(_row(
                            "IR", "novel", genechr[gene], gene, genestrand[gene], "?",
                            "|".join(shared), ".", ">".join(J), g.get_rc(J),
                            ">".join(path), cov, ".", "."))

    if "IR" not in events and "ES" not in events:
        return rows
    for J in g.junctions:
        if g.get_rc(J) < rca:
            continue
        a, b = J
        gene = _one_gene(_junction_transcripts(g, J), t2g)
        if gene is None:
            continue
        ex_a = {e for e in g.exset(a) if t2g[_transcript_of_exon(e)] == gene}
        ex_b = {e for e in g.exset(b) if t2g[_transcript_of_exon(e)] == gene}
        assert ex_a and ex_b
        head = (genechr[gene], gene, genestrand[gene])

        if "ES" in events:
            leave = g.novel_by_head.get(a, set()) - {J}
            enter = g.novel_by_tail.get(b, set()) - {J}
            cassettes = {(j1[1], j2[0]) for j1, j2 in product(leave, enter) if j1[1] <= j2[0]}
            for s, e in cassettes:
                rows.append(_row(
                    "CE", "novel", *head, "|".join(g.labels(J)), "?", "?", ">".join(J),
                    g.get_rc(J), f"{a}>{s}", g.get_rc((a, s)), f"{e}>{b}", g.get_rc((e, b))))

        if "IR" in events:
            def plain(link):
                return link in g.rc and link not in g.junctions and g.get_rc(link) >= rca

            if not any(plain((a, str(x))) for x in range(int(a) + 1, int(a) + 4)):
                continue
            if not any(plain((str(x), b)) for x in range(int(b) - 3, int(b))):
                continue
            after = set()
            for x in g.out[a]:
                after |= g.exset(x)
            before = set()
            for x in g.inc[b]:
                before |= g.exset(x)
            ends = [e for e in ex_a if e not in after]
            starts = [e for e in ex_b if e not in before]
            pairs, retained = [], set()
            for e0 in ends:
                for e1 in starts:
                    if _transcript_of_exon(e0) == _transcript_of_exon(e1):
                        pairs.append(e0 + "." + e1.split(".")[-1])
                        retained.add(_transcript_of_exon(e0))
            if not pairs:
                continue
            path = [a]
            while path[-1] != b:
                steps = [x for x in g.out[path[-1]] if x <= b]
                if len(path) == 1 and b in steps:
                    steps.remove(b)
                if b in steps:
                    path.append(b)
                    continue
                steps = [x for x in steps if g.out[x]]
                if not steps:
                    path = None  # upstream stops with an error here
                    break
                path.append(max(steps, key=g.get_nc))
            if path is None or sum(g.length[x] for x in path[1:-1]) < minintronsize:
                continue
            gene2 = _one_gene(retained, t2g)
            if gene2 is None:
                continue
            cov = ceil(sum(g.get_nc(x) for x in path) / len(path))
            rows.append(_row(
                "IR", "novel", genechr[gene2], gene2, genestrand[gene2], "|".join(pairs), "?", ".",
                ">".join(path), cov, ">".join(J), g.get_rc(J), ".", "."))
    return rows
