"""Alternative-splicing event caller.

Behavioral contract: ``scripts/call.py`` of the reference. Every emitted CSV
row matches the reference caller on the same (augmented GFA, GTF) inputs.
Row *order* is not part of the contract — the reference iterates hash-ordered
sets of junctions, so its own row order is PYTHONHASHSEED-dependent
(``call.py:240,531``); equality is defined on the row multiset.

Deliberately preserved reference quirks (each marked QUIRK below):

* node-id comparisons are lexicographic on the string ids
  (``call.py:477,494,848,961,1038``),
* the ``--junction`` filter in the annotated pass compares against the
  literal string ``"f{_j[0]}-{_j[1]}"`` — a broken f-string — so it never
  matches real junctions (``call.py:241``),
* the IR path walk appends the *last* outgoing neighbor when no neighbor
  satisfies the exon-continuation condition (for-loop fallthrough,
  ``call.py:492-497``),
* in the novel-SS pass, loop variables ``p``/``n`` leak across blocks and
  junction iterations (``call.py:630,685``); we mirror their lifetimes,
* intronic search is a hash-ordered frontier ``set.pop()`` walk, not a true
  BFS (``call.py:739-751``).
"""

from __future__ import annotations
from pantas_tpu_torch.io.xopen import xopen

import gc
import sys
from dataclasses import dataclass, field
from itertools import product
from math import ceil
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from pantas_tpu_torch.io.gtf import parse_transcript_maps

try:  # native loader/tokenizer (self-building; falls back to pure Python)
    from pantas_tpu_torch.native.gfaload import get_module as _get_ext

    _EXT = _get_ext()
except Exception:  # pragma: no cover - g++/headers unavailable
    _EXT = None

Jct = Tuple[str, str]

CSV_HEADER = ",".join(
    [
        "event_type",
        "annotated/novel",
        "chrom",
        "gene",
        "strand",
        "transcripts1",
        "transcripts2",
        "transcripts3",
        "nodes1",
        "coverage1",
        "nodes2",
        "coverage2",
        "nodes3",
        "coverage3",
    ]
)


@dataclass
class CallOptions:
    rca: int = -1
    novel: bool = False
    no_annotated: bool = False
    events: Sequence[str] = ("ES", "SS", "IR")
    isw: int = 5
    minintronsize: int = 100
    junction: Optional[str] = None
    debug: bool = False


class SegInfo:
    """Node record with LAZY exon-label parsing (whole-genome graphs have
    millions of nodes; most never get their EX tag consulted)."""

    __slots__ = ("ex_raw", "length", "nc", "incoming", "outgoing")

    def __init__(self, length: int = 0):
        self.ex_raw: Optional[str] = None
        self.length = length
        self.nc: Optional[int] = None  # None == no NC tag (un-augmented)
        self.incoming: List[str] = []  # link file order
        self.outgoing: List[str] = []

class LinkInfo:
    """Link record with LAZY junction-label parsing."""

    __slots__ = ("rc", "jn_raw", "novel", "_jn")

    def __init__(self, rc: Optional[int] = None, novel: bool = False):
        self.rc = rc
        self.jn_raw: Optional[str] = None
        self.novel = novel
        self._jn: Optional[List[str]] = None

    @property
    def jn(self) -> List[str]:
        if self._jn is None:
            self._jn = self.jn_raw.split(",") if self.jn_raw else []
        return self._jn


class SplicingGraph:
    """Caller view of an augmented spliced pangenome."""

    def __init__(self) -> None:
        self.seg: Dict[str, SegInfo] = {}
        self.link: Dict[Jct, LinkInfo] = {}
        self.junctions: Set[Jct] = set()
        self.novel_junctions: Set[Jct] = set()
        # caches (content-identical to on-the-fly construction; callers
        # never mutate returned sets)
        self._exon_sets: Dict[str, Set[str]] = {}
        self._node_gene_labels: Dict[str, Dict[str, Set[str]]] = {}
        self._jn_keys: Dict[Jct, Set[str]] = {}
        self._jn_genes: Dict[Jct, Set[str]] = {}
        self._empty: Set[str] = set()
        self._empty_j: Set[Jct] = set()
        # gene-filtered junction neighborhoods (junctions sharing a head /
        # tail node whose transcripts hit the gene) — junctions sharing an
        # endpoint re-filter the same neighbor set otherwise
        self._jhead_gene: Dict[Tuple[str, str], frozenset] = {}
        self._jtail_gene: Dict[Tuple[str, str], frozenset] = {}
        # junction endpoint indexes (replace the reference's O(J) scans at
        # call.py:280-282,945-947 with content-identical sets)
        self.j_by_head: Dict[str, Set[Jct]] = {}
        self.j_by_tail: Dict[str, Set[Jct]] = {}
        self.nj_by_head: Dict[str, Set[Jct]] = {}
        self.nj_by_tail: Dict[str, Set[Jct]] = {}

    @classmethod
    def from_coverage(cls, gfa_path: str, counts) -> "SplicingGraph":
        """Fused-pipeline constructor: annotated (un-augmented) GFA + an
        in-memory :class:`~pantas_tpu_torch.coverage.host.CoverageCounts`.

        Produces the exact graph that parsing the emitted augmented GFA
        would: NC/RC default to 0, novel links append after the file's
        links in first-seen order — so calling is identical with no
        augmented-GFA round trip.
        """
        g = cls.from_gfa(gfa_path)
        for nid, info in g.seg.items():
            info.nc = counts.nc.get(nid, 0)
        file_links = frozenset(g.link)  # novel pairs mutate g.link below
        for pair, li in g.link.items():
            li.rc = counts.edge.get(pair, 0)
        for pair, w in counts.edge.items():
            if pair in file_links:
                continue
            a, b = pair
            li = LinkInfo(rc=w, novel=True)
            g.link[pair] = li
            g.seg[a].outgoing.append(b)
            g.seg[b].incoming.append(a)
            g.novel_junctions.add(pair)
            g.nj_by_head.setdefault(a, set()).add(pair)
            g.nj_by_tail.setdefault(b, set()).add(pair)
        return g

    @classmethod
    def from_engine(cls, gfa_path: str, tensors, eng) -> "SplicingGraph":
        """Fused-pipeline constructor from the NATIVE engine's state.

        Equivalent to ``from_coverage(gfa_path, eng.to_counts())`` but
        without materializing the CoverageCounts dicts: ``to_counts``
        builds NC/IL/OL/edge dicts over every node (13.6 s at 5.5M
        nodes, most of it for the IL/OL histograms the caller never
        reads), and ``from_coverage`` then walks all 5.5M segments
        again. Here only the NONZERO counts-vector entries apply (same
        values), and novel links append in the engine's first-seen
        sidecar order (the same order ``to_counts`` records).
        """
        import numpy as np

        g = cls.from_gfa(gfa_path)
        vec = eng.counts_vector()
        t = tensors
        names = t.node_names
        # NC: explicit 0 everywhere first — None means "un-augmented
        # graph" to the caller (SegInfo.nc docstring) and an emitted
        # augmented GFA tags NC:i:0 on every node
        for info in g.seg.values():
            info.nc = 0
        nc_part = vec[: t.n_nodes]
        for i in np.nonzero(nc_part)[0]:
            g.seg[names[int(i)]].nc = int(nc_part[i])
        # RC: every known link gets an explicit 0 first (an emitted
        # augmented GFA tags RC:i:0, so the staged parse never sees None)
        for li in g.link.values():
            li.rc = 0
        # then overwrite the nonzero rc slots via the edge table
        rc_part = vec[t.rc_base : t.rc_base + t.n_edges]
        for e in np.nonzero(rc_part)[0]:
            a = names[int(t.edge_src[e])]
            b = names[int(t.edge_dst[e])]
            g.link[(a, b)].rc = int(rc_part[e])
        # novel links in first-seen order
        keys, vals, _poss = eng.novel_sidecar()
        for k, w in zip(keys, vals):
            a = names[int(k >> np.uint64(32))]
            b = names[int(k & np.uint64(0xFFFFFFFF))]
            li = LinkInfo(rc=int(w), novel=True)
            g.link[(a, b)] = li
            g.seg[a].outgoing.append(b)
            g.seg[b].incoming.append(a)
            g.novel_junctions.add((a, b))
            g.nj_by_head.setdefault(a, set()).add((a, b))
            g.nj_by_tail.setdefault(b, set()).add((a, b))
        return g

    @classmethod
    def from_gfa(cls, gfa_path: str) -> "SplicingGraph":
        """Parse an (augmented) GFA; native C loader when available.

        The native path keeps the file as flat tables: ``seg`` and ``link``
        are mappings over them that build a record on its first lookup and
        keep it, and iterate in file order as the pure-Python loader's dicts
        do. The junction sets and the four endpoint indexes are real sets
        and dicts with the same content and insertion order (interpreter
        string hashing — so downstream hash-order effects match the
        pure-Python parse within a process seed); see
        ``native/gfaload.cpp``. Validated by ``tests/test_torch_graph_load``.
        """
        if _EXT is not None:
            from pantas_tpu_torch.io.xopen import materialized

            g = cls()
            with materialized(gfa_path) as plain:
                (
                    g.seg,
                    g.link,
                    g.junctions,
                    g.novel_junctions,
                    g.j_by_head,
                    g.j_by_tail,
                    g.nj_by_head,
                    g.nj_by_tail,
                ) = _EXT.load(plain)
            return g
        return cls._from_gfa_py(gfa_path)

    @classmethod
    def _from_gfa_py(cls, gfa_path: str) -> "SplicingGraph":
        g = cls()
        seg = g.seg
        link = g.link
        # dispatch on the first byte: P/W lines (most of an augmented GFA's
        # bytes) must not pay a strip/copy. S/L lines are parsed with
        # C-speed find() field extraction instead of a full split — the
        # sequence and the (never-consumed) IL/OL tag strings are never
        # materialized, only their spans measured.
        for line in xopen(gfa_path):
            c = line[0] if line else ""
            if c == "S":
                nl = len(line) - 1 if line[-1] == "\n" else len(line)
                i1 = line.index("\t", 2)  # after nid
                i2 = line.find("\t", i1 + 1)  # after seq (-1: no tags)
                if i2 == -1 or i2 > nl:
                    i2 = nl
                info = SegInfo(length=i2 - i1 - 1)
                p = line.find("\tNC:i:", i2 - 1, nl)
                if p != -1:
                    e = line.find("\t", p + 6, nl)
                    info.nc = int(line[p + 6 : e if e != -1 else nl])
                p = line.find("\tEX:Z:", i2 - 1, nl)
                if p != -1:
                    e = line.find("\t", p + 6, nl)
                    info.ex_raw = line[p + 6 : e if e != -1 else nl]
                seg[line[2:i1]] = info
            elif c == "L":
                nl = len(line) - 1 if line[-1] == "\n" else len(line)
                i1 = line.index("\t", 2)  # after a
                a = line[2:i1]
                i2 = line.index("\t", i1 + 1)  # after orient1
                i3 = line.index("\t", i2 + 1)  # after b
                b = line[i2 + 1 : i3]
                li = LinkInfo()
                p = line.find("\tRC:i:", i3, nl)
                if p != -1:
                    e = line.find("\t", p + 6, nl)
                    li.rc = int(line[p + 6 : e if e != -1 else nl])
                p = line.find("\tJN:Z:", i3, nl)
                if p != -1:
                    e = line.find("\t", p + 6, nl)
                    li.jn_raw = line[p + 6 : e if e != -1 else nl]
                li.novel = line.find("\tID:Z:", i3, nl) != -1
                pair = (a, b)
                link[pair] = li
                seg[a].outgoing.append(b)
                seg[b].incoming.append(a)
                # DIVERGENCE (crash-only class): an EMPTY `JN:Z:` tag is
                # not registered as a junction — the reference's presence
                # test (`"JN" in gfaL[...]`, call.py:178) registers it and
                # later crashes with KeyError '' in transcript2gene. The
                # native loader matches this truthiness (gfaload.cpp
                # registers only jn_len > 0).
                if li.jn_raw:
                    g.junctions.add(pair)
                    g.j_by_head.setdefault(a, set()).add(pair)
                    g.j_by_tail.setdefault(b, set()).add(pair)
                if li.novel:
                    g.novel_junctions.add(pair)
                    g.nj_by_head.setdefault(a, set()).add(pair)
                    g.nj_by_tail.setdefault(b, set()).add(pair)
        return g

    # --- small accessors matching reference helper semantics ---

    def exset(self, nid: Optional[str]) -> Set[str]:
        """Exon-label set of a node (cached; do not mutate the result)."""
        if nid is None:
            return self._empty
        cached = self._exon_sets.get(nid)
        if cached is not None:
            return cached
        info = self.seg.get(nid)
        if info is None or not info.ex_raw:
            s: Set[str] = set()
        elif _EXT is not None:
            s = _EXT.split_set(info.ex_raw)
        else:
            s = set(info.ex_raw.split(","))
        self._exon_sets[nid] = s
        return s

    def jn_keys(self, j: Jct) -> Set[str]:
        """Transcript keys of a link's JN labels (cached).

        The reference builds a transcript->haplotype-set dict here
        (``call.py:106-121``) but every downstream consumer uses only its
        KEYS (set algebra / membership / iteration) — verified across
        ``call.py``; the haplotype values are never read. A plain key set
        is content-identical for every row emitted."""
        cached = self._jn_keys.get(j)
        if cached is None:
            raw = self.link[j].jn_raw
            if not raw:
                cached = set()
            elif _EXT is not None:
                cached = _EXT.jn_tkeys(raw)
            else:
                cached = {
                    _split_ht(lab.rpartition(".")[0].rpartition(".")[0])[0]
                    for lab in self.link[j].jn
                }
            self._jn_keys[j] = cached
        return cached

    def jn_genes(self, j: Jct, t2g: Dict[str, str]) -> Set[str]:
        """Gene set of a junction's transcript keys (cached; same content
        and KeyError semantics as ``set(t2g[t] for t in jn_keys(j))``)."""
        cached = self._jn_genes.get(j)
        if cached is None:
            cached = set(t2g[t] for t in self.jn_keys(j))
            self._jn_genes[j] = cached
        return cached

    def nc(self, nid: str) -> int:
        v = self.seg[nid].nc
        if v is None:
            raise KeyError(f"segment {nid} has no NC tag (graph not augmented?)")
        return v

    def rc(self, j: Jct) -> int:
        v = self.link[j].rc
        if v is None:
            raise KeyError(f"link {j} has no RC tag (graph not augmented?)")
        return v

    def out(self, nid: str) -> List[str]:
        return self.seg[nid].outgoing

    def inc(self, nid: str) -> List[str]:
        return self.seg[nid].incoming


def record_counts(g) -> Dict[str, int]:
    """Records of a graph's file, and of those the records built: the native
    loader's mappings build one on its first lookup, a dict (the pure-Python
    loader's, or any other graph's) holds every one from the start."""
    return {
        "segments": getattr(g.seg, "in_file", len(g.seg)),
        "links": getattr(g.link, "in_file", len(g.link)),
        "seg_built": getattr(g.seg, "built", len(g.seg)),
        "link_built": getattr(g.link, "built", len(g.link)),
    }


# --- haplotype-aware transcript name algebra (reference call.py:90-121) ---
# A junction label is "T_H.e1.e2", an exon label is "T_H.e"; T may itself
# contain '_' and the haplotype tag H is the last '_' token.


from functools import lru_cache


@lru_cache(maxsize=1 << 20)
def _split_ht(ht: str) -> Tuple[str, str]:
    # rsplit form of the reference's "_".join(split[:-1]) / split[-1]
    # (identical output for every input, incl. no-underscore strings)
    head, sep, tail = ht.rpartition("_")
    return (head, tail) if sep else ("", ht)


@lru_cache(maxsize=1 << 20)
def _exon_label_th(label: str) -> Tuple[str, str]:
    return _split_ht(label.rpartition(".")[0])


def tkeys_of_exons(labels) -> Set[str]:
    """Transcript keys of exon labels.

    The reference builds transcript->haplotype-set dicts from exon labels
    (``call.py:113-121``) but consumes only the keys everywhere (set
    algebra, ``t2g`` lookups, membership) — the haplotype values are never
    read. A key set is content-identical for every emitted row."""
    return {_exon_label_th(lab)[0] for lab in labels}


@lru_cache(maxsize=1 << 20)
def transcript_of_label(label: str) -> str:
    """Junction/exon label -> transcript id (drops the trailing hap tag).

    QUIRK: the reference filters printable labels with
    ``"_".join(x.split("_")[:-1])`` applied to the FULL label (exon numbers
    still attached), which works because the exon suffix rides on the last
    '_' token (``call.py:356,364``).
    """
    return "_".join(label.split("_")[:-1])


def _row(*fields) -> str:
    return ",".join(str(x) for x in fields)


def call_events(
    gfa_path: str,
    gtf_path: str,
    opts: CallOptions,
    log=sys.stderr,
    graph: Optional[SplicingGraph] = None,
) -> Iterator[str]:
    """Yield event CSV lines (header first) for one augmented replicate."""
    # the parse allocates >100k long-lived container objects and the event
    # scan churns small temporaries: cyclic-GC passes walking the graph mid-
    # stage cost ~25% of the stage. Nothing here creates reference cycles;
    # defer collection to the end of the stage.
    gc_was = gc.isenabled()
    if gc_was:
        gc.disable()
    try:
        if graph is None:
            graph = SplicingGraph.from_gfa(gfa_path)
        t2g, genestrand, genechr = parse_transcript_maps(gtf_path)
        yield CSV_HEADER
        if not opts.no_annotated:
            yield from _call_annotated(graph, t2g, genestrand, genechr, opts, log)
        if opts.novel:
            yield from _call_novel(graph, t2g, genestrand, genechr, opts, log)
    finally:
        if gc_was:
            gc.enable()


def _genes_of_hts(hts, t2g: Dict[str, str]) -> Set[str]:
    return set(t2g[t] for t in hts)


def _node_gene_labels(g: SplicingGraph, nid: str, t2g) -> Dict[str, Set[str]]:
    """Node's exon labels grouped by gene (cached once per node).

    Same KeyError semantics as the reference's per-junction scan
    (``call.py:251-257`` filters every label through ``t2g``); grouping
    once per node replaces the per-(junction, gene) rescans."""
    cached = g._node_gene_labels.get(nid)
    if cached is None:
        exs = g.exset(nid)
        if not exs:
            cached = {}
        elif _EXT is not None:
            cached = _EXT.gene_labels(exs, t2g)
        else:
            cached = {}
            for e in g.exset(nid):
                gg = t2g[_exon_label_th(e)[0]]
                s = cached.get(gg)
                if s is None:
                    cached[gg] = {e}
                else:
                    s.add(e)
        g._node_gene_labels[nid] = cached
    return cached


def _same_gene_exons_cached(g: SplicingGraph, nid: str, genes: Set[str], t2g) -> Set[str]:
    """Gene-filtered exon-label set of a node (content-identical to the
    reference's per-junction filter). Callers never mutate the result."""
    by_gene = g._node_gene_labels.get(nid)
    if by_gene is None:
        by_gene = _node_gene_labels(g, nid, t2g)
    if len(genes) == 1:
        (gene,) = genes
        return by_gene.get(gene, g._empty)
    out: Set[str] = set()
    for gg in genes:
        out |= by_gene.get(gg, g._empty)
    return out


def _call_annotated(
    g: SplicingGraph,
    t2g,
    genestrand,
    genechr,
    opts: CallOptions,
    log,
    ir_oracle: Optional[Dict[Jct, Tuple[str, str]]] = None,
) -> Iterator[str]:
    """``ir_oracle`` (device engine): maps a junction to the FIRST
    ``(n1, n2)`` pair — in the reference's ``product(nnext, nprev)`` order —
    whose exon intersection fires (:func:`batched.find_annotated_ir`); the
    IR block then skips the per-pair host set algebra and recomputes the
    exact sets only for that pair, which is the one the host loop would
    ``break`` on."""
    for _j in g.junctions:
        # QUIRK: broken f-string filter preserved verbatim.
        if opts.junction is not None and "f{_j[0]}-{_j[1]}" != opts.junction:
            continue
        if g.rc(_j) < opts.rca:
            continue
        jn = g.link[_j].jn
        _ht = g.jn_keys(_j)
        _genes = g.jn_genes(_j, t2g)
        if len(_genes) > 1:
            continue
        _gene = next(iter(_genes))
        _exons1 = _same_gene_exons_cached(g, _j[0], _genes, t2g)
        _exons2 = _same_gene_exons_cached(g, _j[1], _genes, t2g)
        assert len(_exons1) > 0 and len(_exons2) > 0

        # gene-filtered neighborhoods, cached per (endpoint, gene):
        # content-identical to filtering `len(_genes & jn_genes(x)) > 0`
        # per junction (here len(_genes)==1), minus _j itself
        key1 = (_j[0], _gene)
        Js1f = g._jhead_gene.get(key1)
        if Js1f is None:
            Js1f = frozenset(
                x
                for x in g.j_by_head.get(_j[0], g._empty_j)
                if _gene in g.jn_genes(x, t2g)
            )
            g._jhead_gene[key1] = Js1f
        Js1 = Js1f - {_j}
        key2 = (_j[1], _gene)
        Js2f = g._jtail_gene.get(key2)
        if Js2f is None:
            Js2f = frozenset(
                x
                for x in g.j_by_tail.get(_j[1], g._empty_j)
                if _gene in g.jn_genes(x, t2g)
            )
            g._jtail_gene[key2] = Js2f
        Js2 = Js2f - {_j}

        strand = genestrand[_gene]
        chrom = genechr[_gene]

        if "ES" in opts.events:
            _ex_union = _exons1 | _exons2 if Js1 and Js2 else None
            for j1, j2 in product(Js1, Js2):
                ht1 = g.jn_keys(j1)
                ht2 = g.jn_keys(j2)
                inclusion = (ht1 & ht2) - _ht
                if not inclusion:
                    continue
                exons1_2 = g.exset(j1[1])
                exons2_1 = g.exset(j2[0])
                if len((exons1_2 | exons2_1) - _ex_union) > 0:
                    yield _row(
                        "ES",
                        "annotated",
                        chrom,
                        _gene,
                        strand,
                        "|".join(jn),
                        "|".join(
                            x for x in g.link[j1].jn if transcript_of_label(x) in inclusion
                        ),
                        "|".join(
                            x for x in g.link[j2].jn if transcript_of_label(x) in inclusion
                        ),
                        ">".join(_j),
                        g.rc(_j),
                        ">".join(j1),
                        g.rc(j1),
                        ">".join(j2),
                        g.rc(j2),
                    )

        if "SS" in opts.events:
            # A5 on '+' / A3 on '-': exon continues past the donor.
            if len(Js2) != 0:
                for n in g.out(_j[0]):
                    if n == _j[1]:
                        continue
                    exons = g.exset(n) & _exons1
                    if not exons:
                        continue
                    for j2 in Js2:
                        if j2[0] == _j[0]:
                            continue
                        j2_exons = g.exset(j2[0]) & exons
                        if not j2_exons:
                            continue
                        ht = tkeys_of_exons(j2_exons)
                        if _ht.issuperset(ht):  # == len(set(ht)-set(_ht))==0
                            continue
                        assert len(set(jn) & set(g.link[j2].jn)) == 0
                        yield _row(
                            "A5" if strand == "+" else "A3",
                            "annotated",
                            chrom,
                            _gene,
                            strand,
                            "|".join(jn),
                            "|".join(g.link[j2].jn),
                            ".",
                            ">".join(_j),
                            g.rc(_j),
                            ">".join(j2),
                            g.rc(j2),
                            ".",
                            ".",
                        )
            # A3 on '+' / A5 on '-': exon continues before the acceptor.
            if len(Js1) != 0:
                for n in g.inc(_j[1]):
                    if n == _j[0]:
                        continue
                    exons = g.exset(n) & _exons2
                    if not exons:
                        continue
                    for j1 in Js1:
                        if j1[1] == _j[1]:
                            continue
                        j1_exons = g.exset(j1[1]) & exons
                        if not j1_exons:
                            continue
                        ht = tkeys_of_exons(j1_exons)
                        if _ht.issuperset(ht):  # == len(set(ht)-set(_ht))==0
                            continue
                        yield _row(
                            "A3" if strand == "+" else "A5",
                            "annotated",
                            chrom,
                            _gene,
                            strand,
                            "|".join(jn),
                            "|".join(g.link[j1].jn),
                            ".",
                            ">".join(_j),
                            g.rc(_j),
                            ">".join(j1),
                            g.rc(j1),
                            ".",
                            ".",
                        )

        if "IR" in opts.events:
            exons = _exons1 & _exons2
            retained: Dict[str, Set[str]] = {}
            subpath: List[str] = []
            if ir_oracle is not None:
                pair = ir_oracle.get(_j)
                pairs: Iterator[Tuple[str, str]] = iter(() if pair is None else (pair,))
            else:
                nnext = g.out(_j[0])
                nprev = g.inc(_j[1])
                pairs = product(nnext, nprev)
            for n1, n2 in pairs:
                if n1 == _j[1] or n2 == _j[0]:
                    continue
                if n2 < n1:  # QUIRK: lexicographic on string ids
                    continue
                i_exons = g.exset(n1) & g.exset(n2) & exons
                if not i_exons:
                    continue
                e = next(iter(i_exons))
                n = n1
                subpath = [n]
                while n != n2:
                    nn = "-1"
                    for nn in g.out(n):
                        # QUIRK: falls through to the last neighbor if none match
                        if nn <= n2 and e in g.exset(nn):
                            break
                    assert nn != "-1", "Error while reconstructing IR path"
                    subpath.append(nn)
                    n = nn
                retained = tkeys_of_exons(i_exons)
                break

            if retained:
                cov = ceil(sum(g.nc(x) for x in subpath) / len(subpath))
                yield _row(
                    "IR",
                    "annotated",
                    chrom,
                    _gene,
                    strand,
                    "|".join(jn),
                    ".",
                    ".",
                    ">".join(_j),
                    g.rc(_j),
                    ">".join(subpath),
                    cov,
                    ".",
                    ".",
                )


def _call_novel(
    g: SplicingGraph,
    t2g,
    genestrand,
    genechr,
    opts: CallOptions,
    log,
    emit_novel_es: bool = True,
    ss_oracle: Optional[Set[Tuple[Jct, int, str]]] = None,
    ce_oracle: Optional[Dict[Jct, Set[Tuple[str, str]]]] = None,
) -> Iterator[str]:
    """The novel pass: :func:`_novel_junction_rows`, then, where ES or IR
    is asked for, :func:`_annotated_junction_rows`."""
    yield from _novel_junction_rows(
        g, t2g, genestrand, genechr, opts, log, emit_novel_es, ss_oracle
    )
    if "IR" in opts.events or "ES" in opts.events:
        yield from _annotated_junction_rows(g, t2g, genestrand, genechr, opts, log, ce_oracle)


def _novel_junction_rows(
    g: SplicingGraph,
    t2g,
    genestrand,
    genechr,
    opts: CallOptions,
    log,
    emit_novel_es: bool = True,
    ss_oracle: Optional[Set[Tuple[Jct, int, str]]] = None,
) -> Iterator[str]:
    """The novel pass's loop over novel junctions: novel ES, exonic and
    intronic SS, novel IR.

    ``emit_novel_es=False`` suppresses only the novel-ES yields (the
    device engine produces them); safe because the ES block writes no state
    the leaked ``p``/``n`` quirk variables could observe — ``p`` is never
    assigned there and ``n`` is reassigned before any read.

    ``ss_oracle`` (device engine): hit keys ``(J, block, node)`` from
    :func:`batched.find_novel_ss_exonic` — the exonic-SS loops then skip
    the per-candidate exon/transcript set algebra for misses and recompute
    the exact sets only for hits."""
    events = opts.events
    # QUIRK: p and n mirror the reference's leaked loop variables
    # (call.py:630,685): their values persist across blocks AND across
    # junction iterations.
    p: Optional[str] = None

    for _j in g.novel_junctions:
        if opts.junction is not None and f"{_j[0]}-{_j[1]}" != opts.junction:
            continue
        if g.rc(_j) < opts.rca:
            continue
        _exons0 = g.exset(_j[0])
        _exons1 = g.exset(_j[1])
        if len(_exons0) == 0 and len(_exons1) == 0:
            continue
        _ht0 = tkeys_of_exons(_exons0)
        _ht1 = tkeys_of_exons(_exons1)
        cap = set(_ht0) & set(_ht1)
        _next0 = g.out(_j[0])
        _prev1 = g.inc(_j[1])

        if "ES" in events and emit_novel_es:
            if _exons0 and _exons1 and len(_exons0 & _exons1) != len(_exons0):
                nodes1 = [n for n in _next0 if (_j[0], n) in g.junctions]
                nodes2 = [q for q in _prev1 if (q, _j[1]) in g.junctions]
                if nodes1 and nodes2:
                    for n, q in product(nodes1, nodes2):
                        j1 = (_j[0], n)
                        j2 = (q, _j[1])
                        nht = g.jn_keys(j1)
                        pht = g.jn_keys(j2)
                        inclusion = set(nht) & set(pht)
                        if not inclusion:
                            continue
                        _genes = set(t2g[t] for t in inclusion)
                        if len(_genes) > 1:
                            print("Skipping ES due to multiple genes", file=log)
                            continue
                        _gene = next(iter(_genes))
                        yield _row(
                            "ES",
                            "novel",
                            genechr[_gene],
                            _gene,
                            genestrand[_gene],
                            "?",
                            "|".join(
                                x
                                for x in g.link[j1].jn
                                if transcript_of_label(x) in inclusion
                            ),
                            "|".join(
                                x
                                for x in g.link[j2].jn
                                if transcript_of_label(x) in inclusion
                            ),
                            ">".join(_j),
                            g.rc(_j),
                            ">".join(j1),
                            g.rc(j1),
                            ">".join(j2),
                            g.rc(j2),
                        )

        if "SS" in events:
            if cap:
                # exonic A3+/A5-: does the novel junction splice into exon body?
                spliced_exons: Set[str] = set()
                if _j[0] in g.inc(_j[1]):
                    spliced_exons = _exons1
                else:
                    for p in _prev1:  # QUIRK: last iteration wins; p leaks
                        spliced_exons = g.exset(p) & _exons1
                if spliced_exons:
                    annotated_js = []
                    for n in _next0:
                        if ss_oracle is not None and (_j, 1, n) not in ss_oracle:
                            continue
                        exons_n = g.exset(n) & spliced_exons
                        if not exons_n:
                            continue
                        ht_n = tkeys_of_exons(exons_n)
                        if (_j[0], n) in g.junctions and set(ht_n) & cap:
                            annotated_js.append([(_j[0], n), set(ht_n) & cap])
                    for j1, transcripts in annotated_js:
                        _genes = set(t2g[t] for t in transcripts)
                        if len(_genes) > 1:
                            print("Skipping SS due to multiple genes", file=log)
                            continue
                        _gene = next(iter(_genes))
                        yield _row(
                            "A3" if genestrand[_gene] == "+" else "A5",
                            "novel",
                            genechr[_gene],
                            _gene,
                            genestrand[_gene],
                            "?",
                            "|".join(g.link[j1].jn),
                            ".",
                            ">".join(_j),
                            g.rc(_j),
                            ">".join(j1),
                            g.rc(j1),
                            ".",
                            ".",
                        )
                # exonic A5+/A3-
                spliced_exons = set()
                if _j[1] in g.out(_j[0]):
                    spliced_exons = _exons0
                else:
                    for n in _next0:
                        # QUIRK: reference consults exset(p) here — the leaked
                        # variable from the previous block — not exset(n).
                        spliced_exons = g.exset(p) & _exons0
                if spliced_exons:
                    annotated_js = []
                    for p in _prev1:
                        if ss_oracle is not None and (_j, 2, p) not in ss_oracle:
                            continue
                        exons_p = g.exset(p) & spliced_exons
                        if not exons_p:
                            continue
                        ht_p = tkeys_of_exons(exons_p)
                        if (p, _j[1]) in g.junctions and set(ht_p) & cap:
                            annotated_js.append([(p, _j[1]), set(ht_p) & cap])
                    for j1, transcripts in annotated_js:
                        _genes = set(t2g[t] for t in transcripts)
                        if len(_genes) > 1:
                            print("Skipping SS due to multiple genes", file=log)
                            continue
                        _gene = next(iter(_genes))
                        yield _row(
                            "A5" if genestrand[_gene] == "+" else "A3",
                            "novel",
                            genechr[_gene],
                            _gene,
                            genestrand[_gene],
                            "?",
                            "|".join(g.link[j1].jn),
                            ".",
                            ">".join(_j),
                            g.rc(_j),
                            ">".join(j1),
                            g.rc(j1),
                            ".",
                            ".",
                        )
            # intronic SS: one end exonic, walk into the intron
            if len(_exons0) > 0 and len(_exons1) == 0:
                exonic_next = set(n for n in _next0 if (_j[0], n) in g.junctions)
                found = _frontier_search(g, _j[1], exonic_next, opts.isw, forward=True)
                if found is not None:
                    j1 = (_j[0], found)
                    _genes = g.jn_genes(j1, t2g)
                    if len(_genes) > 1:
                        print("Skipping SS due to multiple genes", file=log)
                    else:
                        _gene = next(iter(_genes))
                        yield _row(
                            "A3" if genestrand[_gene] == "+" else "A5",
                            "novel",
                            genechr[_gene],
                            _gene,
                            genestrand[_gene],
                            "|".join(g.link[j1].jn),
                            "?",
                            ".",
                            ">".join(j1),
                            g.rc(j1),
                            ">".join(_j),
                            g.rc(_j),
                            ".",
                            ".",
                        )
            elif len(_exons0) == 0 and len(_exons1) > 0:
                exonic_prev = set(q for q in _prev1 if (q, _j[1]) in g.junctions)
                found = _frontier_search(g, _j[0], exonic_prev, opts.isw, forward=False)
                if found is not None:
                    j1 = (found, _j[1])
                    _genes = g.jn_genes(j1, t2g)
                    if len(_genes) > 1:
                        print("Skipping SS due to multiple genes", file=log)
                    else:
                        _gene = next(iter(_genes))
                        yield _row(
                            "A3" if genestrand[_gene] == "+" else "A5",
                            "novel",
                            genechr[_gene],
                            _gene,
                            genestrand[_gene],
                            "|".join(g.link[j1].jn),
                            "?",
                            ".",
                            ">".join(j1),
                            g.rc(j1),
                            ">".join(_j),
                            g.rc(_j),
                            ".",
                            ".",
                        )

        if "IR" in events:
            if cap:
                exons = _exons0 & _exons1
                if exons:
                    subpath = [_j[0]]
                    while subpath[-1] != _j[1]:
                        nn = "-1"
                        for nn in g.out(subpath[-1]):
                            if nn <= _j[1] and len(exons & g.exset(nn)):
                                break
                        assert nn != "-1", "Error while reconstructing novel IR path"
                        subpath.append(nn)
                    if sum(g.seg[x].length for x in subpath) >= opts.minintronsize:
                        retained = tkeys_of_exons(exons)
                        _genes = set(t2g[t] for t in retained)
                        if len(_genes) > 1:
                            print("Skipping novel IR due to multiple genes", file=log)
                        else:
                            _gene = next(iter(_genes))
                            cov = ceil(sum(g.nc(x) for x in subpath) / len(subpath))
                            yield _row(
                                "IR",
                                "novel",
                                genechr[_gene],
                                _gene,
                                genestrand[_gene],
                                "?",
                                "|".join(exons),
                                ".",
                                ">".join(_j),
                                g.rc(_j),
                                ">".join(subpath),
                                cov,
                                ".",
                                ".",
                            )


def _annotated_junction_rows(
    g: SplicingGraph,
    t2g,
    genestrand,
    genechr,
    opts: CallOptions,
    log,
    ce_oracle: Optional[Dict[Jct, Set[Tuple[str, str]]]] = None,
) -> Iterator[str]:
    """The novel pass's loop over ANNOTATED junctions: novel CE (where ES
    is asked for) and novel IR-2 (where IR is). ``ce_oracle`` (device
    engine) maps an annotated junction to its novel-CE ``(exon_start,
    exon_end)`` pair set (:func:`batched.find_novel_ce`), replacing the
    flank product scan."""
    events = opts.events
    ir2_head_cache: Dict[Tuple[str, str], List[str]] = {}
    ir2_tail_cache: Dict[Tuple[str, str], Dict[str, List[str]]] = {}
    for _j in g.junctions:
        if opts.junction is not None and f"{_j[0]}-{_j[1]}" != opts.junction:
            continue
        if g.rc(_j) < opts.rca:
            continue
        jn = g.link[_j].jn
        _ht = g.jn_keys(_j)
        _genes = g.jn_genes(_j, t2g)
        if len(_genes) > 1:
            continue
        _gene = next(iter(_genes))
        _exons0 = _same_gene_exons_cached(g, _j[0], _genes, t2g)
        _exons1 = _same_gene_exons_cached(g, _j[1], _genes, t2g)
        assert len(_exons0) > 0 and len(_exons1) > 0

        Js1 = g.nj_by_head.get(_j[0], g._empty_j) - set([_j])
        Js2 = g.nj_by_tail.get(_j[1], g._empty_j) - set([_j])

        if "ES" in events:
            if len(Js1) > 0 and len(Js2) > 0:
                if ce_oracle is not None:
                    novel_exons = ce_oracle.get(_j, set())
                else:
                    novel_exons = set()
                    for j1, j2 in product(Js1, Js2):
                        if j1[1] <= j2[0]:  # QUIRK: lexicographic
                            novel_exons.add((j1[1], j2[0]))
                for es, ee in novel_exons:
                    j1 = (_j[0], es)
                    j2 = (ee, _j[1])
                    yield _row(
                        "CE",
                        "novel",
                        genechr[_gene],
                        _gene,
                        genestrand[_gene],
                        "|".join(jn),
                        "?",
                        "?",
                        ">".join(_j),
                        g.rc(_j),
                        ">".join(j1),
                        g.rc(j1),
                        ">".join(j2),
                        g.rc(j2),
                    )

        if "IR" in events:
            # a few edges past each end (tolerating variation nodes)
            head_ok = any(
                g.rc((_j[0], str(x))) >= opts.rca
                for x in range(int(_j[0]) + 1, int(_j[0]) + 4)
                if (_j[0], str(x)) in g.link and (_j[0], str(x)) not in g.junctions
            )
            tail_ok = any(
                g.rc((str(x), _j[1])) >= opts.rca
                for x in range(int(_j[1]) - 3, int(_j[1]))
                if (str(x), _j[1]) in g.link and (str(x), _j[1]) not in g.junctions
            )
            if head_ok and tail_ok:
                # "e continues on no successor/predecessor" == absence
                # from the union of their exon sets. Both sides depend
                # only on (endpoint node, gene): cache per side — the
                # cached lists preserve the set-iteration order the
                # uncached scan would produce (same set object).
                key0 = (_j[0], _gene)
                exons0_end = ir2_head_cache.get(key0)
                if exons0_end is None:
                    out_union: Set[str] = set()
                    for x in g.out(_j[0]):
                        out_union |= g.exset(x)
                    exons0_end = [e for e in _exons0 if e not in out_union]
                    ir2_head_cache[key0] = exons0_end
                key1 = (_j[1], _gene)
                tail_suf = ir2_tail_cache.get(key1)
                if tail_suf is None:
                    inc_union: Set[str] = set()
                    for x in g.inc(_j[1]):
                        inc_union |= g.exset(x)
                    exons1_start = [e for e in _exons1 if e not in inc_union]
                    # pair condition "share a haplotype-aware transcript"
                    # is label-transcript equality (labels name exactly
                    # one transcript); group by transcript and keep only
                    # the exon-number suffixes the jann field needs
                    # (`e2.split(".")[-1]`, reference call.py:1060-1067)
                    tail_suf = {}
                    for e1x in exons1_start:
                        tail_suf.setdefault(_exon_label_th(e1x)[0], []).append(
                            "." + e1x.rsplit(".", 1)[-1]
                        )
                    ir2_tail_cache[key1] = tail_suf
                has_pairs = any(
                    _exon_label_th(e0)[0] in tail_suf for e0 in exons0_end
                )
                if has_pairs:
                    subpath = [_j[0]]
                    dead_end = False
                    while subpath[-1] != _j[1]:
                        onodes = [x for x in g.out(subpath[-1]) if x <= _j[1]]
                        if len(subpath) == 1 and _j[1] in onodes:
                            onodes.remove(_j[1])
                        if _j[1] in onodes:
                            subpath.append(_j[1])
                        else:
                            onodes = [x for x in onodes if len(g.out(x)) > 0]
                            if not onodes:
                                # DIVERGENCE from the reference: its greedy
                                # walk dead-ends here and crashes with
                                # max() on an empty list (call.py:1049) —
                                # the lexicographic `x <= _j[1]` filter
                                # wrongly excludes nodes at scale. We skip
                                # the candidate event and keep calling.
                                dead_end = True
                                break
                            best = max(onodes, key=lambda x: g.nc(x))
                            subpath.append(best)
                    if dead_end:
                        print(
                            f"Skipping novel IR at {_j[0]}>{_j[1]}: "
                            "greedy intron walk dead-ended",
                            file=log,
                        )
                        continue
                    if (
                        sum(g.seg[x].length for x in subpath[1:-1])
                        >= opts.minintronsize
                    ):
                        retained = {
                            t
                            for t in (_exon_label_th(e0)[0] for e0 in exons0_end)
                            if t in tail_suf
                        }
                        _genes = set(t2g[t] for t in retained)
                        if len(_genes) > 1:
                            print("Skipping novel IR due to multiple genes", file=log)
                        else:
                            _gene = next(iter(_genes))
                            jann = "|".join(
                                e0 + s
                                for e0 in exons0_end
                                for s in tail_suf.get(_exon_label_th(e0)[0], ())
                            )
                            cov = ceil(
                                sum(g.nc(x) for x in subpath) / len(subpath)
                            )
                            yield _row(
                                "IR",
                                "novel",
                                genechr[_gene],
                                _gene,
                                genestrand[_gene],
                                jann,
                                "?",
                                ".",
                                ">".join(subpath),
                                cov,
                                ">".join(_j),
                                g.rc(_j),
                                ".",
                                ".",
                            )


def _frontier_search(
    g: SplicingGraph, start: str, targets: Set[str], isw: int, forward: bool
) -> Optional[str]:
    """Hash-ordered frontier walk bounded by ``isw`` levels.

    Mirrors the reference intronic search (``call.py:734-751``): a set-pop
    pseudo-BFS whose level counter advances when the sampled frontier size
    hits zero. Returns the reached target node or None.
    """
    visit = set([start])
    pvisitl = 1
    _i = 0
    while len(visit & targets) == 0 and _i < isw:
        if len(visit) == 0:
            return None
        n = visit.pop()
        pvisitl -= 1
        visit |= set(g.out(n) if forward else g.inc(n))
        if pvisitl == 0:
            _i += 1
            pvisitl = len(visit)
    if _i < isw:
        return next(iter(visit & targets))
    return None
