"""Splice-edge addition and haplotype-aware transcript projection.

Replaces both ``vg rna`` passes of the reference build
(``build/build.smk:77-89`` splice edges; ``:143-162`` haplotype-aware
transcript projection driven by the GBWT).

Design: a transcript's projection onto a haplotype differs from its
reference projection only at variant sites inside its exons. So each
(transcript, haplotype) pair reduces to an integer *allele signature* —
the haplotype's allele choices at the transcript's in-exon sites — and
projection dedup is one vectorized ``np.unique(signatures, axis=0)`` over
the (haplotypes × sites) allele matrix instead of a per-path comparison.

Naming follows the vg rna convention the downstream stages parse
(reference ``call.py:90-104``, ``remap.py:21-27``): the reference
projection is ``{tid}_R1``; each distinct non-reference projection is
``{tid}_H{i}`` numbered by first occurrence.
"""

from __future__ import annotations

import sys
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from pbench.reference.build.construct import VariationGraph
from pbench.reference.io.gtf import Transcript
from pbench.reference.io.vcf import VcfVariant

REF_HAP = "ref"


@dataclass
class TranscriptCopy:
    name: str  # tid_R1 / tid_H{i}
    tid: str
    path: List[int]
    source_hap: str  # REF_HAP or "{sample}#{1|2}"
    exon_breaks: List[int] = field(default_factory=list)  # path idx of each exon start


@dataclass
class Pantranscriptome:
    graph: VariationGraph
    copies: List[TranscriptCopy] = field(default_factory=list)
    hap_names: List[str] = field(default_factory=list)
    splice_edges: Set[Tuple[int, int]] = field(default_factory=set)
    straddling_sites: int = 0
    # allele matrix (haplotypes × sites), for haplotype path reconstruction
    alleles: Optional[np.ndarray] = None

    def hap_path(self, hap: str) -> List[int]:
        """Full chromosome path of one haplotype (or the reference)."""
        g = self.graph
        if hap == REF_HAP or self.alleles is None:
            return list(g.ref_path)
        h = self.hap_names.index(hap)
        row = self.alleles[h]
        return _substituted_path(g, range(len(g.sites)), row)


def _substituted_path(
    g: VariationGraph, site_indices, alleles_row
) -> List[int]:
    """Reference path with site substitutions per an allele assignment."""
    sub: Dict[int, Tuple[List[int], Set[int]]] = {}
    for si in site_indices:
        a = int(alleles_row[si])
        if a != 0:
            site = g.sites[si]
            if a in site.alt_nodes:
                sub[site.ref_nodes[0]] = (site.alt_nodes[a], set(site.ref_nodes))
    path: List[int] = []
    skip: Set[int] = set()
    for nid in g.ref_path:
        if nid in skip:
            continue
        if nid in sub:
            chain, ref_nodes = sub[nid]
            path.extend(chain)
            skip |= ref_nodes
        else:
            path.append(nid)
    return path


def validate_paths(ptx: "Pantranscriptome") -> None:
    """Invariant: every emitted path step traverses an existing L edge.

    Guards the contract between construct's edge wiring and the path
    substitution here — a violation means an emitted P/W line could not be
    walked on the graph (the class of bug ``vg construct`` prevents by
    building paths and edges together).
    """
    g = ptx.graph
    edges = g.edges

    def chk(name: str, path: Sequence[int]) -> None:
        for a, b in zip(path, path[1:]):
            if (a, b) not in edges:
                raise AssertionError(
                    f"path {name!r} steps over nonexistent edge {a}->{b}"
                )

    chk(g.chrom, g.ref_path)
    for c in ptx.copies:
        chk(c.name, c.path)


def build_allele_matrix(
    variants: Sequence[VcfVariant],
) -> Tuple[List[str], np.ndarray]:
    """(haplotype names, H×S int16 allele matrix) from accepted variants."""
    if not variants:
        return [], np.zeros((0, 0), dtype=np.int16)
    n_samples = len(variants[0].genotypes)
    # sample names are not stored on the variant; caller passes them via
    # project(); here we only need indices
    H = 2 * n_samples
    A = np.zeros((H, len(variants)), dtype=np.int16)
    for si, v in enumerate(variants):
        for s, (h1, h2) in enumerate(v.genotypes):
            A[2 * s, si] = h1 or 0
            A[2 * s + 1, si] = h2 or 0
    return [], A


def project(
    graph: VariationGraph,
    transcripts: Sequence[Transcript],
    variants: Sequence[VcfVariant],
    sample_names: Sequence[str],
    log=sys.stderr,
) -> Pantranscriptome:
    """Project every transcript onto the reference and all haplotypes."""
    ptx = Pantranscriptome(graph=graph)
    _, A = build_allele_matrix(variants)
    ptx.alleles = A
    ptx.hap_names = [f"{s}#{h}" for s in sample_names for h in (1, 2)]

    # reference-path position index (spans are increasing along ref_path)
    ref_nodes = graph.ref_path
    starts = [graph.ref_span[n][0] for n in ref_nodes]
    ends = [graph.ref_span[n][1] for n in ref_nodes]

    # site lookup tables
    site_pos = [s.pos for s in graph.sites]
    site_end = [s.end for s in graph.sites]
    node2site: Dict[int, int] = {}
    for si, s in enumerate(graph.sites):
        for n in s.ref_nodes:
            node2site[n] = si

    def exon_node_range(s: int, e: int) -> Tuple[int, int]:
        """ref_path index range [i0, i1) of nodes overlapping [s, e]."""
        i0 = bisect_left(ends, s)
        i1 = bisect_right(starts, e)
        return i0, i1

    def exon_sites(s: int, e: int) -> List[int]:
        """sites overlapping [s, e] (straddlers substituted whole, counted)."""
        i0 = bisect_left(site_pos, s)
        out = []
        # at most one (non-overlapping) site can straddle the exon start
        if i0 > 0 and site_end[i0 - 1] >= s:
            out.append(i0 - 1)
            ptx.straddling_sites += 1
        for si in range(i0, len(site_pos)):
            if site_pos[si] > e:
                break
            out.append(si)
            if site_end[si] > e:
                ptx.straddling_sites += 1
        return out

    H = A.shape[0]

    for tr in transcripts:
        ranges = [exon_node_range(s, e) for s, e in tr.exons]
        ksites: List[int] = []
        for s, e in tr.exons:
            ksites.extend(exon_sites(s, e))

        # distinct allele signatures over the transcript's in-exon sites
        if H > 0 and ksites:
            sig = A[:, ksites]
            nz = sig.any(axis=1)
            distinct: List[Tuple[Tuple[int, ...], int]] = []  # (sig, first hap)
            seen: Dict[Tuple[int, ...], int] = {}
            for h in np.nonzero(nz)[0]:
                key = tuple(int(x) for x in sig[h])
                if key not in seen:
                    seen[key] = int(h)
                    distinct.append((key, int(h)))
        else:
            distinct = []

        def build_copy(name: str, source: str, sig_row) -> TranscriptCopy:
            path: List[int] = []
            breaks: List[int] = []
            prev_tail: Optional[int] = None
            # skip/done persist across exons: a site straddling an intron
            # (REF span crossing an exon boundary) must substitute exactly
            # once, not once per touching exon
            skip: Set[int] = set()
            done_sites: Set[int] = set()
            for (i0, i1) in ranges:
                chain: List[int] = []
                for idx in range(i0, i1):
                    nid = ref_nodes[idx]
                    if nid in skip:
                        continue
                    si = node2site.get(nid)
                    a = int(sig_row[si]) if (sig_row is not None and si is not None) else 0
                    if a != 0 and a in graph.sites[si].alt_nodes:
                        if si in done_sites:
                            continue
                        done_sites.add(si)
                        chain.extend(graph.sites[si].alt_nodes[a])
                        skip |= set(graph.sites[si].ref_nodes)
                    else:
                        chain.append(nid)
                if not chain:
                    continue
                breaks.append(len(path))
                if prev_tail is not None:
                    edge = (prev_tail, chain[0])
                    if edge not in graph.edges:
                        graph.add_edge(*edge)
                    ptx.splice_edges.add(edge)
                path.extend(chain)
                prev_tail = chain[-1]
            return TranscriptCopy(
                name=name, tid=tr.tid, path=path, source_hap=source, exon_breaks=breaks
            )

        ref_copy = build_copy(f"{tr.tid}_R1", REF_HAP, None)
        if ref_copy.path:
            ptx.copies.append(ref_copy)
        full_sig = np.zeros(len(graph.sites), dtype=np.int16)
        for i, (key, h) in enumerate(distinct, start=1):
            row = full_sig.copy()
            row[ksites] = key
            hap_copy = build_copy(f"{tr.tid}_H{i}", ptx.hap_names[h], row)
            if hap_copy.path:
                ptx.copies.append(hap_copy)

    return ptx
