"""Variation-graph construction from a reference chromosome + VCF.

Replaces ``vg construct --alt-paths`` (reference ``build/build.smk:62-74``).

Node ids are assigned in a single left-to-right sweep of the reference, with
each variant site's reference-allele nodes emitted before its alternate
chains, so ids are topologically sorted — an invariant the downstream event
caller exploits (reference ``call.py:477-479``) and the chromosome combiner
assumes (``build/combine.py:5-6``).

Node boundaries are cut at: variant allele spans, transcript exon
boundaries (so splice edges attach cleanly), and a maximum node length.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from pbench.reference.io.vcf import VcfVariant

DEFAULT_MAX_NODE_LEN = 32


@dataclass
class Site:
    """One accepted variant: reference span + per-allele node chains."""

    vid: str
    pos: int  # 1-based
    end: int  # 1-based inclusive end of REF span
    ref_nodes: List[int] = field(default_factory=list)
    alt_nodes: Dict[int, List[int]] = field(default_factory=dict)  # allele>=1


@dataclass
class VariationGraph:
    chrom: str
    seqs: List[str] = field(default_factory=list)  # node i+1 -> seqs[i]
    edges: Set[Tuple[int, int]] = field(default_factory=set)
    ref_path: List[int] = field(default_factory=list)
    # reference-path node -> (start, end) 1-based inclusive reference span
    ref_span: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    sites: List[Site] = field(default_factory=list)
    skipped_variants: int = 0

    def n_nodes(self) -> int:
        return len(self.seqs)

    def new_node(self, seq: str) -> int:
        self.seqs.append(seq)
        return len(self.seqs)

    def seq(self, nid: int) -> str:
        return self.seqs[nid - 1]

    def add_edge(self, a: int, b: int) -> None:
        self.edges.add((a, b))

    def node_lengths(self) -> List[int]:
        return [len(s) for s in self.seqs]


def _chunks(seq: str, max_len: int) -> List[str]:
    return [seq[i : i + max_len] for i in range(0, len(seq), max_len)]


def accept_variants(
    variants: Iterable[VcfVariant], ref_seq: str, log=sys.stderr
) -> Tuple[List[VcfVariant], int]:
    """Filter to non-overlapping, reference-consistent variants (sorted)."""
    accepted: List[VcfVariant] = []
    skipped = 0
    last_end = 0
    for v in sorted(variants, key=lambda v: (v.pos, v.end)):
        if v.pos <= last_end:
            skipped += 1
            continue
        if ref_seq[v.pos - 1 : v.end].upper() != v.ref.upper():
            skipped += 1
            continue
        accepted.append(v)
        last_end = v.end
    if skipped:
        print(f"[construct] skipped {skipped} overlapping/mismatching variants", file=log)
    return accepted, skipped


def construct(
    chrom: str,
    ref_seq: str,
    variants: Iterable[VcfVariant],
    exon_boundaries: Optional[Iterable[Tuple[int, int]]] = None,
    max_node_len: int = DEFAULT_MAX_NODE_LEN,
    log=sys.stderr,
    prefiltered: bool = False,
) -> VariationGraph:
    """Build the variation graph for one chromosome.

    ``exon_boundaries``: iterable of (start, end) 1-based inclusive exon
    spans; node cuts are added after ``start-1`` and after ``end``.
    ``prefiltered``: the variants already passed :func:`accept_variants`
    (skip the redundant re-sort/re-scan).
    """
    g = VariationGraph(chrom=chrom)
    if prefiltered:
        accepted = list(variants)
    else:
        accepted, g.skipped_variants = accept_variants(variants, ref_seq, log)

    # cut marks: a cut after reference position p (1-based) splits p | p+1
    cuts: Set[int] = {0, len(ref_seq)}
    if exon_boundaries:
        for s, e in exon_boundaries:
            cuts.add(s - 1)
            cuts.add(e)
    for v in accepted:
        cuts.add(v.pos - 1)
        cuts.add(v.end)
    cutlist = sorted(c for c in cuts if 0 <= c <= len(ref_seq))

    site_iter = iter(accepted)
    next_var = next(site_iter, None)

    prev_tail: Optional[int] = None  # last ref-path node emitted
    open_site: Optional[Site] = None
    open_var: Optional[VcfVariant] = None
    open_head: Optional[int] = None  # ref node preceding the open site

    for i in range(len(cutlist) - 1):
        seg_start = cutlist[i] + 1
        seg_end = cutlist[i + 1]
        if seg_start > seg_end:
            continue

        if next_var is not None and seg_start == next_var.pos:
            open_site = Site(vid=next_var.vid, pos=next_var.pos, end=next_var.end)
            open_var = next_var
            open_head = prev_tail
            next_var = next(site_iter, None)

        pos = seg_start
        for chunk in _chunks(ref_seq[seg_start - 1 : seg_end], max_node_len):
            nid = g.new_node(chunk)
            if prev_tail is not None:
                g.add_edge(prev_tail, nid)
            g.ref_path.append(nid)
            g.ref_span[nid] = (pos, pos + len(chunk) - 1)
            pos += len(chunk)
            prev_tail = nid
            if open_site is not None:
                open_site.ref_nodes.append(nid)

        if open_site is not None and seg_end == open_site.end:
            for a_idx, alt_seq in enumerate(open_var.alts, start=1):
                chain: List[int] = []
                for chunk in _chunks(alt_seq, max_node_len):
                    nid = g.new_node(chunk)
                    if chain:
                        g.add_edge(chain[-1], nid)
                    chain.append(nid)
                open_site.alt_nodes[a_idx] = chain
                if chain and open_head is not None:
                    g.add_edge(open_head, chain[0])
            g.sites.append(open_site)
            open_site = None
            open_var = None
            open_head = None

    _wire_alt_tails(g)
    return g


def _wire_alt_tails(g: VariationGraph) -> None:
    """Connect alternate-chain tails to every node that can follow the site.

    A substituted path leaving a site must find an edge to whatever comes
    next: the next reference node, an adjacent site's alternate heads, or —
    through any run of adjacent pure-deletion (empty-alt) alleles —
    whatever follows THAT run.  ``ENTRY(i)`` is the transitive closure of
    "nodes a walk arriving at reference position i can step onto",
    computed right-to-left so arbitrarily deep adjacent chains are wired
    (anchored VCF indels never produce empty alts, but the synthetic /
    simulator path can; see ``tests/test_graph_validity.py``).
    """
    pos_in_ref = {nid: i for i, nid in enumerate(g.ref_path)}
    head_at: Dict[int, Site] = {}
    for site in g.sites:
        if site.ref_nodes:
            head_at[pos_in_ref[site.ref_nodes[0]]] = site

    n = len(g.ref_path)
    entry: Dict[int, Tuple[int, ...]] = {}
    for idx in range(n - 1, -1, -1):
        site = head_at.get(idx)
        if site is None:
            continue  # only site heads need a computed closure
        out: List[int] = [g.ref_path[idx]]
        for chain in site.alt_nodes.values():
            if chain:
                out.append(chain[0])
            else:
                after = pos_in_ref[site.ref_nodes[-1]] + 1
                out.extend(entry.get(after, (g.ref_path[after],) if after < n else ()))
        seen: Set[int] = set()
        entry[idx] = tuple(x for x in out if not (x in seen or seen.add(x)))

    for site in g.sites:
        if not site.ref_nodes:
            continue
        tail_idx = pos_in_ref[site.ref_nodes[-1]]
        head_idx = pos_in_ref[site.ref_nodes[0]]
        prev = g.ref_path[head_idx - 1] if head_idx > 0 else None

        # sources that can precede whatever follows this site: alt tails,
        # and (for pure-deletion alleles) the node before the site
        sources = [c[-1] for c in site.alt_nodes.values() if c]
        if any(not c for c in site.alt_nodes.values()) and prev is not None:
            sources.append(prev)

        after = tail_idx + 1
        targets = entry.get(after, (g.ref_path[after],) if after < n else ())
        for s in sources:
            for t in targets:
                g.add_edge(s, t)
