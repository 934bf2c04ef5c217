"""EX/JN annotation via per-haplotype edge-set difference.

Replaces the reference's native annotator (``build/annotate.cpp``): for each
haplotype-aware transcript copy, walk its path against the edge set of the
haplotype it was projected from; an edge absent from the haplotype is a
splice junction and increments the exon counter (``annotate.cpp:160-191``).

Membership is vectorized over packed uint64 edges (``(src << 32) | dst``,
as ``annotate.cpp:14,131``). A haplotype's edge set is never materialized
as a full path: it is the reference edge set plus a per-haplotype DELTA
(edges removed around substituted sites, alternate-chain edges added),
computed from the allele matrix — O(#alt sites) per haplotype instead of
O(chromosome).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Sequence, TextIO, Tuple

import numpy as np

from pbench.reference.build.transcripts import Pantranscriptome, REF_HAP

_EMPTY = np.zeros(0, dtype=np.uint64)


def pack_edges(path: Sequence[int]) -> np.ndarray:
    arr = np.asarray(path, dtype=np.uint64)
    if arr.size < 2:
        return _EMPTY
    return (arr[:-1] << np.uint64(32)) | arr[1:]


def _pack_pairs(nodes: List[int], out: List[int]) -> None:
    for a, b in zip(nodes, nodes[1:]):
        out.append((a << 32) | b)


def _member(sorted_edges: np.ndarray, probes: np.ndarray) -> np.ndarray:
    if probes.size == 0 or sorted_edges.size == 0:
        return np.zeros(probes.shape, dtype=bool)
    idx = np.searchsorted(sorted_edges, probes)
    idx = np.minimum(idx, len(sorted_edges) - 1)
    return sorted_edges[idx] == probes


def _hap_edge_delta(
    graph, row, pos_in_ref: Dict[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """(removed, added) packed-edge arrays for one haplotype's substitutions.

    Substituted sites are grouped into runs of reference-adjacent sites so
    alternate chains of adjacent sites connect to each other, matching the
    path-substitution semantics of ``transcripts._substituted_path``.
    """
    sites = graph.sites
    subs: List[int] = [
        int(si)
        for si in np.nonzero(row)[0]
        if int(row[si]) in sites[si].alt_nodes and sites[si].ref_nodes
    ]
    if not subs:
        return _EMPTY, _EMPTY

    ref_path = graph.ref_path
    removed: List[int] = []
    added: List[int] = []

    i = 0
    while i < len(subs):
        # maximal run of reference-adjacent substituted sites
        j = i
        while (
            j + 1 < len(subs)
            and pos_in_ref[sites[subs[j + 1]].ref_nodes[0]]
            == pos_in_ref[sites[subs[j]].ref_nodes[-1]] + 1
        ):
            j += 1
        head_idx = pos_in_ref[sites[subs[i]].ref_nodes[0]]
        tail_idx = pos_in_ref[sites[subs[j]].ref_nodes[-1]]
        prev = ref_path[head_idx - 1] if head_idx > 0 else None
        nxt = ref_path[tail_idx + 1] if tail_idx + 1 < len(ref_path) else None

        ref_run = ref_path[head_idx : tail_idx + 1]
        chain: List[int] = []
        for si in subs[i : j + 1]:
            chain.extend(sites[si].alt_nodes[int(row[si])])

        rm = ([prev] if prev is not None else []) + ref_run + (
            [nxt] if nxt is not None else []
        )
        _pack_pairs(rm, removed)
        ad = ([prev] if prev is not None else []) + chain + (
            [nxt] if nxt is not None else []
        )
        _pack_pairs(ad, added)
        i = j + 1

    return (
        np.sort(np.asarray(removed, dtype=np.uint64)),
        np.sort(np.asarray(added, dtype=np.uint64)),
    )


class Annotation:
    """Accumulated EX (per node) and JN (per edge) tag label lists."""

    def __init__(self) -> None:
        self.ex: Dict[int, List[str]] = {}
        self.jn: Dict[Tuple[int, int], List[str]] = {}

    def add_exon(self, nid: int, label: str) -> None:
        self.ex.setdefault(nid, []).append(label)

    def add_junction(self, edge: Tuple[int, int], label: str) -> None:
        self.jn.setdefault(edge, []).append(label)


def annotate(ptx: Pantranscriptome, log=sys.stderr) -> Annotation:
    ann = Annotation()
    g = ptx.graph
    ref_sorted = np.sort(pack_edges(g.ref_path))
    pos_in_ref = {nid: i for i, nid in enumerate(g.ref_path)}
    A = ptx.alleles
    hap_index = {name: i for i, name in enumerate(ptx.hap_names)}

    # group copies by source haplotype; reference group first, then sorted
    groups: Dict[str, List[int]] = {}
    for ci, copy in enumerate(ptx.copies):
        groups.setdefault(copy.source_hap, []).append(ci)
    ordered = sorted(groups, key=lambda h: (h != REF_HAP, h))

    ex = ann.ex
    jn = ann.jn

    for hap in ordered:
        if hap == REF_HAP or A is None or A.size == 0:
            removed = added = _EMPTY
        else:
            removed, added = _hap_edge_delta(g, A[hap_index[hap]], pos_in_ref)

        for ci in groups[hap]:
            copy = ptx.copies[ci]
            path = copy.path
            if not path:
                continue
            probes = pack_edges(path)
            on_hap = _member(ref_sorted, probes)
            if removed.size:
                on_hap &= ~_member(removed, probes)
            if added.size:
                on_hap |= _member(added, probes)
            jidx = np.nonzero(~on_hap)[0]

            # nodes between junction t and t+1 belong to exon t+1
            bounds = [0] + [int(k) + 1 for k in jidx] + [len(path)]
            name = copy.name
            for s in range(len(bounds) - 1):
                label = f"{name}.{s + 1}"
                for nid in path[bounds[s] : bounds[s + 1]]:
                    lst = ex.get(nid)
                    if lst is None:
                        ex[nid] = [label]
                    else:
                        lst.append(label)
            for t, k in enumerate(jidx):
                k = int(k)
                edge = (path[k], path[k + 1])
                label = f"{name}.{t + 1}.{t + 2}"
                lst = jn.get(edge)
                if lst is None:
                    jn[edge] = [label]
                else:
                    lst.append(label)
    return ann


def write_annotated_gfa(
    ptx: Pantranscriptome,
    ann: Annotation,
    out: TextIO,
    hp: int = 0,
    keep_nodes=None,
    w_lines: bool = False,
) -> None:
    """Emit the annotated GFA: H, S (ascending id), L (sorted), P lines.

    ``hp=1`` (aggressive mode) drops haplotype-aware transcript paths from
    the P section, keeping only reference-projected transcripts — matching
    the reference build's ``--add-ref-paths``-only mode
    (``build/build.smk:10-12,153``). Tags are unaffected.
    ``keep_nodes``: optional node-id set filter (reduce mode).
    ``w_lines``: emit haplotype-aware transcript walks as GFA 1.1 W lines
    (``W sample hap seqid 0 len walk``) instead of P lines — the vg-style
    walk output; every downstream stage ignores W lines exactly like the
    reference scripts do (S/L/P dispatch only).
    """
    g = ptx.graph
    w = out.write
    w("H\tVN:Z:1.1\n")

    def kept(nid: int) -> bool:
        return keep_nodes is None or nid in keep_nodes

    ex = ann.ex
    for nid in range(1, g.n_nodes() + 1):
        if not kept(nid):
            continue
        labels = ex.get(nid)
        if labels:
            w(f"S\t{nid}\t{g.seq(nid)}\tEX:Z:{','.join(labels)}\n")
        else:
            w(f"S\t{nid}\t{g.seq(nid)}\n")

    jn = ann.jn
    for a, b in sorted(g.edges):
        if not (kept(a) and kept(b)):
            continue
        labels = jn.get((a, b))
        if labels:
            w(f"L\t{a}\t+\t{b}\t+\t*\tJN:Z:{','.join(labels)}\n")
        else:
            w(f"L\t{a}\t+\t{b}\t+\t*\n")

    # reference path (possibly split into kept sub-paths), then transcripts
    if keep_nodes is None or all(kept(n) for n in g.ref_path):
        _write_path(out, g.chrom, g.ref_path)
    else:
        sub: List[int] = []
        i = 0
        for nid in g.ref_path:
            if kept(nid):
                sub.append(nid)
            elif sub:
                _write_path(out, f"{g.chrom}.{i}", sub)
                i += 1
                sub = []
        if sub:
            _write_path(out, f"{g.chrom}.{i}", sub)

    for copy in ptx.copies:
        if hp == 1 and copy.source_hap != REF_HAP:
            continue
        if not copy.path:
            continue
        if keep_nodes is not None and not all(kept(n) for n in copy.path):
            continue
        if w_lines and copy.source_hap != REF_HAP:
            sample, _, hap = copy.source_hap.partition("#")
            walk = "".join(f">{n}" for n in copy.path)
            length = sum(len(g.seq(n)) for n in copy.path)
            out.write(f"W\t{sample}\t{hap}\t{copy.name}\t0\t{length}\t{walk}\n")
        else:
            _write_path(out, copy.name, copy.path)


def _write_path(out: TextIO, name: str, path: Sequence[int]) -> None:
    steps = "+,".join(map(str, path))
    out.write(f"P\t{name}\t{steps}+\t*\n")
