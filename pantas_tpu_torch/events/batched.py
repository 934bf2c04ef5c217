"""Batched junction-pattern matching of the call stage, on a torch device.

The counterpart of ``pantas_tpu/events/batched.py`` (its docstring states the
set algebra of each family). Every finder is split in two:

- a host half, copied verbatim from the JAX finder, that enumerates the
  candidates (endpoint grouping, per-gene :class:`_BlockVocab` ids) and packs
  their sets into uint32 bitset matrices (:func:`_bitset_matrix`);
- a ``match_*`` function on tensors, elementwise over the candidate axis:
  row gathers, AND / OR / ANDNOT, and an any-reduce (``find_novel_ce``'s is
  a rank compare with no tables).

In the JAX package the match functions are XLA-jitted ops, not Pallas
kernels, so here they are plain torch ops with no hand-written kernel. The
bitsets travel as int32 views of the uint32 matrices: torch's uint32 bitwise
ops are incomplete on CUDA, and the view keeps every bit.

:func:`call_events_device` emits the host caller's row multiset, as the JAX
engine does; novel IR and the intronic-SS frontier search stay on the host
enumerator in both packages. Nothing here imports ``jax``.
"""

from __future__ import annotations

import gc
from collections import Counter
from itertools import product
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from pantas_tpu_torch import backend, trace
from pantas_tpu_torch.events.caller import (
    CallOptions,
    Jct,
    SplicingGraph,
    _exon_label_th,
    _genes_of_hts,
    _row,
    _same_gene_exons_cached,
    tkeys_of_exons,
    transcript_of_label,
)

# candidates evaluated in this process, keyed (finder, device type);
# chip_smoke.py reads them to prove where each finder's evaluation ran, and
# trace.snapshot() reports them as its counters ``call.candidates.<finder>``
EVALS: Counter = Counter()


def finder_label(finder: str) -> str:
    """A finder's name in spans and counters: ``annotated_es`` -> ``es``,
    ``novel_es`` stays ``novel_es``."""
    return finder.removeprefix("annotated_")


def _bitset_matrix(sets: Sequence[Set[int]], vocab: int) -> np.ndarray:
    """Pack id-sets into a (rows, words) uint32 bitset matrix.

    Vectorized fill: the per-element Python loop measured 36x slower at
    genome scale (11.9 s vs 0.33 s over 7.4M elements)."""
    words = (vocab + 31) // 32
    out = np.zeros((len(sets), max(words, 1)), dtype=np.uint32)
    if not sets:
        return out
    lens = np.fromiter((len(s) for s in sets), dtype=np.int64, count=len(sets))
    total = int(lens.sum())
    if total == 0:
        return out
    vals = np.empty(total, dtype=np.int64)
    pos = 0
    for s in sets:
        ln = len(s)
        if ln:
            vals[pos : pos + ln] = np.fromiter(s, dtype=np.int64, count=ln)
            pos += ln
    rows = np.repeat(np.arange(len(sets)), lens)
    np.bitwise_or.at(
        out,
        (rows, vals >> 5),
        np.uint32(1) << (vals & 31).astype(np.uint32),
    )
    return out


class _BlockVocab:
    """Per-block (per-gene) token id spaces.

    Every candidate's device AND/compare only touches rows built under the
    SAME gene, so token ids may restart at 0 per block: the bitset matrix
    width becomes the max block vocabulary instead of the global one. At
    genome scale this is the difference between ~20 GB / minutes of matrix
    fill (measured, 554k-node graph) and megabytes — the 'bitset vocab
    sizing' fix. Ids are injective within a block, so set algebra results
    are exact; rows of different blocks share columns but never meet.
    """

    def __init__(self):
        self.maps: Dict[object, Dict[str, int]] = {}

    def block(self, key) -> Dict[str, int]:
        return self.maps.setdefault(key, {})

    def ids(self, block_map: Dict[str, int], items) -> Set[int]:
        # len() is evaluated before setdefault inserts, so a missing token
        # gets exactly the next id — one dict op per element
        sd = block_map.setdefault
        return {sd(x, len(block_map)) for x in items}

    @property
    def width(self) -> int:
        return max((len(m) for m in self.maps.values()), default=0)


def _to_device(mat: np.ndarray, device) -> torch.Tensor:
    """A uint32 bitset matrix as an int32 tensor on ``device``, bit for bit."""
    return torch.from_numpy(np.ascontiguousarray(mat, dtype=np.uint32).view(np.int32)).to(device)


def _eval_match(match, tables, index_arrays, devices=None) -> np.ndarray:
    """Evaluate ``match(*tables, *index_vectors)`` over the candidate axis.

    ``devices`` (default: the first card, :func:`.backend.default_devices`;
    the CPU only where named) holds one device, or N for ``--mesh N``:
    the tables are copied to every device, the candidate axis is split into
    N contiguous shards in order (``torch.tensor_split``; no padding is
    needed), and the hits come back in candidate order. Returns a host bool
    array, one entry per candidate. ``EVALS`` counts each device's
    candidates under ``match``'s name without its ``match_`` prefix. The
    span ``call.<finder>.match`` holds the copies, the ops and the read-back;
    the counter ``call.h2d_bytes`` the bytes handed to the devices.
    """
    devices = backend.default_devices(devices)
    finder = match.__name__.removeprefix("match_")
    with trace.span(f"call.{finder_label(finder)}.match"):
        index = [torch.from_numpy(np.asarray(v, dtype=np.int32)) for v in index_arrays]
        shards = zip(*(torch.tensor_split(v, len(devices)) for v in index))
        table_bytes = sum(t.nbytes for t in tables)
        hits = []
        for dev, shard in zip(devices, shards):
            if not shard[0].numel():
                continue  # fewer candidates than devices
            hits.append(match(*(_to_device(t, dev) for t in tables), *(v.to(dev) for v in shard)))
            EVALS[(finder, dev.type)] += shard[0].numel()
            trace.add("call.h2d_bytes", table_bytes + sum(4 * v.numel() for v in shard))
        # launched on every device first, read back after
        return np.concatenate([h.cpu().numpy() for h in hits]).astype(bool)


def _any(x: torch.Tensor) -> torch.Tensor:
    return x.ne(0).any(dim=1)


def match_annotated_es(T, E, Ef, jJ, j1, j2, j1_tail, j2_head, ef):
    inclusion = (T[j1] & T[j2]) & ~T[jJ]
    new_exons = (E[j1_tail] | E[j2_head]) & ~Ef[ef]
    return _any(inclusion) & _any(new_exons)


def match_annotated_ss(E, Ex, X, nn, ff, exi, xi):
    return _any((E[nn] & Ex[exi] & E[ff]) & ~X[xi])


def match_novel_es(T, j1, j2):
    return _any(T[j1] & T[j2])


def match_annotated_ir(E, EJ, n1s, n2s, rows):
    return _any(E[n1s] & E[n2s] & EJ[rows])


def match_novel_ss_exonic(E, S, C, nn, rr):
    return _any(E[nn] & S[rr] & C[rr])


def match_novel_ce(a, b):
    return a <= b


_NONE = ([], (), [])  # a host half with no candidates


def _annotated_es_candidates(graph: SplicingGraph, t2g: Dict[str, str], rca: int):
    """Host half of :func:`find_annotated_es` (candidates, tables, indices)."""
    junctions = sorted(graph.junctions)  # deterministic candidate order
    if not junctions:
        return _NONE

    # --- per-gene block vocabularies (see _BlockVocab) -------------------
    tv = _BlockVocab()  # transcripts
    ev = _BlockVocab()  # exon labels

    # gene resolution ONLY for junctions the host caller would touch —
    # rc-passing primaries and their endpoint neighbors. The host checks
    # rc BEFORE consulting t2g (caller.py:514), so a below-threshold
    # junction with a transcript missing from the GTF must not raise
    # here when the host would simply skip it.
    passing = [j for j in junctions if graph.rc(j) >= rca]
    touched_ends = {e for j in passing for e in j}
    j_gene: Dict[Jct, object] = {}
    for j in junctions:
        if not (j[0] in touched_ends or j[1] in touched_ends):
            j_gene[j] = None
            continue
        genes = _genes_of_hts(graph.jn_keys(j), t2g)
        j_gene[j] = next(iter(genes)) if len(genes) == 1 else None

    # T rows keyed (gene, junction); E rows keyed (gene, node)
    t_rows: List[Set[int]] = []
    t_row_of: Dict[Tuple[object, Jct], int] = {}
    e_rows: List[Set[int]] = []
    e_row_of: Dict[Tuple[object, str], int] = {}

    def t_row(gene, tmap, j: Jct) -> int:
        key = (gene, j)
        r = t_row_of.get(key)
        if r is None:
            r = len(t_rows)
            t_rows.append(tv.ids(tmap, graph.jn_keys(j)))
            t_row_of[key] = r
        return r

    def e_row(gene, emap, n: str) -> int:
        key = (gene, n)
        r = e_row_of.get(key)
        if r is None:
            r = len(e_rows)
            e_rows.append(ev.ids(emap, graph.exset(n)))
            e_row_of[key] = r
        return r

    # --- host-side candidate enumeration (cheap endpoint grouping) ------
    cands: List[Tuple[Jct, Jct, Jct]] = []
    idx = {k: [] for k in ("jJ", "j1", "j2", "j1_tail", "j2_head", "ef")}
    filt_sets: List[Set[int]] = []  # per-candidate gene-filtered (Ef row)
    filt_row: Dict[Jct, int] = {}
    for J in junctions:
        gene = j_gene[J]
        if gene is None or graph.rc(J) < rca:
            continue
        Js1 = graph.j_by_head.get(J[0], graph._empty_j) - {J}
        Js2 = graph.j_by_tail.get(J[1], graph._empty_j) - {J}
        Js1 = {x for x in Js1 if gene in graph.jn_genes(x, t2g)}
        Js2 = {x for x in Js2 if gene in graph.jn_genes(x, t2g)}
        if not Js1 or not Js2:
            continue
        tmap = tv.block(gene)
        emap = ev.block(gene)
        if J not in filt_row:
            filt_row[J] = len(filt_sets)
            filt_sets.append(
                ev.ids(
                    emap,
                    (
                        e
                        for n in J
                        for e in graph.exset(n)
                        if t2g[_exon_label_th(e)[0]] == gene
                    ),
                )
            )
        rJ = t_row(gene, tmap, J)
        for j1 in sorted(Js1):
            r1 = t_row(gene, tmap, j1)
            e1 = e_row(gene, emap, j1[1])
            for j2 in sorted(Js2):
                cands.append((J, j1, j2))
                idx["jJ"].append(rJ)
                idx["j1"].append(r1)
                idx["j2"].append(t_row(gene, tmap, j2))
                idx["j1_tail"].append(e1)
                idx["j2_head"].append(e_row(gene, emap, j2[0]))
                idx["ef"].append(filt_row[J])
    if not cands:
        return _NONE

    T = _bitset_matrix(t_rows, tv.width)
    E = _bitset_matrix(e_rows, ev.width)
    Ef = _bitset_matrix(filt_sets, ev.width)
    return cands, (T, E, Ef), [idx["jJ"], idx["j1"], idx["j2"], idx["j1_tail"],
                               idx["j2_head"], idx["ef"]]


def find_annotated_es(
    graph: SplicingGraph,
    t2g: Dict[str, str],
    rca: int = -1,
    devices=None,
) -> Set[Tuple[Jct, Jct, Jct]]:
    """All (J, j1, j2) annotated-ES triples, evaluated on ``devices``."""
    devices = backend.default_devices(devices)
    with trace.span("call.es.candidates"):
        cands, tables, index = _annotated_es_candidates(graph, t2g, rca)
    if not cands:
        return set()
    hits = _eval_match(match_annotated_es, tables, index, devices)
    return {c for c, hit in zip(cands, hits) if hit}


def _annotated_ss_candidates(graph, t2g, genestrand, rca):
    """Host half of :func:`find_annotated_ss` (keys, tables, indices)."""
    junctions = sorted(graph.junctions)
    if not junctions:
        return _NONE

    ev = _BlockVocab()  # per-gene exon-label ids (the Ex AND confines every
    # candidate's algebra to its own gene's labels, so blocking is exact)

    # E rows keyed (gene, node); Ex rows keyed (gene, J, side); X rows per
    # (gene, J) — X depends on the block's FINAL vocab, so only keys are
    # recorded during enumeration and the rows fill after the freeze.
    e_rows: List[Set[int]] = []
    e_row_of: Dict[Tuple[object, str], int] = {}
    ex_rows: List[Set[int]] = []
    x_keys: List[Tuple[object, Jct]] = []
    x_row_of: Dict[Tuple[object, Jct], int] = {}

    def e_row(gene, emap, n: str) -> int:
        key = (gene, n)
        r = e_row_of.get(key)
        if r is None:
            r = len(e_rows)
            e_rows.append(ev.ids(emap, graph.exset(n)))
            e_row_of[key] = r
        return r

    # candidate enumeration (cheap host adjacency/endpoint grouping)
    keys: List[Tuple[str, Jct, Jct]] = []
    idx_n: List[int] = []
    idx_f: List[int] = []
    idx_ex: List[int] = []
    idx_x: List[int] = []
    for J in junctions:
        # rc BEFORE gene resolution (host order, caller.py:514): a
        # below-threshold junction whose transcript is missing from the
        # GTF is skipped, not a KeyError
        if graph.rc(J) < rca:
            continue
        hts = graph.jn_keys(J)
        genes = _genes_of_hts(hts, t2g)
        gene = next(iter(genes)) if len(genes) == 1 else None
        if gene is None:
            continue
        Js1 = graph.j_by_head.get(J[0], graph._empty_j) - {J}
        Js2 = graph.j_by_tail.get(J[1], graph._empty_j) - {J}
        Js1 = {x for x in Js1 if gene in graph.jn_genes(x, t2g)}
        Js2 = {x for x in Js2 if gene in graph.jn_genes(x, t2g)}
        strand = genestrand[gene]
        emap = ev.block(gene)

        xkey = (gene, J)
        xr = x_row_of.get(xkey)
        if xr is None:
            xr = len(x_keys)
            x_keys.append(xkey)
            x_row_of[xkey] = xr

        ex1 = ex2 = None
        if Js2:
            ex1 = len(ex_rows)
            ex_rows.append(
                ev.ids(
                    emap,
                    (e for e in graph.exset(J[0])
                     if t2g[_exon_label_th(e)[0]] == gene),
                )
            )
            etype = "A5" if strand == "+" else "A3"
            for n in graph.out(J[0]):
                if n == J[1]:
                    continue
                rn = e_row(gene, emap, n)
                for j2 in sorted(Js2):
                    if j2[0] == J[0]:
                        continue
                    keys.append((etype, J, j2))
                    idx_n.append(rn)
                    idx_f.append(e_row(gene, emap, j2[0]))
                    idx_ex.append(ex1)
                    idx_x.append(xr)
        if Js1:
            ex2 = len(ex_rows)
            ex_rows.append(
                ev.ids(
                    emap,
                    (e for e in graph.exset(J[1])
                     if t2g[_exon_label_th(e)[0]] == gene),
                )
            )
            etype = "A3" if strand == "+" else "A5"
            for n in graph.inc(J[1]):
                if n == J[0]:
                    continue
                rn = e_row(gene, emap, n)
                for j1 in sorted(Js1):
                    if j1[1] == J[1]:
                        continue
                    keys.append((etype, J, j1))
                    idx_n.append(rn)
                    idx_f.append(e_row(gene, emap, j1[1]))
                    idx_ex.append(ex2)
                    idx_x.append(xr)
    if not keys:
        return _NONE

    # X[(g, J)]: label ids (in g's frozen vocab) whose transcript is on J
    t2e_of_block: Dict[object, Dict[str, Set[int]]] = {}
    x_rows: List[Set[int]] = []
    for gene, J in x_keys:
        t2e = t2e_of_block.get(gene)
        if t2e is None:
            t2e = {}
            for e, i in ev.block(gene).items():
                t2e.setdefault(_exon_label_th(e)[0], set()).add(i)
            t2e_of_block[gene] = t2e
        s: Set[int] = set()
        for t in graph.jn_keys(J):
            s |= t2e.get(t, set())
        x_rows.append(s)

    vocab = ev.width
    E = _bitset_matrix(e_rows, vocab)
    Ex = _bitset_matrix(ex_rows, vocab)
    X = _bitset_matrix(x_rows, vocab)
    return keys, (E, Ex, X), [idx_n, idx_f, idx_ex, idx_x]


def find_annotated_ss(
    graph: SplicingGraph,
    t2g: Dict[str, str],
    genestrand: Dict[str, str],
    rca: int = -1,
    devices=None,
) -> Counter:
    """Annotated A5/A3 hits: a ``Counter`` keyed by ``(etype, J, j_other)``
    whose counts are the host caller's row multiplicities (one row per
    exon-continuation neighbor ``n`` that fires the pattern)."""
    devices = backend.default_devices(devices)
    with trace.span("call.ss.candidates"):
        keys, tables, index = _annotated_ss_candidates(graph, t2g, genestrand, rca)
    if not keys:
        return Counter()
    hits = _eval_match(match_annotated_ss, tables, index, devices)
    return Counter(k for k, h in zip(keys, hits) if h)


def _novel_es_candidates(graph, t2g, rca):
    """Host half of :func:`find_novel_es` (candidates, tables, indices)."""
    if not graph.junctions or not graph.novel_junctions:
        return _NONE

    cands: List[Tuple[Jct, Jct, Jct]] = []
    for J in sorted(graph.novel_junctions):
        if graph.rc(J) < rca:
            continue
        ex0 = graph.exset(J[0])
        ex1 = graph.exset(J[1])
        if not ex0 and not ex1:
            continue
        if not (ex0 and ex1 and len(ex0 & ex1) != len(ex0)):
            continue
        nodes1 = [n for n in graph.out(J[0]) if (J[0], n) in graph.junctions]
        nodes2 = [q for q in graph.inc(J[1]) if (q, J[1]) in graph.junctions]
        for n in nodes1:
            for q in nodes2:
                cands.append((J, (J[0], n), (q, J[1])))
    if not cands:
        return _NONE

    # T rows only for junctions a candidate references (novel neighborhoods
    # are local — building rows for every junction in the graph was the
    # genome-scale memory hog)
    t_vocab: Dict[str, int] = {}

    def t_id(t: str) -> int:
        return t_vocab.setdefault(t, len(t_vocab))

    used = sorted({c[1] for c in cands} | {c[2] for c in cands})
    j_index = {j: i for i, j in enumerate(used)}
    j_tsets: List[Set[int]] = [
        {t_id(t) for t in graph.jn_keys(j)} for j in used
    ]

    T = _bitset_matrix(j_tsets, len(t_vocab))
    j1 = np.asarray([j_index[c[1]] for c in cands], dtype=np.int32)
    j2 = np.asarray([j_index[c[2]] for c in cands], dtype=np.int32)
    return cands, (T,), [j1, j2]


def find_novel_es(
    graph: SplicingGraph,
    t2g: Dict[str, str],
    rca: int = -1,
    devices=None,
) -> Set[Tuple[Jct, Jct, Jct]]:
    """Novel-ES (J, j1, j2) triples: the flanks j1 = (J.head, n) and
    j2 = (q, J.tail) share a transcript."""
    devices = backend.default_devices(devices)
    with trace.span("call.novel_es.candidates"):
        cands, tables, index = _novel_es_candidates(graph, t2g, rca)
    if not cands:
        return set()
    hits = _eval_match(match_novel_es, tables, index, devices)
    return {c for c, h in zip(cands, hits) if h}


def _annotated_ir_candidates(graph, t2g, rca):
    """Host half of :func:`find_annotated_ir` (candidates, tables, indices)."""
    ev = _BlockVocab()  # per-gene label ids (exact: the AND is confined to
    # EJ, a gene-filtered set, so cross-block collisions never meet)

    cands: List[Tuple[Jct, str, str]] = []  # product order within each J
    cand_row: List[int] = []
    cand_node_idx: List[Tuple[int, int]] = []
    ej_sets: List[Set[int]] = []
    node_keys: List[Tuple[object, str]] = []  # (gene, node) per E row
    node_row_of: Dict[Tuple[object, str], int] = {}

    def n_row(gene, n: str) -> int:
        key = (gene, n)
        r = node_row_of.get(key)
        if r is None:
            r = len(node_keys)
            node_keys.append(key)
            node_row_of[key] = r
        return r

    for J in sorted(graph.junctions):
        if graph.rc(J) < rca:
            continue
        genes = graph.jn_genes(J, t2g)  # same KeyError semantics as host
        if len(genes) > 1:
            continue
        exons = _same_gene_exons_cached(
            graph, J[0], genes, t2g
        ) & _same_gene_exons_cached(graph, J[1], genes, t2g)
        if not exons:
            continue
        gene = next(iter(genes))
        emap = ev.block(gene)
        row = len(ej_sets)
        ej_sets.append(ev.ids(emap, exons))
        for n1, n2 in product(graph.out(J[0]), graph.inc(J[1])):
            if n1 == J[1] or n2 == J[0]:
                continue
            if n2 < n1:  # QUIRK parity: lexicographic on string ids
                continue
            cands.append((J, n1, n2))
            cand_row.append(row)
            cand_node_idx.append((n_row(gene, n1), n_row(gene, n2)))
    if not cands:
        return _NONE

    # node exon bitsets restricted to each block's (frozen) junction-exon
    # vocab — a label outside every EJ row can never fire the AND
    node_rows: List[Set[int]] = []
    for gene, n in node_keys:
        emap = ev.block(gene)
        node_rows.append({emap[e] for e in graph.exset(n) if e in emap})
    E = _bitset_matrix(node_rows, ev.width)
    EJ = _bitset_matrix(ej_sets, ev.width)
    n1s = np.asarray([a for a, _ in cand_node_idx], dtype=np.int32)
    n2s = np.asarray([b for _, b in cand_node_idx], dtype=np.int32)
    rows = np.asarray(cand_row, dtype=np.int32)
    return cands, (E, EJ), [n1s, n2s, rows]


def find_annotated_ir(
    graph: SplicingGraph,
    t2g: Dict[str, str],
    rca: int = -1,
    devices=None,
) -> Dict[Jct, Tuple[str, str]]:
    """Annotated-IR pair per junction: the FIRST ``(n1, n2)`` of
    ``product(out(J.head), inc(J.tail))`` whose exons meet the junction's
    common gene-filtered exons, as the host caller's loop breaks on it."""
    devices = backend.default_devices(devices)
    with trace.span("call.ir.candidates"):
        cands, tables, index = _annotated_ir_candidates(graph, t2g, rca)
    if not cands:
        return {}
    hits = _eval_match(match_annotated_ir, tables, index, devices)
    out: Dict[Jct, Tuple[str, str]] = {}
    for (J, n1, n2), h in zip(cands, hits):
        if h and J not in out:  # first hit in product order wins (host break)
            out[J] = (n1, n2)
    return out


def _novel_ss_exonic_candidates(graph, t2g, opts: CallOptions):
    """Host half of :func:`find_novel_ss_exonic` (candidates, tables,
    indices). It walks ``g.novel_junctions`` in the set's own order: the
    reference's leaked loop variable ``p`` follows that order."""
    g = graph
    e_vocab: Dict[str, int] = {}

    def e_id(e: str) -> int:
        return e_vocab.setdefault(e, len(e_vocab))

    cands: List[Tuple[Jct, int, str]] = []
    cand_row: List[int] = []
    rows_spliced: List[Set[int]] = []
    rows_cap: List[Set[str]] = []  # transcript keys; expanded after vocab
    cand_nodes: Set[str] = set()

    def add_row(spliced: Set[str], cap: Set[str]) -> int:
        rows_spliced.append({e_id(e) for e in spliced})
        rows_cap.append(cap)
        return len(rows_spliced) - 1

    p: Optional[str] = None  # QUIRK: leaked loop variable trajectory
    for _j in g.novel_junctions:
        if opts.junction is not None and f"{_j[0]}-{_j[1]}" != opts.junction:
            continue
        if g.rc(_j) < opts.rca:
            continue
        _exons0 = g.exset(_j[0])
        _exons1 = g.exset(_j[1])
        if len(_exons0) == 0 and len(_exons1) == 0:
            continue
        cap = tkeys_of_exons(_exons0) & tkeys_of_exons(_exons1)
        if not cap:
            continue  # p is only ever assigned inside the cap-gated blocks
        _next0 = g.out(_j[0])
        _prev1 = g.inc(_j[1])

        # block 1 — spliced into J.tail's exon body
        spliced: Set[str] = set()
        if _j[0] in g.inc(_j[1]):
            spliced = _exons1
        elif _prev1:
            p = _prev1[-1]  # host loop keeps only the last iteration
            spliced = g.exset(p) & _exons1
        if spliced:
            row = add_row(spliced, cap)
            for n in _next0:
                if (_j[0], n) in g.junctions:
                    cands.append((_j, 1, n))
                    cand_row.append(row)
                    cand_nodes.add(n)

        # block 2 — mirror on the head side (uses the leaked p)
        spliced2: Set[str] = set()
        if _j[1] in g.out(_j[0]):
            spliced2 = _exons0
        elif _next0:
            spliced2 = g.exset(p) & _exons0
        if spliced2:
            row = add_row(spliced2, cap)
            for q in _prev1:
                if (q, _j[1]) in g.junctions:
                    cands.append((_j, 2, q))
                    cand_row.append(row)
                    cand_nodes.add(q)
            if _prev1:
                p = _prev1[-1]  # host's annotated_js loop reassigns p
    if not cands:
        return _NONE

    # cap expansion over the frozen vocab: a label can only fire if it is
    # in some spliced row, so vocab-restricted node/cap rows are exact
    t2e: Dict[str, Set[int]] = {}
    for e, i in e_vocab.items():
        t2e.setdefault(_exon_label_th(e)[0], set()).add(i)
    cap_rows = [
        set().union(*(t2e.get(t, set()) for t in cap)) if cap else set()
        for cap in rows_cap
    ]
    n_index = {n: i for i, n in enumerate(sorted(cand_nodes))}
    node_rows: List[Set[int]] = [set() for _ in n_index]
    for n, i in n_index.items():
        node_rows[i] = {e_vocab[e] for e in g.exset(n) if e in e_vocab}

    vocab = len(e_vocab)
    E = _bitset_matrix(node_rows, vocab)
    S = _bitset_matrix(rows_spliced, vocab)
    C = _bitset_matrix(cap_rows, vocab)
    nn = np.asarray([n_index[c[2]] for c in cands], dtype=np.int32)
    rr = np.asarray(cand_row, dtype=np.int32)
    return cands, (E, S, C), [nn, rr]


def find_novel_ss_exonic(
    graph: SplicingGraph,
    t2g: Dict[str, str],
    opts: CallOptions,
    devices=None,
) -> Set[Tuple[Jct, int, str]]:
    """Novel exonic A3/A5 hit keys ``(J, block, node)``: per candidate,
    ``exset(node) & spliced_exons[J, block] & labels(cap[J])`` is not empty."""
    devices = backend.default_devices(devices)
    with trace.span("call.novel_ss_exonic.candidates"):
        cands, tables, index = _novel_ss_exonic_candidates(graph, t2g, opts)
    if not cands:
        return set()
    hits = _eval_match(match_novel_ss_exonic, tables, index, devices)
    return {c for c, h in zip(cands, hits) if h}


def _novel_ce_candidates(graph, opts: CallOptions):
    """Host half of :func:`find_novel_ce` (candidates, no tables, ranks)."""
    cands: List[Tuple[Jct, str, str]] = []
    for J in sorted(graph.junctions):
        if opts.junction is not None and f"{J[0]}-{J[1]}" != opts.junction:
            continue
        if graph.rc(J) < opts.rca:
            continue
        Js1 = graph.nj_by_head.get(J[0], graph._empty_j) - {J}
        Js2 = graph.nj_by_tail.get(J[1], graph._empty_j) - {J}
        if Js1 and Js2:
            for j1 in sorted(Js1):
                for j2 in sorted(Js2):
                    cands.append((J, j1[1], j2[0]))
    if not cands:
        return _NONE

    rank = {
        s: i for i, s in enumerate(sorted({x for c in cands for x in c[1:]}))
    }
    a = np.asarray([rank[c[1]] for c in cands], dtype=np.int32)
    b = np.asarray([rank[c[2]] for c in cands], dtype=np.int32)
    return cands, (), [a, b]


def find_novel_ce(
    graph: SplicingGraph,
    opts: CallOptions,
    devices=None,
) -> Dict[Jct, Set[Tuple[str, str]]]:
    """Novel-CE ``(exon_start, exon_end)`` pairs per annotated junction: the
    product pairs with ``j1.tail <= j2.head`` (lexicographic), as a rank
    compare over the sorted node ids."""
    devices = backend.default_devices(devices)
    with trace.span("call.novel_ce.candidates"):
        cands, tables, index = _novel_ce_candidates(graph, opts)
    if not cands:
        return {}
    hits = _eval_match(match_novel_ce, tables, index, devices)
    out: Dict[Jct, Set[Tuple[str, str]]] = {}
    for (J, es, ee), h in zip(cands, hits):
        if h:
            out.setdefault(J, set()).add((es, ee))
    return out


def _novel_es_rows(graph, t2g, genestrand, genechr, opts, log, devices) -> list:
    """The novel-ES rows of :func:`find_novel_es`'s hits, as the host
    caller writes them."""
    # the novel-junction --junction filter WORKS in the reference
    # (unlike the annotated pass's broken literal) — apply it here
    hits = find_novel_es(graph, t2g, rca=opts.rca, devices=devices)
    if opts.junction is not None:
        hits = {c for c in hits if f"{c[0][0]}-{c[0][1]}" == opts.junction}
    rows = []
    for J, j1, j2 in sorted(hits):
        inclusion = graph.jn_keys(j1) & graph.jn_keys(j2)
        _genes = set(t2g[t] for t in inclusion)
        if len(_genes) > 1:
            print("Skipping ES due to multiple genes", file=log)
            continue
        gene = next(iter(_genes))
        rows.append(_row(
            "ES",
            "novel",
            genechr[gene],
            gene,
            genestrand[gene],
            "?",
            "|".join(x for x in graph.link[j1].jn if transcript_of_label(x) in inclusion),
            "|".join(x for x in graph.link[j2].jn if transcript_of_label(x) in inclusion),
            ">".join(J),
            graph.rc(J),
            ">".join(j1),
            graph.rc(j1),
            ">".join(j2),
            graph.rc(j2),
        ))
    return rows


def call_events_device(
    gfa_path: str,
    gtf_path: str,
    opts: CallOptions,
    log=None,
    graph: Optional[SplicingGraph] = None,
    devices: Optional[Sequence] = None,
):
    """Device-batched call engine on ``devices`` (one, or N for ``--mesh``;
    the first card when None, :func:`.backend.default_devices`, resolved
    before any file is read).

    The six finders above evaluate on the devices; the remaining irregular
    pieces (intron subpath walks, intronic-SS frontier search, novel IR)
    stay on the reference-exact host enumerator, consuming the device hit
    oracles. Emits the host caller's row MULTISET; row order may differ.

    Each part of the work (the loads, then each finder with its rows) runs
    inside a root span ``stage.call`` of its own, and lists its rows before
    they are yielded, so a span ends where its work ends and not where the
    consumer resumes; the counters ``call.rows.<event type>`` count the rows.
    The novel pass is one part: ``call.novel_es`` (its finder and rows),
    ``call.novel_ss`` and ``call.novel_ce`` (their finders), then
    ``call.novel_walk``, the host enumerator, whose loops over the novel and
    the annotated junctions are its children
    ``call.novel_walk.novel_junctions`` and
    ``call.novel_walk.annotated_junctions``; the counter
    ``call.novel_junctions`` counts the graph's novel links.
    Once the last part has ended, ``call.graph.segments`` and
    ``call.graph.links`` count the graph's file records, and
    ``call.graph.seg_built`` and ``call.graph.link_built`` the records built
    from them (:func:`.caller.record_counts`).

    The cyclic GC is off until the call has ended, as in the host caller
    (:func:`.caller.call_events`): nothing here makes reference cycles, and
    the records the graph builds on first lookup would otherwise put a full
    collection of the process inside a finder.
    """
    gc_was = gc.isenabled()
    gc.disable()
    try:
        yield from _call_events_device(gfa_path, gtf_path, opts, log, graph, devices)
    finally:
        if gc_was:
            gc.enable()


def _call_events_device(gfa_path, gtf_path, opts, log, graph, devices):
    import sys
    from dataclasses import replace

    from pantas_tpu_torch.events.caller import (
        CSV_HEADER,
        _annotated_junction_rows,
        _call_annotated,
        _novel_junction_rows,
        record_counts,
    )
    from pantas_tpu_torch.io.gtf import parse_transcript_maps

    devices = backend.default_devices(devices)
    log = sys.stderr if log is None else log
    with trace.span("stage.call"):
        if graph is None:
            with trace.span("call.graph_load"):
                graph = SplicingGraph.from_gfa(gfa_path)
        with trace.span("call.gtf"):
            t2g, genestrand, genechr = parse_transcript_maps(gtf_path)
    yield CSV_HEADER

    # QUIRK parity: the reference's --junction filter compares a broken
    # f-string LITERAL (call.py:241), so any value except that literal
    # filters out every annotated junction — mirror the host caller.
    annotated_filtered = (
        opts.junction is not None and opts.junction != "f{_j[0]}-{_j[1]}"
    )
    if not opts.no_annotated and not annotated_filtered:
        if "ES" in opts.events:
            with trace.span("stage.call"), trace.span("call.es"):
                hits = sorted(find_annotated_es(graph, t2g, rca=opts.rca, devices=devices))
                rows = []
                with trace.span("call.rows"):
                    for J, j1, j2 in hits:
                        _ht = graph.jn_keys(J)
                        inclusion = (
                            set(graph.jn_keys(j1)) & set(graph.jn_keys(j2))
                        ) - set(_ht)
                        gene = next(iter(_genes_of_hts(_ht, t2g)))
                        rows.append(_row(
                            "ES",
                            "annotated",
                            genechr[gene],
                            gene,
                            genestrand[gene],
                            "|".join(graph.link[J].jn),
                            "|".join(
                                x for x in graph.link[j1].jn
                                if transcript_of_label(x) in inclusion
                            ),
                            "|".join(
                                x for x in graph.link[j2].jn
                                if transcript_of_label(x) in inclusion
                            ),
                            ">".join(J),
                            graph.rc(J),
                            ">".join(j1),
                            graph.rc(j1),
                            ">".join(j2),
                            graph.rc(j2),
                        ))
            yield from _counted(rows)
        if "SS" in opts.events:
            with trace.span("stage.call"), trace.span("call.ss"):
                hits = find_annotated_ss(graph, t2g, genestrand, rca=opts.rca, devices=devices)
                rows = []
                with trace.span("call.rows"):
                    for (etype, J, jo), count in sorted(hits.items()):
                        gene = next(iter(_genes_of_hts(graph.jn_keys(J), t2g)))
                        row = _row(
                            etype,
                            "annotated",
                            genechr[gene],
                            gene,
                            genestrand[gene],
                            "|".join(graph.link[J].jn),
                            "|".join(graph.link[jo].jn),
                            ".",
                            ">".join(J),
                            graph.rc(J),
                            ">".join(jo),
                            graph.rc(jo),
                            ".",
                            ".",
                        )
                        rows += [row] * count
            yield from _counted(rows)
        if "IR" in opts.events:
            with trace.span("stage.call"), trace.span("call.ir"):
                ir_oracle = find_annotated_ir(graph, t2g, rca=opts.rca, devices=devices)
                with trace.span("call.rows"):
                    rows = list(_call_annotated(
                        graph, t2g, genestrand, genechr, replace(opts, events=["IR"]), log,
                        ir_oracle=ir_oracle,
                    ))
            yield from _counted(rows)
    if opts.novel:
        with trace.span("stage.call"):
            trace.add("call.novel_junctions", len(graph.novel_junctions))
            rows = []
            if "ES" in opts.events:
                with trace.span("call.novel_es"):
                    rows += _novel_es_rows(graph, t2g, genestrand, genechr, opts, log, devices)
            ss_oracle = ce_oracle = None
            if "SS" in opts.events:
                with trace.span("call.novel_ss"):
                    ss_oracle = find_novel_ss_exonic(graph, t2g, opts, devices=devices)
            if "ES" in opts.events:
                with trace.span("call.novel_ce"):
                    ce_oracle = find_novel_ce(graph, opts, devices=devices)
            with trace.span("call.novel_walk"):
                with trace.span("call.novel_walk.novel_junctions"):
                    rows += _novel_junction_rows(
                        graph, t2g, genestrand, genechr, opts, log,
                        emit_novel_es="ES" not in opts.events,
                        ss_oracle=ss_oracle,
                    )
                if "IR" in opts.events or "ES" in opts.events:
                    with trace.span("call.novel_walk.annotated_junctions"):
                        rows += _annotated_junction_rows(
                            graph, t2g, genestrand, genechr, opts, log, ce_oracle=ce_oracle
                        )
        yield from _counted(rows)
    for name, n in record_counts(graph).items():
        trace.add(f"call.graph.{name}", n)


def _counted(rows: list) -> list:
    """``rows``, counted by event type into ``call.rows.<type>`` while
    tracing is on."""
    if trace.enabled():
        for etype, n in Counter(r.split(",", 1)[0] for r in rows).items():
            trace.add(f"call.rows.{etype}", n)
    return rows


def host_ss_rows(gfa_path: str, gtf_path: str, rca: int = -1):
    """Reference-exact host caller's annotated A5/A3 hit multiset."""
    from collections import Counter

    from pantas_tpu_torch.events.caller import call_events

    opts = CallOptions(rca=rca, events=["SS"])
    out = Counter()
    for row in call_events(gfa_path, gtf_path, opts):
        cols = row.split(",")
        if cols[0] not in ("A5", "A3") or cols[1] != "annotated":
            continue
        j = tuple(cols[8].split(">"))
        jo = tuple(cols[10].split(">"))
        out[(cols[0], j, jo)] += 1
    return out


def host_es_triples(
    gfa_path: str, gtf_path: str, rca: int = -1
) -> Set[Tuple[Jct, Jct, Jct]]:
    """Reference-exact host caller's annotated-ES triples (for validation)."""
    from pantas_tpu_torch.events.caller import call_events

    triples = set()
    opts = CallOptions(rca=rca, events=["ES"])
    for row in call_events(gfa_path, gtf_path, opts):
        cols = row.split(",")
        if cols[0] != "ES" or cols[1] != "annotated":
            continue
        j = tuple(cols[8].split(">"))
        j1 = tuple(cols[10].split(">"))
        j2 = tuple(cols[12].split(">"))
        triples.add((j, j1, j2))
    return triples
