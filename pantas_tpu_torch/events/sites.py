"""Intra-node novel splice-site detection from alignment clip boundaries.

A splice site that falls strictly *inside* a graph node is structurally
invisible to the whole reference pipeline: no edge can exist there, so the
caller (reference ``scripts/call.py``) can never emit it, and the augment
stage's IL/OL offset histograms — the one channel that could carry the
signal — deliberately skip the first node's entry offset and the last
node's exit offset (the ``i != 0`` / ``i != len-1`` guards at
``scripts/alignments_augmentation_from_gaf.py:281,289,299,306``), so only
pass-through (always-boundary) and deletion offsets are ever recorded.
``docs/SIM_ACCURACY.md`` measures the consequence: simulated A3/A5/CE
events whose variant site is mid-node have recall 0 for the reference
design and for our compat path alike.

The evidence is nevertheless present in the GAF: a read spanning an
unannotated splice site aligns one arm and *soft-clips* the other, so its
alignment starts (acceptor side) or ends (donor side) at the same
node-interior offset for every read that crosses the site, with unaligned
query sequence left over. This module streams the GAF once (same
mapq/dv/path filters as augmentation) and accumulates clip-boundary
pile-ups:

* ``start`` site — alignments whose first aligned base sits at a
  node-interior offset with >= ``min_clip`` query bases clipped before it
  (the unaligned arm continues genomically left: acceptor-like).
* ``end`` site — alignments whose last aligned base sits at a
  node-interior offset with >= ``min_clip`` query bases clipped after it
  (donor-like).

Sites with pile-up count >= ``w`` are reported with genomic coordinates
recovered from the reference path(s) (the chromosome-named P lines), the
node's exon labels, and its NC coverage for context. This is an opt-in
EXTENSION subcommand (``novel-sites``): it adds no tags and changes no
byte-compatible artifact, so all differential guarantees are untouched.
"""

from __future__ import annotations

import sys
from bisect import bisect_right
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, TextIO, Tuple

from pantas_tpu_torch.coverage.semantics import DEFAULT_MAPQ_THR, DEFAULT_MAX_DIVERGENCE
from pantas_tpu_torch.io.gaf import parse_gaf_line

HEADER = "chrom,pos,side,node,offset,count,clip_max,nc,exons"


@dataclass
class NodeMeta:
    length: int
    gchrom: Optional[str] = None  # reference-path chromosome, if on one
    gstart: int = 0  # 1-based genomic coord of forward base 0
    nc: int = 0
    exons: str = "."


def _is_reference_path(name: str) -> bool:
    """Reference(-derived) P lines are the ones not named after a transcript.

    Our build layer and the reference's annotate.cpp both name transcript
    paths ``<transcript>_R<i>`` / ``<transcript>_H<i>`` (haplotype-aware
    copies); reference chromosome paths keep the FASTA sequence name
    (``4``, ``chrX``) and reduce-mode sub-paths get ``<chrom>.N``
    (reference ``build/reduce.py:40-44``).
    """
    tail = name.rsplit("_", 1)[-1]
    if tail != name and tail[:1] in ("R", "H") and tail[1:].isdigit():
        return False
    return True


def _is_subpath(name: str) -> bool:
    """Reduce-mode sub-paths are named ``<chrom>.N`` (reference
    ``build/reduce.py:40-44``); their coordinates restart at 1 per
    sub-path, so they are only sub-path-local."""
    head, _, tail = name.rpartition(".")
    return bool(head) and tail.isdigit()


def load_graph_meta(gfa_path: str) -> Dict[str, NodeMeta]:
    """One pass over the (annotated, optionally augmented) GFA.

    Genomic coordinates come from reference-named P lines. Exact
    chromosome paths are preferred over reduce-mode ``<chrom>.N``
    sub-paths (whose positions are sub-path-local — they restart at 1
    per sub-path); reverse-oriented steps are skipped rather than mapped
    to wrong coordinates (the walk position still advances)."""
    from pantas_tpu_torch.io.xopen import xopen

    meta: Dict[str, NodeMeta] = {}
    ref_paths: List[Tuple[str, List[str]]] = []
    with xopen(gfa_path) as fh:
        for line in fh:
            c = line[0]
            if c == "S":
                f = line.rstrip("\n").split("\t")
                m = NodeMeta(length=len(f[2]))
                for tag in f[3:]:
                    if tag.startswith("EX:Z:"):
                        m.exons = tag[5:]
                    elif tag.startswith("NC:i:"):
                        m.nc = int(tag[5:])
                    elif tag.startswith("LN:i:") and f[2] == "*":
                        m.length = int(tag[5:])
                meta[f[1]] = m
            elif c == "P":
                f = line.rstrip("\n").split("\t")
                if _is_reference_path(f[1]):
                    ref_paths.append((f[1], f[2].split(",")))
    # exact chromosome paths claim nodes before '.N' sub-paths
    ref_paths.sort(key=lambda cn: _is_subpath(cn[0]))
    for chrom, steps in ref_paths:
        pos = 1
        for step in steps:
            n, orient = step[:-1], step[-1:]
            m = meta.get(n)
            if m is None:
                continue
            if m.gchrom is None and orient == "+":
                m.gchrom = chrom
                m.gstart = pos
            pos += m.length
    return meta


def _boundary_events(rec, meta: Dict[str, NodeMeta], min_clip: int):
    """Yield ('start'|'end', node, fwd_offset, clip_len) for one record.

    The first/last ALIGNED base can sit in an interior step of the walk:
    spliced joins emit walks whose terminal node has zero aligned span
    (the alignment ends exactly at a node boundary — e.g. an inclusion
    read of a novel cassette exon whose clipped arm made the aligner
    keep the skip-edge node with no covered bases). Locate the covered
    node by cumulative step lengths instead of assuming the terminal
    steps — discarding these records silenced the donor-side CE piles.
    """
    path = rec.path
    rev = path[0] == "<"
    steps = path.split("<" if rev else ">")[1:]
    if not steps:
        return
    lens = []
    for s in steps:
        m = meta.get(s)
        if m is None:
            return
        lens.append(m.length)
    # walk-local coords of the first/last aligned base. GAF col 9 in
    # this framework is the INCLUSIVE last aligned base (the mapper
    # writes pend_excl - 1 — verified empirically: a 33-base match from
    # offset 0 reports pend 32), so path_end IS we_abs; treating it as
    # exclusive shifted every donor-side site one base left.
    ws = rec.path_start
    we_abs = rec.path_end
    cum = [0]
    for ln in lens:
        cum.append(cum[-1] + ln)
    if not (0 <= ws <= we_abs < cum[-1]):
        return
    i = bisect_right(cum, ws) - 1
    j = bisect_right(cum, we_abs) - 1
    off_s = ws - cum[i]
    off_e = we_abs - cum[j]
    first, last = steps[i], steps[j]
    len_first, len_last = lens[i], lens[j]
    fs = (len_first - 1 - off_s) if rev else off_s
    fe = (len_last - 1 - off_e) if rev else off_e
    clip_head = rec.query_start
    clip_tail = rec.query_len - rec.query_end
    if not rev:
        if clip_head >= min_clip:
            yield ("start", first, fs, clip_head)
        if clip_tail >= min_clip:
            yield ("end", last, fe, clip_tail)
    else:
        # reverse walk: the query head clip hangs off the genomic RIGHT
        # boundary (walk start = rightmost node), and vice versa.
        if clip_head >= min_clip:
            yield ("end", first, fs, clip_head)
        if clip_tail >= min_clip:
            yield ("start", last, fe, clip_tail)


def _scan_python(gaf_path, meta, min_clip, mapq_thr, max_dv):
    from pantas_tpu_torch.io.xopen import xopen

    piles: Dict[Tuple[str, str, int], List[int]] = {}  # (side,node,off) -> [n, clipmax]
    with xopen(gaf_path) as fh:
        for line in fh:
            if not line.strip():
                continue
            rec = parse_gaf_line(line)
            if rec.mapq < mapq_thr or rec.path == "*":
                continue
            if rec.dv is not None and rec.dv > max_dv:
                continue
            for side, node, off, clip in _boundary_events(rec, meta, min_clip):
                cur = piles.setdefault((side, node, off), [0, 0])
                cur[0] += 1
                cur[1] = max(cur[1], clip)
    return piles


def _scan_native(gaf_path, meta, min_clip, mapq_thr, max_dv):
    """Native mmap scanner — requires canonical integer node ids (same
    convention as the native GFA loader); returns None to fall back."""
    import numpy as np

    try:
        from pantas_tpu_torch.native import clip_sites_native, native_available

        if not native_available():
            return None
        # the native scanner returns keys as str(int(id)): require canonical
        # ids so '007'-style names neither crash the meta lookup nor merge
        # silently with '7' (same guard as NativeCoverage / compile_gfa)
        if not all(n.isdigit() and str(int(n)) == n for n in meta):
            return None
        ids = np.fromiter((int(n) for n in meta), dtype=np.int64, count=len(meta))
    except (ValueError, ImportError):
        return None
    lens = np.fromiter((m.length for m in meta.values()), dtype=np.int32, count=len(meta))
    return clip_sites_native(
        gaf_path, ids, lens, mapq_thr=mapq_thr, max_dv=max_dv, min_clip=min_clip
    )


def detect_novel_sites(
    gaf_path: str,
    gfa_path: str,
    w: int = 3,
    min_clip: int = 5,
    mapq_thr: int = DEFAULT_MAPQ_THR,
    max_dv: float = DEFAULT_MAX_DIVERGENCE,
    include_boundary: bool = False,
    engine: str = "auto",
) -> List[str]:
    """Scan a GAF for clip-boundary pile-ups; return CSV rows (no header).

    ``include_boundary`` also reports sites at node boundaries (offset 0
    for ``start`` / len-1 for ``end``); those are expressible as graph
    edges and therefore already covered by the novel-link machinery
    (reference ``alignments_augmentation_from_gaf.py:426-427``), so they
    are off by default.

    ``engine``: ``auto`` uses the native mmap scanner (memory-speed; needs
    integer node ids) and falls back to the pure-Python oracle;
    ``host`` forces Python; ``native`` requires the native path.
    """
    meta = load_graph_meta(gfa_path)
    piles = _scan(gaf_path, meta, min_clip, mapq_thr, max_dv, engine)

    rows: List[str] = []
    for (side, node, off), (count, clipmax) in piles.items():
        if count < w:
            continue
        m = meta[node]
        if not include_boundary:
            if side == "start" and off == 0:
                continue
            if side == "end" and off == m.length - 1:
                continue
        if m.gchrom is not None:
            chrom, pos = m.gchrom, str(m.gstart + off)
        else:
            chrom, pos = "?", "?"
        rows.append(
            f"{chrom},{pos},{side},{node},{off},{count},{clipmax},{m.nc},{m.exons.replace(',', '|')}"
        )

    def key(r: str):
        f = r.split(",")
        return (f[0], int(f[1]) if f[1].isdigit() else -1, f[2], f[3], int(f[4]))

    rows.sort(key=key)
    return rows


def write_novel_sites(rows: Iterable[str], out: TextIO = sys.stdout) -> None:
    print(HEADER, file=out)
    for r in rows:
        print(r, file=out)


def _scan(gaf_path, meta, min_clip, mapq_thr, max_dv, engine="auto"):
    piles = None
    if engine in ("auto", "native"):
        piles = _scan_native(gaf_path, meta, min_clip, mapq_thr, max_dv)
        if piles is None and engine == "native":
            raise RuntimeError("native clip-site scanner unavailable")
    if piles is None:
        piles = _scan_python(gaf_path, meta, min_clip, mapq_thr, max_dv)
    return piles


EVENTS_HEADER = "event_type,annotated/novel,chrom,gene,strand,position,side,node,offset,coverage"


def classify_sites(rows: Iterable[str], gtf_path: str) -> List[str]:
    """Site rows -> alternative-splice-site EVENT rows (A3 / A5).

    A clip-boundary site is one terminus of an intron absent from the
    graph. Which terminus it is follows from the side and the gene's
    strand: alignments that *start* at the site (body extends genomically
    right) mark the right-hand intron terminus — the acceptor on a ``+``
    gene (A3: alternative 3' splice site) and the donor on a ``-`` gene
    (A5) — and symmetrically for *end* sites. Gene and strand come from
    the node's exon labels + GTF, exactly the caller's label algebra
    (reference ``call.py:90-129`` naming: transcript ``T_H`` splits on
    the last ``_``; exon label ``T.e``). Sites on exon-less nodes
    (intronic, e.g. inside a novel cassette exon's intron) cannot be
    oriented and are reported with etype ``NS`` (novel site), gene ``.``.
    """
    from pantas_tpu_torch.io.gtf import parse_transcript_maps

    t2g, genestrand, _ = parse_transcript_maps(gtf_path)
    out: List[str] = []
    for r in rows:
        chrom, pos, side, node, off, count, _clip, _nc, exons = r.split(",")
        gene = strand = None
        if exons != ".":
            for label in exons.split("|"):
                th = label.rsplit(".", 1)[0]
                t = th.rsplit("_", 1)[0]
                if t in t2g:
                    gene = t2g[t]
                    strand = genestrand.get(gene)
                    break
        if gene is None or strand not in ("+", "-"):
            out.append(f"NS,novel,{chrom},.,.,{pos},{side},{node},{off},{count}")
            continue
        etype = "A3" if (side == "start") == (strand == "+") else "A5"
        out.append(
            f"{etype},novel,{chrom},{gene},{strand},{pos},{side},{node},{off},{count}"
        )
    return out


# --- end-to-end quantification of clip sites (novel-sites --quant) ---------

QUANT_HEADER = (
    "etype,annotation_type,chrom,gene,strand,donor_pos,acceptor_pos,"
    "W1,W2,psi_c1,psi_c2,dpsi"
)


def _gene_of(meta: Dict[str, NodeMeta], node: str, t2g, genestrand):
    m = meta.get(node)
    if m is None or m.exons == ".":
        return None, None
    for label in m.exons.split(","):
        t = label.rsplit(".", 1)[0].rsplit("_", 1)[0]
        if t in t2g:
            g = t2g[t]
            return g, genestrand.get(g)
    return None, None


def _condition_piles(gafs, meta, min_clip, mapq_thr, max_dv, engine):
    """Sum clip pile-ups, node coverage (NC), and adjacency traversals
    over a condition's GAFs."""
    piles: Dict[Tuple[str, str, int], List[int]] = {}
    nc: Dict[str, int] = {}
    pairs: Dict[Tuple[str, str], int] = {}
    for gaf in gafs:
        for k, (cnt, clipmax) in _scan(
            str(gaf), meta, min_clip, mapq_thr, max_dv, engine
        ).items():
            cur = piles.setdefault(k, [0, 0])
            cur[0] += cnt
            cur[1] = max(cur[1], clipmax)
        for node, cov in _node_coverage(
            str(gaf), meta, mapq_thr, max_dv, pairs
        ).items():
            nc[node] = nc.get(node, 0) + cov
    return piles, nc, pairs


def _node_coverage(
    gaf_path, meta, mapq_thr, max_dv, pairs: Optional[Dict] = None
) -> Dict[str, int]:
    """Per-node read counts for a GAF — the inclusion-side denominator.

    Cheap streaming count (every walked node +1 per accepted record), the
    NC semantics of the augment stage at node granularity. When ``pairs``
    is given (a dict), adjacent-step traversal counts accumulate into it
    keyed by (from_node, to_node) in genomic orientation — the skip-side
    denominator for cassette-exon candidates.
    """
    from pantas_tpu_torch.io.xopen import xopen

    out: Dict[str, int] = {}
    with xopen(gaf_path) as fh:
        for line in fh:
            if not line.strip():
                continue
            rec = parse_gaf_line(line)
            if rec.mapq < mapq_thr or rec.path == "*":
                continue
            if rec.dv is not None and rec.dv > max_dv:
                continue
            rev = rec.path[0] == "<"
            last = None
            for step in rec.path.split("<" if rev else ">")[1:]:
                if step != last and step in meta:
                    out[step] = out.get(step, 0) + 1
                    if pairs is not None and last is not None and last in meta:
                        key = (step, last) if rev else (last, step)
                        pairs[key] = pairs.get(key, 0) + 1
                last = step
    return out


def quantify_sites(
    c1_gafs: List[str],
    c2_gafs: List[str],
    gfa_path: str,
    gtf_path: str,
    w: int = 3,
    min_clip: int = 5,
    mapq_thr: int = DEFAULT_MAPQ_THR,
    max_dv: float = DEFAULT_MAX_DIVERGENCE,
    max_intron: int = 10_000,
    min_intron: int = 20,
    canonical_tol: int = 6,
    ce_min_clip: int = 25,
    engine: str = "auto",
) -> List[str]:
    """Quantified intra-node novel splice events (PSI analogue), CSV rows.

    The detector's clip pile-ups become quantified events:

    * **donor/acceptor merging** — an intron invisible to the graph leaves
      an ``end`` pile-up at its donor and a ``start`` pile-up at its
      acceptor; same-gene (end, start) pairs within ``max_intron`` merge
      into ONE intron candidate whose evidence is the SUM of both ends, so
      two half-strength pile-ups (each < w) still surface when their
      combined support passes ``w``. Unpaired sites stay single-terminus
      events.
    * **PSI analogue** — per condition, inclusion = reads walking the
      node(s) (NC semantics), event = clip evidence;
      ``psi = inclusion / (inclusion + clip)`` with the quant stage's -1
      sentinel for zero coverage and ``dpsi = max(0,psi1) - max(0,psi2)``
      (reference quantify.py:15-24,317-319 conventions).

    * **annotated-boundary filtering** — termini that coincide (±3) with
      an annotated exon end ('end' sites) / exon start ('start' sites) are
      canonical: events whose every terminus is canonical are clip shadows
      of ANNOTATED junctions and are dropped; for merged pairs the novel
      (non-canonical) terminus determines the event type.

    Event typing is strand-aware like :func:`classify_sites` (the novel
    terminus's side: acceptor on '+' = A3, ...); merged introns report both
    genomic termini.
    """
    from pantas_tpu_torch.io.gtf import parse_transcript_maps, parse_transcript_models

    meta = load_graph_meta(gfa_path)
    t2g, genestrand, _ = parse_transcript_maps(gtf_path)

    # annotated exon boundaries per chrom (donor = exon end, acceptor =
    # exon start): clip termini within +-3 of one are canonical
    exon_ends: Dict[str, set] = {}
    exon_starts: Dict[str, set] = {}
    models = parse_transcript_models(gtf_path)
    for tr in models.values():
        for s0, e0 in tr.exons:
            exon_starts.setdefault(tr.chrom, set()).add(s0)
            exon_ends.setdefault(tr.chrom, set()).add(e0)

    def canonical(chrom: str, side: str, pos: int, tol: int = canonical_tol) -> bool:
        # near ANY annotated exon boundary: junction clip shadows pile up
        # on both sides of a splice site, so a start-side pile at an exon
        # END is just as canonical as one at an exon start
        return any(
            pos + d in anno
            for anno in (exon_ends.get(chrom, ()), exon_starts.get(chrom, ()))
            for d in range(-tol, tol + 1)
        )
    p1, nc1, pr1 = _condition_piles(c1_gafs, meta, min_clip, mapq_thr, max_dv, engine)
    p2, nc2, pr2 = _condition_piles(c2_gafs, meta, min_clip, mapq_thr, max_dv, engine)

    # candidate sites = union of both conditions' pile keys, interior only
    sites = []
    for key in set(p1) | set(p2):
        side, node, off = key
        m = meta.get(node)
        if m is None:
            continue
        if side == "start" and off == 0:
            continue
        if side == "end" and off == m.length - 1:
            continue
        gene, strand = _gene_of(meta, node, t2g, genestrand)
        if m.gchrom is None or gene is None or strand not in ("+", "-"):
            continue
        sites.append({
            "side": side,
            "node": node,
            "gene": gene,
            "strand": strand,
            "chrom": m.gchrom,
            "pos": m.gstart + off,
            "clip1": p1.get(key, [0, 0])[0],
            "clip2": p2.get(key, [0, 0])[0],
        })

    # donor/acceptor merging: pair each 'end' (donor side, genomic-left
    # terminus) with the nearest downstream same-gene 'start'
    by_gene: Dict[str, List[dict]] = {}
    for s in sites:
        by_gene.setdefault(s["gene"], []).append(s)
    events = []
    for gene, ss in by_gene.items():
        ends = sorted((s for s in ss if s["side"] == "end"), key=lambda s: s["pos"])
        starts = sorted(
            (s for s in ss if s["side"] == "start"), key=lambda s: s["pos"]
        )
        used = set()
        for e in ends:
            mate = None
            e_w = e["clip1"] + e["clip2"]
            for s in starts:
                if id(s) in used:
                    continue
                if not (e["pos"] + min_intron <= s["pos"] <= e["pos"] + max_intron):
                    continue
                # only merge comparable evidence: pairing a strong pile-up
                # with a 1-read noise site dilutes the real signal's PSI
                s_w = s["clip1"] + s["clip2"]
                if min(e_w, s_w) < 2 or min(e_w, s_w) * 4 < max(e_w, s_w):
                    continue
                mate = s
                break
            if mate is not None:
                used.add(id(mate))
                events.append((e, mate))
            else:
                events.append((e, None))
        events.extend((None, s) for s in starts if id(s) not in used)

    rows = []
    for e, s in events:
        clip1 = (e["clip1"] if e else 0) + (s["clip1"] if s else 0)
        clip2 = (e["clip2"] if e else 0) + (s["clip2"] if s else 0)
        if max(clip1, clip2) < w:
            continue
        anchor = s if s is not None else e
        strand = anchor["strand"]
        # novel terminus = the one NOT at an annotated exon boundary; an
        # event with only canonical termini is an annotated junction's clip
        # shadow (reads soft-clipped instead of spliced) — drop it
        e_canon = e is None or canonical(e["chrom"], "end", e["pos"])
        s_canon = s is None or canonical(s["chrom"], "start", s["pos"])
        if e_canon and s_canon:
            continue
        if not s_canon and e_canon:
            novel_side = "start"
        elif not e_canon and s_canon:
            novel_side = "end"
        elif e is not None and s is not None:
            # both termini novel: the stronger pile-up carries the signal
            e_w = e["clip1"] + e["clip2"]
            s_w = s["clip1"] + s["clip2"]
            novel_side = "end" if e_w > s_w else "start"
        else:
            novel_side = "start" if s is not None else "end"
        # a start (acceptor-like) site is the intron's genomic-right
        # terminus — A3 on '+', A5 on '-'
        etype = "A3" if (novel_side == "start") == (strand == "+") else "A5"
        nodes = {x["node"] for x in (e, s) if x}
        incl1 = sum(nc1.get(n, 0) for n in nodes)
        incl2 = sum(nc2.get(n, 0) for n in nodes)

        def psi(incl, clip):
            return incl / (incl + clip) if incl + clip > 0 else -1

        psi1, psi2 = psi(incl1, clip1), psi(incl2, clip2)
        dpsi = -1 if psi1 == -1 and psi2 == -1 else max(0, psi1) - max(0, psi2)
        rows.append(
            f"{etype},novel,{anchor['chrom']},{anchor['gene']},{strand},"
            f"{e['pos'] if e else '?'},{s['pos'] if s else '?'},"
            f"{incl1}/{clip1},{incl2}/{clip2},{psi1},{psi2},{dpsi}"
        )

    rows.extend(
        _ce_rows(
            meta, t2g, genestrand, models, p1, p2, pr1, pr2,
            w=w, ce_min_clip=ce_min_clip, tol=canonical_tol // 2,
        )
    )

    def key(r: str):
        f = r.split(",")
        return (f[2], f[3], f[5], f[6])

    rows.sort(key=key)
    return rows


def _ce_rows(
    meta, t2g, genestrand, models, p1, p2, pr1, pr2,
    w: int = 3, ce_min_clip: int = 25, tol: int = 3,
):
    """Cassette-exon candidates from PAIRED canonical-boundary pile-ups.

    A novel cassette exon inside an annotated intron leaves its two
    REACHABLE clip signatures at the intron's own (annotated, node-
    boundary) termini: inclusion reads splice from the upstream exon's
    last base into the CE (long soft-clip at the donor boundary, an
    'end' pile) and from the CE into the downstream exon's first base
    (long clip at the acceptor boundary, a 'start' pile). The CE's own
    boundaries stay unreachable (an arm inside a < L/2 exon cannot map
    — docs/SIM_ACCURACY.md), which is why the plain site detector has
    structural CE recall 0: it drops node-boundary piles as annotated-
    junction clip shadows.

    The discriminators that separate a CE from those shadows:

    * **pairing** — BOTH termini of one annotated intron (consecutive
      exons of some transcript) carry a pile;
    * **clip length** — shadow clips are arms the mapper refused to
      splice (< MIN_SPAN ≈ 20 bp); CE inclusion arms run up to L/2, so
      ``ce_min_clip`` (default 25) excludes shadows;
    * **support** — each pile needs count ≥ ``w`` in one condition.

    PSI analogue follows the reference CE quant convention
    (quantify.py:151-161): canonic = reads traversing the skip junction
    (adjacency donor-node -> acceptor-node in the walks), event =
    (clip_donor + clip_acceptor) / 2; psi = canonic/(canonic+event).
    """
    # annotated introns between consecutive exons: (chrom, donor_end,
    # acceptor_start) -> transcript strand (models = the caller's
    # already-parsed transcript models; re-parsing the GTF here paid a
    # second full-file scan per quant invocation)
    introns: Dict[Tuple[str, int, int], str] = {}
    for tr in models.values():
        exons = sorted(tr.exons)
        for (s0, e0), (s1, _e1) in zip(exons, exons[1:]):
            introns.setdefault((tr.chrom, e0, s1), tr.strand)

    # genomic position -> boundary piles (INCLUDING node-boundary ones)
    def pile_positions(piles):
        by_pos: Dict[Tuple[str, str, int], List[int]] = {}
        for (side, node, off), (cnt, clipmax) in piles.items():
            m = meta.get(node)
            if m is None or m.gchrom is None:
                continue
            cur = by_pos.setdefault((side, m.gchrom, m.gstart + off), [0, 0, node])
            cur[0] += cnt
            cur[1] = max(cur[1], clipmax)
        return by_pos

    bp1 = pile_positions(p1)
    bp2 = pile_positions(p2)

    # skip-junction traversals aggregated by the junction's GENOMIC
    # boundary positions: variant bubbles put several node copies at one
    # position, and the pile's recorded node need not be the copy the
    # skip reads traverse — a raw node-pair probe then reads 0 and the
    # event dies at the |dpsi| filter (measured: 5 of 25 truth CEs)
    def pair_pos_counts(pr):
        out: Dict[Tuple[str, int, int], int] = {}
        for (a, b), n in pr.items():
            ma, mb = meta.get(a), meta.get(b)
            if (
                ma is None or mb is None
                or ma.gchrom is None or mb.gchrom is None
                or ma.gchrom != mb.gchrom
            ):
                continue
            key = (ma.gchrom, ma.gstart + ma.length - 1, mb.gstart)
            out[key] = out.get(key, 0) + n
        return out

    pp1 = pair_pos_counts(pr1)
    pp2 = pair_pos_counts(pr2)

    def find(bp, side, chrom, pos):
        for d in range(-tol, tol + 1):
            hit = bp.get((side, chrom, pos + d))
            if hit is not None:
                return hit
        return None

    def find_donor(bp, chrom, d_end, a_start):
        # donor-side evidence: an end pile at the donor boundary, OR one
        # just INSIDE the acceptor exon — an inclusion read whose arm the
        # aligner snapped through the skip edge aligns 1-2 chance-matching
        # bases of the downstream exon before clipping, so its (honest,
        # inclusive) end position lands at a_start..a_start+tol rather
        # than at d_end
        hit = find(bp, "end", chrom, d_end)
        if hit is not None:
            return hit
        for d in range(0, tol + 1):
            hit = bp.get(("end", chrom, a_start + d))
            if hit is not None:
                return hit
        return None

    out = []
    for (chrom, d_end, a_start), strand in sorted(introns.items()):
        e1 = find_donor(bp1, chrom, d_end, a_start)
        s1 = find(bp1, "start", chrom, a_start)
        e2 = find_donor(bp2, chrom, d_end, a_start)
        s2 = find(bp2, "start", chrom, a_start)
        def ok(e, s):
            return (
                e is not None and s is not None
                and e[0] >= w and s[0] >= w
                and e[1] >= ce_min_clip and s[1] >= ce_min_clip
            )
        if not (ok(e1, s1) or ok(e2, s2)):
            continue
        node_d = (e1 or e2)[2]
        node_a = (s1 or s2)[2]
        gene, gstrand = _gene_of(meta, node_d, t2g, genestrand)
        if gene is None:
            gene, gstrand = _gene_of(meta, node_a, t2g, genestrand)
        if gene is None:
            continue
        clip1 = ((e1 or [0])[0] + (s1 or [0])[0]) / 2
        clip2 = ((e2 or [0])[0] + (s2 or [0])[0]) / 2
        skip1 = pp1.get((chrom, d_end, a_start)) or pr1.get((node_d, node_a), 0)
        skip2 = pp2.get((chrom, d_end, a_start)) or pr2.get((node_d, node_a), 0)

        def psi(skip, incl):
            return skip / (skip + incl) if skip + incl > 0 else -1

        psi1, psi2 = psi(skip1, clip1), psi(skip2, clip2)
        dpsi = -1 if psi1 == -1 and psi2 == -1 else max(0, psi1) - max(0, psi2)
        out.append(
            f"CE,novel,{chrom},{gene},{gstrand or strand},"
            f"{d_end},{a_start},"
            f"{skip1}/{clip1:g},{skip2}/{clip2:g},{psi1},{psi2},{dpsi}"
        )
    return out
