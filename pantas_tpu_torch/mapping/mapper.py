"""Path-guided seed-and-extend read mapper producing GAF.

Strategy: RNA reads come from transcripts (possibly with retained introns
or novel splice combinations), so the annotated pangenome's embedded paths
— reference-projected transcripts (``*_R1``) plus the reference chromosome
path — are the alignment targets. Each path's sequence is k-mer indexed;
reads vote for (path, diagonal) pairs, extensions are scored by a
max-identity window (soft-clipping junction overhangs), and clipped reads
attempt a *two-piece spliced join*: the remainder re-seeds independently
and the pieces merge into one walk when they meet at node boundaries in
topological order — which is exactly how novel junctions enter the GAF
(the augmenter then records the absent edge as a novel link).

Output GAF is consumable by the augment stage (and by the reference
augmenter): oriented path, path-interval coordinates, mapq, ``cs:Z:`` and
``dv:f:`` tags, following the conventions of ``vg mpmap -F GAF``
(reference ``README.md:86-101``).
"""

from __future__ import annotations

import re
import sys
from bisect import bisect_right

import numpy as np
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from pantas_tpu_torch.io.fasta import revcomp
from pantas_tpu_torch.io.xopen import xopen

MISMATCH_PENALTY = 4  # max-window scoring: match +1, mismatch -penalty

_HAP_COPY_RE = re.compile(r"_H\d+$")


@dataclass
class PathRecord:
    name: str
    nodes: List[str]
    offsets: List[int]  # cumulative start offset of each node
    seq: str


def load_alignment_paths(
    gfa_path: str, ref_transcripts_only: bool = True
) -> List[PathRecord]:
    """Stream a GFA, materializing only the alignment-target paths.

    Avoids building step tuples for the (potentially tens of thousands of)
    haplotype transcript copies the mapper never aligns against.

    Fast path: the native gfaload extension scans + assembles the paths in
    C (same selection, same fields) — the pure-Python loop below took
    18–30 s on the 3.6 GB / 100 Mbp graph, per map invocation.
    """
    if ref_transcripts_only:
        try:
            from pantas_tpu_torch.io.xopen import materialized
            from pantas_tpu_torch.native.gfaload import get_module

            with materialized(gfa_path) as plain:
                raw = get_module().load_paths(plain)
            return [PathRecord(n, nodes, offs, seq) for n, nodes, offs, seq in raw]
        except Exception:
            pass  # malformed/unusual input: the Python loop decides
    seqs: Dict[str, str] = {}
    out: List[PathRecord] = []
    with xopen(gfa_path) as fh:
        for line in fh:
            kind = line[0] if line else ""
            if kind == "S":
                t = line.split("\t", 3)
                seqs[t[1]] = t[2].rstrip("\n")
            elif kind == "P":
                _, name, steps_s, *_ = line.rstrip("\n").split("\t")
                # exclude only haplotype transcript copies ("..._H<k>");
                # chromosome/scaffold names may themselves contain '_'
                if ref_transcripts_only and _HAP_COPY_RE.search(name):
                    continue
                nodes = [s[:-1] for s in steps_s.split(",")]
                offsets = []
                total = 0
                node_seqs = [seqs[n] for n in nodes]
                for s in node_seqs:
                    offsets.append(total)
                    total += len(s)
                out.append(PathRecord(name, nodes, offsets, "".join(node_seqs)))
    return out


_BASE_CODE = np.zeros(256, dtype=np.uint64)
_BASE_CODE[ord("C")] = _BASE_CODE[ord("c")] = 1
_BASE_CODE[ord("G")] = _BASE_CODE[ord("g")] = 2
_BASE_CODE[ord("T")] = _BASE_CODE[ord("t")] = 3


def _pack_kmers(seq: str, k: int) -> np.ndarray:
    """Exact 2-bit packed k-mers (k <= 32) of a sequence, vectorized."""
    codes = _BASE_CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    # rolling pack: kmer[i] = sum_j codes[i+j] << 2*(k-1-j)
    out = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        out |= codes[j : j + n] << np.uint64(2 * (k - 1 - j))
    return out


class PathIndex:
    """Packed-u64 k-mer index over selected embedded paths of a GFA.

    k-mers are exact 2-bit packings sorted into one array; lookups are two
    binary searches. High-multiplicity seeds (> max_hits) are skipped at
    query time.
    """

    def __init__(
        self,
        paths: List[PathRecord],
        k: int = 21,
        max_hits: int = 64,
    ):
        assert k <= 32
        self.k = k
        self.max_hits = max_hits
        self.paths = paths

        sizes = [max(0, len(rec.seq) - k + 1) for rec in self.paths]
        total = sum(sizes)
        kmers = np.zeros(total, dtype=np.uint64)
        pids = np.zeros(total, dtype=np.int32)
        poss = np.zeros(total, dtype=np.int32)

        # native pack+sort when available: this environment trap-emulates
        # AVX numpy kernels, making elementwise u64 ops ~100x slow
        try:
            from pantas_tpu_torch.native import kidx_pack, kidx_sort, native_available

            use_native = native_available() and total > 0
        except Exception:
            use_native = False

        off = 0
        for pi, rec in enumerate(self.paths):
            n = sizes[pi]
            if n <= 0:
                continue
            if use_native:
                kidx_pack(rec.seq, k, kmers[off : off + n])
            else:
                kmers[off : off + n] = _pack_kmers(rec.seq, k)
            pids[off : off + n] = pi
            poss[off : off + n] = np.arange(n, dtype=np.int32)
            off += n

        if total > 0:
            if use_native:
                kidx_sort(kmers, pids, poss)
            else:
                order = np.argsort(kmers, kind="stable")
                kmers, pids, poss = kmers[order], pids[order], poss[order]
        self._kmers = kmers
        self._pids = pids
        self._poss = poss

    @property
    def kmers(self):  # diagnostic: number of indexed positions
        return self._kmers

    def _lookup(self, packed: int):
        lo = int(np.searchsorted(self._kmers, np.uint64(packed), side="left"))
        hi = int(np.searchsorted(self._kmers, np.uint64(packed), side="right"))
        if hi - lo > self.max_hits:
            return range(0, 0)
        return range(lo, hi)

    def seed(
        self, read: str, qlo: int = 0, qhi: Optional[int] = None
    ) -> Dict[Tuple[int, int], int]:
        """Vote for (path, diagonal) using seeds inside read[qlo:qhi]."""
        k = self.k
        qhi = len(read) if qhi is None else qhi
        span = qhi - qlo
        if span < k:
            return {}
        votes: Dict[Tuple[int, int], int] = {}
        offs = sorted(
            {qlo, qlo + span // 4, qlo + span // 2, qlo + (3 * span) // 4, qhi - k}
        )
        for q in offs:
            if q < qlo or q + k > qhi:
                continue
            sub = read[q : q + k]
            if "N" in sub or "n" in sub:
                continue
            packed = 0
            for ch in sub:
                packed = (packed << 2) | int(_BASE_CODE[ord(ch)])
            for i in self._lookup(packed):
                key = (int(self._pids[i]), int(self._poss[i]) - q)
                votes[key] = votes.get(key, 0) + 1
        return votes


@dataclass
class Piece:
    """One gapless alignment piece of the (oriented) read."""

    path_idx: int
    qstart: int  # on the oriented read
    qend: int
    pstart: int  # on the forward path
    pend: int
    mismatches: int
    ops: List[Tuple[str, object]]  # (':', n) or ('*', 'xy')

    @property
    def span(self) -> int:
        return self.pend - self.pstart


def _extend(
    read: str, pseq: str, diag: int, qlo: int, qhi: int
) -> Optional[Piece]:
    """Best-identity contiguous window of read[qlo:qhi] vs path at a diagonal.

    Kadane-style max-subarray over +1/-MISMATCH_PENALTY scores, so junction
    overhangs soft-clip instead of dragging the identity down.
    """
    lo = max(qlo, -diag)
    hi = min(qhi, len(pseq) - diag)
    if hi - lo <= 0:
        return None
    # max-scoring window
    best_s = best_e = cur_s = lo
    best_score = cur = 0
    for i in range(lo, hi):
        cur += 1 if read[i] == pseq[diag + i] else -MISMATCH_PENALTY
        if cur > best_score:
            best_score = cur
            best_s, best_e = cur_s, i + 1
        if cur < 0:
            cur = 0
            cur_s = i + 1
    if best_e <= best_s:
        return None
    ops: List[Tuple[str, object]] = []
    mism = 0
    run = 0
    for i in range(best_s, best_e):
        if read[i] == pseq[diag + i]:
            run += 1
        else:
            if run:
                ops.append((":", run))
                run = 0
            mism += 1
            ops.append(("*", pseq[diag + i].lower() + read[i].lower()))
    if run:
        ops.append((":", run))
    return Piece(
        path_idx=-1,
        qstart=best_s,
        qend=best_e,
        pstart=diag + best_s,
        pend=diag + best_e,
        mismatches=mism,
        ops=ops,
    )


def _node_interval(index: PathIndex, p: Piece) -> Tuple[int, int]:
    """(min,max) node id covered by the piece — the placement-identity key.

    Node ids are topologically sorted, so same-locus placements (e.g. the
    same exon reached via a different transcript path) have intersecting
    intervals and do NOT count as secondary hits for MAPQ.
    """
    rec = index.paths[p.path_idx]
    i0 = bisect_right(rec.offsets, p.pstart) - 1
    i1 = bisect_right(rec.offsets, p.pend - 1) - 1
    try:
        a, b = int(rec.nodes[i0]), int(rec.nodes[i1])
    except ValueError:
        # non-integer segment names (micro fixtures): salted hash() would
        # make MAPQ run-dependent and ignoring i1 collapsed multi-node
        # placements — use a stable digest over both endpoints
        import zlib

        a = zlib.crc32(rec.nodes[i0].encode())
        b = zlib.crc32(rec.nodes[i1].encode())
    return (a, b) if a <= b else (b, a)


def _best_piece(
    index: PathIndex,
    seq: str,
    qlo: int = 0,
    qhi: Optional[int] = None,
    max_mismatch_frac: float = 0.08,
    min_span: int = 20,
    exclude: Optional[Tuple[int, int]] = None,
    cands: Optional[List[Tuple[int, int, int]]] = None,
) -> Optional[Piece]:
    qhi = len(seq) if qhi is None else qhi
    votes = index.seed(seq, qlo, qhi)
    if exclude is not None:
        votes.pop(exclude, None)
    if not votes:
        return None
    best: Optional[Piece] = None
    for (pi, diag), _ in sorted(votes.items(), key=lambda kv: -kv[1])[:4]:
        p = _extend(seq, index.paths[pi].seq, diag, qlo, qhi)
        if p is None or p.span < min_span:
            continue
        if p.mismatches > max_mismatch_frac * p.span:
            continue
        p.path_idx = pi
        if cands is not None:
            lo, hi = _node_interval(index, p)
            cands.append((p.span - MISMATCH_PENALTY * p.mismatches, lo, hi))
        if best is None or (p.span - MISMATCH_PENALTY * p.mismatches) > (
            best.span - MISMATCH_PENALTY * best.mismatches
        ):
            best = p
    return best


def _node_boundary_end(rec: PathRecord, pos: int) -> bool:
    """Is path position `pos` the end of some node (exclusive boundary)?"""
    if pos == len(rec.seq):
        return True
    i = bisect_right(rec.offsets, pos) - 1
    return rec.offsets[i] == pos


def _piece_nodes(index: PathIndex, p: Piece) -> Tuple[List[str], int, int, int]:
    """(nodes, walk_len, start offset in first node, uncovered tail)."""
    rec = index.paths[p.path_idx]
    i0 = bisect_right(rec.offsets, p.pstart) - 1
    i1 = bisect_right(rec.offsets, p.pend - 1) - 1
    nodes = rec.nodes[i0 : i1 + 1]
    end_off = rec.offsets[i1 + 1] if i1 + 1 < len(rec.offsets) else len(rec.seq)
    walk_len = end_off - rec.offsets[i0]
    start = p.pstart - rec.offsets[i0]
    tail = end_off - p.pend
    return nodes, walk_len, start, tail


def _make_piece(seq: str, pseq: str, diag: int, qstart: int, qend: int) -> Piece:
    """Gapless piece over an exact read range (ops + mismatch recount)."""
    ops: List[Tuple[str, object]] = []
    mism = 0
    run = 0
    for i in range(qstart, qend):
        if seq[i] == pseq[diag + i]:
            run += 1
        else:
            if run:
                ops.append((":", run))
                run = 0
            mism += 1
            ops.append(("*", pseq[diag + i].lower() + seq[i].lower()))
    if run:
        ops.append((":", run))
    return Piece(
        path_idx=-1,
        qstart=qstart,
        qend=qend,
        pstart=diag + qstart,
        pend=diag + qend,
        mismatches=mism,
        ops=ops,
    )


MAX_INDEL = 16
GAP_OPEN = 6
GAP_EXTEND = 2


def _indel_join(
    index: PathIndex, seq: str, first: Piece, second: Piece
) -> Optional[Piece]:
    """Merge two same-path pieces whose diagonals differ by a small shift.

    A diagonal shift of +g is a deletion of g path bases (cs ``-seq``); -g
    is an insertion of g read bases (cs ``+seq``). Returns ONE piece whose
    ops contain the gap, with path-contiguous coordinates — reads carrying
    indel variants against the reference-projected paths align end-to-end
    instead of soft-clipping.
    """
    if second.path_idx != first.path_idx:
        return None
    diag1 = first.pstart - first.qstart
    diag2 = second.pstart - second.qstart
    g = diag2 - diag1
    if g == 0 or abs(g) > MAX_INDEL:
        return None
    pseq = index.paths[first.path_idx].seq
    ins = max(0, -g)
    # split c ends piece1 at read offset c; piece2 resumes at c+ins
    lo = max(first.qstart + 1, second.qstart - ins)
    hi = min(first.qend, second.qend - ins - 1)
    if hi < lo:
        return None
    # choose the read split maximizing matches on both sides
    best_c = None
    best_m = -1
    for c in range(lo, hi + 1):
        m = 0
        for i in range(first.qstart, c):
            if seq[i] == pseq[diag1 + i]:
                m += 1
        for i in range(c + ins, second.qend):
            if seq[i] == pseq[diag2 + i]:
                m += 1
        if m > best_m:
            best_m = m
            best_c = c
    if best_c is None:
        return None
    c = best_c

    p1 = _make_piece(seq, pseq, diag1, first.qstart, c)
    p2 = _make_piece(seq, pseq, diag2, c + ins, second.qend)
    if p2.qend <= p2.qstart or p1.qend <= p1.qstart:
        return None
    gap_ops: List[Tuple[str, object]]
    if g > 0:
        deleted = pseq[diag1 + c : diag1 + c + g].lower()
        gap_ops = [("-", deleted)]
    else:
        inserted = seq[c : c + ins].lower()
        gap_ops = [("+", inserted)]
    merged = Piece(
        path_idx=first.path_idx,
        qstart=p1.qstart,
        qend=p2.qend,
        pstart=p1.pstart,
        pend=p2.pend,
        mismatches=p1.mismatches + p2.mismatches,
        ops=p1.ops + gap_ops + p2.ops,
    )
    return merged


def _piece_score(p: Piece) -> int:
    """matched - 3*mism - gap_cost; equals span - 4*mism for gapless pieces
    (the original scoring), so junction-join comparisons are unchanged."""
    matched = 0
    gap_cost = 0
    for op, v in p.ops:
        if op == ":":
            matched += v
        elif op in ("-", "+"):
            gap_cost += GAP_OPEN + GAP_EXTEND * len(v)
    return matched - 3 * p.mismatches - gap_cost


def _snap_join(
    index: PathIndex, seq: str, first: Piece, second: Piece
) -> Optional[Tuple[Piece, Piece]]:
    """Find a split point where both pieces meet node boundaries.

    Chance matches let extensions overshoot a junction by a few bases, so
    the exact split is searched over the pieces' meeting region: read
    offset c splits validly when piece1 trimmed to [qstart1, c) ends on a
    node boundary of its path AND piece2 trimmed to [c, qend2) starts on a
    node boundary of its path, with the junction in topological order.
    """
    rec1 = index.paths[first.path_idx]
    rec2 = index.paths[second.path_idx]
    diag1 = first.pstart - first.qstart
    diag2 = second.pstart - second.qstart
    lo = max(second.qstart, first.qstart + 1)
    hi = min(first.qend, second.qend - 1)
    for c in range(lo, hi + 1):
        pe1 = diag1 + c
        ps2 = diag2 + c
        if not _node_boundary_end(rec1, pe1) or pe1 <= first.pstart:
            continue
        i2 = bisect_right(rec2.offsets, ps2) - 1
        if i2 < 0 or rec2.offsets[i2] != ps2 or ps2 >= len(rec2.seq):
            continue
        # topological order across the junction
        i1 = bisect_right(rec1.offsets, pe1 - 1) - 1
        try:
            if int(rec1.nodes[i1]) >= int(rec2.nodes[i2]):
                continue
        except ValueError:
            if rec1.nodes[i1] == rec2.nodes[i2]:
                continue
        p1 = _make_piece(seq, rec1.seq, diag1, first.qstart, c)
        p2 = _make_piece(seq, rec2.seq, diag2, c, second.qend)
        p1.path_idx = first.path_idx
        p2.path_idx = second.path_idx
        return p1, p2
    return None


@dataclass
class SplicedAlignment:
    pieces: List[Piece]
    reverse: bool
    mapq: int = 60

    @property
    def qstart(self) -> int:
        return self.pieces[0].qstart

    @property
    def qend(self) -> int:
        return self.pieces[-1].qend

    @property
    def mismatches(self) -> int:
        return sum(p.mismatches for p in self.pieces)

    @property
    def span(self) -> int:
        return sum(p.span for p in self.pieces)

    def score(self) -> int:
        return sum(_piece_score(p) for p in self.pieces)

    def matched(self) -> int:
        return sum(v for p in self.pieces for op, v in p.ops if op == ":")


def _mapq_from_scores(s1: int, s2: int) -> int:
    """Second-best-gap MAPQ (integer arithmetic shared with aligner.cpp).

    s2 is the best score among *distinct placements* (disjoint node-id
    interval or opposite strand); s2<=0 means uniquely placed.
    """
    if s2 <= 0:
        return 60
    if s1 <= s2 or s1 <= 0:
        return 0
    return min(60, (40 * (s1 - s2)) // s1)


def align_read(
    index: PathIndex, read: str, max_mismatch_frac: float = 0.08
) -> Optional[SplicedAlignment]:
    """Best (possibly two-piece spliced) alignment of the read, or None."""
    L = len(read)
    k = index.k
    best: Optional[SplicedAlignment] = None
    all_cands: List[Tuple[int, int, int, bool]] = []

    for reverse, seq in ((False, read), (True, revcomp(read))):
        strand_cands: List[Tuple[int, int, int]] = []
        p1 = _best_piece(index, seq, 0, L, max_mismatch_frac, cands=strand_cands)
        all_cands.extend((s, lo, hi, reverse) for s, lo, hi in strand_cands)
        if p1 is None:
            continue
        cand = SplicedAlignment([p1], reverse)

        # try to rescue a clipped tail with a second piece (allow a few
        # bases of overlap: extensions overshoot junctions on chance matches)
        excl = (p1.path_idx, p1.pstart - p1.qstart)
        if L - p1.qend >= k:
            p2 = _best_piece(
                index, seq, max(0, p1.qend - 8), L, max_mismatch_frac, exclude=excl
            )
            if p2 is not None and p2.qend > p1.qend:
                snapped = _snap_join(index, seq, p1, p2)
                if snapped is not None:
                    cand = SplicedAlignment(list(snapped), reverse)
                else:
                    merged = _indel_join(index, seq, p1, p2)
                    if merged is not None:
                        cand = SplicedAlignment([merged], reverse)
        # or a clipped head
        if cand.qstart >= k and len(cand.pieces) == 1 and not _has_gap(cand):
            p0 = _best_piece(
                index, seq, 0, min(L, p1.qstart + 8), max_mismatch_frac, exclude=excl
            )
            if p0 is not None and p0.qstart < p1.qstart:
                snapped = _snap_join(index, seq, p0, p1)
                if snapped is not None:
                    cand = SplicedAlignment(list(snapped), reverse)
                else:
                    merged = _indel_join(index, seq, p0, p1)
                    if merged is not None:
                        cand = SplicedAlignment([merged], reverse)

        if cand.span < L // 2:
            continue
        if best is None or cand.score() > best.score():
            best = cand

    if best is not None:
        w_lo = w_hi = None
        for p in best.pieces:
            lo, hi = _node_interval(index, p)
            w_lo = lo if w_lo is None else min(w_lo, lo)
            w_hi = hi if w_hi is None else max(w_hi, hi)
        s1 = best.score()
        s2 = 0
        for sc, lo, hi, rev in all_cands:
            if rev != best.reverse or hi < w_lo or lo > w_hi:
                s2 = max(s2, sc)
        best.mapq = _mapq_from_scores(s1, s2)
    return best


def _has_gap(aln: "SplicedAlignment") -> bool:
    return any(op in ("-", "+") for p in aln.pieces for op, _ in p.ops)


def _cs_string(ops: List[Tuple[str, object]]) -> str:
    parts = []
    for op, v in ops:
        parts.append(f":{v}" if op == ":" else f"{op}{v}" if op in ("-", "+") else f"*{v}")
    return "".join(parts)


def _merge_ops(pieces: List[Piece]) -> List[Tuple[str, object]]:
    ops: List[Tuple[str, object]] = []
    for p in pieces:
        for op, v in p.ops:
            if ops and op == ":" and ops[-1][0] == ":":
                ops[-1] = (":", ops[-1][1] + v)
            else:
                ops.append((op, v))
    return ops


def format_gaf(
    index: PathIndex,
    name: str,
    read_len: int,
    piece_coords: List[Tuple[int, int, int]],  # (path_idx, pstart, pend)
    reverse: bool,
    cs: str,  # already oriented
    qstart: int,
    qend: int,
    mismatches: int,
    mapq: int = 60,
) -> str:
    walk_nodes: List[str] = []
    walk_len = 0
    head_start = 0
    tail_uncovered = 0
    span = 0
    for i, (pi, pstart_p, pend_p) in enumerate(piece_coords):
        shim = Piece(pi, 0, 0, pstart_p, pend_p, 0, [])
        nodes, wlen, start, tail = _piece_nodes(index, shim)
        if i == 0:
            head_start = start
        if i == len(piece_coords) - 1:
            tail_uncovered = tail
        walk_nodes.extend(nodes)
        walk_len += wlen
        span += pend_p - pstart_p

    if not reverse:
        path_str = ">" + ">".join(walk_nodes)
        pstart = head_start
        pend_excl = walk_len - tail_uncovered
    else:
        path_str = "<" + "<".join(reversed(walk_nodes))
        pstart = tail_uncovered
        pend_excl = walk_len - head_start

    matches = span - mismatches
    dv = round(1.0 - (matches / span), 6) if span else 1.0
    return "\t".join(
        map(
            str,
            [
                name,
                read_len,
                qstart,
                qend,
                "+",
                path_str,
                walk_len,
                pstart,
                pend_excl - 1,
                matches,
                span,
                mapq,
                "AS:i:" + str(matches),
                f"dv:f:{dv}",
                f"cs:Z:{cs}",
            ],
        )
    )


def alignment_to_gaf(
    index: PathIndex, name: str, read: str, aln: SplicedAlignment
) -> str:
    ops = _merge_ops(aln.pieces)
    if not aln.reverse:
        cs = _cs_string(ops)
    else:
        rev_ops = []
        for op, v in reversed(ops):
            if op == ":":
                rev_ops.append((op, v))
            elif op in ("-", "+"):
                rev_ops.append((op, revcomp(v)))
            else:
                rev_ops.append((op, revcomp(v[0]) + revcomp(v[1])))
        cs = _cs_string(rev_ops)
    # matches must count only ':' bases (deleted path bases inflate span)
    span = aln.span
    matched = aln.matched()
    return format_gaf(
        index,
        name,
        len(read),
        [(p.path_idx, p.pstart, p.pend) for p in aln.pieces],
        aln.reverse,
        cs,
        aln.qstart,
        aln.qend,
        span - matched,
        aln.mapq,
    )


class NativePathAligner:
    """ctypes bridge to the native per-read alignment core (aligner.cpp)."""

    def __init__(self, index: PathIndex, cached_arrays=None):
        import ctypes

        from pantas_tpu_torch.native.gafcov import _load, _ptr

        lib = _load()
        self.lib = lib
        self.index = index
        paths = index.paths
        if cached_arrays is not None:
            # mmap-loaded cache (load_map_index): consume the arrays
            # directly — no sequence re-concatenation, no CSR rebuild;
            # pages fault in on first use
            self._seq_arr = np.ascontiguousarray(cached_arrays["seq"])
            self._seq = self._seq_arr.ctypes.data_as(ctypes.c_char_p)
            seq_off = np.ascontiguousarray(cached_arrays["seq_off"])
            node_off = np.ascontiguousarray(cached_arrays["node_off"])
            node_idx = np.ascontiguousarray(cached_arrays["node_idx"])
            node_ids = np.ascontiguousarray(cached_arrays["node_ids"])
            kmers = np.ascontiguousarray(cached_arrays["kmers"])
            pids = np.ascontiguousarray(cached_arrays["pids"])
            poss = np.ascontiguousarray(cached_arrays["poss"])
            index._kmers, index._pids, index._poss = kmers, pids, poss
        else:
            # concatenated sequences + CSR offsets
            self._seq = "".join(rec.seq for rec in paths).encode()
            seq_off = np.zeros(len(paths) + 1, dtype=np.int64)
            node_idx = np.zeros(len(paths) + 1, dtype=np.int64)
            for i, rec in enumerate(paths):
                seq_off[i + 1] = seq_off[i] + len(rec.seq)
                node_idx[i + 1] = node_idx[i] + len(rec.nodes)
            node_off = np.zeros(int(node_idx[-1]), dtype=np.int64)
            node_ids = np.zeros(int(node_idx[-1]), dtype=np.int64)
            for i, rec in enumerate(paths):
                base = int(node_idx[i])
                node_off[base : base + len(rec.offsets)] = rec.offsets
                node_ids[base : base + len(rec.nodes)] = [int(n) for n in rec.nodes]
        self._arrays = (seq_off, node_off, node_idx, node_ids)
        self.handle = lib.aln_create(
            self._seq,
            _ptr(seq_off, ctypes.c_int64),
            _ptr(node_off, ctypes.c_int64),
            _ptr(node_idx, ctypes.c_int64),
            _ptr(node_ids, ctypes.c_int64),
            len(paths),
            _ptr(index._kmers, ctypes.c_uint64),
            _ptr(index._pids, ctypes.c_int32),
            _ptr(index._poss, ctypes.c_int32),
            len(index._kmers),
            index.k,
            index.max_hits,
        )
        self._meta = np.zeros(8, dtype=np.int64)  # [rev,qs,qe,mism,mapq,...]
        self._pieces = np.zeros(10, dtype=np.int64)
        self._cs = ctypes.create_string_buffer(1 << 16)
        self._ptrs = (
            _ptr(self._meta, ctypes.c_int64),
            _ptr(self._pieces, ctypes.c_int64),
        )

    def align_to_gaf(self, name: str, read: str) -> Optional[Tuple[str, int]]:
        import ctypes

        n = self.lib.aln_align(
            self.handle,
            read.encode(),
            len(read),
            self._ptrs[0],
            self._ptrs[1],
            self._cs,
            len(self._cs),
        )
        while n == -1 and len(self._cs) < (1 << 24):
            # cs string exceeded the buffer: grow and retry (distinct from
            # "unmapped" — dropping the read would silently diverge from
            # the Python engine)
            self._cs = ctypes.create_string_buffer(len(self._cs) * 4)
            n = self.lib.aln_align(
                self.handle, read.encode(), len(read),
                self._ptrs[0], self._ptrs[1], self._cs, len(self._cs),
            )
        if n == -1:
            raise IOError("cs buffer overflow during native alignment")
        if n <= 0:
            return None
        reverse = bool(self._meta[0])
        pieces = [
            (
                int(self._pieces[i * 5 + 0]),
                int(self._pieces[i * 5 + 1]),
                int(self._pieces[i * 5 + 2]),
            )
            for i in range(n)
        ]
        return (
            format_gaf(
                self.index,
                name,
                len(read),
                pieces,
                reverse,
                self._cs.value.decode(),
                int(self._meta[1]),
                int(self._meta[2]),
                int(self._meta[3]),
                int(self._meta[4]),
            ),
            n,
        )

    def phase_stats(self):
        """Per-phase ns totals since creation: dict of the aligner's wall
        bisection (seed/extend/join/mapq/format/io + counters)."""
        import ctypes

        from pantas_tpu_torch.native.gafcov import _ptr

        out = np.zeros(8, dtype=np.int64)
        self.lib.aln_phase_stats(self.handle, _ptr(out, ctypes.c_int64))
        keys = ("seed", "extend", "join", "mapq", "format", "io",
                "best_piece_calls", "reads")
        return dict(zip(keys, (int(x) for x in out)))

    def map_file(self, fq1: str, fq2, out_fd: int, threads: int = 1):
        """Full-batch FASTQ -> GAF natively; returns (mapped, spliced, total)."""
        import ctypes

        from pantas_tpu_torch.native.gafcov import _ptr

        stats = np.zeros(3, dtype=np.int64)
        rc = self.lib.aln_map_file(
            self.handle,
            str(fq1).encode(),
            str(fq2).encode() if fq2 else None,
            out_fd,
            threads,
            _ptr(stats, ctypes.c_int64),
        )
        if rc != 0:
            raise IOError(f"aln_map_file failed ({rc})")
        return int(stats[0]), int(stats[1]), int(stats[2])

    def __del__(self):
        try:
            if getattr(self, "handle", None):
                self.lib.aln_destroy(self.handle)
                self.handle = None
        except Exception:
            pass


# --- on-disk index cache (map --index DIR) ---------------------------------

INDEX_CACHE_VERSION = 1


def save_map_index(index: "PathIndex", aligner: "NativePathAligner",
                   cache_dir: str, gfa_path: str) -> None:
    """Persist the built index as plain .npy files (mmap-loadable).

    Saves exactly what the native aligner consumes — the sorted k-mer
    arrays, concatenated path sequence, and CSR node tables — plus path
    names and a (size, mtime) stamp of the source GFA for staleness
    detection. Index build measured 41 s at 100 Mbp (load_paths 24 s at
    the disk ceiling + pack/sort 15 s); a warm mmap load is seconds and
    pages fault in on demand.
    """
    import json
    import os

    import numpy as np

    os.makedirs(cache_dir, exist_ok=True)
    seq_off, node_off, node_idx, node_ids = aligner._arrays
    arrays = {
        "kmers": index._kmers,
        "pids": index._pids,
        "poss": index._poss,
        "seq": np.frombuffer(aligner._seq, dtype=np.uint8),
        "seq_off": seq_off,
        "node_off": node_off,
        "node_idx": node_idx,
        "node_ids": node_ids,
    }
    for name, arr in arrays.items():
        # per-pid tmp: two concurrent cold `map --index DIR` processes
        # must not interleave writes into one tmp file (os.replace keeps
        # the publish itself atomic either way)
        tmp = os.path.join(cache_dir, f"{name}.npy.tmp.{os.getpid()}")
        with open(tmp, "wb") as fh:  # np.save(path) would append .npy
            np.save(fh, arr)
        os.replace(tmp, os.path.join(cache_dir, name + ".npy"))
    st = os.stat(gfa_path)
    meta = {
        "version": INDEX_CACHE_VERSION,
        "k": index.k,
        "max_hits": index.max_hits,
        "names": [r.name for r in index.paths],
        "gfa_size": st.st_size,
        "gfa_mtime": st.st_mtime,
    }
    tmp = os.path.join(cache_dir, f"meta.json.tmp.{os.getpid()}")
    with open(tmp, "w") as fh:
        json.dump(meta, fh)
    os.replace(tmp, os.path.join(cache_dir, "meta.json"))


class _CachedPathRecord:
    """PathRecord view over the cached arrays: nodes/offsets materialize
    eagerly (cheap), the sequence decodes lazily from the shared blob."""

    __slots__ = ("name", "nodes", "offsets", "_blob", "_off", "_len", "_seq")

    def __init__(self, name, nodes, offsets, blob, off, length):
        self.name = name
        self.nodes = nodes
        self.offsets = offsets
        self._blob = blob
        self._off = off
        self._len = length
        self._seq = None

    @property
    def seq(self) -> str:
        if self._seq is None:
            self._seq = bytes(
                self._blob[self._off : self._off + self._len]
            ).decode()
        return self._seq


def load_map_index(cache_dir: str, gfa_path: str, k: int):
    """Load a saved index; returns (PathIndex-compatible, arrays) or None
    when absent/stale (GFA size or mtime changed, or k differs)."""
    import json
    import os

    import numpy as np

    meta_path = os.path.join(cache_dir, "meta.json")
    try:
        meta = json.load(open(meta_path))
        st = os.stat(gfa_path)
        if (
            meta.get("version") != INDEX_CACHE_VERSION
            or meta.get("k") != k
            or meta.get("gfa_size") != st.st_size
            or meta.get("gfa_mtime") != st.st_mtime
        ):
            return None
        arrays = {
            name: np.load(os.path.join(cache_dir, name + ".npy"), mmap_mode="r")
            for name in (
                "kmers", "pids", "poss", "seq",
                "seq_off", "node_off", "node_idx", "node_ids",
            )
        }
    except Exception:
        return None

    idx = PathIndex.__new__(PathIndex)
    idx.k = k
    idx.max_hits = int(meta["max_hits"])
    idx._kmers = arrays["kmers"]
    idx._pids = arrays["pids"]
    idx._poss = arrays["poss"]
    names = meta["names"]
    seq_off = arrays["seq_off"]
    node_idx = arrays["node_idx"]
    node_off_all = arrays["node_off"]
    node_ids_all = arrays["node_ids"]
    blob = arrays["seq"]
    paths = []
    for i, name in enumerate(names):
        a, b = int(node_idx[i]), int(node_idx[i + 1])
        s0 = int(seq_off[i])
        paths.append(
            _CachedPathRecord(
                name,
                [str(x) for x in node_ids_all[a:b]],
                [int(x) for x in node_off_all[a:b]],
                blob,
                s0,
                int(seq_off[i + 1]) - s0,
            )
        )
    idx.paths = paths
    return idx, arrays


def iter_fastq(path: str) -> Iterator[Tuple[str, str]]:
    with xopen(path) as fh:
        while True:
            h = fh.readline()
            if not h:
                return
            seq = fh.readline().strip()
            fh.readline()
            fh.readline()
            yield h[1:].strip().split()[0], seq


def map_reads(
    gfa_path: str,
    fq1: str,
    fq2: Optional[str] = None,
    k: int = 21,
    out=sys.stdout,
    log=sys.stderr,
    engine: str = "auto",
    threads: int = 1,
    index_cache: Optional[str] = None,
) -> Tuple[int, int]:
    """Map reads; returns (mapped, total).

    ``index_cache``: directory holding a persisted index (``--index``).
    Loaded when present and fresh (GFA size+mtime, same k); otherwise the
    index builds normally and is saved there for the next invocation —
    replicate 2..N of an experiment skip the ~41 s genome-scale build.
    """
    native: Optional[NativePathAligner] = None
    index = None
    if index_cache and engine in ("auto", "native"):
        loaded = load_map_index(index_cache, gfa_path, k)
        if loaded is not None:
            index, arrays = loaded
            try:
                native = NativePathAligner(index, cached_arrays=arrays)
                print(f"[map] index cache hit: {index_cache}", file=log)
            except Exception as e:
                print(f"[map] cached index unusable ({e}); rebuilding", file=log)
                index = native = None
    if index is None:
        print("[map] loading graph & indexing paths..", file=log)
        index = PathIndex(load_alignment_paths(gfa_path), k=k)
    print(
        f"[map] indexed {len(index.paths)} paths, {len(index.kmers)} kmers",
        file=log,
    )
    if native is None and engine in ("auto", "native"):
        try:
            native = NativePathAligner(index)
            print("[map] native alignment core", file=log)
            if index_cache:
                try:
                    save_map_index(index, native, index_cache, gfa_path)
                    print(f"[map] index cached -> {index_cache}", file=log)
                except Exception as e:
                    print(f"[map] index cache save failed ({e})", file=log)
        except Exception as e:
            if engine == "native":
                raise
            print(f"[map] native core unavailable ({e}); python path", file=log)

    # fully-native batch path when writing to a real file descriptor
    if native is not None:
        try:
            out.flush()
            fd = out.fileno()
        except Exception:
            fd = None
        if fd is not None:
            from contextlib import nullcontext

            from pantas_tpu_torch.io.xopen import materialized

            # the C batch reader fopen()s the paths directly — compressed
            # FASTQs inflate once (gz bytes fgets-parsed as FASTQ would
            # silently emit garbage records)
            with materialized(fq1) as f1, (
                materialized(fq2) if fq2 else nullcontext(None)
            ) as f2:
                mapped, spliced, total = native.map_file(f1, f2, fd, threads)
            ph = native.phase_stats()
            reads = max(1, ph["reads"])
            print(
                "[map] phases (us/read, summed over threads): "
                + " ".join(
                    f"{k}={ph[k] / 1e3 / reads:.1f}"
                    for k in ("seed", "extend", "join", "mapq", "format", "io")
                )
                + f" best_piece_calls/read={ph['best_piece_calls'] / reads:.2f}",
                file=log,
            )
            print(
                f"[map] mapped {mapped}/{total} reads ({spliced} spliced joins)",
                file=log,
            )
            return mapped, total

    mapped = total = spliced = 0
    streams = [iter_fastq(fq1)]
    if fq2:
        streams.append(iter_fastq(fq2))
    for stream in streams:
        for name, seq in stream:
            total += 1
            if native is not None:
                res = native.align_to_gaf(name, seq)
                if res is None:
                    print(
                        "\t".join(
                            map(str, [name, len(seq), 0, 0, "+", "*", 0, 0, 0, 0, 0, 0])
                        ),
                        file=out,
                    )
                    continue
                line, n_pieces = res
                mapped += 1
                if n_pieces > 1:
                    spliced += 1
                print(line, file=out)
                continue
            aln = align_read(index, seq)
            if aln is None:
                print(
                    "\t".join(
                        map(str, [name, len(seq), 0, 0, "+", "*", 0, 0, 0, 0, 0, 0])
                    ),
                    file=out,
                )
                continue
            mapped += 1
            if len(aln.pieces) > 1:
                spliced += 1
            print(alignment_to_gaf(index, name, seq, aln), file=out)
    print(f"[map] mapped {mapped}/{total} reads ({spliced} spliced joins)", file=log)
    return mapped, total
