"""Mapper accuracy + MAPQ calibration harness.

The mapper replaces ``vg mpmap`` as the GAF producer (reference
``README.md:97-101``), so its placement quality bounds the framework's
real-world recall. This harness quantifies it: reads are sampled from the
graph's indexed alignment paths, mutated at a controlled divergence rate
(plus a sequencing-error rate), mapped, and scored against their known
source interval.

Correctness criterion: the mapped walk's node-id interval must intersect
the truth node-id interval (node ids are topologically sorted per
chromosome — ``build/combine.py`` invariant — so interval intersection is
locus identity, tolerant of transcript-path multiplicity at the same locus).

MAPQ calibration: per-MAPQ-bin empirical wrong-placement rates, so the
``mapq >= 20`` augment filter (reference
``alignments_augmentation_from_gaf.py:143-145``) has a measured meaning
on our GAF.
"""

from __future__ import annotations

import random
import sys
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from pantas_tpu_torch.io.fasta import revcomp
from pantas_tpu_torch.mapping.mapper import (
    NativePathAligner,
    PathIndex,
    align_read,
    alignment_to_gaf,
    load_alignment_paths,
)

MAPQ_BINS = ((0, 0), (1, 19), (20, 59), (60, 60))


@dataclass
class TruthRead:
    name: str
    seq: str
    node_lo: int
    node_hi: int


@dataclass
class BinStats:
    n: int = 0
    wrong: int = 0

    @property
    def err(self) -> float:
        return self.wrong / self.n if self.n else 0.0


@dataclass
class AccuracyResult:
    divergence: float
    total: int
    mapped: int = 0
    correct: int = 0
    mapped_q20: int = 0
    correct_q20: int = 0
    bins: Dict[Tuple[int, int], BinStats] = field(
        default_factory=lambda: {b: BinStats() for b in MAPQ_BINS}
    )

    def row(self) -> str:
        return (
            f"{self.divergence:.3f},{self.total},{self.mapped},"
            f"{self.mapped / self.total:.4f},"
            f"{(self.correct / self.mapped) if self.mapped else 0:.4f},"
            f"{self.mapped_q20},"
            f"{(self.correct_q20 / self.mapped_q20) if self.mapped_q20 else 0:.4f}"
        )


from pantas_tpu_torch.eval.simulate import _mutate  # one mutation model for
# both harnesses — a verbatim copy here could silently diverge


def sample_reads(
    index: PathIndex,
    n_reads: int,
    read_len: int,
    divergence: float,
    error_rate: float,
    rng: random.Random,
) -> List[TruthRead]:
    paths = [p for p in index.paths if len(p.seq) >= read_len]
    weights = [len(p.seq) for p in paths]
    reads: List[TruthRead] = []
    for i in range(n_reads):
        rec = rng.choices(paths, weights=weights)[0]
        start = rng.randrange(0, len(rec.seq) - read_len + 1)
        frag = rec.seq[start : start + read_len]
        frag = _mutate(frag, rng, divergence)
        frag = _mutate(frag, rng, error_rate)
        if rng.random() < 0.5:
            frag = revcomp(frag)
        i0 = bisect_right(rec.offsets, start) - 1
        i1 = bisect_right(rec.offsets, start + read_len - 1) - 1
        ids = sorted(int(rec.nodes[j]) for j in (i0, i1))
        reads.append(TruthRead(f"sim{i}", frag, ids[0], ids[1]))
    return reads


def _walk_interval(path_field: str) -> Optional[Tuple[int, int]]:
    if path_field in ("*", ""):
        return None
    sep = path_field[0]
    ids = [int(x) for x in path_field[1:].split(sep)]
    return min(ids), max(ids)


def evaluate(
    gfa_path: str,
    divergences=(0.0, 0.01, 0.02, 0.05),
    n_reads: int = 2000,
    read_len: int = 150,
    error_rate: float = 0.001,
    seed: int = 11,
    engine: str = "auto",
    log=sys.stderr,
) -> List[AccuracyResult]:
    index = PathIndex(load_alignment_paths(gfa_path))
    native: Optional[NativePathAligner] = None
    if engine in ("auto", "native"):
        try:
            native = NativePathAligner(index)
        except Exception:
            if engine == "native":
                raise

    results: List[AccuracyResult] = []
    for div in divergences:
        rng = random.Random(seed)
        reads = sample_reads(index, n_reads, read_len, div, error_rate, rng)
        res = AccuracyResult(divergence=div, total=len(reads))
        for tr in reads:
            line = None
            if native is not None:
                hit = native.align_to_gaf(tr.name, tr.seq)
                line = hit[0] if hit else None
            else:
                aln = align_read(index, tr.seq)
                if aln is not None:
                    line = alignment_to_gaf(index, tr.name, tr.seq, aln)
            if line is None:
                continue
            f = line.split("\t")
            iv = _walk_interval(f[5])
            if iv is None:
                continue
            mapq = int(f[11])
            res.mapped += 1
            ok = not (iv[1] < tr.node_lo or iv[0] > tr.node_hi)
            if ok:
                res.correct += 1
            if mapq >= 20:
                res.mapped_q20 += 1
                if ok:
                    res.correct_q20 += 1
            for b in MAPQ_BINS:
                if b[0] <= mapq <= b[1]:
                    st = res.bins[b]
                    st.n += 1
                    if not ok:
                        st.wrong += 1
        results.append(res)
        print(
            f"[map-accuracy] div={div:.3f}: mapped {res.mapped}/{res.total}, "
            f"correct {res.correct}/{res.mapped}, "
            f"q>=20 correct {res.correct_q20}/{res.mapped_q20}",
            file=log,
        )
    return results


def report(results: List[AccuracyResult], out=sys.stdout) -> None:
    print(
        "divergence,total,mapped,mapped_frac,correct_frac,mapped_q20,correct_q20_frac",
        file=out,
    )
    for r in results:
        print(r.row(), file=out)
    print("# MAPQ calibration (bin,n,wrong,empirical_error) per divergence", file=out)
    for r in results:
        for b, st in r.bins.items():
            print(
                f"# div={r.divergence:.3f} mapq {b[0]}-{b[1]}: "
                f"n={st.n} wrong={st.wrong} err={st.err:.4f}",
                file=out,
            )
