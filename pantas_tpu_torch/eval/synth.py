"""Synthetic inputs at scale, made from fixed seeds: a random reference with
a SNP VCF and a multi-isoform GTF (:func:`gen_inputs`), the annotated
pangenome built from them and cached under ``.bench/`` at the root of the
checkout (:func:`ensure_graph`), and a GAF of exact-match reads sampled along
the graph's own transcript paths (:func:`synth_gaf`).

They are this package's copies of the generators in
``scripts/stress_build.py`` and ``scripts/bench_call_scale.py``, with the
same seeds and the same cache directory, and write byte-identical files
(``tests/test_torch_host_copies.py`` holds them to that).
"""

from __future__ import annotations

import os
import random
import sys
import time
from bisect import bisect_right
from pathlib import Path

import numpy as np

CACHE = Path(__file__).resolve().parent.parent.parent / ".bench"
READ_LEN = 150


def log(msg):
    print(f"[synth] {msg}", file=sys.stderr, flush=True)


def gen_inputs(wd: Path, mbp=10.0, n_var=50_000, n_genes=400, n_samples=20,
               n_chroms=1, n_exons=5, n_tx=2):
    """Write synthetic FA/GTF/VCF into wd (``g.fa``, ``g.gtf``, ``g.vcf``),
    from a fixed seed. ``n_exons``/``n_tx`` control isoform richness:
    transcript 1 is the full exon chain, each further isoform varies a
    different internal exon (ES / A3 / A5 / IR in rotation)."""
    MBP, N_VAR, N_GENES, N_SAMPLES, N_CHROMS = mbp, n_var, n_genes, n_samples, n_chroms

    rng = np.random.default_rng(11)
    L = int(MBP * 1e6) // N_CHROMS
    bases = np.frombuffer(b"ACGT", dtype="S1")

    genes_per_chrom = N_GENES // N_CHROMS
    vars_per_chrom = N_VAR // N_CHROMS

    fa = open(wd / "g.fa", "w")
    gtf = open(wd / "g.gtf", "w")
    vcf = open(wd / "g.vcf", "w")
    vcf.write("##fileformat=VCFv4.2\n")
    vcf.write(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(f"s{i}" for i in range(N_SAMPLES))
        + "\n"
    )
    alt_of = {"A": "G", "C": "T", "G": "A", "T": "C"}
    for ci in range(N_CHROMS):
        chrom = f"chr{ci}"
        seq_arr = bases[rng.integers(0, 4, size=L)]
        seq = seq_arr.tobytes().decode()
        fa.write(f">{chrom}\n")
        for i in range(0, L, 10000):
            fa.write(seq[i : i + 10000] + "\n")

        span = L // (genes_per_chrom + 1)
        for gi in range(genes_per_chrom):
            gstart = span * (gi + 1)
            exons = [
                (gstart + k * 500 + 1, gstart + k * 500 + 200)
                for k in range(n_exons)
            ]
            for t in range(1, n_tx + 1):
                tid = f"T{ci}_{gi}_{t}"
                if t == 1:
                    ex = exons
                else:  # event-diverse isoforms: ES / A3 / A5 / IR rotation
                    k = 1 + (t - 2) % max(n_exons - 2, 1)
                    kind = (t - 2) % 4
                    if kind == 0:  # exon skipping
                        ex = exons[:k] + exons[k + 1 :]
                    elif kind == 1:  # alternative acceptor (start shifted)
                        s0, e0 = exons[k]
                        ex = exons[:k] + [(s0 + 60, e0)] + exons[k + 1 :]
                    elif kind == 2:  # alternative donor (end shifted)
                        s0, e0 = exons[k]
                        ex = exons[:k] + [(s0, e0 - 60)] + exons[k + 1 :]
                    else:  # intron retention: merge exon k with k+1
                        ex = (
                            exons[:k]
                            + [(exons[k][0], exons[k + 1][1])]
                            + exons[k + 2 :]
                        )
                gtf.write(
                    "\t".join(
                        [chrom, "s", "transcript", str(ex[0][0]), str(ex[-1][1]),
                         ".", "+", ".",
                         f'gene_id "G{ci}_{gi}"; transcript_id "{tid}";']) + "\n")
                for s, e in ex:
                    gtf.write(
                        "\t".join(
                            [chrom, "s", "exon", str(s), str(e), ".", "+", ".",
                             f'gene_id "G{ci}_{gi}"; transcript_id "{tid}";']) + "\n")

        positions = np.sort(
            rng.choice(np.arange(1, L + 1), size=vars_per_chrom, replace=False)
        )
        # genotype block: 1000G-like allele frequency mix
        afs = rng.choice([0.02, 0.05, 0.15, 0.4], size=vars_per_chrom)
        h = rng.random((vars_per_chrom, 2 * N_SAMPLES)) < afs[:, None]
        gt_chars = np.where(h, "1", "0")
        for vi, pos in enumerate(positions):
            ref = seq[pos - 1]
            row = gt_chars[vi]
            gts = "\t".join(
                row[2 * s] + "|" + row[2 * s + 1] for s in range(N_SAMPLES)
            )
            vcf.write(f"{chrom}\t{pos}\tv{ci}_{vi}\t{ref}\t{alt_of[ref]}\t.\t.\t.\tGT\t{gts}\n")
    fa.close()
    gtf.close()
    vcf.close()


def ensure_graph(mbp: float) -> Path:
    wd = CACHE / f"stress{mbp:g}m"
    gfa = wd / "out" / "pantranscriptome-annotated.gfa"
    if gfa.exists():
        return wd
    wd.mkdir(parents=True, exist_ok=True)
    n_chroms = max(1, int(mbp // 25))
    log(f"generating {mbp} Mbp inputs ({n_chroms} chroms)..")
    # Drosophila-like density: ~100 genes/Mbp, 6 isoforms x 8 exons per gene
    # (the call stage's cost drivers are junction count and label richness)
    gen_inputs(
        wd,
        mbp=mbp,
        n_var=int(mbp * 10_000),
        n_genes=int(mbp * 100),
        n_samples=20,
        n_chroms=n_chroms,
        n_exons=8,
        n_tx=6,
    )
    from pantas_tpu_torch.build.pipeline import build_pangenome

    t0 = time.time()
    build_pangenome(
        str(wd / "g.fa"), str(wd / "g.gtf"), str(wd / "g.vcf"),
        str(wd / "out"), threads=min(os.cpu_count() or 1, n_chroms),
    )
    log(f"build: {time.time() - t0:.1f}s")
    return wd


def synth_gaf(gfa: Path, n_reads: int, out_path: Path, seed: int = 7) -> None:
    """Sample exact-match reads along the graph's transcript paths.

    Each record walks real nodes of a real path with a consistent
    plen/pstart/pend and a `cs:Z::150` run — the same shape `vg mpmap`
    emits for a perfect alignment, so augment (ours or the reference's)
    accepts it unmodified.
    """
    from pantas_tpu_torch.native.gafcov import scan_gfa_structure

    ids, lens, _, _ = scan_gfa_structure(str(gfa))
    nlen = dict(zip((str(i) for i in ids), (int(l) for l in lens)))

    paths = []  # (nodes, cumlens)
    with open(gfa) as fh:
        for line in fh:
            if line[0] != "P":
                continue
            f = line.rstrip("\n").split("\t")
            name, steps = f[1], f[2]
            if "_R" not in name and "_H" not in name:
                continue  # walk transcript paths only
            nodes = [s[:-1] for s in steps.split(",")]
            cum = [0]
            for n in nodes:
                cum.append(cum[-1] + nlen[n])
            if cum[-1] >= READ_LEN:
                paths.append((nodes, cum))
    log(f"{len(paths)} transcript paths usable")
    rng = random.Random(seed)
    with open(out_path, "w") as out:
        for i in range(n_reads):
            nodes, cum = paths[rng.randrange(len(paths))]
            start = rng.randrange(cum[-1] - READ_LEN + 1)
            end = start + READ_LEN
            a = bisect_right(cum, start) - 1
            b = bisect_right(cum, end - 1) - 1
            walk = nodes[a : b + 1]
            plen = cum[b + 1] - cum[a]
            ps = start - cum[a]
            pe = ps + READ_LEN
            out.write(
                f"r{i}\t{READ_LEN}\t0\t{READ_LEN}\t+\t"
                f"{'>' + '>'.join(walk)}\t{plen}\t{ps}\t{pe}\t"
                f"{READ_LEN}\t{READ_LEN}\t60\tdv:f:0\tcs:Z::{READ_LEN}\n"
            )
