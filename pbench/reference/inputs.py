"""Inputs of every cell, made by the benchmark's own code from fixed seeds.

:func:`gen_inputs` is a frozen copy of ``pantas_tpu_torch/eval/synth.py::gen_inputs``
(a random reference, a SNP VCF and a multi-isoform GTF); :func:`ensure_graph`
builds a configuration's annotated pangenome with the frozen copy of the build code under
``pbench/.cache/<config>/`` once per checkout, and :func:`graph_tables` parses
that graph once into the arrays the traffic generators and the references read.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np

GFA_NAME = "pantranscriptome-annotated.gfa"


def log(msg):
    print(f"[pbench] {msg}", file=sys.stderr, flush=True)


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


def ensure_graph(name: str, graph: dict, cache: Path) -> Path:
    """The configuration's graph directory (``g.gtf``, ``out/<GFA_NAME>``,
    ``tables.npz``), built on first use into a fixed scratch name and renamed
    into place whole, so a cut build leaves nothing under the final name.

    The graph served is the one the build writes with ``graph["hp"]``. With
    ``hp=1`` it holds only the reference transcript paths, while reads come
    from the samples' haplotypes: the build then writes every haplotype copy
    (``hp=0``, unpruned, which differs from ``hp=1`` only in those ``P``
    lines), the tables are read from that, and the served graph is it with the
    haplotype copies' ``P`` lines left out."""
    final = cache / name
    if (final / "tables.npz").exists():
        return final
    tmp = cache / f"{name}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    mbp = float(graph["mbp"])
    if int(graph["seed"]) != 11:
        raise ValueError("gen_inputs draws from its fixed seed 11")
    hp = int(graph["hp"])
    if hp not in (0, 1):
        raise ValueError(f"hp={hp}: only 0 and 1 are built here")
    log(f"{name}: generating {mbp:g} Mbp inputs (one-time)")
    gen_inputs(tmp, mbp=mbp, n_var=int(mbp * graph["snps_per_mbp"]),
               n_genes=int(mbp * graph["genes_per_mbp"]), n_samples=graph["samples"],
               n_chroms=graph["chromosomes"], n_exons=graph["exons"], n_tx=graph["isoforms"])
    from pbench.reference.build.pipeline import build_pangenome

    build_pangenome(str(tmp / "g.fa"), str(tmp / "g.gtf"), str(tmp / "g.vcf"),
                    str(tmp / "out"), hp=0, threads=1, prune=bool(graph["prune"]) and hp == 0)
    shutil.rmtree(tmp / "out" / "chroms", ignore_errors=True)
    (tmp / "g.fa").unlink()
    (tmp / "g.vcf").unlink()
    gfa = tmp / "out" / GFA_NAME
    _write_tables(gfa, tmp / "tables.npz")
    if hp == 1:
        every = gfa.with_name("every-copy.gfa")
        os.replace(gfa, every)
        with open(every) as src, open(gfa, "w") as dst:
            dst.writelines(line for line in src if not _haplotype_copy(line))
        every.unlink()
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    return final


def _haplotype_copy(line: str) -> bool:
    """A ``P`` line of a haplotype's transcript copy (``<tid>_H<i>``)."""
    return line.startswith("P\t") and line.split("\t", 2)[1].rsplit("_", 1)[-1].startswith("H")


def _write_tables(gfa: Path, out: Path) -> None:
    """Parse the graph once: segment ids and lengths in file order, links in
    file order (as segment rows, and whether each is a splice junction, with a
    non-empty ``JN`` tag), and every transcript path (``_R``/``_H``
    copies) as rows, with the ``>id`` walk text of all paths end to end and
    each step's offset in it, so a record's walk is one slice."""
    ids, lens, l_src, l_dst, l_jn = [], [], [], [], []
    row = {}
    p_names, p_steps = [], []
    with open(gfa) as fh:
        for line in fh:
            c = line[0]
            if c == "S":
                f = line.split("\t", 3)
                row[f[1]] = len(ids)
                ids.append(int(f[1]))
                lens.append(len(f[2].rstrip("\n")))
            elif c == "L":
                f = line.split("\t", 4)
                l_src.append(row[f[1]])
                l_dst.append(row[f[3]])
                p = f[4].find("\tJN:Z:")
                l_jn.append(p != -1 and f[4][p + 6:p + 7] not in ("", "\t", "\n"))
            elif c == "P":
                f = line.split("\t", 3)
                if "_R" in f[1] or "_H" in f[1]:
                    p_names.append(f[1])
                    p_steps.append([row[s[:-1]] for s in f[2].rstrip("\n").split(",")])
    ids = np.asarray(ids, np.int64)
    lens = np.asarray(lens, np.int32)
    steps = np.fromiter((r for s in p_steps for r in s), np.int32)
    path_off = np.zeros(len(p_steps) + 1, np.int64)
    path_off[1:] = np.cumsum([len(s) for s in p_steps])
    tx = [n.rsplit("_", 1)[0] for n in p_names]  # T<c>_<g>_<t>_R1 / _H<k> -> T<c>_<g>_<t>
    tx_names, path_tx = np.unique(np.asarray(tx), return_inverse=True)
    tok = np.char.add(">", ids.astype(str))
    walk_text = "".join(tok[steps].tolist())
    tok_len = np.char.str_len(tok).astype(np.int64)
    char_off = np.zeros(len(steps) + 1, np.int64)
    char_off[1:] = np.cumsum(tok_len[steps])
    np.savez(out, ids=ids, lens=lens, l_src=np.asarray(l_src, np.int32),
             l_dst=np.asarray(l_dst, np.int32), l_jn=np.asarray(l_jn, bool), steps=steps, path_off=path_off,
             path_tx=path_tx.astype(np.int32), tx_names=tx_names,
             walk_text=np.frombuffer(walk_text.encode(), np.uint8), char_off=char_off)
    with open(out.with_suffix(".json"), "w") as fh:
        json.dump({"segments": len(ids), "links": len(l_src), "paths": len(p_steps),
                   "transcripts": len(tx_names), "steps": len(steps)}, fh)


class GraphTables:
    """The arrays of :func:`_write_tables`, loaded."""

    def __init__(self, graph_dir: Path):
        z = np.load(graph_dir / "tables.npz")
        self.dir = graph_dir
        self.gfa = graph_dir / "out" / GFA_NAME
        self.ids, self.lens = z["ids"], z["lens"]
        self.l_src, self.l_dst, self.l_jn = z["l_src"], z["l_dst"], z["l_jn"]
        self.steps, self.path_off = z["steps"], z["path_off"]
        self.path_tx, self.tx_names = z["path_tx"], z["tx_names"]
        self.walk_text = z["walk_text"].tobytes().decode()
        self.char_off = z["char_off"]
        # the same walks reversed, ``<id`` a step, for reverse records: step
        # ``len(steps) - 1 - i`` of this text is step ``i`` of the forward one
        tok_len = np.diff(self.char_off)[::-1]
        self.reverse_char_off = np.zeros(len(tok_len) + 1, np.int64)
        self.reverse_char_off[1:] = np.cumsum(tok_len)
        self.reverse_walk_text = "<" + "<".join(reversed(self.walk_text[1:].split(">")))
        # bp offset of every step when all paths are laid end to end
        step_len = self.lens[self.steps].astype(np.int64)
        self.step_start = np.zeros(len(step_len) + 1, np.int64)
        self.step_start[1:] = np.cumsum(step_len)
        self.path_bp = self.step_start[self.path_off]  # (P + 1,)
