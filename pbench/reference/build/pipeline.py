"""Build orchestration: per-chromosome scatter -> annotated spliced pangenome.

Replaces the reference's Snakemake DAG (``build/build.smk``): chromosomes
(taken from the GTF, as ``build.smk:14-18``) build independently — the
natural host-level task parallelism — and merge with id-shifting.

Outputs (under ``outdir``):

* ``chroms/{c}/pantranscriptome-annotated.gfa`` — per-chromosome graphs
* ``pantranscriptome-annotated.gfa`` — the combined annotated pangenome
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

from pbench.reference.build.annotate import annotate, write_annotated_gfa
from pbench.reference.build.construct import DEFAULT_MAX_NODE_LEN, accept_variants, construct
from pbench.reference.build.combine import combine_gfas
from pbench.reference.build.reduce import transcript_intervals
from pbench.reference.build.transcripts import project, validate_paths
from pbench.reference.io.fasta import read_fasta_record
from pbench.reference.io.gtf import chromosomes, parse_transcript_models
from pbench.reference.io.vcf import read_vcf


def prune_keep_nodes(graph, ptx) -> set:
    """Restore-compatible prune set for hp=0: the native analogue of
    ``vg prune --restore-paths`` (reference ``build/build.smk:165-178``).

    vg prunes complex regions then restores everything on GBWT-threaded
    paths; the net graph keeps reference + carried haplotype + transcript
    material and drops unthreaded complexity. Here that is exactly: the
    reference path, every emitted transcript copy, and the alternate
    chains of alleles CARRIED by at least one haplotype — alt nodes of
    alleles nobody carries are the unthreaded material and are dropped.
    """
    import numpy as np

    keep = set(graph.ref_path)
    for c in ptx.copies:
        keep.update(c.path)
    A = ptx.alleles
    if A is not None and A.size:
        for si, site in enumerate(graph.sites):
            for a in np.unique(A[:, si]):
                a = int(a)
                if a > 0 and a in site.alt_nodes:
                    keep.update(site.alt_nodes[a])
    return keep


def build_chromosome(
    chrom: str,
    fa_path: str,
    gtf_path: str,
    vcf_path: str,
    out_gfa: str,
    hp: int = 0,
    max_node_len: int = DEFAULT_MAX_NODE_LEN,
    w_lines: bool = False,
    prune: bool = True,
    log=sys.stderr,
) -> str:
    t0 = time.time()
    seq = read_fasta_record(fa_path, chrom)

    models = [
        t for t in parse_transcript_models(gtf_path).values() if t.chrom == chrom
    ]
    samples, variants = read_vcf(vcf_path, chrom)
    accepted, _ = accept_variants(variants, seq, log)

    exon_bounds = [span for t in models for span in t.exons]
    graph = construct(
        chrom, seq, accepted, exon_bounds, max_node_len=max_node_len, log=log,
        prefiltered=True,
    )
    ptx = project(graph, models, accepted, samples, log=log)
    validate_paths(ptx)
    ann = annotate(ptx, log=log)

    keep = None
    if hp == 2:
        keep = transcript_intervals([c.path for c in ptx.copies])
    elif hp == 0 and prune:
        keep = prune_keep_nodes(graph, ptx)
        dropped = graph.n_nodes() - len(keep)
        if dropped:
            print(f"[build:{chrom}] prune: dropped {dropped} unthreaded nodes", file=log)
        else:
            keep = None  # fully threaded graph: pruning is a no-op

    os.makedirs(os.path.dirname(out_gfa), exist_ok=True)
    with open(out_gfa, "w") as fh:
        write_annotated_gfa(ptx, ann, fh, hp=hp, keep_nodes=keep, w_lines=w_lines)
    print(
        f"[build:{chrom}] {graph.n_nodes()} nodes, {len(graph.edges)} edges, "
        f"{len(ptx.copies)} transcript copies, {len(graph.sites)} sites "
        f"({time.time() - t0:.1f}s)",
        file=log,
    )
    return out_gfa


def _build_one(args) -> str:
    return build_chromosome(*args)


def build_pangenome(
    fa_path: str,
    gtf_path: str,
    vcf_path: str,
    outdir: str,
    hp: int = 0,
    threads: int = 8,
    max_node_len: int = DEFAULT_MAX_NODE_LEN,
    w_lines: bool = False,
    chroms: Optional[List[str]] = None,
    prune: bool = True,
    log=sys.stderr,
) -> str:
    os.makedirs(outdir, exist_ok=True)
    if chroms is None:
        chroms = chromosomes(gtf_path)
    jobs = [
        (
            c,
            fa_path,
            gtf_path,
            vcf_path,
            os.path.join(outdir, "chroms", c, "pantranscriptome-annotated.gfa"),
            hp,
            max_node_len,
            w_lines,
            prune,
        )
        for c in chroms
    ]
    if threads > 1 and len(jobs) > 1:
        # spawn, not fork: the parent may have initialized JAX (multithreaded),
        # and forking a multithreaded process can deadlock the children
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(
            max_workers=min(threads, len(jobs)), mp_context=ctx
        ) as ex:
            per_chrom = list(ex.map(_build_one, jobs))
    else:
        per_chrom = [_build_one(j) for j in jobs]

    combined = os.path.join(outdir, "pantranscriptome-annotated.gfa")
    with open(combined, "w") as fh:
        combine_gfas(per_chrom, fh, log=log)
    print(f"[build] wrote {combined}", file=log)
    return combined
