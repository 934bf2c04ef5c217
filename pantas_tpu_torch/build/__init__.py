"""Pangenome construction: FA + GTF + VCF -> annotated spliced pangenome.

A native, vg-free reimplementation of the reference build chain
(``build/build.smk``: vg construct / vg rna / vg gbwt / annotate.cpp):

* :mod:`construct` — reference + VCF -> variation graph with topologically
  sorted ids, reference path, and per-site allele node chains
  (replaces ``vg construct --alt-paths``, ``build.smk:73``),
* :mod:`transcripts` — GTF exons -> splice edges and haplotype-aware
  transcript projection with numpy signature dedup (replaces both
  ``vg rna`` passes, ``build.smk:88,161``),
* :mod:`annotate` — per-haplotype edge-set difference -> EX/JN tags,
  vectorized over packed u64 edge arrays (replaces ``annotate.cpp``),
* :mod:`reduce` / :mod:`combine` — gene-panel reduction and per-chromosome
  ID-shift merge (replaces ``reduce.py`` / ``combine.py``),
* :mod:`pipeline` — per-chromosome scatter orchestration (replaces the
  Snakemake DAG).
"""
