"""Minimal VCF parser (build layer: graph construction + haplotype threading).

Only what construction needs: positions, REF/ALT alleles, sample names, and
per-sample genotype allele indices. Symbolic alleles (``<...>``) are skipped,
matching the reference's haplotype synthesizer
(``scripts/add_haplotypes.py:39-41``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from pbench.reference.xopen import xopen


@dataclass
class VcfVariant:
    chrom: str
    pos: int  # 1-based
    vid: str
    ref: str
    alts: Tuple[str, ...]
    # per-sample (h1, h2) allele indices; None where the call is missing ('.')
    genotypes: List[Tuple[Optional[int], Optional[int]]]
    phased: List[bool]

    @property
    def end(self) -> int:
        """1-based inclusive end of the REF allele span."""
        return self.pos + len(self.ref) - 1


def _open(path: str):
    # one compression layer for every stage input (adds .zst over the
    # old inline gzip special-case)
    return xopen(path)


_GT_CACHE: dict = {}


def _parse_gt(gt_field: str) -> Tuple[Tuple[Optional[int], Optional[int]], bool]:
    # genotype strings repeat massively across samples/variants: memoize
    cached = _GT_CACHE.get(gt_field)
    if cached is not None:
        return cached
    gt = gt_field.split(":", 1)[0]
    phased = "|" in gt
    parts = gt.replace("|", "/").split("/")
    idx: List[Optional[int]] = []
    for p in parts[:2]:
        idx.append(None if p in (".", "") else int(p))
    while len(idx) < 2:
        idx.append(idx[0] if idx else None)
    result = ((idx[0], idx[1]), phased)
    if len(_GT_CACHE) < 65536:
        _GT_CACHE[gt_field] = result
    return result


def read_vcf(path: str, chrom: Optional[str] = None) -> Tuple[List[str], List[VcfVariant]]:
    """Return (sample names, variants), optionally restricted to one chrom."""
    samples: List[str] = []
    variants: List[VcfVariant] = []
    for rec in iter_vcf(path, chrom, samples):
        variants.append(rec)
    return samples, variants


def iter_vcf(
    path: str, chrom: Optional[str] = None, samples_out: Optional[List[str]] = None
) -> Iterator[VcfVariant]:
    with _open(path) as fh:
        for line in fh:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                cols = line.rstrip("\n").split("\t")
                if samples_out is not None:
                    samples_out.extend(cols[9:])
                continue
            cols = line.rstrip("\n").split("\t")
            if chrom is not None and cols[0] != chrom:
                continue
            alts = tuple(cols[4].split(","))
            if any(a.startswith("<") for a in alts):
                continue
            gts = []
            phased = []
            for s in cols[9:]:
                g, ph = _parse_gt(s)
                gts.append(g)
                phased.append(ph)
            yield VcfVariant(
                chrom=cols[0],
                pos=int(cols[1]),
                vid=cols[2],
                ref=cols[3],
                alts=alts,
                genotypes=gts,
                phased=phased,
            )


def write_vcf_excluding_sample(in_path: str, out_path: str, sample: str) -> None:
    """Copy a VCF dropping one sample's genotype column.

    The held-out-sample protocol of the simulation experiment (reference
    ``exps/1-dm-sim/workflow/rules/pantas.smk:1-10``): reads are simulated
    from a sample's haplotype consensus while the graph is built WITHOUT
    that sample, so haplotype-awareness is tested without leakage.
    """
    drop: Optional[int] = None
    out = xopen(out_path, "wt")
    with out:
        with _open(in_path) as fh:
            for line in fh:
                if line.startswith("##"):
                    out.write(line)
                    continue
                cols = line.rstrip("\n").split("\t")
                if line.startswith("#CHROM"):
                    if sample not in cols[9:]:
                        raise KeyError(f"sample {sample!r} not in {in_path}")
                    drop = cols.index(sample)
                if drop is not None:
                    cols = cols[:drop] + cols[drop + 1 :]
                out.write("\t".join(cols) + "\n")
    if drop is None:
        raise ValueError(f"no #CHROM header in {in_path}")


def consensus_snps(
    ref_by_chrom: Dict[str, str], vcf_path: str, sample: str, hap: int
) -> Dict[str, str]:
    """Apply one haplotype's SNP alleles to the reference sequences.

    SNPs only (the reference simulation uses DGRP2 SNPs with bcftools
    consensus, ``rules/simulation.smk:1-35``): indels would shift GTF
    coordinates, so they are skipped. ``hap`` is 1 or 2.
    """
    samples: List[str] = []
    muts: Dict[str, List[Tuple[int, str]]] = {}
    for v in iter_vcf(vcf_path, None, samples):
        if v.chrom not in ref_by_chrom:
            continue
        if len(v.ref) != 1 or any(len(a) != 1 for a in v.alts):
            continue
        try:
            si = samples.index(sample)
        except ValueError:
            raise KeyError(f"sample {sample!r} not in {vcf_path}")
        a = v.genotypes[si][hap - 1] or 0
        if a:
            muts.setdefault(v.chrom, []).append((v.pos, v.alts[a - 1]))
    out = {}
    for chrom, seq in ref_by_chrom.items():
        if chrom not in muts:
            out[chrom] = seq
            continue
        s = list(seq)
        for pos, alt in muts[chrom]:
            s[pos - 1] = alt
        out[chrom] = "".join(s)
    return out
