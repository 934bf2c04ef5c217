"""The annotation of the call's configuration: the frozen recipe of
:mod:`pbench.reference.inputs` with one alternative isoform a gene, whose
kind turns from gene to gene.

The frozen recipe gives every gene the same isoforms. At two a gene, as dm6
has, the second is always an exon skip, so a call finds no A3, A5 or IR
there. Here gene ``g``'s second transcript varies one internal exon of its
full chain by kind ``g % 4``: an exon skip, an acceptor 60 bp in, a donor 60
bp in, or a retained intron, at exons 1, 2, 3 and 1, as the frozen recipe's
isoforms 2 to 5 vary them. Sequence, SNPs and gene placement are the frozen
recipe's, drawn from the same seed: :func:`gen_inputs` writes them with
one transcript a gene, then adds each gene's second to the GTF.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

from pbench.reference import inputs
from pbench.reference.inputs import GFA_NAME, log


def variant(exons: list, kind: int) -> list:
    """The full exon chain ``exons`` varied by ``kind`` (0 ES, 1 A3, 2 A5,
    3 IR) at internal exon ``1 + kind % (len(exons) - 2)``."""
    k = 1 + kind % max(len(exons) - 2, 1)
    s0, e0 = exons[k]
    if kind == 0:
        return exons[:k] + exons[k + 1:]
    if kind == 1:
        return exons[:k] + [(s0 + 60, e0)] + exons[k + 1:]
    if kind == 2:
        return exons[:k] + [(s0, e0 - 60)] + exons[k + 1:]
    return exons[:k] + [(s0, exons[k + 1][1])] + exons[k + 2:]


def _gtf_line(fields: list, feature: str, s: int, e: int, attrs: str) -> str:
    return "\t".join([*fields[:2], feature, str(s), str(e), *fields[5:8], attrs]) + "\n"


def gen_inputs(wd: Path, n_exons: int, **kw) -> None:
    """The frozen recipe's ``g.fa``, ``g.vcf`` and full chains, with each
    gene's rotated second isoform (``T<c>_<g>_2``) after its first."""
    inputs.gen_inputs(wd, n_exons=n_exons, n_tx=1, **kw)
    if n_exons < 5:
        raise ValueError("the four kinds need three internal exons")
    gtf = wd / "g.gtf"
    lines = gtf.read_text().splitlines(keepends=True)
    out = []
    for i in range(0, len(lines), n_exons + 1):  # a transcript line, then its exons
        block = lines[i:i + n_exons + 1]
        out += block
        fields = block[0].split("\t")
        gene = fields[8].split('"')[1]  # G<c>_<g>
        tid = f"T{gene[1:]}_2"
        attrs = f'gene_id "{gene}"; transcript_id "{tid}";'
        exons = [tuple(int(x) for x in b.split("\t")[3:5]) for b in block[1:]]
        ex = variant(exons, int(gene.rsplit("_", 1)[1]) % 4)
        out.append(_gtf_line(fields, "transcript", ex[0][0], ex[-1][1], attrs))
        out += [_gtf_line(fields, "exon", s, e, attrs) for s, e in ex]
    gtf.write_text("".join(out))


def ensure_graph(name: str, graph: dict, cache: Path) -> Path:
    """:func:`pbench.reference.inputs.ensure_graph` for this annotation:
    built on first use under ``cache/name`` (a scratch name renamed into place
    whole), and served as ``graph["hp"]`` says."""
    final = cache / name
    if (final / "tables.npz").exists():
        return final
    if int(graph["seed"]) != 11 or int(graph["isoforms"]) != 2:
        raise ValueError("the rotated recipe draws from seed 11 with two isoforms a gene")
    hp = int(graph["hp"])
    if hp not in (0, 1):
        raise ValueError(f"hp={hp}: only 0 and 1 are built here")
    tmp = cache / f"{name}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    mbp = float(graph["mbp"])
    log(f"{name}: generating {mbp:g} Mbp inputs, kinds rotating (one-time)")
    gen_inputs(tmp, mbp=mbp, n_var=int(mbp * graph["snps_per_mbp"]),
               n_genes=int(mbp * graph["genes_per_mbp"]), n_samples=graph["samples"],
               n_chroms=graph["chromosomes"], n_exons=graph["exons"])
    from pbench.reference.build.pipeline import build_pangenome

    build_pangenome(str(tmp / "g.fa"), str(tmp / "g.gtf"), str(tmp / "g.vcf"),
                    str(tmp / "out"), hp=0, threads=1, prune=bool(graph["prune"]) and hp == 0)
    shutil.rmtree(tmp / "out" / "chroms", ignore_errors=True)
    (tmp / "g.fa").unlink()
    (tmp / "g.vcf").unlink()
    gfa = tmp / "out" / GFA_NAME
    inputs._write_tables(gfa, tmp / "tables.npz")
    if hp == 1:  # the served graph: the haplotype copies' P lines left out
        every = gfa.with_name("every-copy.gfa")
        os.replace(gfa, every)
        with open(every) as src, open(gfa, "w") as dst:
            dst.writelines(line for line in src if not inputs._haplotype_copy(line))
        every.unlink()
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    return final
