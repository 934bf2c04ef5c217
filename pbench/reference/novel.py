"""The annotation of the novel call's configuration: the frozen recipe of
:mod:`pbench.reference.inputs` with a second isoform a gene that the served
graph leaves out, as the novel mode of a simulation leaves its simulated
isoforms out of the build, so that the call finds them only in its novel pass.

Gene ``g`` has two transcripts. ``T<c>_<g>_1``, the served one, is the full
exon chain. ``T<c>_<g>_2``, the event, varies it by kind ``g % 5``: an exon
skip, an acceptor 60 bp in, a donor 60 bp in or a retained intron, as
:func:`pbench.reference.rotated.variant` makes them, or a 60-bp cassette exon
in the middle of the intron after internal exon 2. Sequence, SNPs and gene
placement are the frozen recipe's, drawn from the same seed.

The graph is built once with both isoforms by the benchmark's own build, so
its node boundaries fall at the event's splice sites too, and the walk tables
hold every copy of both: the reads walk the events. The graph served is that
graph with the events taken out: their labels in ``EX`` and ``JN`` tags (a
tag left empty goes), their ``P`` lines, their GTF records, and each link
that carries none of the served isoforms' junctions but some of the events'.
Every link a graph built without the events would have stays: those between
genome-adjacent bases carry no ``JN`` tag, and a served junction keeps its
link. A read across a removed splice link then makes a novel link in the
augment; a read through a retained intron walks links that are there.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

from pbench.reference import inputs, rotated
from pbench.reference.inputs import GFA_NAME, log

KINDS = ("ES", "A3", "A5", "IR", "CE")
CASSETTE_BP = 60
CASSETTE_EXON = 2  # the cassette sits in the intron after this exon


def variant(exons: list, kind: int) -> list:
    """The full exon chain ``exons`` varied by ``kind`` (an index of
    :data:`KINDS`)."""
    if kind < 4:
        return rotated.variant(exons, kind)
    k = CASSETTE_EXON
    if not 0 < k < len(exons) - 2:
        raise ValueError("the cassette needs an internal intron after exon 2")
    intron = exons[k + 1][0] - exons[k][1] - 1
    start = exons[k][1] + 1 + (intron - CASSETTE_BP) // 2
    return exons[:k + 1] + [(start, start + CASSETTE_BP - 1)] + exons[k + 1:]


def event_transcript(tid: str) -> bool:
    """``T<c>_<g>_2`` is gene ``g``'s event."""
    return tid.endswith("_2")


def gen_inputs(wd: Path, n_exons: int, **kw) -> None:
    """The frozen recipe's ``g.fa`` and ``g.vcf``; ``all.gtf`` with each
    gene's served chain and its event after it, and ``g.gtf`` with the served
    chains alone."""
    inputs.gen_inputs(wd, n_exons=n_exons, n_tx=1, **kw)
    if n_exons < 5:
        raise ValueError("the five kinds need three internal exons")
    served = (wd / "g.gtf").read_text().splitlines(keepends=True)
    out = []
    for i in range(0, len(served), n_exons + 1):  # a transcript line, then its exons
        block = served[i:i + n_exons + 1]
        out += block
        fields = block[0].split("\t")
        gene = fields[8].split('"')[1]  # G<c>_<g>
        attrs = f'gene_id "{gene}"; transcript_id "T{gene[1:]}_2";'
        exons = [tuple(int(x) for x in b.split("\t")[3:5]) for b in block[1:]]
        ex = variant(exons, int(gene.rsplit("_", 1)[1]) % len(KINDS))
        out.append(rotated._gtf_line(fields, "transcript", ex[0][0], ex[-1][1], attrs))
        out += [rotated._gtf_line(fields, "exon", s, e, attrs) for s, e in ex]
    (wd / "all.gtf").write_text("".join(out))


def _label_transcript(label: str) -> str:
    """``T_H.e`` or ``T_H.e1.e2`` -> ``T``."""
    return label.split(".", 1)[0].rpartition("_")[0]


def _served_tag(line: str, key: str) -> str:
    """``line`` (stripped) with the events' labels taken out of its ``key``
    tag, and the tag taken out where none is left."""
    fields = line.split("\t")
    for i, f in enumerate(fields):
        if f.startswith(key):
            kept = [x for x in f[len(key):].split(",") if x and not event_transcript(_label_transcript(x))]
            if kept:
                fields[i] = key + ",".join(kept)
            else:
                del fields[i]
            break
    return "\t".join(fields)


def _events_only(line: str) -> bool:
    """An ``L`` line whose ``JN`` labels are all the events'."""
    for f in line.split("\t")[5:]:
        if f.startswith("JN:Z:"):
            labels = [x for x in f[5:].split(",") if x]
            return bool(labels) and all(event_transcript(_label_transcript(x)) for x in labels)
    return False


def serve(every: Path, served: Path, view: Path, hp: int) -> dict:
    """Write the served graph and the view the tables are read from (the
    served ``S`` and ``L`` lines, then every copy's ``P`` line); returns what
    was taken out."""
    gone = {"links": 0, "paths": 0}
    with open(every) as src, open(served, "w") as dst, open(view, "w") as tab:
        for line in src:
            c = line[0]
            if c == "S":
                line = _served_tag(line.rstrip("\n"), "EX:Z:") + "\n"
                tab.write(line)
            elif c == "L":
                if _events_only(line.rstrip("\n")):
                    gone["links"] += 1
                    continue
                line = _served_tag(line.rstrip("\n"), "JN:Z:") + "\n"
                tab.write(line)
            elif c == "P":
                name = line.split("\t", 2)[1]
                tab.write(line)
                copy = name.rsplit("_", 1)
                if len(copy) == 2 and copy[1][:1] in ("R", "H"):  # T<c>_<g>_<t>_R1 / _H<k>
                    if event_transcript(copy[0]) or (hp == 1 and inputs._haplotype_copy(line)):
                        gone["paths"] += 1
                        continue
            dst.write(line)
    return gone


def ensure_graph(name: str, graph: dict, cache: Path) -> Path:
    """:func:`pbench.reference.inputs.ensure_graph` for this annotation:
    built on first use under ``cache/name`` (a scratch name renamed into place
    whole), and served without the events, with ``graph["hp"]``'s paths."""
    final = cache / name
    if (final / "tables.npz").exists():
        return final
    if int(graph["seed"]) != 11 or int(graph["isoforms"]) != 2:
        raise ValueError("the novel recipe draws from seed 11 with two isoforms a gene")
    hp = int(graph["hp"])
    if hp not in (0, 1):
        raise ValueError(f"hp={hp}: only 0 and 1 are built here")
    tmp = cache / f"{name}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    mbp = float(graph["mbp"])
    log(f"{name}: generating {mbp:g} Mbp inputs, events left out of the served graph (one-time)")
    gen_inputs(tmp, mbp=mbp, n_var=int(mbp * graph["snps_per_mbp"]),
               n_genes=int(mbp * graph["genes_per_mbp"]), n_samples=graph["samples"],
               n_chroms=graph["chromosomes"], n_exons=graph["exons"])
    from pbench.reference.build.pipeline import build_pangenome

    build_pangenome(str(tmp / "g.fa"), str(tmp / "all.gtf"), str(tmp / "g.vcf"),
                    str(tmp / "out"), hp=0, threads=1, prune=False)
    shutil.rmtree(tmp / "out" / "chroms", ignore_errors=True)
    for f in ("g.fa", "g.vcf", "all.gtf"):
        (tmp / f).unlink()
    gfa = tmp / "out" / GFA_NAME
    every = gfa.with_name("every-copy.gfa")
    view = gfa.with_name("tables-view.gfa")
    os.replace(gfa, every)
    gone = serve(every, gfa, view, hp)
    every.unlink()
    inputs._write_tables(view, tmp / "tables.npz")
    view.unlink()
    log(f"{name}: served without the events: {gone['links']} links and {gone['paths']} paths out")
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    return final
