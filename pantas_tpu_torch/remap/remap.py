"""Remap quantified events from graph junction labels to linear coordinates.

Behavioral contract: ``scripts/remap.py`` of the reference — byte-identical
output on the same (quant CSV, GTF) inputs.

Preserved reference quirks:

* only ``_R*`` (reference-haplotype) transcripts yield coordinates; events
  whose labels are all haplotype-only become ``?`` positions and may be
  classified ``haplotype``,
* in the annotated A-type reorder branch where positions[0] is ``?``, the
  double assignment ends up clobbering BOTH positions to ``?``
  (``remap.py:155-160``) — the real coordinate is lost,
* A-type junctions reorder shorter-first with W/psi swap and ΔPSI sign
  flip; annotated IR always swaps to put the retained intron first,
* novel events drop when any mapped region is shorter than the minimum
  intron size.
"""

from __future__ import annotations
from pantas_tpu_torch.io.xopen import xopen

from typing import Iterator, List, Optional, Sequence, TextIO, Tuple

from pantas_tpu_torch.io.gtf import parse_exons

REMAP_HEADER = ",".join(
    [
        "etype",
        "annotation_type",
        "haplotype_type",
        "chrom",
        "gene",
        "strand",
        "junction1_name",
        "junction2_name",
        "junction3_name",
        "junction1_nodes",
        "junction2_nodes",
        "junction3_nodes",
        "junction1_positions",
        "junction2_positions",
        "junction3_positions",
        "W1",
        "W2",
        "psi_c1",
        "psi_c2",
        "dpsi",
    ]
)


def reference_label(names: str) -> str:
    """Pick the reference-haplotype (``_R*``) label out of a '|' list, else '?'."""
    for x in names.split("|"):
        if x.split("_")[-1][0] == "R":
            return x
    return "?"


def region_bounds(region: str) -> Tuple[str, int, int, bool]:
    if region == "?":
        return "?", -1, -1, True
    imprecise = region.endswith("?")
    if imprecise:
        region = region[:-1]
    chrom, span = region.split(":")
    s, e = span.split("-")
    return chrom, int(s), int(e), imprecise


def region_size(region: str) -> int:
    _, span = region.split(":")
    s, e = span.split("-")
    return int(e) - int(s)


def _label_position(label: str, chrom: str, exons_by_tid) -> str:
    """Junction/exon label -> linear region string (or '?')."""
    if label == "?":
        return "?"
    head = label.split(".")[0]
    tid = "_".join(head.split("_")[:-1])
    imprecise = head.split("_")[-1][0] == "H"
    exon_nums = [int(n) for n in label.split(".")[1:]]
    assert len(exon_nums) <= 2
    if len(exon_nums) == 0:
        return "?"
    spans = exons_by_tid[tid]
    if len(exon_nums) == 1:
        # intron retention: the full exon span
        s, e = spans[exon_nums[0] - 1]
    else:
        # splice junction: the intron between the two exons
        e1, e2 = exon_nums
        s = spans[e1 - 1][1] + 1
        e = spans[e2 - 1][0] - 1
    assert s <= e
    return f"{chrom}:{s}-{e}" + ("?" if imprecise else "")


def remap(
    csv_path: str,
    gtf_path: str,
    min_intron_size: int = 100,
    out: Optional[TextIO] = None,
) -> Iterator[str]:
    """Yield remapped CSV lines (header first); optionally write to ``out``."""

    def _gen():
        # pass 1: which reference transcripts do we need exon spans for?
        wanted = set()
        for line in xopen(csv_path):
            if line.startswith("etype"):
                continue
            names3 = line.strip("\n").split(",")[5:8]
            for t in map(reference_label, names3):
                if t != "?":
                    wanted.add("_".join(t.split(".")[0].split("_")[:-1]))
        exons_by_tid = parse_exons(gtf_path, wanted)

        yield REMAP_HEADER

        for line in xopen(csv_path):
            if line.startswith("etype"):
                continue
            (
                etype,
                annotation_type,
                chrom,
                gene,
                strand,
                j1_names,
                j2_names,
                j3_names,
                j1_nodes,
                j2_nodes,
                j3_nodes,
                w1,
                w2,
                psi_c1,
                psi_c2,
                dpsi,
            ) = line.strip("\n").split(",")

            j1_name = reference_label(j1_names)
            j2_name = reference_label(j2_names)
            j3_name = reference_label(j3_names)

            positions: List[str] = [
                _label_position(t, chrom, exons_by_tid)
                for t in (j1_name, j2_name, j3_name)
            ]

            if annotation_type == "annotated":
                if etype[0] == "A":
                    if positions[0] == "?":
                        # QUIRK: the reference's double assignment clobbers
                        # both positions to '?' here (remap.py:155-160)
                        positions[0] = positions[1]
                        positions[1] = "?"
                        j1_name = j2_name
                        j2_name = "?"
                        positions[0] = positions[1]
                        positions[1] = "?"
                        j1_nodes = j2_nodes
                        j2_nodes = "."
                        w1, w2 = w2, w1
                        psi_c1, psi_c2 = psi_c2, psi_c1
                        dpsi = -float(dpsi)
                    elif positions[1] == "?":
                        pass
                    else:
                        p0 = region_bounds(positions[0])
                        p1 = region_bounds(positions[1])
                        if p0[2] - p0[1] > p1[2] - p1[1]:
                            positions[0], positions[1] = positions[1], positions[0]
                            j1_name, j2_name = j2_name, j1_name
                            j1_nodes, j2_nodes = j2_nodes, j1_nodes
                            w1, w2 = w2, w1
                            psi_c1, psi_c2 = psi_c2, psi_c1
                            dpsi = -float(dpsi)
                elif etype == "IR":
                    j1_name = j2_name
                    j2_name = "?"
                    positions[0] = positions[1]
                    positions[1] = "?"
                    j1_nodes = j2_nodes
                    j2_nodes = "."
                    w1, w2 = w2, w1
                    psi_c1, psi_c2 = psi_c2, psi_c1
                    dpsi = -float(dpsi)

            htype = "reference"
            if annotation_type == "annotated":
                if etype == "ES" and (
                    positions[0] == "?" or positions[1] == "?" or positions[2] == "?"
                ):
                    htype = "haplotype"
                if etype[0] == "A" and (positions[0] == "?" or positions[1] == "?"):
                    htype = "haplotype"
                if etype == "IR" and positions[0] == "?":
                    htype = "haplotype"
            else:
                if etype == "ES" and (
                    positions[0] == "?" and positions[1] == "?" and positions[2] == "?"
                ):
                    htype = "haplotype"
                if etype[0] == "A" and (positions[0] == "?" and positions[1] == "?"):
                    htype = "haplotype"
                if etype == "IR" and (positions[0] == "?" and positions[1] == "?"):
                    htype = "haplotype"

            if annotation_type == "novel":
                if any(
                    region_size(p) < min_intron_size for p in positions if p != "?"
                ):
                    continue

            yield ",".join(
                map(
                    str,
                    [
                        etype,
                        annotation_type,
                        htype,
                        chrom,
                        gene,
                        strand,
                        j1_name,
                        j2_name,
                        j3_name,
                        j1_nodes,
                        j2_nodes,
                        j3_nodes,
                        positions[0],
                        positions[1],
                        positions[2],
                        w1,
                        w2,
                        psi_c1,
                        psi_c2,
                        dpsi,
                    ],
                )
            )

    if out is None:
        return _gen()
    for line in _gen():
        print(line, file=out)
    return iter(())
