"""Alternative-splicing read simulator with ground truth.

Native replacement for the reference's ASimulatoR-based simulation
(``exps/1-dm-sim/workflow/rules/simulation.smk``): pick multi-exon
transcripts, derive event isoforms —

* ``es``  — skip an internal exon,
* ``ir``  — retain an intron,
* ``a3``  — alternative acceptor (exon shortened at the acceptor edge),
* ``a5``  — alternative donor (exon shortened at the donor edge),
* ``ce``  — novel cassette exon inside an intron (novel w.r.t. the
  annotation: exercises the caller's novel pass),

— then sample paired-end reads from base isoforms (condition 1) and event
isoforms (condition 2), with read names carrying provenance in the
ASimulatoR style (``read{i}/{gene}_{template|kind};mate1:{s}-{e};...``).
Truth comes through two channels: the regions CSV for the comparator, and
ASimulatoR-compatible exon_junction/event_annotation tables consumed by
the ``sim_truth`` scripts (simrc/build_truth parity with the reference
``exps/1-dm-sim`` truth pipeline).
"""

from __future__ import annotations

import random
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from pantas_tpu_torch.io.fasta import read_fasta, revcomp
from pantas_tpu_torch.io.gtf import Transcript, parse_transcript_models

TRUTH_HEADER = "etype,gene,transcript,chrom,strand,region1,region2,region3"


@dataclass
class SimEvent:
    etype: str  # ES / IR / A3 / A5 / CE
    gene: str
    tid: str
    chrom: str
    strand: str
    regions: List[str]  # defining linear regions "chrom:s-e"
    base_seq: str = ""
    event_seq: str = ""
    base_exons: List[Tuple[int, int]] = field(default_factory=list)
    event_exons: List[Tuple[int, int]] = field(default_factory=list)
    ann_span: Optional[Tuple[int, int]] = None  # event's genomic span (ANN)

    def truth_row(self) -> str:
        regs = (self.regions + [".", ".", "."])[:3]
        return ",".join(
            [self.etype, self.gene, self.tid, self.chrom, self.strand] + regs
        )


def spliced_seq(ref: str, exons: Sequence[Tuple[int, int]]) -> str:
    return "".join(ref[s - 1 : e] for s, e in exons)


def _intron(chrom: str, left: Tuple[int, int], right: Tuple[int, int]) -> str:
    return f"{chrom}:{left[1] + 1}-{right[0] - 1}"


def make_event(
    ref: str, tr: Transcript, etype: str, shift: int = 12
) -> Optional[SimEvent]:
    """Derive one event isoform from a transcript, or None if not applicable."""
    ex = tr.exons
    chrom = tr.chrom
    ann_span: Optional[Tuple[int, int]] = None
    if etype == "ES" and len(ex) >= 3:
        k = len(ex) // 2
        new_exons = ex[:k] + ex[k + 1 :]
        ann_span = ex[k]  # skipped exon
        regions = [
            _intron(chrom, ex[k - 1], ex[k + 1]),  # skip junction
            _intron(chrom, ex[k - 1], ex[k]),  # inclusion 1
            _intron(chrom, ex[k], ex[k + 1]),  # inclusion 2
        ]
    elif etype == "IR" and len(ex) >= 2:
        k = len(ex) // 2 - 1
        merged = (ex[k][0], ex[k + 1][1])
        new_exons = ex[:k] + [merged] + ex[k + 2 :]
        ann_span = (ex[k][1] + 1, ex[k + 1][0] - 1)  # retained intron
        regions = [_intron(chrom, ex[k], ex[k + 1])]  # retained intron
    elif etype in ("A3", "A5") and len(ex) >= 2:
        # alternative splice site: SHORTEN an internal exon (the variant
        # splice site moves inside the annotated exon) — ASimulatoR's
        # convention, so the truth-channel scripts (sim_truth.build_truth
        # matching the reference exps/1-dm-sim/scripts/build_truth.py)
        # consume our event annotation directly. Which exon edge moves
        # depends on (etype, strand): the donor (A5) is the transcript-
        # upstream edge, the acceptor (A3) the downstream one.
        shorten_end = (etype == "A5") == (tr.strand == "+")
        k = len(ex) // 2 - 1 if shorten_end else len(ex) // 2
        s, e = ex[k]
        if e - s <= shift + 4:
            return None
        if shorten_end:
            if k + 1 >= len(ex):
                return None
            new_exon = (s, e - shift)
            removed = (e - shift + 1, e)  # ANN genomic span
            regions = [
                f"{chrom}:{e - shift + 1}-{ex[k + 1][0] - 1}",  # variant intron
                _intron(chrom, ex[k], ex[k + 1]),  # canonic intron
            ]
        else:
            if k == 0:
                return None
            new_exon = (s + shift, e)
            removed = (s, s + shift - 1)
            regions = [
                f"{chrom}:{ex[k - 1][1] + 1}-{s + shift - 1}",  # variant intron
                _intron(chrom, ex[k - 1], ex[k]),  # canonic intron
            ]
        new_exons = ex[:k] + [new_exon] + ex[k + 1 :]
        ann_span = removed
    elif etype == "CE" and len(ex) >= 2:
        # novel cassette exon in the middle intron (always NOVEL w.r.t. the
        # annotation: neither its junctions nor the exon exist in any
        # transcript)
        k = len(ex) // 2 - 1
        il, ir_ = ex[k][1] + 1, ex[k + 1][0] - 1
        if ir_ - il < 80:
            return None
        cs = il + (ir_ - il) // 3
        ce_len = min(60, (ir_ - il) // 3 - 2)
        if ce_len < 20:
            return None
        new_exons = ex[: k + 1] + [(cs, cs + ce_len - 1)] + ex[k + 1 :]
        ann_span = (cs, cs + ce_len - 1)
        regions = [
            _intron(chrom, ex[k], ex[k + 1]),  # the annotated intron spanned
            f"{chrom}:{cs}-{cs + ce_len - 1}",  # the cassette exon
        ]
    else:
        return None

    base = spliced_seq(ref, ex)
    event = spliced_seq(ref, new_exons)
    if tr.strand == "-":
        # biological mRNA: reads sample the transcript-order sequence, so
        # mate coordinates in read names are transcript-order offsets —
        # the coordinate system the ASimulatoR truth channel uses
        base = revcomp(base)
        event = revcomp(event)
    if min(len(base), len(event)) < 400 or len(base) > 3000:
        return None
    return SimEvent(
        etype=etype,
        gene=tr.gene,
        tid=tr.tid,
        chrom=chrom,
        strand=tr.strand,
        regions=regions,
        base_seq=base,
        event_seq=event,
        base_exons=list(ex),
        event_exons=list(new_exons),
        ann_span=ann_span,
    )


def _mutate(seq: str, rng: random.Random, error_rate: float) -> str:
    if error_rate <= 0:
        return seq
    out = list(seq)
    for i in range(len(out)):
        if rng.random() < error_rate:
            out[i] = rng.choice("ACGT".replace(out[i].upper(), "") or "ACGT")
    return "".join(out)


def _sample_pairs(
    name_prefix: str,
    template: str,
    n_pairs: int,
    rng: random.Random,
    read_len: int,
    frag_len: int,
    error_rate: float,
    fq1: List[str],
    fq2: List[str],
    counter: List[int],
) -> None:
    L = len(template)
    frag = min(frag_len, L)
    for _ in range(n_pairs):
        start = rng.randrange(0, L - frag + 1)
        fragment = template[start : start + frag]
        m1 = fragment[:read_len]
        m2 = revcomp(fragment[-read_len:])
        i = counter[0]
        counter[0] += 1
        name = (
            f"read{i}/{name_prefix};"
            f"mate1:{start}-{start + read_len - 1};"
            f"mate2:{start + frag - read_len}-{start + frag - 1}"
        )
        fq1.append(f"@{name}\n{_mutate(m1, rng, error_rate)}\n+\n{'I' * len(m1)}")
        fq2.append(f"@{name}\n{_mutate(m2, rng, error_rate)}\n+\n{'I' * len(m2)}")


def _tr_order(exons: Sequence[Tuple[int, int]], strand: str):
    """Exons in TRANSCRIPT order with 0-based inclusive transcriptomic
    spans — the coordinate system of the sampled mRNA (and therefore of
    the mate positions in read names)."""
    ordered = list(exons) if strand == "+" else list(reversed(exons))
    out = []
    pos = 0
    for s, e in ordered:
        n = e - s + 1
        out.append(((s, e), (pos, pos + n - 1)))
        pos += n
    return out


def _tr_pos(exons: Sequence[Tuple[int, int]], strand: str, g: int) -> int:
    """Transcriptomic offset of genomic position ``g`` on an isoform."""
    for (s, e), (ts, _te) in _tr_order(exons, strand):
        if s <= g <= e:
            return ts + (g - s if strand == "+" else e - g)
    return 0


def write_variants_gtf(
    events: Sequence["SimEvent"], gtf_path: str, out_path: str
) -> None:
    """Variant-inclusive annotation (ASimulatoR's ``splicing_variants.gtf``).

    The reference's sim experiment runs in two modes
    (exps/1-dm-sim/workflow/rules/pantas.smk:16-19): "anno" builds the
    graph from the annotation WITH the event isoforms (every simulated
    event is then an annotated event with graph support at its splice
    sites) and "novel" from the annotation without them. This writes the
    anno-mode GTF: the original annotation plus one transcript per event
    isoform.
    """
    with open(out_path, "w") as out:
        with open(gtf_path) as fh:
            out.write(fh.read())
        for ev in events:
            tid = f"{ev.gene}_{ev.etype.lower()}"
            exons = sorted(ev.event_exons)
            attrs = f'gene_id "{ev.gene}"; transcript_id "{tid}";'
            out.write(
                f"{ev.chrom}\tsim\ttranscript\t{exons[0][0]}\t{exons[-1][1]}"
                f"\t.\t{ev.strand}\t.\t{attrs}\n"
            )
            for s, e in exons:
                out.write(
                    f"{ev.chrom}\tsim\texon\t{s}\t{e}\t.\t{ev.strand}\t.\t{attrs}\n"
                )


def write_asim_artifacts(events: Sequence["SimEvent"], out_prefix: str) -> None:
    """ASimulatoR-compatible truth-channel artifacts for sim_truth/simrc.

    * ``{prefix}_exon_junction.tsv`` — per-isoform exon rows (chrom, start,
      end, strand, gene, transcript, exon rank in transcript order,
      transcriptomic span) in the 15-column layout the reference
      ``simrc.py`` indexes;
    * ``{prefix}_event_annotation.tsv`` — one row per event isoform with
      its genomic + transcriptomic defining span.
    """
    jun = open(f"{out_prefix}_exon_junction.tsv", "w")
    ann = open(f"{out_prefix}_event_annotation.tsv", "w")
    jun.write(
        "seqnames\tstart\tend\twidth\tstrand\tsource\ttype\tscore\tphase\t"
        "gene_id\ttranscript_id\ttemplate\texon_number\ttr_start\ttr_end\n"
    )
    ann.write(
        "event\ttranscript\ttemplate\tgenomic_start\tgenomic_end\t"
        "transcriptomic_start\ttranscriptomic_end\n"
    )
    for ev in events:
        if ev.ann_span is None:
            continue
        template = f"{ev.gene}_template"
        variant = f"{ev.gene}_{ev.etype.lower()}"
        for tid, exons in ((template, ev.base_exons), (variant, ev.event_exons)):
            for rank, ((s, e), (ts, te)) in enumerate(
                _tr_order(exons, ev.strand), start=1
            ):
                jun.write(
                    f"{ev.chrom}\t{s}\t{e}\t{e - s + 1}\t{ev.strand}\t"
                    f"sim\texon\t.\t.\t{ev.gene}\t{tid}\t{template}\t"
                    f"{rank}\t{ts}\t{te}\n"
                )
        gs, ge = ev.ann_span
        # transcriptomic span of the event within the VARIANT isoform
        # (what simrc's retained-intron counting consumes, ir only)
        p1 = _tr_pos(ev.event_exons, ev.strand, gs)
        p2 = _tr_pos(ev.event_exons, ev.strand, ge)
        ts, te = min(p1, p2), max(p1, p2)
        ann.write(
            f"{ev.etype.lower()}\t{variant}\t{template}\t{gs}\t{ge}\t{ts}\t{te}\n"
        )
    jun.close()
    ann.close()


def simulate(
    fa_path: str,
    gtf_path: str,
    out_prefix: str,
    n_events: int = 8,
    reads_per_isoform: int = 60,
    read_len: int = 150,
    frag_len: int = 300,
    error_rate: float = 0.001,
    seed: int = 7,
    etypes: Sequence[str] = ("ES", "IR", "A3", "A5"),
    replicates: int = 1,
    dpsi: float = 0.5,
    depth_factors: Sequence[float] = (),
    min_pairs: int = 8,
    log=sys.stderr,
) -> List[SimEvent]:
    """Write {prefix}_c{1,2}_{1,2}.fq + {prefix}_truth.csv; return events.

    Condition 1 reads come from base isoforms only; condition 2 reads mix
    base and event isoform at ``dpsi`` event fraction (PSI_c2 = 1 − dpsi,
    PSI_c1 = 1 ⇒ ΔPSI signal ≈ ``dpsi``; default 0.5). With
    ``replicates`` > 1 every condition gets that many independent read
    samples over the same events/truth, named
    ``{prefix}_c{c}_r{r}_{mate}.fq`` (the reference workflow's per-sample
    fastq layout, exps/1-dm-sim/workflow/rules/simulation.smk).

    Hard-regime knobs (the reference scores at Δψ ≥ 0.05 over real SRA
    reads, exps/1-dm-sim/workflow/Snakefile:83-108 — these let the
    synthetic benchmark leave its saturated P=R=1 region):
    ``dpsi`` < 0.5 weakens the signal; ``error_rate`` adds per-base
    substitutions; ``depth_factors`` scales each replicate's depth
    (unequal replicates), cycled over the replicate index; ``min_pairs``
    floors the per-isoform pair count (lower it below 8 so small
    depth × dpsi products are not silently inflated).
    """
    ref_by_chrom = read_fasta(fa_path)
    models = parse_transcript_models(gtf_path)

    # deterministic transcript ordering, one event per gene, round-robin types
    events: List[SimEvent] = []
    used_genes = set()
    rng = random.Random(seed)
    tids = sorted(models)
    ti = 0
    for tid in tids:
        if len(events) >= n_events:
            break
        tr = models[tid]
        if tr.gene in used_genes or tr.chrom not in ref_by_chrom:
            continue
        etype = etypes[ti % len(etypes)]
        ev = make_event(ref_by_chrom[tr.chrom], tr, etype)
        if ev is None:
            continue
        ti += 1
        used_genes.add(tr.gene)
        events.append(ev)

    reps = range(1, max(replicates, 1) + 1)
    fqs = {(c, r, m): [] for c in ("c1", "c2") for r in reps for m in (1, 2)}
    counter = [0]
    factors = list(depth_factors) or [1.0]
    # reads_per_isoform is interpreted as target DEPTH: pair counts scale
    # with template length so junction coverage is length-independent
    def n_pairs(template: str, depth: float) -> int:
        return max(min_pairs, int(depth * len(template) / (2 * read_len)))

    for ev in events:
        # ASimulatoR isoform naming: the annotated isoform is
        # "{gene}_template", the event isoform "{gene}_{kind}" — the
        # truth-channel scripts (sim_truth / reference simrc+build_truth)
        # key on these suffixes
        template_name = f"{ev.gene}_template"
        variant_name = f"{ev.gene}_{ev.etype.lower()}"
        for i, r in enumerate(reps):
            depth = reads_per_isoform * factors[i % len(factors)]
            _sample_pairs(
                template_name, ev.base_seq,
                n_pairs(ev.base_seq, depth),
                rng, read_len, frag_len, error_rate,
                fqs[("c1", r, 1)], fqs[("c1", r, 2)], counter,
            )
            _sample_pairs(
                template_name, ev.base_seq,
                n_pairs(ev.base_seq, depth * (1 - dpsi)),
                rng, read_len, frag_len, error_rate,
                fqs[("c2", r, 1)], fqs[("c2", r, 2)], counter,
            )
            _sample_pairs(
                variant_name, ev.event_seq,
                n_pairs(ev.event_seq, depth * dpsi),
                rng, read_len, frag_len, error_rate,
                fqs[("c2", r, 1)], fqs[("c2", r, 2)], counter,
            )

    paths = {}
    for (cond, r, mate), recs in fqs.items():
        tag = f"{cond}_r{r}" if replicates > 1 else cond
        p = f"{out_prefix}_{tag}_{mate}.fq"
        with open(p, "w") as fh:
            fh.write("\n".join(recs) + ("\n" if recs else ""))
        paths[(cond, r, mate)] = p
    truth_path = f"{out_prefix}_truth.csv"
    with open(truth_path, "w") as fh:
        fh.write(TRUTH_HEADER + "\n")
        for ev in events:
            fh.write(ev.truth_row() + "\n")
    write_asim_artifacts(events, out_prefix)
    write_variants_gtf(events, gtf_path, f"{out_prefix}_variants.gtf")
    print(
        f"[simulate] {len(events)} events, {counter[0]} read pairs -> {out_prefix}_*",
        file=log,
    )
    return events
