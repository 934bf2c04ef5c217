"""Cross-condition PSI/ΔPSI quantification.

Behavioral contract: ``scripts/quantify.py`` of the reference — byte-identical
output on the same per-replicate event CSVs (row order here IS deterministic:
it follows input file order per event type).

Preserved arithmetic details:

* coverages parse as floats; missing ('.') coverages become -1,
* ES/CE double-junction coverage is ``(c2 + c3) // 2`` — float floor
  division (``quantify.py:71,140``),
* PSI per replicate is ``canonic / (canonic + event)`` with an integer -1
  sentinel for zero total coverage; the event PSI is the mean over non-(-1)
  replicates, or -1 when all are -1,
* ΔPSI is ``max(0, psi1) - max(0, psi2)``, -1 when both PSIs are -1,
* replicate slots are only zero-backfilled when a later replicate re-finds
  the event (``quantify.py:205-212``),
* replicate dedupe is first-match-wins over a linear scan with an
  at-most-one-match assertion (``quantify.py:263-272``).
"""

from __future__ import annotations
from pantas_tpu_torch.io.xopen import xopen

import sys
from dataclasses import dataclass, field
from statistics import mean
from typing import Dict, Iterator, List, Optional, Sequence, TextIO

ETYPES = ["ES", "CE", "IR", "A3", "A5"]

QUANT_HEADER = ",".join(
    [
        "etype",
        "annotation_type",
        "chrom",
        "gene",
        "strand",
        "junction1_name",  # canonic
        "junction2_name",  # canonic or event
        "junction3_name",  # event if 2 canonic
        "junction1_nodes",
        "junction2_nodes",
        "junction3_nodes",
        "W1",
        "W2",
        "psi_c1",
        "psi_c2",
        "dpsi",
    ]
)


def node_ids(nodes_str: str) -> List[int]:
    """Parse a '>'-joined node string, dropping '..' (long IR) and '?'."""
    return [int(x) for x in nodes_str.split(">") if x != ".." and x != "?"]


def _psi_of(event_cov: float, canonic_cov: float):
    den = canonic_cov + event_cov
    return float(canonic_cov) / den if den != 0 else -1


@dataclass
class QuantEvent:
    """One AS event with canonic/event junction roles resolved."""

    etype: str
    annotation_type: str
    chrom: str
    gene: str
    strand: str
    event_cov: float
    canonic_cov: float
    event_j: object  # node-id list, or list of two lists for ES/CE pairs
    canonic_j: object
    event_nodes: List[str]
    canonic_nodes: List[str]
    event_jname: List[str]
    canonic_jname: List[str]
    replicates: List[List[float]] = field(default_factory=list)

    def set_replicate(self, replicate: int, event_cov: float, canonic_cov: float) -> None:
        if replicate >= len(self.replicates):
            while replicate + 1 != len(self.replicates):
                self.replicates.append([0, 0])
        self.replicates[replicate][0] = event_cov
        self.replicates[replicate][1] = canonic_cov

    def psi(self):
        psis = [_psi_of(ec, cc) for ec, cc in self.replicates]
        if all(x == -1 for x in psis):
            return -1
        return mean([x for x in psis if x != -1])

    def mean_event_cov(self) -> int:
        return int(mean([r[0] for r in self.replicates]))

    def mean_canonic_cov(self) -> int:
        return int(mean([r[1] for r in self.replicates]))

    def csv_prefix(self) -> str:
        return ",".join(
            [
                self.etype,
                self.annotation_type,
                self.chrom,
                self.gene,
                self.strand,
                ",".join(self.canonic_jname),
                ",".join(self.event_jname),
                ",".join(self.canonic_nodes),
                ",".join(self.event_nodes),
            ]
        )


def event_from_row(row: Sequence[str], replicate: int) -> QuantEvent:
    (
        etype,
        annotation_type,
        chrom,
        gene,
        strand,
        j1_name,
        j2_name,
        j3_name,
        j1_nodes,
        j1_cov,
        j2_nodes,
        j2_cov,
        j3_nodes,
        j3_cov,
    ) = row

    c1 = float(j1_cov) if j1_cov != "." else -1
    c2 = float(j2_cov) if j2_cov != "." else -1
    c3 = float(j3_cov) if j3_cov != "." else -1

    if etype == "ES":
        kw = dict(
            event_cov=c1,
            event_j=node_ids(j1_nodes),
            canonic_cov=(c2 + c3) // 2,
            canonic_j=[node_ids(j2_nodes), node_ids(j3_nodes)],
            event_nodes=[j1_nodes],
            canonic_nodes=sorted([j2_nodes, j3_nodes]),
            event_jname=[j1_name],
            canonic_jname=[j2_name, j3_name],
        )
    elif etype == "CE":
        kw = dict(
            event_cov=(c2 + c3) // 2,
            event_j=[node_ids(j2_nodes), node_ids(j3_nodes)],
            canonic_cov=c1,
            canonic_j=node_ids(j1_nodes),
            event_nodes=sorted([j2_nodes, j3_nodes]),
            canonic_nodes=[j1_nodes],
            event_jname=[j2_name, j3_name],
            canonic_jname=[j1_name],
        )
    else:
        # two-junction events: which junction is "event" depends on
        # type/strand (A5/A3) or on the novel-IR marker (IR).
        if etype == "A5":
            event_is_j1 = strand == "+"
        elif etype == "A3":
            event_is_j1 = strand != "+"
        elif etype == "IR":
            event_is_j1 = not (annotation_type == "novel" and j2_name == "?")
        else:
            raise ValueError(f"unknown event type {etype}")
        if event_is_j1:
            ev_name, ev_nodes, ev_cov = j1_name, j1_nodes, c1
            ca_name, ca_nodes, ca_cov = j2_name, j2_nodes, c2
        else:
            ev_name, ev_nodes, ev_cov = j2_name, j2_nodes, c2
            ca_name, ca_nodes, ca_cov = j1_name, j1_nodes, c1
        kw = dict(
            event_cov=ev_cov,
            event_j=node_ids(ev_nodes),
            canonic_cov=ca_cov,
            canonic_j=node_ids(ca_nodes),
            event_nodes=[ev_nodes, "."],
            canonic_nodes=[ca_nodes],
            event_jname=[ev_name, "."],
            canonic_jname=[ca_name],
        )

    ev = QuantEvent(
        etype=etype,
        annotation_type=annotation_type,
        chrom=chrom,
        gene=gene,
        strand=strand,
        **kw,
    )
    ev.set_replicate(replicate, ev.event_cov, ev.canonic_cov)
    return ev


def same_event(a: QuantEvent, b: QuantEvent) -> bool:
    if a.etype != b.etype or a.chrom != b.chrom or a.gene != b.gene:
        return False
    if a.etype == "IR":
        # IR canonic paths can differ through variation nodes
        return a.event_j == b.event_j
    return a.canonic_j == b.canonic_j and a.event_j == b.event_j


def _ev_key(ev: QuantEvent):
    """Hashable identity under :func:`same_event` (pure equality on these
    fields), so the reference's O(n²) linear scans (``quantify.py:263-272``)
    become dict probes with IDENTICAL outcomes: stored events are deduped
    by the same relation, so keys are unique and the reference's
    at-most-one-match assertion can never fire either way. At 71k rows per
    replicate (full-scale experiment) the quadratic scan ran for the
    better part of an hour; the index is linear."""

    def tup(x):
        if isinstance(x, list):
            return tuple(tup(i) for i in x)
        return x

    if ev.etype == "IR":
        return (ev.chrom, ev.gene, tup(ev.event_j))
    return (ev.chrom, ev.gene, tup(ev.canonic_j), tup(ev.event_j))


def _load_condition(
    paths: Sequence[str], min_w: int, pool_w: Optional[int] = None
) -> Dict[str, List[QuantEvent]]:
    events: Dict[str, List[QuantEvent]] = {x: [] for x in ETYPES}
    index: Dict[str, Dict] = {x: {} for x in ETYPES}
    for i, fpath in enumerate(paths):
        for line in xopen(fpath):
            row = line.strip().split(",")
            if row[0] == "event_type":
                continue
            ev = event_from_row(row, i)
            if pool_w is None and (ev.canonic_cov < min_w or ev.event_cov < min_w):
                continue
            match = index[ev.etype].get(_ev_key(ev))
            if match is not None:
                match.set_replicate(i, ev.event_cov, ev.canonic_cov)
            else:
                events[ev.etype].append(ev)
                index[ev.etype][_ev_key(ev)] = ev
    if pool_w is not None:
        # pooled-replicate coverage filter (EXTENSION, off by default —
        # VERDICT r4 task 4): instead of the reference's per-replicate
        # drop (which kills a true ΔPSI=0.1 event whose minor junction
        # sits at 1-2 reads in EVERY replicate, docs/SIM_ACCURACY.md
        # "failure mode"), require the SUM of each junction's coverage
        # across the condition's replicates to reach the threshold.
        # Consistent weak support across replicates then survives, while
        # a junction seen once stays filtered. Feed this from a w=0 call
        # pass (the per-event coverages are already in the rows).
        for et in ETYPES:
            events[et] = [
                ev
                for ev in events[et]
                if sum(max(0.0, r[0]) for r in ev.replicates) >= pool_w
                and sum(max(0.0, r[1]) for r in ev.replicates) >= pool_w
            ]
            index[et] = {_ev_key(ev): ev for ev in events[et]}
    return events, index


def quantify(
    c1_paths: Sequence[str],
    c2_paths: Sequence[str],
    both: bool = False,
    min_w: int = 0,
    out: Optional[TextIO] = None,
    pool_w: Optional[int] = None,
) -> Iterator[str]:
    """Yield quant CSV lines (header first); optionally also write to ``out``.

    ``pool_w`` (extension): replace the reference's per-replicate ``-w``
    drop with a pooled-across-replicates coverage threshold per junction
    role — see :func:`_load_condition`. Mutually exclusive with ``min_w``.
    """
    if pool_w is not None and min_w:
        raise ValueError("pool_w and min_w are mutually exclusive")

    def _gen():
        # _load_condition's dedupe index IS the per-etype key index the
        # matching pass needs — rebuilding it re-ran _ev_key over every
        # stored event twice per condition
        events_1, idx_1 = _load_condition(c1_paths, min_w, pool_w)
        events_2, idx_2 = _load_condition(c2_paths, min_w, pool_w)
        yield QUANT_HEADER
        for etype in ETYPES:
            for e1 in events_1[etype]:
                match = idx_2[etype].get(_ev_key(e1))
                if match is not None:
                    matches = [match]
                    psi1 = e1.psi()
                    psi2 = matches[0].psi()
                    dpsi = max(0, psi1) - max(0, psi2)
                    if psi1 == -1 and psi2 == -1:
                        dpsi = -1
                    yield ",".join(
                        [
                            e1.csv_prefix(),
                            f"{e1.mean_canonic_cov()}/{e1.mean_event_cov()}",
                            f"{matches[0].mean_canonic_cov()}/{matches[0].mean_event_cov()}",
                            str(psi1),
                            str(psi2),
                            str(dpsi),
                        ]
                    )
                elif not both:
                    if not e1.psi() == -1:
                        psi2 = 1
                        dpsi = max(0, e1.psi()) - max(0, psi2)
                        yield ",".join(
                            [
                                e1.csv_prefix(),
                                f"{e1.mean_canonic_cov()}/{e1.mean_event_cov()}",
                                ".",
                                str(e1.psi()),
                                str(psi2),
                                str(dpsi),
                            ]
                        )
            if not both:
                for e2 in events_2[etype]:
                    if _ev_key(e2) not in idx_1[etype] and not e2.psi() == -1:
                        psi1 = 1
                        dpsi = max(0, psi1) - max(0, e2.psi())
                        yield ",".join(
                            [
                                e2.csv_prefix(),
                                ".",
                                f"{e2.mean_canonic_cov()}/{e2.mean_event_cov()}",
                                str(psi1),
                                str(e2.psi()),
                                str(dpsi),
                            ]
                        )

    if out is None:
        return _gen()
    for line in _gen():
        print(line, file=out)
    return iter(())
