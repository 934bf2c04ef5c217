"""Accuracy scoring: called events (quant-remap CSV) vs simulation truth.

Matching follows the spirit of the reference's event comparator
(``exps/1-dm-sim/scripts/eparser.py:366-485``): a truth event and a called
row of the same event type match when any of the called row's mapped
positions agrees with one of the truth's defining regions within a ±relax
tolerance (region endpoints compared independently). Precision/recall/F1
per event type, with optional |ΔPSI| and coverage filters
(``exps/1-dm-sim/workflow/Snakefile:83-108`` semantics).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

ETYPES = ["ES", "CE", "IR", "A3", "A5"]

# A truth etype may legitimately be called as either of these types
# (a novel cassette presents as CE, a skipped exon as ES, ...).
# Note: alternative-splice-site events whose shifted boundary lies inside
# the intron also light up the coverage-based novel-IR detector (reads
# cover the intron edge), so A3/A5 truth often manifests as IR calls at the
# same locus; scoring stays strict (those count as IR false positives),
# matching the reference comparator's typing.
COMPATIBLE = {
    "ES": {"ES", "CE"},
    "CE": {"ES", "CE"},
    "IR": {"IR"},
    "A3": {"A3", "A5"},
    "A5": {"A3", "A5"},
}


def _parse_region(r: str) -> Optional[Tuple[str, int, int]]:
    if not r or r in (".", "?"):
        return None
    if r.endswith("?"):
        r = r[:-1]
    chrom, span = r.split(":")
    s, e = span.split("-")
    return chrom, int(s), int(e)


def _regions_match(a: str, b: str, relax: int) -> bool:
    ra, rb = _parse_region(a), _parse_region(b)
    if ra is None or rb is None:
        return False
    return (
        ra[0] == rb[0]
        and abs(ra[1] - rb[1]) <= relax
        and abs(ra[2] - rb[2]) <= relax
    )


@dataclass
class CalledEvent:
    etype: str
    gene: str
    positions: List[str]
    dpsi: Optional[float]
    w_min: Optional[float]


def parse_quant_remap(path: str) -> List[CalledEvent]:
    out: List[CalledEvent] = []
    for line in open(path):
        if line.startswith("etype"):
            continue
        cols = line.strip("\n").split(",")
        etype = cols[0]
        gene = cols[4]
        positions = [p for p in cols[12:15]]
        try:
            dpsi = float(cols[19])
        except ValueError:
            dpsi = None
        # coverage-cut statistic: the EVENT junction's coverage, min across
        # the conditions where the event was quantified — the reference
        # comparator's min_event_cov (eparser.py:267-279). Our quant W
        # format is "canonic/event" per condition ('.' when one-sided);
        # taking the min over all numeric Ws instead would let the
        # always-zero absent side veto every cut >= 1.
        ws = []
        for w in (cols[15], cols[16]):
            if "/" in w:
                try:
                    ws.append(float(w.split("/")[1]))
                except (ValueError, IndexError):
                    pass
        out.append(
            CalledEvent(
                etype=etype,
                gene=gene,
                positions=positions,
                dpsi=dpsi,
                w_min=min(ws) if ws else None,
            )
        )
    return out


@dataclass
class TruthEvent:
    etype: str
    gene: str
    tid: str
    regions: List[str]


def parse_truth(path: str) -> List[TruthEvent]:
    out: List[TruthEvent] = []
    for line in open(path):
        if line.startswith("etype"):
            continue
        cols = line.strip("\n").split(",")
        out.append(
            TruthEvent(
                etype=cols[0],
                gene=cols[1],
                tid=cols[2],
                regions=[r for r in cols[5:8] if r != "."],
            )
        )
    return out


def score(
    truth: Sequence[TruthEvent],
    called: Sequence[CalledEvent],
    relax: int = 3,
    min_dpsi: float = 0.0,
    min_w: float = 0.0,
) -> Dict[str, Dict[str, float]]:
    """Per-etype {tp, fp, fn, precision, recall, f1} (+ 'ALL' aggregate)."""
    kept = [
        c
        for c in called
        if (c.dpsi is None or abs(c.dpsi) >= min_dpsi)
        and (c.w_min is None or c.w_min >= min_w)
    ]

    def matches(t: TruthEvent, c: CalledEvent) -> bool:
        if c.etype not in COMPATIBLE.get(t.etype, {t.etype}):
            return False
        return any(
            _regions_match(tr, cp, relax) for tr in t.regions for cp in c.positions
        )

    # one global matching pass: a called row matching ANY compatible truth
    # event is a true call, wherever its etype is scored
    matched_truth = set()
    matched_called = set()
    for ci, c in enumerate(kept):
        for ti, t in enumerate(truth):
            if matches(t, c):
                matched_truth.add(ti)
                matched_called.add(ci)

    results: Dict[str, Dict[str, float]] = {}
    all_tp = all_fp = all_fn = 0
    for etype in ETYPES:
        t_idx = [ti for ti, t in enumerate(truth) if t.etype == etype]
        c_idx = [ci for ci, c in enumerate(kept) if c.etype == etype]
        tp = sum(1 for ti in t_idx if ti in matched_truth)
        fn = len(t_idx) - tp
        fp = sum(1 for ci in c_idx if ci not in matched_called)
        p = tp / (tp + fp) if tp + fp else 0.0
        r = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        results[etype] = {
            "tp": tp, "fp": fp, "fn": fn, "precision": p, "recall": r, "f1": f1,
        }
        all_tp += tp
        all_fp += fp
        all_fn += fn
    p = all_tp / (all_tp + all_fp) if all_tp + all_fp else 0.0
    r = all_tp / (all_tp + all_fn) if all_tp + all_fn else 0.0
    results["ALL"] = {
        "tp": all_tp,
        "fp": all_fp,
        "fn": all_fn,
        "precision": p,
        "recall": r,
        "f1": 2 * p * r / (p + r) if p + r else 0.0,
    }
    return results


def print_scores(results: Dict[str, Dict[str, float]], out=sys.stdout) -> None:
    print("etype,tp,fp,fn,precision,recall,f1", file=out)
    for etype, m in results.items():
        print(
            f"{etype},{m['tp']},{m['fp']},{m['fn']},"
            f"{m['precision']:.3f},{m['recall']:.3f},{m['f1']:.3f}",
            file=out,
        )
