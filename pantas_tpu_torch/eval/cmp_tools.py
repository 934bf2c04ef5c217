"""Multi-tool AS-event comparison against simulated truth.

Equivalent of the reference's accuracy comparator
(``exps/1-dm-sim/scripts/cmp_pantas.py`` + ``eparser.py``): canonicalize
events from pantas (quant-remap CSV), rMATS, Whippet, and SUPPA2 into
(event junction, canonic junction) linear-region pairs, match them to
truth rows with per-coordinate ``relax`` tolerance, and print per-etype
TP/FN/FP + precision/recall/F1 tables. Output is byte-identical to the
reference scripts on the same inputs (differential-tested).

Per-tool canonicalization (``eparser.py``):

* pantas rows are the 20-column quant-remap CSV; junction roles per etype
  at ``eparser.py:139-168`` (ES: j3 = skip junction, j1/j2 canonic;
  A3/A5/IR: j2 event, j1 canonic with the ``.``-swap for IR; CE: j2/j3
  event pair);
* rMATS rows are the 13-column pre-converted CSV (``build_rmats.py``
  output) with mirrored roles (``eparser.py:203-232``);
* truth rows carry ``fix_region`` (+1/-1 interior) coordinates and
  per-junction coverage triplets ``a/b/c`` used by the ``-c`` filter
  (``eparser.py:267-307``, ``cmp_pantas.py:17-23``);
* Whippet psi rows are tab-separated with only the event span; equality
  against non-Whippet events uses the special exon<->intron coordinate
  shifts (``eparser.py:342-363,397-442``).

Preserved quirks: the reference asserts at most one rMATS/Whippet/SUPPA2
match per truth event (``cmp_pantas.py:159,174,189``) and crashes on a
novel CE (``eparser.py:465``); FN lines for rMATS/Whippet/SUPPA2 go to
stdout while pantas FN/FP go to stderr (``cmp_pantas.py:152,167,182``).
"""

from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field
from math import isnan
from typing import Dict, List, Optional, Sequence

ETYPES = ["ES", "IR", "A3", "A5", "CE"]
EMAP_WHIPPET = {"CE": "ES", "RI": "IR", "AD": "A5", "AA": "A3"}

_REGION_RE = re.compile(r"(?P<chr>[\w\d]+):(?P<start>\d+)-(?P<end>\d+)")


def parse_region(string: str):
    if string == "." or string == "?":
        return "."
    if string.endswith("?"):
        string = string[:-1]
    reg = _REGION_RE.match(string)
    if not reg:
        print(f"Unable to read region {string}. Ignoring it", file=sys.stderr)
        sys.exit(1)
    return [int(reg.group("start")), int(reg.group("end"))]


def fix_region(reg):
    return [reg[0] + 1, reg[1] - 1]


def build_region(regions):
    if regions == ".":
        return "."
    elif type(regions[0]) == int:
        return f"{regions[0]}-{regions[1]}"
    elif regions[0] == ".":
        return f"{regions[1][0]}-{regions[1][1]}"
    else:
        return ",".join([f"{r[0]}-{r[1]}" for r in regions])


@dataclass
class Event:
    etype: str
    annotation_type: str
    chrom: str
    gene: str
    strand: str
    psi_c1: float
    psi_c2: float
    dpsi: float
    event_j: object = "."
    canonic_j: object = "."
    whippet: bool = False
    rc_c1: List[int] = field(default_factory=list)
    rc_c2: List[int] = field(default_factory=list)
    min_event_cov: int = 0

    def to_csv(self) -> str:
        return ",".join(
            map(
                str,
                [
                    self.etype,
                    self.annotation_type,
                    self.chrom,
                    self.gene,
                    self.strand,
                    f"{self.chrom}:{build_region(self.event_j)}",
                    f"{self.chrom}:{build_region(self.canonic_j)}",
                    self.psi_c1,
                    self.psi_c2,
                    self.dpsi,
                ],
            )
        )


def _roles_pantas(etype, j1, j2, j3):
    """eparser.py:139-168 junction roles for pantas rows."""
    if etype == "ES":
        return parse_region(j3), [parse_region(j1), parse_region(j2)]
    if etype in ("A5", "A3"):
        return parse_region(j2), parse_region(j1)
    if etype == "IR":
        event_j, canonic_j = parse_region(j2), parse_region(j1)
        if event_j == ".":
            event_j, canonic_j = canonic_j, "."
        return event_j, canonic_j
    if etype == "CE":
        return [parse_region(j2), parse_region(j3)], parse_region(j1)
    return ".", "."


def _roles_rmats(etype, j1, j2, j3):
    """eparser.py:203-232 (mirrored junction order vs pantas)."""
    if etype == "ES":
        return parse_region(j1), [parse_region(j2), parse_region(j3)]
    if etype in ("A5", "A3"):
        return parse_region(j1), parse_region(j2)
    if etype == "IR":
        event_j, canonic_j = parse_region(j1), parse_region(j2)
        if event_j == ".":
            event_j, canonic_j = canonic_j, "."
        return event_j, canonic_j
    if etype == "CE":
        return [parse_region(j2), parse_region(j3)], parse_region(j1)
    return ".", "."


def event_pantas(fields: Sequence[str]) -> Event:
    """A quant-remap CSV row (20 columns, remap.py:67-89 header)."""
    (etype, anno, _htype, chrom, gene, strand, _n1, _n2, _n3, _j1n, _j2n, _j3n,
     j1, j2, j3, _w1, _w2, psi1, psi2, dpsi) = fields
    ev, ca = _roles_pantas(etype, j1, j2, j3)
    return Event(etype, anno, chrom, gene, strand,
                 float(psi1), float(psi2), float(dpsi), ev, ca)


def event_rmats(fields: Sequence[str]) -> Event:
    (etype, anno, chrom, gene, strand, j1, j2, j3, _w1, _w2, psi1, psi2, dpsi) = fields
    ev, ca = _roles_rmats(etype, j1, j2, j3)
    return Event(etype, anno, chrom, gene, strand,
                 float(psi1), float(psi2), float(dpsi), ev, ca)


def event_truth(fields: Sequence[str], dpsi: float) -> Event:
    """Truth CSV row; coverage triplets drive the ``-c`` filter
    (eparser.py:267-279)."""
    (etype, chrom, gene, strand, j1, j2, j3, w1, w2, psi1, psi2) = fields
    if etype == "ES":
        ev = fix_region(parse_region(j3))
        ca = [fix_region(parse_region(j1)), fix_region(parse_region(j2))]
    elif etype in ("A5", "A3"):
        ev = fix_region(parse_region(j2))
        ca = fix_region(parse_region(j1))
    elif etype == "IR":
        ev = fix_region(parse_region(j1))
        ca = fix_region(parse_region(j2))
    else:  # CE (eparser.py:301-307, kept as-is)
        ev = [parse_region(j2), parse_region(j3)]
        ca = parse_region(j1)
    e = Event(etype, "truth", chrom, gene, strand,
              float(psi1), float(psi2), dpsi, ev, ca)
    e.rc_c1 = list(map(int, w1.split("/")))
    e.rc_c2 = list(map(int, w2.split("/")))
    if etype == "ES":
        cov = [e.rc_c1[2], e.rc_c2[2]]
    elif etype == "IR":
        cov = [e.rc_c1[0], e.rc_c2[0]]
    else:
        cov = [e.rc_c1[1], e.rc_c2[1]]
    e.min_event_cov = min(cov)
    return e


def event_whippet(fields: Sequence[str]) -> Event:
    """A Whippet .diff row (tab-separated; eparser.py:310-363)."""
    (gene, _t1, region, strand, etype, psi1, psi2, dpsi, _t2, _t3, _t4) = fields
    chrom = region.split(":")[0]
    if etype == "IR":
        reg = parse_region(region)
        ev = [reg[0] - 1, reg[1] + 1]
    else:
        ev = parse_region(region)
    return Event(etype, "anno", chrom, gene, strand,
                 float(psi1), float(psi2), float(dpsi), ev, ".", whippet=True)


def eq_event_anno(e1: Event, e2: Event, relax: int = 0) -> bool:
    """eparser.py:366-449, incl. the Whippet coordinate-shift branches."""
    if e1.etype != e2.etype or e1.gene != e2.gene:
        return False
    if e1.etype == "CE":
        return (
            abs(e1.canonic_j[0] - e2.canonic_j[0]) <= relax
            and abs(e1.canonic_j[1] - e2.canonic_j[1]) <= relax
            and abs(e1.event_j[0][0] - e2.event_j[0][0]) <= relax
            and abs(e1.event_j[0][1] - e2.event_j[0][1]) <= relax
            and abs(e1.event_j[1][0] - e2.event_j[1][0]) <= relax
            and abs(e1.event_j[1][1] - e2.event_j[1][1]) <= relax
        )
    if e1.etype == "ES":
        if e1.whippet and not e2.whippet:
            return (
                abs(e1.event_j[0] - 1 - e2.canonic_j[0][1]) <= relax
                and abs(e1.event_j[1] + 1 - e2.canonic_j[1][0]) <= relax
            )
        if not e1.whippet and e2.whippet:
            return (
                abs(e2.event_j[0] - 1 - e1.canonic_j[0][1]) <= relax
                and abs(e2.event_j[1] + 1 - e1.canonic_j[1][0]) <= relax
            )
        return (
            abs(e1.event_j[0] - e2.event_j[0]) <= relax
            and abs(e1.event_j[1] - e2.event_j[1]) <= relax
            and abs(e1.canonic_j[0][0] - e2.canonic_j[0][0]) <= relax
            and abs(e1.canonic_j[0][1] - e2.canonic_j[0][1]) <= relax
            and abs(e1.canonic_j[1][0] - e2.canonic_j[1][0]) <= relax
            and abs(e1.canonic_j[1][1] - e2.canonic_j[1][1]) <= relax
        )
    if e1.etype == "IR":
        if e1.whippet and not e2.whippet:
            return (
                abs(e1.event_j[0] + 1 - e2.event_j[0]) <= relax
                and abs(e1.event_j[1] - 1 - e2.event_j[1]) <= relax
            )
        if not e1.whippet and e2.whippet:
            return (
                abs(e2.event_j[0] - e1.event_j[0] + 1) <= relax
                and abs(e2.event_j[1] - e1.event_j[1] - 1) <= relax
            )
        return (
            abs(e1.event_j[0] - e2.event_j[0]) <= relax
            and abs(e1.event_j[1] - e2.event_j[1]) <= relax
        )
    # A3 / A5
    if e1.whippet and not e2.whippet:
        return (
            abs(e1.event_j[0] - e2.event_j[0]) <= relax
            and abs(e1.event_j[1] + 1 - e2.canonic_j[0]) <= relax
        )
    if not e1.whippet and e2.whippet:
        return (
            abs(e2.event_j[0] - e1.event_j[0]) <= relax
            and abs(e2.event_j[1] + 1 - e1.canonic_j[0]) <= relax
        )
    return (
        abs(e1.canonic_j[0] - e2.canonic_j[0]) <= relax
        and abs(e1.canonic_j[1] - e2.canonic_j[1]) <= relax
        and abs(e1.event_j[0] - e2.event_j[0]) <= relax
        and abs(e1.event_j[1] - e2.event_j[1]) <= relax
    )


def eq_event_novel(e1: Event, e2: Event) -> bool:
    """eparser.py:452-479 (truth first; pantas/rMATS only)."""
    if e1.etype != e2.etype or e1.gene != e2.gene:
        return False
    if e1.etype == "CE":
        raise AssertionError("We have a novel cassete exon!")
    if e1.etype == "ES":
        return e1.canonic_j == e2.canonic_j
    if e1.etype == "IR":
        if e1.canonic_j == "." or e1.event_j == ".":
            e1_j = e1.canonic_j if e1.event_j == "." else e1.event_j
            return e1_j == e2.event_j
        if e2.canonic_j == "." or e2.event_j == ".":
            e2_j = e2.canonic_j if e2.event_j == "." else e2.event_j
            return e2_j == e1.event_j
        raise AssertionError("Compare novel IR, why are we here?")
    e2_j = e2.canonic_j if e2.event_j == "." else e2.event_j
    return e1.canonic_j == e2_j or e1.event_j == e2_j


def eq_event(e1: Event, e2: Event, novel: bool) -> bool:
    return eq_event_novel(e1, e2) if novel else eq_event_anno(e1, e2, relax=0)


def precision_recall_f1(tp: int, fn: int, fp: int):
    prec = round(float(tp) / (tp + fp) if tp + fp != 0 else 0, 3)
    rec = round(float(tp) / (tp + fn) if tp + fn != 0 else 0, 3)
    f1 = round(2 * float(tp) / (2 * tp + fp + fn) if tp + fp + fn != 0 else 0, 3)
    return [prec, rec, f1]


def _load_truth(path: str, events, min_dpsi: float) -> Dict[str, List[Event]]:
    out = {x: [] for x in ETYPES}
    for line in open(path):
        fields = line.strip().split(",")
        if fields[0] not in events:
            continue
        psi1, psi2 = float(fields[9]), float(fields[10])
        if isnan(psi1) or isnan(psi2):
            continue
        dpsi = max(0, psi1) - max(0, psi2)
        if psi1 == -1 and psi2 == -1:
            dpsi = -1
        e = event_truth(fields, dpsi)
        if abs(e.dpsi) < min_dpsi:
            continue
        out[e.etype].append(e)
    return out


def _load_csv(path: str, make_event, min_dpsi: float, skip_haplotype=False,
              dpsi_nan_only=False) -> Dict[str, List[Event]]:
    out = {x: [] for x in ETYPES}
    for line in open(path):
        if line.startswith("etype") or line.startswith("Gene"):
            continue
        fields = line.strip().split(",")
        if skip_haplotype and fields[2] == "haplotype":
            continue
        e = make_event(fields)
        if dpsi_nan_only:
            if isnan(e.dpsi):
                continue
        elif isnan(e.psi_c1) or isnan(e.psi_c2):
            continue
        if abs(e.dpsi) < min_dpsi:
            continue
        out[e.etype].append(e)
    return out


def _load_whippet(path: str, events, min_dpsi: float) -> Dict[str, List[Event]]:
    out = {x: [] for x in ETYPES}
    for line in open(path):
        if line.startswith("Gene"):
            continue
        fields = line.strip().split("\t")
        fields[4] = EMAP_WHIPPET.get(fields[4], fields[4])
        if fields[4] not in ETYPES:
            continue
        e = event_whippet(fields)
        if isnan(e.psi_c1) or isnan(e.psi_c2):
            continue
        if abs(e.dpsi) < min_dpsi:
            continue
        out[e.etype].append(e)
    return out


def compare_tools(
    truth_path: str,
    pantas_path: str,
    rmats_path: Optional[str] = None,
    whippet_path: Optional[str] = None,
    suppa_path: Optional[str] = None,
    events: Sequence[str] = ("ES", "A3", "A5", "IR"),
    min_dpsi: float = 0.05,
    min_cov: int = 5,
    novel: bool = False,
    supp: int = 0,
    tabs: bool = False,
    print_flag: bool = False,
    out=sys.stdout,
    err=sys.stderr,
) -> None:
    """The full cmp_pantas.py flow; stdout byte-identical to the reference."""
    sep = "\t" if tabs else ","
    truth = _load_truth(truth_path, events, min_dpsi)
    tools = [("pantas", _load_csv(pantas_path, event_pantas, min_dpsi,
                                  skip_haplotype=True))]
    if rmats_path:
        tools.append(("rMATS", _load_csv(rmats_path, event_rmats, min_dpsi)))
    if whippet_path:
        tools.append(("Whippet", _load_whippet(whippet_path, events, min_dpsi)))
    if suppa_path:
        tools.append(("SUPPA2", _load_csv(suppa_path, event_rmats, min_dpsi,
                                          dpsi_nan_only=True)))

    TP = {t: {x: 0 for x in ETYPES} for t, _ in tools}
    FN = {t: {x: 0 for x in ETYPES} for t, _ in tools}
    FP = {t: {x: 0 for x in ETYPES} for t, _ in tools}

    for etype in ETYPES:
        if etype not in events:
            continue
        for e1 in truth[etype]:
            # the -c coverage cut (cmp_pantas.py:17-23,132)
            if any(c < min_cov for c in e1.rc_c1 + e1.rc_c2):
                continue
            for tool, table in tools:
                eqs = [x for x in table[etype] if eq_event(e1, x, novel)]
                if eqs:
                    if tool != "pantas":
                        assert len(eqs) == 1
                    TP[tool][etype] += 1
                elif print_flag:
                    FN[tool][etype] += 1
                    # QUIRK cmp_pantas.py:152,167,182,197: pantas FNs go to
                    # stderr, the other tools' to stdout
                    if tool == "pantas":
                        print("FN", e1.to_csv(), file=err)
                    elif tool == "rMATS":
                        print("FN RMATS", e1.to_csv(), file=out)
                    elif tool == "Whippet":
                        print("FN WHIPPET", e1.to_csv(), file=out)
                    else:
                        print("FN SUPPA2", e1.to_csv(), file=out)
                else:
                    FN[tool][etype] += 1

    for etype in ETYPES:
        if etype not in events:
            continue
        for tool, table in tools:
            for e2 in table[etype]:
                if not any(eq_event(x, e2, novel) for x in truth[etype]):
                    FP[tool][etype] += 1
                    if print_flag:
                        # FP-rMATS goes to stdout (cmp_pantas.py:223)
                        stream = out if tool == "rMATS" else err
                        print(f"FP-{tool.upper()}", e2.to_csv(), file=stream)

    print("p-supp", "tool", "etype", "mindpsi", "mincov", "TP", "FN", "FP",
          "Prec", "Rec", "F1", "TOT", sep=sep, file=out)
    for tool, _ in tools:
        for etype in ETYPES:
            if etype not in events:
                continue
            tp, fn, fp = TP[tool][etype], FN[tool][etype], FP[tool][etype]
            print(
                supp if tool == "pantas" else 0,
                tool, etype, min_dpsi, min_cov, tp, fn, fp,
                *precision_recall_f1(tp, fn, fp), tp + fn,
                sep=sep, file=out,
            )
