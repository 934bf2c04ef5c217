"""Result aggregation across tools (parse_res equivalent, CSV only).

Behavioral contract: the DATA outputs of
``exps/2-dm-real/workflow/scripts/parse_res.py:176-320`` of the reference —
``res.csv`` (per-event ΔPSI across pantas at every -w, rMATS, SUPPA2,
Whippet) and ``res_mask.csv`` (event name where detected, empty otherwise)
— plus the per-etype venn counts its figures render. The reference script
is Snakemake-embedded and plotting-heavy (seaborn/venn/SeabornFig2Grid);
the plots are out of scope, the tables are reproduced.

Reference quirks preserved/documented:

* pantas IR ΔPSI is negated on parse ("Pantas alternative isoform = rMATS
  canonical isoform", parse_res.py:89-91); SUPPA2 ΔPSI is likewise negated
  (parse_res.py:129);
* the per-tool "dedup by minimum p-value" is DEAD CODE in the reference:
  its eparser Event classes define no ``__eq__``, so ``e not in filt``
  is always true and the update branch (which would crash on
  ``filt[e][0]``, parse_res.py:112) never runs — events simply append;
* Whippet events are matched against every other tool's events with the
  comparator's region equality (``eq_event``, relax=4 default) and
  recorded under the MATCHED event's name; unmatched Whippet events append
  under their own name (parse_res.py:292-308).
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from pantas_tpu_torch.eval.cmp_tools import (
    Event,
    eq_event_anno,
    event_pantas,
    event_rmats,
    event_whippet,
)

# iteration order matters for row construction: the reference's main()
# loops ["ES", "A3", "A5", "IR"] (parse_res.py:213,229,252,271), and
# res.csv row order follows dict insertion order
ETYPES = ["ES", "A3", "A5", "IR"]
EMAP_WHIPPET = {"CE": "ES", "RI": "IR", "AD": "A5", "AA": "A3"}


def _by_etype() -> Dict[str, List[Event]]:
    return {x: [] for x in ETYPES}


def parse_pantas_csv(path: str, min_dpsi: float = 0.0) -> Dict[str, List[Event]]:
    out = _by_etype()
    for line in open(path):
        if line.startswith("etype"):
            continue
        e = event_pantas(line.strip().split(","))
        if e.etype not in out:
            continue
        if math.isnan(e.psi_c1) or math.isnan(e.psi_c2):
            continue
        if abs(e.dpsi) < min_dpsi:
            continue
        if e.etype == "IR":
            e.dpsi = -e.dpsi  # pantas alt isoform == rMATS canonical
        out[e.etype].append(e)
    return out


def parse_rmats_csv(path: str, min_dpsi: float = 0.0) -> Dict[str, List[Event]]:
    out = _by_etype()
    for line in open(path):
        if line.startswith("etype"):
            continue
        e = event_rmats(line.strip().split(","))
        if e.etype not in out:
            continue
        if math.isnan(e.psi_c1) or math.isnan(e.psi_c2):
            continue
        if abs(e.dpsi) < min_dpsi:
            continue
        out[e.etype].append(e)
    return out


def parse_suppa_csv(path: str, min_dpsi: float = 0.0) -> Dict[str, List[Event]]:
    out = _by_etype()
    for line in open(path):
        if line.startswith("etype"):
            continue
        e = event_rmats(line.strip().split(","))
        if e.etype not in out:
            continue
        e.dpsi = -e.dpsi
        if abs(e.dpsi) < min_dpsi:
            continue
        out[e.etype].append(e)
    return out


def parse_whippet_diff(path: str, min_dpsi: float = 0.0) -> Dict[str, List[Event]]:
    out = _by_etype()
    for line in open(path):
        if line.startswith("Gene"):
            continue
        fields = line.strip().split("\t")
        fields[4] = EMAP_WHIPPET.get(fields[4], fields[4])
        if fields[4] not in ETYPES:
            continue
        e = event_whippet(fields)
        if math.isnan(e.psi_c1) or math.isnan(e.psi_c2):
            continue
        if abs(e.dpsi) < min_dpsi:
            continue
        out[e.etype].append(e)
    return out


def _ename(e: Event) -> str:
    return f"{e.etype}_{e.chrom}_{e.event_j[0]}_{e.event_j[1]}"


def aggregate(
    pantas_by_w: Dict[object, Dict[str, List[Event]]],
    rmats: Dict[str, List[Event]],
    suppa: Dict[str, List[Event]],
    whippet: Dict[str, List[Event]],
    relax: int = 4,
) -> Tuple[List[str], List[dict]]:
    """Merged per-event ΔPSI table; returns (columns, rows).

    Row-construction order mirrors the reference exactly: pantas at the
    first w seeds the table, later w's / rMATS / SUPPA2 extend it, Whippet
    fills matched rows last and appends unmatched events.
    """
    ws = list(pantas_by_w)
    columns = ["type", "event", "whippet", "SUPPA2", "rMATS"] + [
        f"pantas_{w}" for w in ws
    ]
    data: Dict[str, dict] = {}
    # p_d accumulates every non-whippet event for the whippet matching pass
    p_d: Dict[str, List[Event]] = {k: list(v) for k, v in pantas_by_w[ws[0]].items()}

    def new_row(etype: str, name: str) -> dict:
        row = {c: math.nan for c in columns}
        row["type"] = etype
        row["event"] = name
        return row

    for key in ETYPES:
        for event in pantas_by_w[ws[0]][key]:
            name = _ename(event)
            row = new_row(key, name)
            row[f"pantas_{ws[0]}"] = event.dpsi
            data[name] = row
    for w in ws[1:]:
        for key in ETYPES:
            for event in pantas_by_w[w][key]:
                name = _ename(event)
                if name in data:
                    data[name][f"pantas_{w}"] = event.dpsi
                else:
                    row = new_row(key, name)
                    row[f"pantas_{w}"] = event.dpsi
                    data[name] = row
                    p_d[key].append(event)
    for tool, events in (("rMATS", rmats), ("SUPPA2", suppa)):
        for key in ETYPES:
            for event in events[key]:
                name = _ename(event)
                if name in data:
                    data[name][tool] = event.dpsi
                else:
                    row = new_row(key, name)
                    row[tool] = event.dpsi
                    data[name] = row
                    p_d[key].append(event)

    # whippet: region-equality match against everything seen so far
    matched_names: Dict[str, Dict[str, float]] = {e: {} for e in ETYPES}
    matched_whippet: set = set()
    for e in ETYPES:
        for c in whippet[e]:
            for t in p_d[e]:
                if eq_event_anno(c, t, relax):
                    matched_names[e][_ename(t)] = c.dpsi
                    matched_whippet.add(_ename(c))
    for name, row in data.items():
        hits = matched_names[row["type"]]
        if name in hits:
            row["whippet"] = hits[name]
    for key in ETYPES:
        for event in whippet[key]:
            name = _ename(event)
            if name not in matched_whippet:
                row = new_row(key, name)
                row["whippet"] = event.dpsi
                data[name] = row

    return columns, list(data.values())


def write_res_csvs(columns, rows, res_path: str, mask_path: str) -> None:
    """res.csv + res_mask.csv with pandas' NaN-as-empty rendering
    (parse_res.py:311-320 semantics)."""
    import pandas as pd

    df = pd.DataFrame(rows, columns=columns)
    df.to_csv(res_path, index=False)
    mask = df.copy()
    for col in columns:
        if col not in ("type", "event"):
            mask[col] = df.apply(
                lambda r: r["event"] if not pd.isna(r[col]) else pd.NA, axis=1
            )
    mask.to_csv(mask_path, index=False)


def venn_counts(columns, rows, out=sys.stdout) -> None:
    """Per-etype detection counts for every tool-subset intersection (the
    numbers the reference's venn figures display)."""
    from itertools import combinations

    tools = [c for c in columns if c not in ("type", "event")]
    print("etype,tools,count", file=out)
    for etype in ETYPES:
        sets = {
            t: {
                r["event"]
                for r in rows
                if r["type"] == etype and isinstance(r[t], float)
                and not math.isnan(r[t])
            }
            for t in tools
        }
        for k in range(1, len(tools) + 1):
            for combo in combinations(tools, k):
                common = set.intersection(*(sets[t] for t in combo))
                print(f"{etype},{'|'.join(combo)},{len(common)}", file=out)
