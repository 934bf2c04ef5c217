"""RT-PCR truth scoring for the human experiment (3-homo).

Behavioral contract: the scoring/stdout surface of
``exps/3-homo-real/workflow/scripts/compare.py:1-510`` of the reference —
byte-identical prints on the same inputs under the same PYTHONHASHSEED
(several reference prints render raw Python sets, so their element order is
seed-dependent, like the caller's row order). The reference's figure
output (venn/box/strip plots) is out of scope; everything it computes and
prints — truth filtering, per-tool true-positive selection, negative rates,
Pearson correlations, the |ΔPSI − RTPCR| describe() tables, the missed-set
report — is reproduced.

Tool CSV formats parsed (same column contracts as the reference):

* pantas quant or quant-remap CSV (13- or 20-column ES rows),
* rMATS ``SE.MATS.JC.txt`` (21 tab columns),
* Whippet ``.diff`` (11 tab columns, CE rows),
* SUPPA2 ``.dpsi`` (3 tab columns, SE event ids),
* truth table: ``POS/NEG  chrom  exon_start  exon_end  gene [dpsi]``
  (the SUPPA2-paper RT-PCR set lifted to hg38, 3-homo ``README.md:33-55``).

Every tool's events key on the SKIPPED EXON's 1-based inclusive span
``chrom:s-e``; per-tool confidence filters differ (p-value for rMATS and
SUPPA2, posterior probability for Whippet, none for pantas).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

Events = Dict[str, List[Tuple[float, object]]]


def _interval(region: str) -> List[int]:
    return [int(x) for x in region.split(":")[1].split("-")]


def _push(events: Events, key: str, item) -> None:
    events[key] = events[key] + [item] if key in events else [item]


def parse_pantas(fpath: str) -> Events:
    """ES rows of a pantas quant(-remap) CSV -> skipped-exon keyed ΔPSI.

    The skipped exon spans (end(inclusion1)+1, start(inclusion2)-1); the
    sign flips because pantas's ΔPSI is inclusion-based while the truth is
    skipping-based (reference compare.py:52-62).
    """
    events: Events = {}
    for line in open(fpath):
        if line.startswith("etype"):
            continue
        cols = line.strip("\n").split(",")
        if len(cols) == 13:  # quant CSV
            etype, novel, chrom = cols[0], cols[1], cols[2]
            i1, i2 = cols[6], cols[7]
            dpsi = cols[12]
        else:  # 20-column quant-remap CSV
            (etype, novel, _hap, chrom) = cols[0], cols[1], cols[2], cols[3]
            i1, i2 = cols[12], cols[13]
            dpsi = cols[19]
        if etype != "ES":
            continue
        dpsi = float(dpsi)
        _s1, e1 = _interval(i1)
        s2, _e2 = _interval(i2)
        _push(events, f"{chrom}:{e1 + 1}-{s2 - 1}", (-float(dpsi), novel))
    return events


def parse_rmats(fpath: str) -> Events:
    events: Events = {}
    for line in open(fpath):
        if line.startswith("ID"):
            continue
        cols = line.strip("\n").split("\t")
        chrom, ex_s, ex_e = cols[3], int(cols[5]), int(cols[6])
        pv, delta_incl = float(cols[18]), float(cols[22])
        _push(events, f"{chrom}:{ex_s + 1}-{ex_e}", (-delta_incl, float(pv)))
    return events


def parse_whippet(fpath: str) -> Events:
    events: Events = {}
    for line in open(fpath):
        if line.startswith("Gene"):
            continue
        cols = line.strip("\t \n").split("\t")
        region, etype = cols[2], cols[4]
        if etype != "CE":
            continue
        _push(events, region, (-float(cols[7]), float(cols[8])))
    return events


def parse_suppa(fpath: str) -> Events:
    events: Events = {}
    for i, line in enumerate(open(fpath)):
        if i == 0:
            continue
        idx, dpsi, pvalue = line.strip("\n").split("\t")
        dpsi, pvalue = float(dpsi), float(pvalue)
        _gene, rest = idx.split(";")
        etype, chrom, *positions, _strand = rest.split(":")
        if not chrom.startswith("chr"):
            chrom = "chr" + chrom
        if etype == "SE":
            ab, cd = positions
            intron1 = tuple(int(x) for x in ab.split("-"))
            intron2 = tuple(int(x) for x in cd.split("-"))
            _push(events, f"{chrom}:{intron1[1]}-{intron2[0]}", (dpsi, pvalue))
    return events


def parse_truth(fpath: str) -> Tuple[Dict[str, float], Set[str]]:
    truth_pos: Dict[str, float] = {}
    truth_neg: Set[str] = set()
    for line in open(fpath):
        if line.startswith("POS"):
            _, chrom, exs, exe, _gidx, dpsi = line.strip("\n").split("\t")
            truth_pos[f"{chrom}:{exs}-{exe}"] = float(dpsi)
        else:
            _, chrom, exs, exe, _gidx = line.strip("\n").split("\t")
            truth_neg.add(f"{chrom}:{exs}-{exe}")
    return truth_pos, truth_neg


@dataclass
class RtpcrOptions:
    strict: bool = False
    common: bool = False
    delta: float = -1.0
    pvalue: float = -1.0
    prob: float = -1.0

    def resolve(self) -> "RtpcrOptions":
        # literal types matter: delta is rendered into stdout, and the
        # reference assigns the INT 0 in the non-strict default branch
        if self.strict:
            d = 0.05 if self.delta == -1 else self.delta
            p = 0.9 if self.prob == -1 else self.prob
            v = 0.05 if self.pvalue == -1 else self.pvalue
        else:
            d = 0 if self.delta == -1 else self.delta
            v = 2 if self.pvalue == -1 else self.pvalue
            p = self.prob
        return RtpcrOptions(self.strict, self.common, d, v, p)


def _conf_ok(tool: str, conf, opts: RtpcrOptions) -> bool:
    """Per-tool confidence gate (reference compare.py:197-207,233-242)."""
    if tool == "rMATS" or tool == "SUPPA2":
        return not conf > opts.pvalue
    if tool == "whippet":
        return not conf < opts.prob
    return True  # pantas carries no confidence


def run_compare(
    truth_path: str,
    pantas_path: str,
    rmats_path: str,
    whippet_path: str,
    suppa_path: str,
    opts: Optional[RtpcrOptions] = None,
    out=sys.stdout,
) -> Dict[str, object]:
    """Score all four tools against the RT-PCR truth; print the reference's
    exact stdout; return the scored tables for programmatic use."""
    opts = (opts or RtpcrOptions()).resolve()
    import pandas as pd

    p = lambda *a: print(*a, file=out)

    truth, negatives = parse_truth(truth_path)
    events: Dict[str, Events] = {
        "pantas": parse_pantas(pantas_path),
        "rMATS": parse_rmats(rmats_path),
        "whippet": parse_whippet(whippet_path),
        "SUPPA2": parse_suppa(suppa_path),
    }

    p("Truth:", len(truth))
    truth = {k: v for k, v in truth.items() if abs(v) >= opts.delta}
    p(f"Filtered truth with delta={opts.delta}:", len(truth))

    df_rows = []
    df_neg_rows = []
    for t, Es in events.items():
        TPs = set(Es.keys()) & set(truth.keys())
        if t == "pantas":
            p(set(truth.keys() - set(Es.keys())))
        for k in TPs:
            best_dpsi, best_conf, best_diff = -1, -1, 2
            for dpsi, conf in Es[k]:
                if abs(dpsi) < opts.delta:
                    continue
                if not _conf_ok(t, conf, opts):
                    continue
                if dpsi - truth[k] > best_diff:
                    continue
                best_dpsi, best_conf = dpsi, conf
                best_diff = dpsi - truth[k]
            if best_diff == 2:
                continue
            df_rows.append(
                [t, k, best_dpsi, best_conf, truth[k], abs(best_dpsi - truth[k])]
            )
        FPs = set(Es.keys()) & set(negatives)
        for k in FPs:
            add_flag = False
            for dpsi, conf in Es[k]:
                if abs(dpsi) < opts.delta:
                    continue
                if not _conf_ok(t, conf, opts):
                    continue
                add_flag = True
                break
            if add_flag:
                # QUIRK: the reference records the LAST-inspected (dpsi,
                # conf) pair — the leaked loop variables at the break — not
                # the best one (compare.py:243-250)
                df_neg_rows.append([t, k, dpsi, conf])

    df = pd.DataFrame(df_rows, columns=["Tool", "Event", "dPSI", "P", "RTPCR", "X"])
    df_neg = pd.DataFrame(df_neg_rows, columns=["Tool", "Event", "dPSI", "P"])

    tp_sets = {t: set(df[df["Tool"] == t]["Event"]) for t in events}
    neg_sets = {t: set(df_neg[df_neg["Tool"] == t]["Event"]) for t in events}
    all_sets = {t: set(Es.keys()) for t, Es in events.items()}

    p(
        "No whippet:",
        len(tp_sets["pantas"] & tp_sets["rMATS"] & tp_sets["SUPPA2"]),
    )

    for t in events:  # negative (true-negative-rate) report
        p(
            t,
            len(neg_sets[t] & negatives),
            "/",
            len(all_sets[t] & negatives),
            len(neg_sets[t] & negatives) / len(all_sets[t] & negatives),
        )

    if opts.common:
        shared = (
            tp_sets["pantas"] & tp_sets["rMATS"]
            & tp_sets["whippet"] & tp_sets["SUPPA2"]
        )
        df = df[df["Event"].isin(shared)]
        for t in tp_sets:
            tp_sets[t] &= shared

    correlations: Dict[str, float] = {}
    for t in events:
        p("---", t)
        from scipy.stats import pearsonr

        sub = df[df["Tool"] == t].sort_values(by="Event")
        corr, _ = pearsonr(sub["RTPCR"], sub["dPSI"])
        p(df[df["Tool"] == t]["X"].describe())
        correlations[t] = round(corr, 3)

    missed = (tp_sets["rMATS"] | tp_sets["whippet"] | tp_sets["SUPPA2"]) - tp_sets["pantas"]
    p("MISSED:", missed)
    for k in (tp_sets["SUPPA2"] | tp_sets["whippet"] | tp_sets["rMATS"]) - tp_sets["pantas"]:
        if k in tp_sets["whippet"]:
            p(k, events["whippet"][k])
        elif k in tp_sets["rMATS"]:
            p(k, events["rMATS"][k])
        else:
            p(k, events["SUPPA2"][k])

    p(
        "All:",
        len(
            (
                tp_sets["rMATS"] | tp_sets["whippet"] | tp_sets["SUPPA2"]
                | tp_sets["pantas"]
            )
            & set(truth.keys())
        ),
    )

    return {
        "df": df,
        "df_neg": df_neg,
        "tp_sets": tp_sets,
        "neg_sets": neg_sets,
        "correlations": correlations,
    }
