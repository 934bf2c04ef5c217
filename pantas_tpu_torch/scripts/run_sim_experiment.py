#!/usr/bin/env python3
"""Simulation experiment with the held-out-sample VCF protocol.

The native equivalent of the reference's ``exps/1-dm-sim`` workflow
(``rules/pantas.smk:1-10`` + ``Snakefile:83-108``):

1. build the held-out sample's SNP consensus genome (its haplotype is what
   reads will be simulated from — the graph must NOT contain it);
2. simulate N replicates x two conditions of AS-event reads on the
   consensus (ES/IR/A3/A5/CE, ΔPSI ≈ 0.5 signal) + both truth channels;
3. run the full pipeline via the experiment driver with the sample's
   genotypes EXCLUDED from the graph build, once per w;
4. score P/R/F1 against the truth at coverage cuts {1,3,5,10,20}.

Two genome modes:

* panel (default) — the reference's own ``example/4`` inputs;
* genome-scale — ``mbp > 0``: a multi-chromosome synthetic genome from the
  stress generators (the reference simulates genome-wide over 7 Drosophila
  chromosomes, ``exps/1-dm-sim/workflow/Snakefile:19-20``), e.g.

    python -m pantas_tpu_torch.scripts.run_sim_experiment .bench/simg s19 125 30 25 2

  = 25 Mbp genome, 125 events (25/type), depth 30, 2 replicates,
  w ∈ {3, 5}. Scores land in ``workdir/scores_w{W}.csv``.

Usage: python -m pantas_tpu_torch.scripts.run_sim_experiment [workdir] [sample] [n_events] [depth] [mbp]
                             [replicates] [dpsi] [error_rate] [depth_factors]

Hard-regime knobs (de-saturating the benchmark — the all-1.000 anno-mode
table at ΔPSI 0.5 / error 0.1% measures nothing): ``dpsi`` sets the c2
event fraction (ΔPSI signal), ``error_rate`` the per-base substitution
rate, ``depth_factors`` a comma list cycled over replicates (unequal
depths), e.g.

    python -m pantas_tpu_torch.scripts.run_sim_experiment .bench/simhard s19 125 30 25 3 \
        0.1 0.01 1.0,0.6,0.3
"""

import json
import os
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO))

# panel mode: the example of the reference checkout named by PANTAS_REFERENCE
EXAMPLE = Path(os.environ.get("PANTAS_REFERENCE", "reference")) / "example"

WD = Path(sys.argv[1]) if len(sys.argv) > 1 else REPO / ".bench" / "simexp"
SAMPLE = sys.argv[2] if len(sys.argv) > 2 else "DGRP-021"
N_EVENTS = int(sys.argv[3]) if len(sys.argv) > 3 else 16
DEPTH = int(sys.argv[4]) if len(sys.argv) > 4 else 30
MBP = float(sys.argv[5]) if len(sys.argv) > 5 else 0.0
REPLICATES = int(sys.argv[6]) if len(sys.argv) > 6 else 1
# hard-regime knobs (VERDICT r3 task 5 — de-saturate the benchmark):
DPSI = float(sys.argv[7]) if len(sys.argv) > 7 else 0.5
ERROR = float(sys.argv[8]) if len(sys.argv) > 8 else 0.001
DEPTH_FACTORS = (
    [float(x) for x in sys.argv[9].split(",")] if len(sys.argv) > 9 else []
)
WS = [3] if MBP == 0 else [3, 5]
HARD = DPSI != 0.5 or ERROR != 0.001 or bool(DEPTH_FACTORS)


def log(msg):
    print(f"[simexp] {msg}", file=sys.stderr, flush=True)


def ensure_genome():
    """Return (fa, gtf, vcf) — example/4 or a generated synthetic genome."""
    if MBP == 0:
        return EXAMPLE / "4.fa", EXAMPLE / "4.gtf", EXAMPLE / "4.vcf.gz"
    gdir = WD / "genome"
    fa, gtf, vcf = gdir / "g.fa", gdir / "g.gtf", gdir / "g.vcf"
    if not fa.exists():
        from pantas_tpu_torch.scripts import stress_build

        gdir.mkdir(parents=True, exist_ok=True)
        n_chroms = max(1, int(MBP // 12))
        log(f"generating {MBP} Mbp synthetic genome ({n_chroms} chroms)..")
        stress_build.gen_inputs(
            gdir, mbp=MBP, n_var=int(MBP * 10_000), n_genes=int(MBP * 40),
            n_samples=20, n_chroms=n_chroms, n_exons=8, n_tx=2,
        )
    return fa, gtf, vcf


def main():
    WD.mkdir(parents=True, exist_ok=True)
    fa, gtf, vcf = ensure_genome()

    # 1. held-out sample consensus (SNPs, hap 1)
    from pantas_tpu_torch.io.fasta import read_fasta
    from pantas_tpu_torch.io.vcf import consensus_snps

    cons_fa = WD / "consensus.fa"
    if not cons_fa.exists():
        ref = read_fasta(str(fa))
        cons = consensus_snps(ref, str(vcf), SAMPLE, hap=1)
        with open(cons_fa, "w") as fh:
            for chrom, seq in cons.items():
                fh.write(f">{chrom}\n")
                for i in range(0, len(seq), 80):
                    fh.write(seq[i : i + 80] + "\n")
        log(f"consensus of {SAMPLE} hap1 -> {cons_fa}")

    # 2. simulate on the consensus
    from pantas_tpu_torch.eval.simulate import simulate

    prefix = WD / "sim"
    if not (WD / "sim_truth.csv").exists():
        simulate(
            str(cons_fa), str(gtf), str(prefix),
            n_events=N_EVENTS, reads_per_isoform=DEPTH,
            etypes=("ES", "IR", "A3", "A5", "CE"),
            replicates=REPLICATES,
            dpsi=DPSI, error_rate=ERROR, depth_factors=DEPTH_FACTORS,
            min_pairs=2 if HARD else 8,
        )

    def rep_fqs(cond):
        if REPLICATES == 1:
            return [[f"{prefix}_{cond}_1.fq", f"{prefix}_{cond}_2.fq"]]
        return [
            [f"{prefix}_{cond}_r{r}_1.fq", f"{prefix}_{cond}_r{r}_2.fq"]
            for r in range(1, REPLICATES + 1)
        ]

    # 3+4. experiment driver per (mode, w), with the sample excluded from
    # the build. Two modes, mirroring the reference workflow's annov axis
    # (exps/1-dm-sim/workflow/rules/pantas.smk:16-19):
    #   anno  — graph built from the variant-INCLUSIVE annotation
    #           (splicing_variants.gtf): every simulated event is an
    #           annotated event with graph support at its splice sites;
    #   novel — graph built without the event isoforms; events must be
    #           recovered by the novel-calling pass (-n).
    # Within a mode, w > first reuses the first run's build + GAFs
    # (hardlinked) — only call/quant/remap re-run.
    from pantas_tpu_torch.experiment import run_experiment

    first_run = None
    for mode in ("anno", "novel"):
        mode_gtf = f"{prefix}_variants.gtf" if mode == "anno" else str(gtf)
        mode_first = None
        for w in WS:
            run_wd = WD / f"run_{mode}_w{w}"
            legacy = WD / f"run_w{w}"
            if mode == "novel" and legacy.exists() and not run_wd.exists():
                run_wd = legacy  # pre-anno-mode layout
            if mode_first is not None and not run_wd.exists():
                run_wd.mkdir()
                for name in os.listdir(mode_first):
                    if name.endswith(".gaf") or name == "pantranscriptome-annotated.gfa":
                        os.link(mode_first / name, run_wd / name)
            cfg = {
                "fa": str(fa),
                "gtf": mode_gtf,
                "vcf": str(vcf),
                "workdir": str(run_wd),
                "build": {"hp": 0, "exclude_sample": SAMPLE},
                "conditions": {"c1": rep_fqs("c1"), "c2": rep_fqs("c2")},
                "call": {"w": w, "novel": mode == "novel", "minintronsize": 20},
                "quant": {"all": True},
                "remap": {"min_intron_size": 20},
                "eval": {
                    "truth": f"{prefix}_truth.csv",
                    "min_dpsi": 0.05,
                    "relax": 5,
                    "cuts": [1, 3, 5, 10, 20],
                },
                "threads": 2,
            }
            cfg_path = WD / f"exp_{mode}_w{w}.json"
            cfg_path.write_text(json.dumps(cfg, indent=2))
            result = run_experiment(str(cfg_path))
            if mode_first is None:
                mode_first = run_wd
            if first_run is None:
                first_run = run_wd

            shutil.copy(result["scores_by_cut_csv"], WD / f"scores_{mode}_w{w}.csv")
            rows = [
                l.strip("\n").split(",")
                for l in open(result["scores_by_cut_csv"])
            ][1:]
            print(
                f"\n### Sim accuracy ({mode} mode, held-out {SAMPLE}, "
                f"{N_EVENTS} events, {REPLICATES} reps, w={w}"
                + (f", {MBP:g} Mbp synthetic genome" if MBP else ", example/4 panel")
                + (
                    f", dPSI={DPSI:g}, err={ERROR:g}"
                    + (f", depth x{','.join(map(str, DEPTH_FACTORS))}"
                       if DEPTH_FACTORS else "")
                    if HARD else ""
                )
                + ")\n"
            )
            print("| cut | etype | TP | FP | FN | precision | recall | F1 |")
            print("|---|---|---|---|---|---|---|---|")
            for cut, etype, tp, fp, fn, p, r, f1 in rows:
                if etype in ("ES", "CE", "IR", "A3", "A5", "ALL"):
                    print(f"| {cut} | {etype} | {tp} | {fp} | {fn} | {p} | {r} | {f1} |")

        # pooled-replicate quant (quant --pool-w, VERDICT r4 task 4):
        # ONE call pass at w=0 (events with their coverages reach quant),
        # then the pooled threshold replaces the per-replicate drop. The
        # second pooled w reuses the first's w=0 events CSVs (hardlinks).
        # Opt-in (PANTAS_SIM_POOLED=1) — it adds a full w=0 call pass.
        if mode == "anno" and os.environ.get("PANTAS_SIM_POOLED"):
            pool_first = None
            for w in WS:
                run_wd = WD / f"run_anno_pool_w{w}"
                if not run_wd.exists():
                    run_wd.mkdir()
                    src = pool_first or mode_first
                    for name in os.listdir(src):
                        link = (
                            name.endswith(".gaf")
                            or name == "pantranscriptome-annotated.gfa"
                            or (pool_first and name.endswith(".events.csv"))
                        )
                        if link:
                            os.link(src / name, run_wd / name)
                cfg = {
                    "fa": str(fa),
                    "gtf": mode_gtf,
                    "vcf": str(vcf),
                    "workdir": str(run_wd),
                    "build": {"hp": 0, "exclude_sample": SAMPLE},
                    "conditions": {"c1": rep_fqs("c1"), "c2": rep_fqs("c2")},
                    "call": {"w": 0, "novel": False, "minintronsize": 20},
                    "quant": {"all": True, "pool_w": w},
                    "remap": {"min_intron_size": 20},
                    "eval": {
                        "truth": f"{prefix}_truth.csv",
                        "min_dpsi": 0.05,
                        "relax": 5,
                        "cuts": [1, 3, 5, 10, 20],
                    },
                    "threads": 2,
                }
                cfg_path = WD / f"exp_anno_pool_w{w}.json"
                cfg_path.write_text(json.dumps(cfg, indent=2))
                result = run_experiment(str(cfg_path))
                if pool_first is None:
                    pool_first = run_wd
                shutil.copy(
                    result["scores_by_cut_csv"], WD / f"scores_anno_pool_w{w}.csv"
                )
                rows = [
                    l.strip("\n").split(",")
                    for l in open(result["scores_by_cut_csv"])
                ][1:]
                print(
                    f"\n### Sim accuracy (anno mode, POOLED quant: call w=0 + "
                    f"quant --pool-w {w}, held-out {SAMPLE}, {N_EVENTS} events, "
                    f"{REPLICATES} reps"
                    + (f", dPSI={DPSI:g}, err={ERROR:g}" if HARD else "")
                    + ")\n"
                )
                print("| cut | etype | TP | FP | FN | precision | recall | F1 |")
                print("|---|---|---|---|---|---|---|---|")
                for cut, etype, tp, fp, fn, pr_, r, f1 in rows:
                    if etype in ("ES", "CE", "IR", "A3", "A5", "ALL"):
                        print(f"| {cut} | {etype} | {tp} | {fp} | {fn} | {pr_} | {r} | {f1} |")

        # P/R panel across every -w of this mode (plot_pr.py equivalent)
        try:
            from pantas_tpu_torch.eval.plots import (
                PR_CSV_HEADER,
                pr_csv_lines_from_scores,
                render_pr,
            )

            lines = [PR_CSV_HEADER]
            for w in WS:
                lines += pr_csv_lines_from_scores(
                    str(WD / f"scores_{mode}_w{w}.csv"), w
                )
            cmp_csv = WD / f"scores_{mode}_cmp.csv"
            cmp_csv.write_text("\n".join(lines) + "\n")
            render_pr(str(cmp_csv), str(WD / f"scores_{mode}_pr.png"))
            log(f"P/R figure -> {WD / f'scores_{mode}_pr.png'}")
        except Exception as e:  # figures are best-effort; tables are the data
            log(f"figure render skipped: {e}")

    # novel-sites scoring runs on the NOVEL-mode graph (the anno graph has
    # the sites as real node boundaries — nothing intra-node left to find)
    score_novel_sites(WD, prefix, run_dir=first_run and (WD / f"run_novel_w{WS[0]}"
                      if (WD / f"run_novel_w{WS[0]}").exists()
                      else WD / f"run_w{WS[0]}"))


def score_novel_sites(wd, prefix, tol=3, run_dir=None):
    """Intra-node splice-site recovery (the ``novel-sites`` extension).

    Truth = every novel-junction endpoint the simulated A3/A5/CE events
    create at positions with NO node boundary in the graph: the shifted
    A3/A5 site, and all four endpoints of a cassette exon's two novel
    junctions. The compat pipeline (ours and the reference design alike)
    has structural recall 0 on these — see docs/SIM_ACCURACY.md.
    """
    import csv

    from pantas_tpu_torch.events.sites import detect_novel_sites

    run_dir = Path(run_dir) if run_dir else wd / "run"

    truth = []
    for row in csv.DictReader(open(f"{prefix}_truth.csv")):
        et = row["etype"]
        if et in ("A3", "A5"):
            c1s, c1e = map(int, row["region1"].split(":")[1].split("-"))
            c2s, c2e = map(int, row["region2"].split(":")[1].split("-"))
            if c1s != c2s:
                truth.append((et, "end", min(c1s, c2s) - 1))
            if c1e != c2e:
                truth.append((et, "start", max(c1e, c2e) + 1))
        elif et == "CE":
            i_s, i_e = map(int, row["region1"].split(":")[1].split("-"))
            s, e = map(int, row["region2"].split(":")[1].split("-"))
            truth += [(et, "end", i_s - 1), (et, "start", s),
                      (et, "end", e), (et, "start", i_e + 1)]
    if not truth:
        return

    gfa = run_dir / "pantranscriptome-annotated.gfa"
    det = []
    for gaf in sorted(run_dir.glob("c*_r*.gaf")):
        for r in detect_novel_sites(str(gaf), str(gfa), w=3):
            f = r.split(",")
            if f[1].isdigit():
                det.append((f[2], int(f[1])))

    hits = sum(
        any(s == side and abs(p - pos) <= tol for s, p in det)
        for _, side, pos in truth
    )
    tp = sum(
        any(side == s and abs(pos - p) <= tol for _, side, pos in truth)
        for s, p in det
    )
    print(f"\n### Intra-node novel splice sites (novel-sites, w=3, tol ±{tol})\n")
    print(f"truth sites {len(truth)} | detected {len(det)} | "
          f"site recall {hits}/{len(truth)} = {hits / len(truth):.2f} | "
          f"precision {tp}/{len(det) or 1} = {tp / (len(det) or 1):.2f} "
          f"(compat pipeline + reference design: structural recall 0)")

    # event-level: classify sites into A3/A5 by gene strand and score
    # against the shifted-site truth per (etype, gene)
    from pantas_tpu_torch.events.sites import classify_sites

    etruth = {}
    for row in csv.DictReader(open(f"{prefix}_truth.csv")):
        et = row["etype"]
        if et not in ("A3", "A5"):
            continue
        c1s, c1e = map(int, row["region1"].split(":")[1].split("-"))
        c2s, c2e = map(int, row["region2"].split(":")[1].split("-"))
        pos = (min(c1s, c2s) - 1) if c1s != c2s else (max(c1e, c2e) + 1)
        etruth[(et, row["gene"])] = pos

    gtf = None
    for cfg_name in ("exp_novel_w3.json", "exp_w3.json", "exp.json"):
        if (wd / cfg_name).exists():
            gtf = json.loads((wd / cfg_name).read_text())["gtf"]
            break
    events = []
    if gtf:
        for gaf in sorted(run_dir.glob("c*_r*.gaf")):
            rows = detect_novel_sites(str(gaf), str(gfa), w=3)
            events += [e.split(",") for e in classify_sites(rows, gtf)]
        ehits = sum(
            any(e[0] == et and e[3] == gene and abs(int(e[5]) - pos) <= tol
                for e in events)
            for (et, gene), pos in etruth.items()
        )
        print(f"event-level A3/A5 (novel-sites --events): recall "
              f"{ehits}/{len(etruth)} = {ehits / (len(etruth) or 1):.2f}")

    # quantified events (novel-sites --quant): donor/acceptor merging +
    # PSI analogue, scored at |dpsi| >= 0.05 like the main comparator
    if gtf:
        from pantas_tpu_torch.events.sites import quantify_sites

        c1 = sorted(str(p) for p in run_dir.glob("c1_r*.gaf"))
        c2 = sorted(str(p) for p in run_dir.glob("c2_r*.gaf"))
        if c1 and c2:
            rows = [r.split(",") for r in quantify_sites(c1, c2, str(gfa), gtf)]
            all_kept = [r for r in rows if abs(float(r[11])) >= 0.05]
            # CE rows are scored in their own section below — keeping
            # them in this A3/A5 precision denominator counted every
            # (true) CE row as an A3/A5 false positive
            kept = [r for r in all_kept if r[0] != "CE"]
            qhits = matched = 0
            for (et, gene), pos in etruth.items():
                if any(
                    r[0] == et and r[3] == gene
                    and any(
                        t.isdigit() and abs(int(t) - pos) <= tol
                        for t in (r[5], r[6])
                    )
                    for r in kept
                ):
                    qhits += 1
            for r in kept:
                if any(
                    r[0] == et and r[3] == gene
                    and any(
                        t.isdigit() and abs(int(t) - pos) <= tol
                        for t in (r[5], r[6])
                    )
                    for (et, gene), pos in etruth.items()
                ):
                    matched += 1
            nk = len(kept) or 1
            print(
                f"quantified events (novel-sites --quant, |dpsi|>=0.05): "
                f"recall {qhits}/{len(etruth)} = "
                f"{qhits / (len(etruth) or 1):.2f} | precision "
                f"{matched}/{len(kept)} = {matched / nk:.2f}"
            )

            # cassette exons (r5): paired canonical-boundary clip piles ->
            # CE rows; truth = the flanking annotated-intron endpoints
            ce_truth = {}
            for row in csv.DictReader(open(f"{prefix}_truth.csv")):
                if row["etype"] == "CE":
                    i_s, i_e = map(int, row["region1"].split(":")[1].split("-"))
                    ce_truth[row["gene"]] = (i_s - 1, i_e + 1)
            ce_rows = [r for r in all_kept if r[0] == "CE"]
            if ce_truth:
                def ce_match(r, gene, d, a):
                    return (
                        r[3] == gene
                        and abs(int(r[5]) - d) <= tol
                        and abs(int(r[6]) - a) <= tol
                    )
                chits = sum(
                    any(ce_match(r, g, d, a) for r in ce_rows)
                    for g, (d, a) in ce_truth.items()
                )
                cgood = sum(
                    any(ce_match(r, g, d, a) for g, (d, a) in ce_truth.items())
                    for r in ce_rows
                )
                nc = len(ce_rows) or 1
                print(
                    f"cassette exons (paired-boundary CE rows, |dpsi|>=0.05): "
                    f"recall {chits}/{len(ce_truth)} = "
                    f"{chits / (len(ce_truth) or 1):.2f} | precision "
                    f"{cgood}/{len(ce_rows)} = {cgood / nc:.2f}"
                )


if __name__ == "__main__":
    main()
