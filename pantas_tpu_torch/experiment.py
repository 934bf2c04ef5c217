"""Experiment driver: end-to-end differential-AS experiments from one config.

Native replacement for the reference's per-experiment Snakemake workflows
(``exps/1-dm-sim``, ``exps/2-dm-real``, ``exps/3-homo-real``): build the
annotated pangenome once, then for every replicate of both conditions run
map -> fused coverage+call, then quant -> remap, and optionally score
against a truth table.

Config (JSON):

    {
      "fa": "genome.fa", "gtf": "genes.gtf", "vcf": "vars.vcf.gz",
      "workdir": "wd",
      "conditions": {
        "c1": [["r1_1.fq", "r1_2.fq"], ["r2_1.fq", "r2_2.fq"]],
        "c2": [["r3_1.fq", "r3_2.fq"], ["r4_1.fq", "r4_2.fq"]]
      },
      "build": {"hp": 0},
      "call": {"w": 3, "novel": true, "minintronsize": 100},
      "quant": {"all": true},      // NOTE: harness default all=true
                                   // (one-sided events kept); the stage
                                   // CLI default is --both
      "remap": {"min_intron_size": 100},
      "eval": {"truth": "truth.csv", "min_dpsi": 0.05, "relax": 3},
      "novel_sites": true,            // or {"w": 3, "min_clip": 5, "events": true}
      "threads": 2
    }

``novel_sites`` (extension, off by default) additionally writes a
``<cond>_r<i>.sites.csv`` per replicate: intra-node novel splice sites
from clip pile-ups, classified into A3/A5 rows (``events/sites.py``).

Stage artifacts land under ``workdir`` (same stage-file resumability
contract as the reference: existing artifacts are reused).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional


def _log(msg: str, log) -> None:
    print(f"[exp] {msg}", file=log, flush=True)


def run_experiment(config_path: str, log=sys.stderr) -> Dict:
    cfg = json.load(open(config_path))
    wd = cfg["workdir"]
    conds_early = list(cfg.get("conditions", {}))
    if len(conds_early) != 2:
        # validate BEFORE hours of build/map work (and before python -O
        # could strip a late assert)
        raise ValueError(
            f"exactly two conditions required, got {len(conds_early)}"
        )
    os.makedirs(wd, exist_ok=True)
    threads = int(cfg.get("threads", 2))
    gtf = cfg["gtf"]

    # 1. build (resumable)
    gfa = os.path.join(wd, "pantranscriptome-annotated.gfa")
    if not os.path.exists(gfa):
        t0 = time.time()
        from pantas_tpu_torch.build.pipeline import build_pangenome

        vcf = cfg["vcf"]
        held_out = cfg.get("build", {}).get("exclude_sample")
        if held_out:
            # held-out-sample protocol (reference
            # exps/1-dm-sim/workflow/rules/pantas.smk:1-10): the graph must
            # not contain the haplotypes reads were simulated from
            from pantas_tpu_torch.io.vcf import write_vcf_excluding_sample

            filtered = os.path.join(wd, "variants.heldout.vcf")
            write_vcf_excluding_sample(vcf, filtered, held_out)
            vcf = filtered
            _log(f"build: held out sample {held_out}", log)
        build_pangenome(
            cfg["fa"], gtf, vcf, wd,
            hp=int(cfg.get("build", {}).get("hp", 0)), threads=threads, log=log,
        )
        _log(f"build: {time.time() - t0:.1f}s", log)
    else:
        _log("build: reusing existing pangenome", log)

    # 2. per replicate: map + fused coverage/call
    from pantas_tpu_torch.events import CallOptions, call_events
    from pantas_tpu_torch.events.caller import SplicingGraph
    from pantas_tpu_torch.graph.compiler import compile_gfa
    from pantas_tpu_torch.mapping.mapper import map_reads

    call_cfg = cfg.get("call", {})
    opts = CallOptions(
        rca=int(call_cfg.get("w", 3)),
        novel=bool(call_cfg.get("novel", False)),
        no_annotated=bool(call_cfg.get("no_annotated", False)),
        events=call_cfg.get("events", ["ES", "SS", "IR"]),
        isw=int(call_cfg.get("isw", 5)),
        minintronsize=int(call_cfg.get("minintronsize", 100)),
    )

    tensors = None
    event_csvs: Dict[str, List[str]] = {}
    for cond, replicates in cfg["conditions"].items():
        event_csvs[cond] = []
        for ri, fqs in enumerate(replicates, start=1):
            tag = f"{cond}_r{ri}"
            gaf = os.path.join(wd, f"{tag}.gaf")
            events_csv = os.path.join(wd, f"{tag}.events.csv")
            event_csvs[cond].append(events_csv)
            if os.path.exists(events_csv):
                _log(f"{tag}: reusing {events_csv}", log)
                continue
            t0 = time.time()
            if not os.path.exists(gaf):
                # write-then-rename so a crash never leaves a partial
                # artifact that a rerun would treat as complete
                with open(gaf + ".tmp", "w") as out:
                    map_reads(
                        gfa, fqs[0], fqs[1] if len(fqs) > 1 else None,
                        out=out, log=log, threads=threads,
                    )
                os.replace(gaf + ".tmp", gaf)
            if tensors is None:
                tensors = compile_gfa(gfa)
            graph = None
            try:
                from pantas_tpu_torch.native import NativeCoverage

                eng = NativeCoverage(tensors)
                eng.process_file(gaf, threads=threads)
                # counts apply straight from the engine vector (no
                # CoverageCounts dict materialization — caller.from_engine)
                graph = SplicingGraph.from_engine(gfa, tensors, eng)
            except Exception as e:
                _log(f"{tag}: native coverage unavailable ({e}); host path", log)
                from pantas_tpu_torch.coverage.host import accumulate_gaf, load_node_lengths

                with open(gaf) as fh:
                    counts = accumulate_gaf(fh, load_node_lengths(gfa))
            if graph is None:
                graph = SplicingGraph.from_coverage(gfa, counts)
            with open(events_csv + ".tmp", "w") as out:
                for row in call_events(gfa, gtf, opts, graph=graph, log=log):
                    print(row, file=out)
            os.replace(events_csv + ".tmp", events_csv)
            _log(f"{tag}: map+call {time.time() - t0:.1f}s", log)

    # optional: intra-node novel splice sites per replicate (extension;
    # the compat pipeline cannot express these — events/sites.py)
    ns_cfg = cfg.get("novel_sites")
    if ns_cfg:
        from pantas_tpu_torch.events.sites import (
            EVENTS_HEADER,
            classify_sites,
            detect_novel_sites,
            write_novel_sites,
        )

        ns_opts = ns_cfg if isinstance(ns_cfg, dict) else {}
        for cond, replicates in cfg["conditions"].items():
            for ri in range(1, len(replicates) + 1):
                tag = f"{cond}_r{ri}"
                sites_csv = os.path.join(wd, f"{tag}.sites.csv")
                if os.path.exists(sites_csv):
                    continue
                rows = detect_novel_sites(
                    os.path.join(wd, f"{tag}.gaf"), gfa,
                    w=int(ns_opts.get("w", 3)),
                    min_clip=int(ns_opts.get("min_clip", 5)),
                )
                with open(sites_csv + ".tmp", "w") as out:
                    if ns_opts.get("events", True):
                        print(EVENTS_HEADER, file=out)
                        for r in classify_sites(rows, gtf):
                            print(r, file=out)
                    else:
                        write_novel_sites(rows, out=out)
                os.replace(sites_csv + ".tmp", sites_csv)
                _log(f"{tag}: novel-sites -> {sites_csv}", log)

        if ns_opts.get("quant"):
            # quantified two-condition events (donor/acceptor merging +
            # PSI analogue) across all replicate GAFs
            from pantas_tpu_torch.events.sites import QUANT_HEADER, quantify_sites

            sq_csv = os.path.join(wd, "sites_quant.csv")
            if not os.path.exists(sq_csv):
                conds_ = list(cfg["conditions"])
                gafs = {
                    c: [
                        os.path.join(wd, f"{c}_r{ri}.gaf")
                        for ri in range(1, len(cfg["conditions"][c]) + 1)
                    ]
                    for c in conds_
                }
                rows = quantify_sites(
                    gafs[conds_[0]], gafs[conds_[1]], gfa, gtf,
                    w=int(ns_opts.get("w", 3)),
                    min_clip=int(ns_opts.get("min_clip", 5)),
                )
                with open(sq_csv + ".tmp", "w") as out:
                    print(QUANT_HEADER, file=out)
                    for r in rows:
                        print(r, file=out)
                os.replace(sq_csv + ".tmp", sq_csv)
                _log(f"novel-sites quant -> {sq_csv}", log)

    conds = list(cfg["conditions"])

    # 3. quant + remap
    from pantas_tpu_torch.quant import quantify
    from pantas_tpu_torch.remap import remap as remap_stage

    quant_csv = os.path.join(wd, "quant.csv")
    pool_w = cfg.get("quant", {}).get("pool_w")
    with open(quant_csv, "w") as out:
        quantify(
            event_csvs[conds[0]],
            event_csvs[conds[1]],
            both=not bool(cfg.get("quant", {}).get("all", True)),
            min_w=int(cfg.get("quant", {}).get("w", 0)),
            out=out,
            pool_w=int(pool_w) if pool_w is not None else None,
        )
    remap_csv = os.path.join(wd, "quant-remap.csv")
    with open(remap_csv, "w") as out:
        remap_stage(
            quant_csv, gtf,
            min_intron_size=int(cfg.get("remap", {}).get("min_intron_size", 100)),
            out=out,
        )
    n_events = sum(1 for _ in open(remap_csv)) - 1
    _log(f"quant-remap: {n_events} events -> {remap_csv}", log)

    result = {"remap_csv": remap_csv, "n_events": n_events}

    # 4. optional truth scoring
    eval_cfg = cfg.get("eval")
    if eval_cfg and eval_cfg.get("truth"):
        from pantas_tpu_torch.eval.compare import (
            parse_quant_remap,
            parse_truth,
            print_scores,
            score,
        )

        truth = parse_truth(eval_cfg["truth"])
        called = parse_quant_remap(remap_csv)
        scores = score(
            truth,
            called,
            relax=int(eval_cfg.get("relax", 3)),
            min_dpsi=float(eval_cfg.get("min_dpsi", 0.0)),
            min_w=float(eval_cfg.get("min_w", 0.0)),
        )
        scores_csv = os.path.join(wd, "scores.csv")
        with open(scores_csv, "w") as out:
            print_scores(scores, out)
        _log(f"eval: F1={scores['ALL']['f1']:.3f} -> {scores_csv}", log)
        result["scores"] = scores
        result["scores_csv"] = scores_csv

        # per-coverage-cut sweep (reference Snakefile:83-108 scores at
        # c in {1,3,5,10,20})
        cuts = eval_cfg.get("cuts")
        if cuts:
            by_cut_csv = os.path.join(wd, "scores_by_cut.csv")
            with open(by_cut_csv, "w") as out:
                print("cut,etype,tp,fp,fn,precision,recall,f1", file=out)
                for cut in cuts:
                    sc = score(
                        truth, called,
                        relax=int(eval_cfg.get("relax", 3)),
                        min_dpsi=float(eval_cfg.get("min_dpsi", 0.0)),
                        min_w=float(cut),
                    )
                    for etype, m in sc.items():
                        print(
                            f"{cut},{etype},{m['tp']},{m['fp']},{m['fn']},"
                            f"{m['precision']:.3f},{m['recall']:.3f},{m['f1']:.3f}",
                            file=out,
                        )
            result["scores_by_cut_csv"] = by_cut_csv
            _log(f"eval: per-cut scores -> {by_cut_csv}", log)
            if eval_cfg.get("figures"):
                # P/R panel over the cut sweep (plot_pr.py equivalent)
                try:
                    from pantas_tpu_torch.eval.plots import (
                        PR_CSV_HEADER,
                        pr_csv_lines_from_scores,
                        render_pr,
                    )

                    w = cfg.get("call", {}).get("w", 3)
                    cmp_csv = os.path.join(wd, "scores_cmp.csv")
                    with open(cmp_csv, "w") as out:
                        print(PR_CSV_HEADER, file=out)
                        for line in pr_csv_lines_from_scores(by_cut_csv, w):
                            print(line, file=out)
                    png = render_pr(cmp_csv, os.path.join(wd, "scores_pr.png"))
                    result["scores_pr_png"] = png
                    _log(f"eval: P/R figure -> {png}", log)
                except Exception as e:  # best-effort; tables are the data
                    _log(f"eval: figure render skipped ({e})", log)
    return result
