#!/usr/bin/env python3
"""Whole-genome-scale event-calling benchmark (VERDICT r2 task 3).

The call stage's cost scales with GRAPH size (junction count), not read
count — the panel-scale bench can't exercise it. This script builds (once,
cached under .bench/) a synthetic multi-Mbp pangenome with the stress
generators, synthesizes a GAF by sampling reads along the graph's own
transcript paths (exact-match walks — valid node lists, plens and cs
strings), augments natively, then times `call --rca 0`:

  * ours, host engine (events/caller.py)
  * ours, device engine (events/batched.py, 8/9 families batched), on the
    card unless ``CALL_SCALE_PLATFORM=cpu`` asks for the CPU
  * the reference (scripts/call.py of the reference checkout named by
    ``PANTAS_REFERENCE``), same input, subprocess

reporting wall time, events/s and peak RSS for each. Reference match:
full-genome call in exps/2-dm-real/workflow/rules/pantas.smk:73-101.

Usage:
  python -m pantas_tpu_torch.scripts.bench_call_scale [mbp] [n_reads] [engines...]
Defaults: 10 Mbp, 500k reads, engines = host device reference.
The 100 Mbp configuration (5.6M nodes): `bench_call_scale 100 1000000`.
"""

import json
import os
import resource
import subprocess
import sys
import time
from bisect import bisect_right
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO))

CACHE = REPO / ".bench"
READ_LEN = 150


def log(msg):
    print(f"[call-scale] {msg}", file=sys.stderr, flush=True)


def rss_gb(children=False):
    who = resource.RUSAGE_CHILDREN if children else resource.RUSAGE_SELF
    return resource.getrusage(who).ru_maxrss / 1e6


def ensure_graph(mbp: float) -> Path:
    wd = CACHE / f"stress{mbp:g}m"
    gfa = wd / "out" / "pantranscriptome-annotated.gfa"
    if gfa.exists():
        return wd
    wd.mkdir(parents=True, exist_ok=True)
    from pantas_tpu_torch.scripts import stress_build

    n_chroms = max(1, int(mbp // 25))
    log(f"generating {mbp} Mbp inputs ({n_chroms} chroms)..")
    # Drosophila-like density: ~100 genes/Mbp, 6 isoforms x 8 exons per gene
    # (the call stage's cost drivers are junction count and label richness)
    stress_build.gen_inputs(
        wd,
        mbp=mbp,
        n_var=int(mbp * 10_000),
        n_genes=int(mbp * 100),
        n_samples=20,
        n_chroms=n_chroms,
        n_exons=8,
        n_tx=6,
    )
    from pantas_tpu_torch.build.pipeline import build_pangenome

    t0 = time.time()
    build_pangenome(
        str(wd / "g.fa"), str(wd / "g.gtf"), str(wd / "g.vcf"),
        str(wd / "out"), threads=min(os.cpu_count() or 1, n_chroms),
    )
    log(f"build: {time.time() - t0:.1f}s")
    return wd


def synth_gaf(gfa: Path, n_reads: int, out_path: Path, seed: int = 7) -> None:
    """Sample exact-match reads along the graph's transcript paths.

    Each record walks real nodes of a real path with a consistent
    plen/pstart/pend and a `cs:Z::150` run — the same shape `vg mpmap`
    emits for a perfect alignment, so augment (ours or the reference's)
    accepts it unmodified.
    """
    import random

    from pantas_tpu_torch.native.gafcov import scan_gfa_structure

    ids, lens, _, _ = scan_gfa_structure(str(gfa))
    nlen = dict(zip((str(i) for i in ids), (int(l) for l in lens)))

    paths = []  # (nodes, cumlens)
    with open(gfa) as fh:
        for line in fh:
            if line[0] != "P":
                continue
            f = line.rstrip("\n").split("\t")
            name, steps = f[1], f[2]
            if "_R" not in name and "_H" not in name:
                continue  # walk transcript paths only
            nodes = [s[:-1] for s in steps.split(",")]
            cum = [0]
            for n in nodes:
                cum.append(cum[-1] + nlen[n])
            if cum[-1] >= READ_LEN:
                paths.append((nodes, cum))
    log(f"{len(paths)} transcript paths usable")
    rng = random.Random(seed)
    with open(out_path, "w") as out:
        for i in range(n_reads):
            nodes, cum = paths[rng.randrange(len(paths))]
            start = rng.randrange(cum[-1] - READ_LEN + 1)
            end = start + READ_LEN
            a = bisect_right(cum, start) - 1
            b = bisect_right(cum, end - 1) - 1
            walk = nodes[a : b + 1]
            plen = cum[b + 1] - cum[a]
            ps = start - cum[a]
            pe = ps + READ_LEN
            out.write(
                f"r{i}\t{READ_LEN}\t0\t{READ_LEN}\t+\t"
                f"{'>' + '>'.join(walk)}\t{plen}\t{ps}\t{pe}\t"
                f"{READ_LEN}\t{READ_LEN}\t60\tdv:f:0\tcs:Z::{READ_LEN}\n"
            )


def time_host(aug: Path, gtf: Path, novel: bool = False):
    from pantas_tpu_torch.events import CallOptions, call_events

    t0 = time.time()
    n = sum(1 for _ in call_events(str(aug), str(gtf), CallOptions(rca=0, novel=novel))) - 1
    return time.time() - t0, n, rss_gb()


def time_device(aug: Path, gtf: Path):
    from pantas_tpu_torch import backend

    # on the card; CALL_SCALE_PLATFORM=cpu asks for the CPU
    devices = backend.devices(os.environ.get("CALL_SCALE_PLATFORM") or "cuda")
    from pantas_tpu_torch.events import CallOptions
    from pantas_tpu_torch.events.batched import call_events_device

    t0 = time.time()
    n = sum(1 for _ in call_events_device(str(aug), str(gtf), CallOptions(rca=0),
                                          devices=devices)) - 1
    return time.time() - t0, n, rss_gb()


def time_reference(aug: Path, gtf: Path, timeout: int = 14400):
    ref = str(Path(os.environ.get("PANTAS_REFERENCE", "reference")) / "scripts" / "call.py")
    t0 = time.time()
    with open(os.devnull, "w") as devnull:
        proc = subprocess.run(
            [sys.executable, ref, "--rca", "0", str(aug), str(gtf)],
            stdout=subprocess.PIPE, stderr=devnull, timeout=timeout, text=True,
        )
    n = proc.stdout.count("\n") - 1
    return time.time() - t0, n, rss_gb(children=True)


def child_main():
    """--child <engine> <aug> <gtf>: run one engine in a clean process so
    peak RSS is per-engine (printed as one JSON line on stdout)."""
    engine, aug, gtf = sys.argv[2:5]
    if engine == "host":
        dt, n, rss = time_host(Path(aug), Path(gtf))
    elif engine == "device":
        dt, n, rss = time_device(Path(aug), Path(gtf))
    elif engine == "novel":
        dt, n, rss = time_host(Path(aug), Path(gtf), novel=True)
    else:
        dt, n, rss = time_reference(Path(aug), Path(gtf))
    print(json.dumps({"engine": engine, "wall_s": round(dt, 2), "events": n,
                      "peak_rss_gb": round(rss, 2)}))


def main():
    mbp = float(sys.argv[1]) if len(sys.argv) > 1 else 10.0
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 500_000
    engines = sys.argv[3:] or ["host", "device", "reference"]

    wd = ensure_graph(mbp)
    gfa = wd / "out" / "pantranscriptome-annotated.gfa"
    gtf = wd / "g.gtf"
    gaf = wd / f"reads_{n_reads}.gaf"
    aug = wd / f"augmented_{n_reads}.gfa"
    if not gaf.exists():
        log(f"synthesizing {n_reads} reads..")
        t0 = time.time()
        synth_gaf(gfa, n_reads, gaf)
        log(f"synth: {time.time() - t0:.1f}s")
    if not aug.exists():
        import io

        from pantas_tpu_torch.native import augment_gfa_native

        t0 = time.time()
        with open(aug, "w") as out:
            augment_gfa_native(
                str(gaf), str(gfa), out=out, log=io.StringIO(),
                threads=os.cpu_count() or 1,
            )
        log(f"augment (native): {time.time() - t0:.1f}s for {n_reads} reads")

    n_nodes = sum(1 for line in open(gfa) if line[0] == "S")
    for engine in engines:
        log(f"timing {engine} call (isolated process)..")
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "pantas_tpu_torch.scripts.bench_call_scale", "--child",
                 engine, str(aug), str(gtf)],
                stdout=subprocess.PIPE, text=True, timeout=14400,
                env={**os.environ, "PYTHONPATH": str(REPO)},
            )
            if proc.returncode != 0:
                print(json.dumps({"metric": "call_scale", "engine": engine,
                                  "mbp": mbp, "nodes": n_nodes,
                                  "failed": proc.returncode}), flush=True)
                continue
            r = json.loads(proc.stdout.strip().splitlines()[-1])
        except subprocess.TimeoutExpired:
            print(json.dumps({"metric": "call_scale", "engine": engine,
                              "mbp": mbp, "nodes": n_nodes, "timeout": True}),
                  flush=True)
            continue
        dt, n = r["wall_s"], r["events"]
        print(json.dumps({
            "metric": "call_scale", "engine": engine, "mbp": mbp,
            "nodes": n_nodes, "reads": n_reads, "events": n,
            "wall_s": dt, "events_per_s": round(n / dt) if dt else None,
            "peak_rss_gb": r["peak_rss_gb"],
        }), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child_main()
    else:
        main()
