#!/usr/bin/env python3
"""Full-scale end-to-end replicate experiment (VERDICT r3 task 4).

The reference's real-Drosophila experiment runs 2 conditions × 3
replicates of 8.75M read pairs each through map → augment → call → quant
→ remap on a full-genome graph, every stage under ``/usr/bin/time -v``
(``exps/2-dm-real/config/config.yaml:9-16`` of the reference, stage rules in
``workflow/rules/pantas.smk``, log folding in
``workflow/scripts/compare_bench.py:10-29``). This script reproduces that
protocol natively at matching scale:

* graph: the 100 Mbp / 5.5M-node synthetic pangenome (same generator as
  ``bench_call_scale.py``, cached under ``.bench/stress100m``);
* reads per replicate: background expression pairs sampled over ALL
  transcript isoforms plus a 125-gene ΔPSI≈0.5 event signal (the signal
  uses :func:`pantas_tpu_torch.eval.simulate.simulate`, so quant-remap has real
  differential events to report);
* every stage runs as a SUBPROCESS under the ``timev`` rusage wrapper
  (same ``time -v`` grammar as the reference), folded into one CSV by
  ``eval.bench.collect`` — per-stage wall/user/sys/maxRSS, no
  extrapolation.

Usage: python -m pantas_tpu_torch.scripts.run_fullscale_experiment [pairs_per_rep] [reps_per_cond] [mbp]
       [--mode staged|fused|both] [--engine native|device] [--device cuda|cpu]
Defaults: 8,750,000 pairs, 2 replicates per condition, 100 Mbp.
Outputs: .bench/fullscale/bench.csv (+ stage artifacts), printed summary.
"""

import io
import json
import os
import random
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO))

import argparse

_ap = argparse.ArgumentParser(description=__doc__)
_ap.add_argument("pairs", nargs="?", type=int, default=8_750_000)
_ap.add_argument("reps", nargs="?", type=int, default=2)
_ap.add_argument("mbp", nargs="?", type=float, default=100.0)
_ap.add_argument(
    "--mode", choices=["staged", "fused", "both"], default="staged",
    help="staged = reference stage layout (augment writes the augmented "
    "GFA, call re-parses it); fused = the `replicate` subcommand (GAF -> "
    "events, no GFA round-trip, SURVEY's pipeline-fusion claim); both = "
    "run the two per replicate and assert the event rows multiset-equal",
)
_ap.add_argument(
    "--wd", default="fullscale",
    help="workdir name under .bench/ (a smoke run should not share "
    "artifacts with the real one)",
)
_ap.add_argument(
    "--engine", choices=["native", "device"], default="native",
    help="engines of the staged layout: native = augment --engine native and "
    "the host call; device = augment --engine device and call --engine device "
    "on --device, each augment held to its log and to the native engine's GFA",
)
_ap.add_argument(
    "--device", choices=["cuda", "cpu"], default="cuda",
    help="device of the device engines (default cuda; never falls back)",
)
_args = _ap.parse_args()
if _args.engine == "device" and _args.mode == "fused":
    _ap.error("--engine device selects the staged layout's engines: use --mode staged or both")
N_PAIRS, REPS, MBP, MODE = _args.pairs, _args.reps, _args.mbp, _args.mode
ENGINE, DEVICE = _args.engine, _args.device
DEVICE_ARGS = ["--device", DEVICE] if ENGINE == "device" else []
CALL_ENGINE = ["--engine", "device", "--device", DEVICE] if ENGINE == "device" else []
# the device engines' staged artifacts carry their name, so that a run never reuses
# another engine's augmented GFA or events in a shared work dir
STAGED = ".device" if ENGINE == "device" else ""

WD = REPO / ".bench" / _args.wd
READ_LEN = 150
FRAG_LEN = 300
ERROR = 0.005  # 0.5% per-base background error
PY = sys.executable


def log(msg):
    print(f"[fullscale] {msg}", file=sys.stderr, flush=True)


def _poisson_small(rng: random.Random, lam: float) -> int:
    """Knuth sampler — lam is ~0.75 here, loop runs 1-3 times."""
    import math

    l = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= l:
            return k
        k += 1


def _mutate_fast(seq: str, rng: random.Random, lam: float) -> str:
    n = _poisson_small(rng, lam)
    if n == 0:
        return seq
    out = list(seq)
    for _ in range(n):
        i = rng.randrange(len(out))
        out[i] = rng.choice("ACGT".replace(out[i].upper(), "") or "ACGT")
    return "".join(out)


def write_background(fa, gtf, out1, out2, n_pairs, rng):
    """Stream n_pairs background pairs sampled over all isoforms."""
    from pantas_tpu_torch.eval.simulate import revcomp, spliced_seq
    from pantas_tpu_torch.io.fasta import read_fasta
    from pantas_tpu_torch.io.gtf import parse_transcript_models

    ref = read_fasta(str(fa))
    models = parse_transcript_models(str(gtf))
    isoforms = []
    for tid in sorted(models):
        tr = models[tid]
        if tr.chrom not in ref:
            continue
        seq = spliced_seq(ref[tr.chrom], tr.exons)
        if len(seq) >= FRAG_LEN:
            isoforms.append((tid, seq))
    log(f"{len(isoforms)} isoforms for background sampling")
    lam = READ_LEN * ERROR
    t0 = time.time()
    with open(out1, "w", buffering=1 << 22) as f1, open(
        out2, "w", buffering=1 << 22
    ) as f2:
        for i in range(n_pairs):
            name, seq = isoforms[rng.randrange(len(isoforms))]
            L = len(seq)
            start = rng.randrange(0, L - FRAG_LEN + 1)
            frag = seq[start : start + FRAG_LEN]
            m1 = _mutate_fast(frag[:READ_LEN], rng, lam)
            m2 = _mutate_fast(revcomp(frag[-READ_LEN:]), rng, lam)
            f1.write(f"@bg{i}/{name};mate1:{start}-{start+READ_LEN-1}\n{m1}\n+\n{'I'*READ_LEN}\n")
            f2.write(f"@bg{i}/{name};mate2\n{m2}\n+\n{'I'*READ_LEN}\n")
    log(f"background {n_pairs} pairs in {time.time()-t0:.0f}s")


def append_file(dst, src):
    with open(dst, "a", buffering=1 << 22) as out, open(src) as fh:
        for chunk in iter(lambda: fh.read(1 << 22), ""):
            out.write(chunk)


def timed_stage(tag, time_name, cmd, stdout_path=None, stderr_path=None):
    """Run one stage as a subprocess under the timev wrapper; its stderr goes
    to ``stderr_path`` (dropped when None)."""
    bench = WD / "bench" / "pantas"
    bench.mkdir(parents=True, exist_ok=True)
    tf = bench / time_name
    full = [PY, "-m", "pantas_tpu_torch", "timev", "-o", str(tf), "--"] + cmd
    log(f"{tag}: {' '.join(cmd[:6])}..")
    out = open(stdout_path, "w") if stdout_path else subprocess.DEVNULL
    err = open(stderr_path, "w") if stderr_path else subprocess.DEVNULL
    try:
        rc = subprocess.run(
            full, stdout=out, stderr=err, cwd=REPO,
            env=dict(
                os.environ,
                PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH','')}",
                # staged call and fused replicate must see the same hash
                # seed: some IR tie-breaks follow set iteration order, so
                # row CONTENT (not just order) is seed-dependent
                PYTHONHASHSEED="0",
            ),
        ).returncode
    finally:
        if stdout_path:
            out.close()
        if stderr_path:
            err.close()
    if rc and stderr_path:
        log(f"{tag}: its log {stderr_path} ends: {open(stderr_path).read()[-2000:]}")
    assert rc == 0, f"{tag} failed (rc={rc})"
    from pantas_tpu_torch.eval.bench import parse_time_verbose

    rec = parse_time_verbose(str(tf), "pantas")
    log(
        f"{tag}: wall {rec['wall_clock'][0]:.1f}s  "
        f"user {rec['user_time'][0]:.1f}s  rss {rec['max_mem'][0]/1e6:.2f} GB"
    )


def stage_log(tag, stage):
    """Where a device stage's stderr goes: ``<tag>.<stage>.log`` in the work
    dir (a native stage's is dropped, as ever)."""
    return str(WD / f"{tag}.{stage}.log") if ENGINE == "device" else None


def check_device_augment(tag, gaf, gfa, dev_out):
    """Hold one device augment to its log, then to ``augment --engine
    native`` on the same inputs: the sorted kernel's scatter (its plain
    version on the CPU), no fallback to the Python feed, kernel launches
    equal to the batches on the card (0 on the CPU, where the kernels'
    wrappers run their plain versions), and the two GFAs sha256-equal. The
    record goes to ``<tag>.device.json``; any failure raises."""
    from pantas_tpu_torch.bench import _sha256

    text = open(stage_log(tag, "augment")).read()
    want = "cuda-sorted" if DEVICE == "cuda" else "cpu-sorted-plain"
    impls = re.findall(r"^\[device\] scatter impl: (\S+)", text, re.M)
    hint = re.search(r"~(\d+) batches expected", text)
    done = re.search(r"^\[device\] kernel launches: (\d+) \(batches: (\d+)\)", text, re.M)
    launches, batches = (int(done[1]), int(done[2])) if done else (None, 0)
    faults = []
    if "native device feed unavailable" in text or "fallback" in text:
        faults.append("it fell back")
    if not impls or impls[-1] != want:
        faults.append(f"its scatter is {impls}, not {want}")
    if done is None or batches < 1 or launches != (batches if DEVICE == "cuda" else 0):
        faults.append(f"kernel launches {launches} for {batches} batches")
    if faults:
        raise RuntimeError(f"{tag}: device augment on {DEVICE}: {'; '.join(faults)}")
    log(f"{tag}: device augment: scatter {impls[-1]}, kernel launches: {launches} "
        f"(batches: {batches}; ~{hint[1] if hint else '?'} batches expected)")
    native = WD / f"{tag}.aug.native.gfa"
    timed_stage(
        f"augment(native) {tag}", f"augment-native.{tag}.time",
        [PY, "-m", "pantas_tpu_torch", "augment", "--engine", "native", str(gaf), str(gfa)],
        stdout_path=str(native),
    )
    record = {"tag": tag, "device": DEVICE, "scatter": impls[-1], "launches": launches,
              "batches": batches, "batches_expected": int(hint[1]) if hint else None,
              "sha256": _sha256(dev_out), "native_sha256": _sha256(native)}
    native.unlink()
    if record["sha256"] != record["native_sha256"]:
        raise RuntimeError(f"{tag}: device GFA sha256 {record['sha256']} != native "
                           f"engine's {record['native_sha256']}")
    (WD / f"{tag}.device.json").write_text(json.dumps(record) + "\n")
    log(f"{tag}: device GFA sha256 {record['sha256']} == native engine's")


def main():
    WD.mkdir(parents=True, exist_ok=True)
    from pantas_tpu_torch.scripts.bench_call_scale import ensure_graph

    gwd = ensure_graph(MBP)
    gfa = gwd / "out" / "pantranscriptome-annotated.gfa"
    fa, gtf = gwd / "g.fa", gwd / "g.gtf"

    # signal: 125 differential events at DPSI 0.5 over REPS replicates
    from pantas_tpu_torch.eval.simulate import simulate

    prefix = WD / "sig"
    if not (WD / "sig_truth.csv").exists():
        simulate(
            str(fa), str(gtf), str(prefix), n_events=125,
            reads_per_isoform=30, etypes=("ES", "IR", "A3", "A5"),
            replicates=REPS, log=sys.stderr,
        )

    # replicate FASTQs: background + signal appended
    reads = WD / "reads"
    reads.mkdir(exist_ok=True)
    tags = [f"{c}_r{r}" for c in ("c1", "c2") for r in range(1, REPS + 1)]
    for tag in tags:
        r1, r2 = reads / f"{tag}_1.fq", reads / f"{tag}_2.fq"
        if r1.exists():
            continue
        # stable seed: hash() is PYTHONHASHSEED-dependent, which made the
        # background reads (and every downstream artifact) unreproducible
        # across runs
        import zlib

        rng = random.Random(zlib.crc32(tag.encode()) & 0xFFFF)
        sig1 = f"{prefix}_{tag}_1.fq" if REPS > 1 else f"{prefix}_{tag.split('_')[0]}_1.fq"
        sig2 = sig1.replace("_1.fq", "_2.fq")
        n_sig = sum(1 for _ in open(sig1)) // 4
        write_background(fa, gtf, r1, r2, max(0, N_PAIRS - n_sig), rng)
        append_file(r1, sig1)
        append_file(r2, sig2)
        log(f"{tag}: {N_PAIRS} pairs ({n_sig} signal)")

    # stages, each its own timed subprocess. staged = the reference stage
    # layout (augment writes the full augmented GFA, call re-parses it:
    # the reference's pantas:132-175); fused = the `replicate` subcommand
    # (coverage tensors feed calling directly — SURVEY.md:167-170's
    # pipeline-fusion claim, exercised HERE at the scale that justifies it)
    for tag in tags:
        gaf = WD / f"{tag}.gaf"
        if not gaf.exists():
            timed_stage(
                f"map {tag}", f"map.{tag}.time",
                [PY, "-m", "pantas_tpu_torch", "map", str(gfa),
                 str(reads / f"{tag}_1.fq"), str(reads / f"{tag}_2.fq"),
                 "-t", "2", "--index", str(WD / "mapidx")],
                stdout_path=str(gaf) + ".tmp",
            )
            os.replace(str(gaf) + ".tmp", gaf)
        ev = WD / f"{tag}.events{STAGED}.csv"
        if MODE in ("staged", "both"):
            aug = WD / f"{tag}.aug{STAGED}.gfa"
            if not aug.exists():
                timed_stage(
                    f"augment {tag}", f"augment.{tag}.time",
                    [PY, "-m", "pantas_tpu_torch", "augment", "--engine", ENGINE,
                     *DEVICE_ARGS, str(gaf), str(gfa)],
                    stdout_path=str(aug) + ".tmp", stderr_path=stage_log(tag, "augment"),
                )
                if ENGINE == "device":
                    check_device_augment(tag, gaf, gfa, str(aug) + ".tmp")
                os.replace(str(aug) + ".tmp", aug)
            if not ev.exists():
                timed_stage(
                    f"call {tag}", f"call.{tag}.w3.time",
                    [PY, "-m", "pantas_tpu_torch", "call", *CALL_ENGINE, "--rca", "3",
                     str(aug), str(gtf)],
                    stdout_path=str(ev) + ".tmp", stderr_path=stage_log(tag, "call"),
                )
                if ENGINE == "device":  # nothing in it is checked: kept only where it failed
                    os.remove(stage_log(tag, "call"))
                os.replace(str(ev) + ".tmp", ev)
        if MODE in ("fused", "both"):
            fev = WD / f"{tag}.events.fused.csv" if MODE == "both" else ev
            if not fev.exists():
                timed_stage(
                    f"replicate(fused) {tag}", f"replicate.{tag}.w3.time",
                    [PY, "-m", "pantas_tpu_torch", "replicate", "-t", "2",
                     "--rca", "3", str(gaf), str(gfa), str(gtf)],
                    stdout_path=str(fev) + ".tmp",
                )
                os.replace(str(fev) + ".tmp", fev)
        if MODE == "both":
            # the fused path must reproduce the staged events exactly
            # (multiset: row order follows set iteration and is not
            # semantically meaningful — SURVEY §3.3)
            staged_rows = sorted(open(ev))
            fused_rows = sorted(open(WD / f"{tag}.events.fused.csv"))
            assert staged_rows == fused_rows, (
                f"{tag}: fused events differ from staged "
                f"({len(staged_rows)} vs {len(fused_rows)} rows)"
            )
            log(f"{tag}: fused == staged ({len(staged_rows) - 1} events)")
            # the comparison is done; drop the ~4 GB augmented GFA so a
            # 4-replicate both-mode run fits the disk
            aug = WD / f"{tag}.aug{STAGED}.gfa"
            if aug.exists():
                aug.unlink()

    quant = WD / "quant.csv"
    timed_stage(
        "quant", "quant.w3.time",
        [PY, "-m", "pantas_tpu_torch", "quant", "-a",
         "--c1"] + [str(WD / f"c1_r{r}.events{STAGED}.csv") for r in range(1, REPS + 1)]
        + ["--c2"] + [str(WD / f"c2_r{r}.events{STAGED}.csv") for r in range(1, REPS + 1)],
        stdout_path=str(quant),
    )
    timed_stage(
        "remap", "remap.w3.time",
        [PY, "-m", "pantas_tpu_torch", "remap", str(quant), str(gtf)],
        stdout_path=str(WD / "quant-remap.csv"),
    )
    n_events = sum(1 for _ in open(WD / "quant-remap.csv")) - 1
    log(f"quant-remap: {n_events} events")

    # fold the .time logs into the reference bench.csv grammar
    from pantas_tpu_torch.eval.bench import collect

    out_csv = WD / "bench.csv"
    with open(out_csv, "w") as out:
        collect(str(WD / "bench"), out=out)
    print(open(out_csv).read())
    log(f"bench table -> {out_csv}")


if __name__ == "__main__":
    main()
