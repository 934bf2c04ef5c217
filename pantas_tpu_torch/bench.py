#!/usr/bin/env python3
"""Benchmark of the port: augment-stage throughput (GAF reads/s), on the card.

The counterpart of the root ``bench.py``, one function for each of its
functions, all on ``pantas_tpu_torch``:

- :func:`ensure_workload`: the example/4 pangenome built by the port's build
  layer, its reads mapped by the port's mapper and the GAF replicated
  ``--multiplier`` times, when ``PANTAS_REFERENCE`` names a checkout with
  ``example/``; otherwise a synthetic example made from seeds (the 10 Mbp
  graph of ``eval/synth.py`` and reads of the port's ``sim``, mapped).
- :func:`bench_native`: the native engine, best of 3 (the headline number).
- :func:`bench_reference`: the reference augmenter, only where
  ``PANTAS_REFERENCE`` names its script; otherwise ``vs_baseline`` is null.
- :func:`bench_call`: ``call --rca 0`` on the augmented GFA: the host caller
  (best of 3), the reference caller where named (best of 2), one ``--novel``
  run, and the device engine (best of 3), whose rows must equal the host's.
- :func:`bench_device`: the device augment, one subprocess a run: a
  discarded warm-up under ``PANTAS_SCATTER=auto`` on a fresh cache, three
  interleaved pairs of ``PANTAS_SCATTER`` unset (kernel #1) against ``xla``
  (one ``index_add_``), then one run on the CPU. Every output's sha256 must
  equal the native engine's.
- :func:`bench_genome_augment`: the native engine (best of 2) and the device
  augment (best of 2) on the cached 100 Mbp graph, in its 2^28 bucket.

Run on the card; ``--device cpu`` is for the tests::

    python -m pantas_tpu_torch.bench [--device cuda|cpu] [--multiplier N]

Prints ONE JSON line on stdout, as the root bench does:
  {"metric": "augment_reads_per_s", "value": N, "unit": "reads/s", "vs_baseline": R}
Everything else goes to stderr as ``[bench] ...`` lines. Only the absence of
the reference and of the cached 100 Mbp workload is tolerated (and logged);
any other failure raises, so the exit code is non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / ".bench"

MULTIPLIER = 2000  # the root bench's: 500 alignments -> 1M records
MIN_RECORDS = 1_000_000  # what MULTIPLIER copies of the synthetic sample must reach
SYNTH_MBP = 10  # the synthetic example's graph: eval/synth.py::ensure_graph(10)
SYNTH_SEED = 7
SYNTH_EVENTS = 8  # sim -n: with SYNTH_DEPTH, 512 GAF records to replicate
SYNTH_DEPTH = 6  # sim -r
SYNTH_ERROR = 0.005  # sim -e, as chip_smoke.py phase 13
GENOME_MBP = 100
GENOME_READS = 1_000_000  # reads_<n>.gaf, the name the port's scale scripts write
DEVICE_RUN_TIMEOUT_S = 600
EXAMPLE_FILES = ("4.fa", "4.gtf", "4.vcf.gz", "reads_1.fq", "reads_2.fq")

# one device run in a process of its own; its record is the last stdout line
DEVICE_RUN = """
import json, sys
from pantas_tpu_torch import bench
print(json.dumps(bench.device_run(*sys.argv[1:])))
"""


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _reference() -> Path | None:
    """The reference checkout, named by ``PANTAS_REFERENCE`` only."""
    name = os.environ.get("PANTAS_REFERENCE")
    return Path(name) if name else None


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


@contextlib.contextmanager
def _written(path: Path):
    """Yield a temporary name beside ``path``; it replaces ``path`` only when
    the block finishes, so a cut run leaves no partial file under its name."""
    tmp = path.with_name(path.name + ".tmp")
    if tmp.is_dir():
        shutil.rmtree(tmp)
    try:
        yield tmp
    except BaseException:
        if tmp.is_dir():
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, path)


def _example_key(example: Path) -> str:
    h = hashlib.sha256()
    for name in EXAMPLE_FILES:
        h.update(name.encode() + b"\0" + (example / name).read_bytes())
    return h.hexdigest()[:12]


def ensure_workload(multiplier: int = MULTIPLIER):
    """The pangenome, its GTF, the replicated GAF and its record count.

    With ``PANTAS_REFERENCE`` naming a checkout that has ``example/``, the
    root bench's workload: example/4 built by the port's build layer and its
    reads mapped by the port's mapper. Otherwise the synthetic example: the
    10 Mbp graph of ``eval/synth.py::ensure_graph`` and one condition of the
    port's ``sim`` on it, mapped. Either way the sample GAF is replicated
    ``multiplier`` times. Everything is cached under ``CACHE`` by the
    example's content (or seed and size) and the multiplier."""
    ref = _reference()
    example = ref / "example" if ref is not None else None
    from_example = example is not None and (example / "4.fa").exists()
    if from_example:
        wd = CACHE / f"bench_example4_{_example_key(example)}"
        gfa, gtf = wd / "out" / "pantranscriptome-annotated.gfa", example / "4.gtf"
        fq = (example / "reads_1.fq", example / "reads_2.fq")
        if not gfa.exists():
            log("building example/4 pangenome (one-time)")
            from pantas_tpu_torch.build.pipeline import build_pangenome

            wd.mkdir(parents=True, exist_ok=True)
            with _written(gfa.parent) as tmp:
                build_pangenome(str(example / "4.fa"), str(example / "4.gtf"),
                                str(example / "4.vcf.gz"), str(tmp))
    else:
        log(f"no example/ under PANTAS_REFERENCE ({ref}); the synthetic example: "
            f"ensure_graph({SYNTH_MBP}) and sim -n {SYNTH_EVENTS} -r {SYNTH_DEPTH} "
            f"-e {SYNTH_ERROR} (seed {SYNTH_SEED})")
        from pantas_tpu_torch.eval import synth

        gwd = synth.ensure_graph(SYNTH_MBP)
        gfa, gtf = gwd / "out" / "pantranscriptome-annotated.gfa", gwd / "g.gtf"
        wd = CACHE / f"bench_synth{SYNTH_MBP}m_s{SYNTH_SEED}"
        fq = (wd / "sim_c1_1.fq", wd / "sim_c1_2.fq")
        if not fq[1].exists():
            log("simulating reads (one-time)")
            from pantas_tpu_torch.eval.simulate import simulate

            wd.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=wd) as tmp:
                simulate(str(gwd / "g.fa"), str(gtf), f"{tmp}/sim", n_events=SYNTH_EVENTS,
                         reads_per_isoform=SYNTH_DEPTH, error_rate=SYNTH_ERROR,
                         seed=SYNTH_SEED, log=io.StringIO())
                for mate in fq:  # the second mate last: it marks the pair done
                    os.replace(f"{tmp}/{mate.name}", mate)
    sample = wd / "sample.gaf"
    if not sample.exists():
        log("mapping example reads (one-time)")
        from pantas_tpu_torch.mapping.mapper import map_reads

        with _written(sample) as tmp, open(tmp, "w") as out:
            map_reads(str(gfa), str(fq[0]), str(fq[1]), out=out)
    data = sample.read_bytes()
    records = data.count(b"\n")
    if not from_example and records * MULTIPLIER < MIN_RECORDS:
        raise RuntimeError(f"the synthetic sample holds {records} records: "
                           f"x{MULTIPLIER} stays under {MIN_RECORDS}")
    big = wd / f"big_x{multiplier}.gaf"
    if not big.exists():
        log(f"replicating GAF x{multiplier}")
        with _written(big) as tmp, open(tmp, "wb") as out:
            for _ in range(multiplier):
                out.write(data)
    return gfa, gtf, big, records * multiplier


def bench_reference(gfa, big, n_reads):
    """The reference augmenter's rate, or None where ``PANTAS_REFERENCE``
    names no checkout that holds it."""
    ref = _reference()
    script = ref / "scripts" / "alignments_augmentation_from_gaf.py" if ref else None
    if script is None or not script.exists():
        log(f"reference augmenter absent ({script or 'PANTAS_REFERENCE unset'}); "
            "vs_baseline is null")
        return None
    log("timing reference augmenter..")
    t0 = time.time()
    subprocess.run([sys.executable, str(script), str(big), str(gfa)],
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, check=True)
    dt = time.time() - t0
    log(f"reference: {n_reads} reads in {dt:.2f}s = {n_reads / dt:.0f} reads/s")
    return n_reads / dt


def bench_native(gfa, big, n_reads):
    from pantas_tpu_torch.native import augment_gfa_native

    threads = os.cpu_count() or 1
    log(f"timing native engine ({threads} parse threads, best of 3)..")
    runs = []
    for i in range(3):  # first run warms the page cache; report steady state
        t0 = time.time()
        with open(os.devnull, "w") as devnull:
            augment_gfa_native(str(big), str(gfa), out=devnull, log=io.StringIO(),
                               threads=threads)
        dt = time.time() - t0
        log(f"native run {i}: {n_reads} reads in {dt:.2f}s = {n_reads / dt:.0f} reads/s")
        runs.append(dt)
    best = min(runs)
    log(
        f"native best-of-3: {n_reads / best:.0f} reads/s "
        f"(spread {n_reads / max(runs):.0f}..{n_reads / best:.0f} reads/s, "
        f"walls {[round(t, 2) for t in runs]}s)"
    )
    return n_reads / best


def _augmented(gfa: Path, big: Path) -> Path:
    """The native engine's augmented GFA of ``big`` (cached beside it): the
    call bench's input and the bytes every device run must reproduce."""
    aug = big.with_name(f"augmented_{big.stem}.gfa")
    if not aug.exists():
        from pantas_tpu_torch.native import augment_gfa_native

        with _written(aug) as tmp, open(tmp, "w") as out:
            augment_gfa_native(str(big), str(gfa), out=out, log=io.StringIO())
    return aug


@contextlib.contextmanager
def traced():
    """The program's tracing (:mod:`pantas_tpu_torch.trace`) on for the
    block, from a reset, and off after it. Yields a dict that then holds the
    snapshot's ``counters`` and its ``spans`` summed by name."""
    from pantas_tpu_torch import trace

    got = {}
    trace.reset()
    trace.enable()
    try:
        yield got
        snap = trace.snapshot()
    finally:
        trace.disable()
    got.update(counters=snap["counters"], spans=trace.span_totals(snap))


def device_evals(got: dict, device_type: str) -> dict:
    """``{finder: {"candidates", "eval_s"}}`` of a device call run under
    :func:`traced` with ``EVALS`` zeroed first: the candidates from
    ``EVALS``, every one of which must have run on ``device_type``, and the
    seconds in the finder's ``call.<finder>.match`` spans."""
    from pantas_tpu_torch.events.batched import EVALS, finder_label

    if not EVALS or {dev for _, dev in EVALS} != {device_type}:
        raise RuntimeError(f"device call evaluations {dict(EVALS)}, expected every one on "
                           f"{device_type}")
    return {f: {"candidates": n,
                "eval_s": round(got["spans"][f"call.{finder_label(f)}.match"], 4)}
            for (f, _), n in EVALS.items()}


def bench_call(gfa, gtf, big, device="cuda"):
    """Event calling on the heavy workload (the augmented replicated GAF):
    the host caller, the reference where named, ``--novel``, and the device
    engine on ``device``, whose sorted rows must equal the host caller's.
    Returns the counts and best walls."""
    from pantas_tpu_torch import backend
    from pantas_tpu_torch.events import CallOptions, call_events
    from pantas_tpu_torch.events.batched import EVALS, call_events_device

    devices = backend.devices(device)
    aug = _augmented(gfa, big)

    dt, rows = None, None  # best of 3 (same convention as bench_native: steady state)
    for _ in range(3):
        t0 = time.time()
        rows = list(call_events(str(aug), str(gtf), CallOptions(rca=0)))
        d = time.time() - t0
        dt = d if dt is None else min(dt, d)
    n_events = len(rows) - 1
    log(f"call (ours): {n_events} events in {dt:.2f}s = {n_events / dt:.0f} events/s")

    ref = _reference()
    script = ref / "scripts" / "call.py" if ref else None
    if script is None or not script.exists():
        log(f"call (reference): absent ({script or 'PANTAS_REFERENCE unset'}); not timed")
    else:
        dt_ref = None  # best of 2 (parity with our steady-state convention)
        for _ in range(2):
            t0 = time.time()
            subprocess.run([sys.executable, str(script), "--rca", "0", str(aug), str(gtf)],
                           stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, check=True,
                           timeout=600)
            d = time.time() - t0
            dt_ref = d if dt_ref is None else min(dt_ref, d)
        log(f"call (reference): {dt_ref:.2f}s -> ours {dt_ref / dt:.1f}x faster")

    t0 = time.time()
    n_novel = sum(1 for _ in call_events(str(aug), str(gtf), CallOptions(rca=0, novel=True))) - 1
    d = time.time() - t0
    log(f"call --novel (ours): {n_novel} events in {d:.2f}s = {n_novel / d:.0f} events/s")

    want = sorted(rows)
    walls, split = [], None
    for _ in range(3):
        EVALS.clear()
        with traced() as got:
            t0 = time.time()
            out = sorted(call_events_device(str(aug), str(gtf), CallOptions(rca=0),
                                            log=io.StringIO(), devices=devices))
            walls.append(time.time() - t0)
        if out != want:
            raise RuntimeError(f"call --engine device rows differ from the host caller's "
                               f"({len(out)} vs {len(want)} lines)")
        evals = device_evals(got, devices[0].type)
        if split is None or walls[-1] == min(walls):
            split = evals
    best = min(walls)
    in_eval = sum(rec["eval_s"] for rec in split.values())
    log(f"call --engine device ({devices[0]}): {n_events} events in {best:.2f}s "
        f"(best of 3, walls {[round(w, 2) for w in walls]}s), rows equal to the host "
        f"caller's; in the call.<finder>.match spans {in_eval:.3f}s ({100 * in_eval / best:.1f}% "
        f"of the best wall); per finder {json.dumps(split)}")
    return {"events": n_events, "host_s": dt, "novel_events": n_novel, "device_s": best}


# device_run's split: each key and the program's span it sums
SPLIT_SPANS = {"tensorize_s": "graph.compile_gfa", "engine_s": "native.engine_init",
               "stream_s": "native.stream", "batches_host_s": "device.add_slots",
               "readback_s": "device.readback", "emit_s": "native.emit"}


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)


def device_run(gaf, gfa, out, device) -> dict:
    """One device augment of ``gaf`` on ``gfa`` into ``out`` on ``device``,
    under the caller's ``PANTAS_SCATTER``: its wall, its split by the
    program's spans (:data:`SPLIT_SPANS`, and ``parse_s`` from the counter
    ``slots.parse_ns``), kernel launches (zeroed just before), batches (the
    counter ``device.batches``), the ``scatter impl:`` lines, and under
    ``auto`` or ``race`` the verdict file it left."""
    from pantas_tpu_torch import backend
    from pantas_tpu_torch.coverage import kernels, scatter_impls
    from pantas_tpu_torch.coverage.device import augment_gfa_device_native

    dev = backend.device(device)
    said = io.StringIO()
    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    with traced() as got, open(out, "w") as fh:
        t0 = time.perf_counter()
        augment_gfa_device_native(str(gaf), str(gfa), out=fh, log=_Tee(sys.stderr, said),
                                  device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
    split = {key: got["spans"].get(name, 0.0) for key, name in SPLIT_SPANS.items()}
    split["parse_s"] = got["counters"].get("slots.parse_ns", 0) / 1e9
    record = {
        "s": seconds,
        "launches": dict(kernels.LAUNCHES),
        "batches": got["counters"].get("device.batches", 0),
        "impl": [ln.split("scatter impl: ", 1)[1] for ln in said.getvalue().splitlines()
                 if "scatter impl: " in ln],
        "split": {k: round(v, 4) for k, v in split.items()},
    }
    if scatter_impls.pantas_scatter()[0] == "race":
        with open(scatter_impls._verdict_file()) as fh:
            record["verdict"] = json.load(fh)
    return record


def _check_run(what, rec, out, native_sha, device) -> int:
    """A device run's output must be the native engine's bytes, and on a
    card a run that chose kernel #1 must launch it once a batch; nothing
    here launches kernel #2. Returns the kernel #1 launches so held equal to
    the run's batches (0 where it did not run, or raced first)."""
    sha = _sha256(out)
    out.unlink()
    if sha != native_sha:
        raise RuntimeError(f"{what}: device GFA sha256 {sha} != native engine's {native_sha}")
    chosen = rec["impl"][-1].split(" (")[0]
    raced = "verdict" in rec and any(e.get("explored") for e in rec["verdict"].values())
    want = rec["batches"] if torch.device(device).type == "cuda" and chosen == "cuda-sorted" else 0
    got = rec["launches"]["sorted_coverage_scatter_add"]
    if rec["launches"]["coverage_scatter_add"] or (got != want and not raced):
        raise RuntimeError(f"{what}: {rec['launches']} kernel launches for {rec['batches']} "
                           f"batches under {chosen}")
    return 0 if raced else want


def bench_device(gfa, big, n_reads, device="cuda"):
    """The device path (native parse -> scatter-add on ``device``), each run
    a subprocess: one discarded warm-up under ``PANTAS_SCATTER=auto`` on a
    fresh ``PANTAS_TORCH_CACHE``, then ``PANTAS_SCATTER`` unset and ``xla``
    as 3 INTERLEAVED A/B pairs, each side reported as its median, then one
    run on the CPU, whose rate is returned. A run that fails or times out
    raises with its stderr's tail; every output must be the native
    engine's bytes."""
    native_sha = _sha256(_augmented(gfa, big))
    totals = {"launches": 0, "runs": 0}  # kernel #1's, in the runs that chose it

    def run_once(what, dev, scatter=None, cache=None):
        env = dict(os.environ, PYTHONPATH=str(REPO))
        env.pop("PANTAS_SCATTER", None)
        if scatter is not None:
            env["PANTAS_SCATTER"] = scatter
        if cache is not None:
            env["PANTAS_TORCH_CACHE"] = cache
        out = big.with_name(f"device_{big.stem}.gfa")
        try:
            proc = subprocess.run(
                [sys.executable, "-c", DEVICE_RUN, str(big), str(gfa), str(out), str(dev)],
                capture_output=True, text=True, timeout=DEVICE_RUN_TIMEOUT_S, env=env,
                cwd=REPO,
            )
        except subprocess.TimeoutExpired as e:
            out.unlink(missing_ok=True)
            tail = (e.stderr or b"")[-2000:]
            raise RuntimeError(f"{what}: timed out after {DEVICE_RUN_TIMEOUT_S}s: "
                               f"{tail.decode(errors='replace') if isinstance(tail, bytes) else tail}"
                               ) from None
        if proc.returncode != 0:
            out.unlink(missing_ok=True)
            raise RuntimeError(f"{what}: exited {proc.returncode}: {proc.stderr[-2000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        held = _check_run(what, rec, out, native_sha, dev)
        totals["launches"] += held
        totals["runs"] += held > 0
        log(f"{what}: {rec['s']:.2f}s, scatter impl: {' -> '.join(rec['impl'])}; LAUNCHES "
            f"{rec['launches']} for {rec['batches']} batches; sha256 == native engine's; "
            f"split {json.dumps(rec['split'])}")
        return rec

    with tempfile.TemporaryDirectory() as cache:  # pays the race on a fresh cache; discarded
        warm = run_once(f"warm-up on {device} (PANTAS_SCATTER=auto, fresh cache)", device,
                        scatter="auto", cache=cache)
    for key, entry in sorted(warm["verdict"].items()):
        for impl, st in entry.get("stats", {}).items():
            log(f"device scatter per-step [{key}] {impl}: median {st.get('median_s')}s/step, "
                f"first-call {st.get('first_s')}s (decision at race: {entry.get('impl')}, "
                f"explored {entry.get('explored')}, batches_hint {entry.get('batches_hint')})")
    log(f"auto on a fresh cache chose {warm['impl'][-1].split(' (')[0]}")

    times = {"default": [], "xla": []}
    impl = ""
    for i in range(3):
        rec = run_once(f"A/B pair {i}: PANTAS_SCATTER unset", device)
        times["default"].append(rec["s"])
        impl = rec["impl"][-1].split(" (")[0]
        times["xla"].append(run_once(f"A/B pair {i}: PANTAS_SCATTER=xla", device, "xla")["s"])
    for label, ts in times.items():
        med = statistics.median(ts)
        sel = f" [{impl}]" if label == "default" else ""
        log(f"device path (native parse -> {device} {label}{sel} scatter-add): "
            f"{n_reads / med:.0f} reads/s (median of {len(ts)}, runs={[round(t, 2) for t in ts]})")
    cpu = run_once("cpu run", "cpu")["s"]
    log(f"device path (native parse -> cpu-backend scatter-add): {n_reads / cpu:.0f} reads/s")
    return n_reads / cpu, totals


def bench_genome_augment(device="cuda"):
    """Augment at genome scale: the cached 100 Mbp graph (~236M count slots,
    the 2^28 bucket) and its 1M reads, when both are there (the port's
    scale scripts and ``chip_smoke.py`` phase 15 write them). The native engine's
    parse and accumulate, best of 2, as the root bench; then the device
    augment, best of 2, split by stage, its sha256 equal to the native
    engine's and, on a card, one kernel #1 launch a batch."""
    wd = CACHE / f"stress{GENOME_MBP}m"
    gfa = wd / "out" / "pantranscriptome-annotated.gfa"
    gaf = wd / f"reads_{GENOME_READS}.gaf"
    if not (gfa.exists() and gaf.exists()):
        log(f"genome-scale augment: cached {GENOME_MBP} Mbp workload absent ({gaf}); skipped")
        return None
    from pantas_tpu_torch.graph.compiler import compile_gfa
    from pantas_tpu_torch.native import augment_gfa_native
    from pantas_tpu_torch.native.gafcov import NativeCoverage

    threads = os.cpu_count() or 1
    t0 = time.time()
    tensors = compile_gfa(str(gfa))
    bucket = max(1 << 12, 1 << (tensors.total_slots - 1).bit_length())
    log(f"genome tensorize {time.time() - t0:.1f}s ({tensors.n_nodes} nodes, "
        f"{tensors.total_slots} slots, bucket {bucket})")
    n_reads = sum(1 for _ in open(gaf))
    best = None
    for _ in range(2):
        eng = NativeCoverage(tensors)
        t0 = time.time()
        eng.process_file(str(gaf), threads=threads)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
        del eng
    log(f"genome-scale augment ({tensors.n_nodes} nodes, {threads} threads): "
        f"{n_reads} reads in {best:.2f}s = {n_reads / best:.0f} reads/s")

    out = wd / "bench_genome.gfa"
    t0 = time.time()
    with open(out, "w") as fh:
        augment_gfa_native(str(gaf), str(gfa), out=fh, log=io.StringIO(), tensors=tensors,
                           threads=threads)
    native_sha = _sha256(out)
    out.unlink()
    log(f"genome-scale native augment with emission: {time.time() - t0:.2f}s, "
        f"sha256 {native_sha}")
    del tensors
    runs, held = [], []
    for i in range(2):
        rec = device_run(gaf, gfa, out, device)
        held.append(_check_run(f"genome-scale device run {i}", rec, out, native_sha, device))
        runs.append(rec)
        log(f"genome-scale device augment run {i} ({device}): {n_reads} reads in "
            f"{rec['s']:.2f}s = {n_reads / rec['s']:.0f} reads/s, scatter impl: "
            f"{rec['impl'][-1]}; LAUNCHES {rec['launches']} for {rec['batches']} batches; "
            f"sha256 == native engine's; split {json.dumps(rec['split'])}")
    fastest = min(runs, key=lambda r: r["s"])
    log(f"genome-scale device augment best-of-2: {n_reads / fastest['s']:.0f} reads/s")
    return {"native_s": best, "device_s": fastest["s"], "batches": fastest["batches"],
            "launches": sum(held), "runs": sum(h > 0 for h in held)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pantas_tpu_torch.bench")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the device runs go (default cuda; never falls back)")
    ap.add_argument("--multiplier", type=int, default=MULTIPLIER,
                    help=f"copies of the sample GAF (default {MULTIPLIER})")
    args = ap.parse_args(argv)
    from pantas_tpu_torch import backend

    device = backend.device(args.device)
    if device.type == "cuda":
        log(f"card: {backend.card_label()}")
    gfa, gtf, big, n_reads = ensure_workload(args.multiplier)
    log(f"workload: {gfa} ({n_reads} GAF records in {big.name})")
    bench_call(gfa, gtf, big, device.type)
    genome = bench_genome_augment(device.type)
    _, totals = bench_device(gfa, big, n_reads, device.type)
    if genome is not None:
        totals["launches"] += genome["launches"]
        totals["runs"] += genome["runs"]
    log(f"kernel #1 launches over the bench: {totals['launches']}, one a batch in each of "
        f"the {totals['runs']} device runs that chose it")
    ours = bench_native(gfa, big, n_reads)
    baseline = bench_reference(gfa, big, n_reads)
    result = {
        "metric": "augment_reads_per_s",
        "value": round(ours),
        "unit": "reads/s",
        "vs_baseline": round(ours / baseline, 2) if baseline else None,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
