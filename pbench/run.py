"""One run of one cell of the benchmark of ``pantas_tpu_torch``.

    python3 -m pbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix, stage,
end-to-end metrics and per-layer metrics are found by the names that
``BENCHMARK.json`` gives, as files under ``pbench/``: ``configs/<config>.json``,
``traffic/<traffic>.json`` (which names its generator, ``traffic/<g>.py``, and
its stage, ``stages/<stage>.py``), ``metrics/<metric>.py`` and
``layers/<metric>.py``. A run makes its inputs from the seed, warms up with
one job, runs jobs back to back until ``--seconds`` have passed (the window
ends with the job that crosses it), reads the device's peak memory, frees the
program's state, holds every job's output against the plain reference, and
prints one JSON line last on stdout. It exits non-zero with no result line
when the card is missing or a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import shutil
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = "pantas_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "pantas_tpu")  # whole top-level module names


def log(msg):
    print(f"[pbench] {msg}", file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def load(path: Path):
    """Import one file of the benchmark by its path."""
    name = "pbench_" + "_".join(path.relative_to(path.parents[1]).with_suffix("").parts)
    name = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, workload: str):
    """The cell's entry and the metrics it reports: an end-to-end metric where
    its ``workloads`` name the cell or it has none; a per-layer metric where
    its ``workloads`` name the cell, or, without them, where the cell reports
    the metric it moves."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m["workloads"] or "workloads" not in m and m["moves"] in names]
    return cells[workload], e2e, per_layer


def context(root: Path, w: dict, seed: int, device: str) -> SimpleNamespace:
    """What a run of cell ``w`` works with: its configuration and mix, their
    stage and generator, the graph's tables (built on a checkout's first run)
    and an empty run directory at a fixed path inside the checkout."""
    from pbench.reference import inputs
    from pbench.trace import Tracer

    here = root / "pbench"
    config = json.loads((here / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    cache = here / ".cache"
    run_dir = cache / "run"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    return SimpleNamespace(
        seed=seed, device=device, config=config, mix=mix, run_dir=run_dir,
        stage=load(here / "stages" / f"{mix['stage']}.py"),
        generator=load(here / "traffic" / f"{mix['generator']}.py"),
        tables=inputs.GraphTables(inputs.ensure_graph(w["config"], config["graph"], cache)),
        tracer=Tracer(),
    )


def require_cards(chips: int) -> str:
    """The device the run measures on; exits without a result when the card
    or enough cards are missing (a measurement never falls back to the CPU)."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"needs {chips} CUDA device(s), found {n}: no result")
        raise SystemExit(3)
    return "cuda"


def device_record(device: str, chips: int) -> dict:
    import torch

    if device == "cuda":
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": int(peak)}
    return {"platform": device, "kind": device, "count": chips, "memory_peak_bytes": 0}


def foreign_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def refuse_foreign() -> bool:
    foreign = foreign_modules()
    if foreign:
        log(f"modules of JAX or of the JAX package are loaded: {foreign}: no result")
    return bool(foreign)


def main(argv=None, root: Path = ROOT, device: str | None = None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() - process_age_s() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m pbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    here = root / "pbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w, e2e, per_layer = cell(bench, args.workload)
    device = require_cards(int(w["chips"])) if device is None else device
    importlib.import_module(PROGRAM)  # a checkout without the program stops here

    from pbench.trace import device_window, idle_gaps, top_ops

    log(f"set-up: imports done at {time.perf_counter() - t_start:.3f} s")
    ctx = context(root, w, args.seed, device)
    log(f"set-up: graph tables at {time.perf_counter() - t_start:.3f} s")
    stage, run_dir = ctx.stage, ctx.run_dir
    readers = {m["name"]: load(here / "layers" / f"{m['name']}.py") for m in per_layer} if args.trace else {}
    try:
        for mod in readers.values():
            if hasattr(mod, "install"):
                mod.install(ctx)
        state = stage.setup(ctx)
        log(f"set-up: inputs at {time.perf_counter() - t_start:.3f} s")
        ctx.tracer.phase = "warmup"
        stage.job(ctx, state, warmup=True)
        ctx.tracer.phase = "setup"
        log(f"set-up: warm-up job at {time.perf_counter() - t_start:.3f} s")

        results, failed = [], 0
        device_tl: dict = {}
        window = device_window(run_dir / "trace.json", device_tl) if args.trace else contextlib.nullcontext()
        t_window = time.perf_counter()
        setup_s = t_window - t_start
        with window, ctx.tracer.window():
            t0 = time.perf_counter()
            while True:
                t_job = time.perf_counter()
                try:
                    results.append(stage.job(ctx, state))
                except Exception:
                    failed += 1
                    traceback.print_exc()
                ctx.tracer.spans.append(("job", t_job, time.perf_counter()))
                if time.perf_counter() - t0 >= args.seconds:
                    break
            window_s = time.perf_counter() - t0
        dev = device_record(device, int(w["chips"]))
        work = stage.finish(ctx, state)
        gc.collect()
        if device == "cuda":
            import torch

            torch.cuda.empty_cache()
        if refuse_foreign():
            return 4
        t_ref = time.perf_counter()
        checks = stage.check(ctx, state, results)
        log(f"reference and comparison: {time.perf_counter() - t_ref:.3f} s")
    finally:
        ctx.tracer.restore()
        shutil.rmtree(run_dir, ignore_errors=True)

    jobs = len(results) + failed
    run = SimpleNamespace(jobs=len(results), attempted=jobs, window_s=window_s, setup_s=setup_s,
                          work=work, tracer=ctx.tracer, device=device_tl or None, ctx=ctx)
    metrics = {}
    if args.trace:
        for m in per_layer:
            value = readers[m["name"]].read(run) if run.jobs else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif run.jobs:
        for m in e2e:
            value = load(here / "metrics" / f"{m['name']}.py").read(run)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": jobs, "failed": failed, "metrics": metrics,
           "device": dev}
    if args.trace:
        out["device"]["busy_s"] = device_tl.get("busy_s", 0.0)
        out["device"]["window_s"] = device_tl.get("window_s", window_s)
        if device_tl:
            out["breakdown"] = {"device_ops": [list(kv) for kv in top_ops(device_tl)],
                                "idle_gaps": [list(kv) for kv in idle_gaps(device_tl, ctx.tracer.spans)[:10]]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    log(f"{args.workload} seed {args.seed}: {jobs} jobs in {window_s:.3f} s, set-up {setup_s:.3f} s")
    log(f"job seconds {[round(t1 - t0, 3) for name, t0, t1 in ctx.tracer.spans if name == 'job']}")
    if refuse_foreign():  # the readers and the reference have run: look again
        return 4
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
