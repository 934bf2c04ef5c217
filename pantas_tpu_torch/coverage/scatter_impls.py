"""Which coverage scatter the device engine runs, and the races that decide it.

Counterpart of ``pantas_tpu/coverage/pallas_kernel.py:217-500``:

- :data:`SCATTER_IMPLS`, the registry. ``plain`` (``index_add_``),
  ``cuda-sorted`` (kernel #1) and ``cuda-direct`` (kernel #2) stand where the
  JAX package has ``xla``, ``pallas-sorted`` and ``pallas-onehot``.
- :func:`pantas_scatter` and :func:`mesh_scatter`, the one reader of
  ``PANTAS_SCATTER`` (its spellings in :data:`SCATTER_CHOICES`): the device
  engine, the CLI's and ``augment-dist``'s early checks, the graft entry and
  the scale scripts all ask these.
- :func:`pick_scatter_endtoend`, the DEPLOYMENT decision: it races whole
  steps at the stage's padded counts length and batch size, on the stage's
  first real batch, and persists the measured stats in a verdict file under
  the port's own cache directory (:func:`_verdict_file`). The decision is
  recomputed from those stats and the stage's expected batch count by
  :func:`_decide`.
- :func:`pick_scatter_impl`, the raw-rate race of all three candidates at a
  synthetic shape, which :mod:`.bench_scatter` prints in full.

Deliberate differences from the JAX package (ROADMAP.md §3): a candidate
that fails to build or launch, or that verifies wrong, raises instead of
being dropped, so a broken kernel is never quietly replaced by
``index_add_``; the verdict file is never shared with the JAX package's; and
the raw race is not cached process-wide.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time
from typing import Callable, Tuple

import numpy as np
import torch

from pantas_tpu_torch import backend
from pantas_tpu_torch.coverage import _build, kernels
from pantas_tpu_torch.parallel.mesh import scatter_add_counts

SCATTER_IMPLS = {
    "plain": scatter_add_counts,
    "cuda-sorted": kernels.sorted_coverage_scatter_add,
    "cuda-direct": kernels.coverage_scatter_add,
}

# PANTAS_SCATTER values: the JAX package's spellings and the port's own names
SCATTER_CHOICES = {
    "xla": "plain", "off": "plain", "plain": "plain",
    "pallas": "cuda-sorted", "sorted": "cuda-sorted", "pallas-sorted": "cuda-sorted",
    "cuda-sorted": "cuda-sorted",
    "race": "race", "auto": "race",
}


def pantas_scatter(mesh: bool = False) -> Tuple[str, bool]:
    """What ``PANTAS_SCATTER`` chooses: ``plain``, ``cuda-sorted`` or
    ``race``, and whether the race is forced (``race``; ``auto`` decides from
    a cached verdict where one exists).

    Unset (empty) is ``cuda-sorted``, the kernel measured on the card, where
    the JAX package races by default on a TPU (ROADMAP.md §3). An unknown
    value raises, where the JAX package takes its plain scatter in silence.
    With ``mesh``, ``race`` and ``auto`` raise too: the JAX engine ignores
    ``PANTAS_SCATTER`` under a mesh and runs its XLA scatter; here a shard's
    partial is an ordinary tensor on one device, so every shard runs the
    named step, and a race that quietly settled on ``index_add_`` would hide
    the kernel.
    """
    value = os.environ.get("PANTAS_SCATTER", "")
    if not value:
        return "cuda-sorted", False
    try:
        choice = SCATTER_CHOICES[value.lower()]
    except KeyError:
        raise ValueError(
            f"PANTAS_SCATTER={value!r} is not one of {', '.join(SCATTER_CHOICES)}"
        ) from None
    if mesh and choice == "race":
        raise ValueError(
            f"PANTAS_SCATTER={value} cannot be combined with a mesh: name a "
            "scatter (plain, cuda-sorted) or leave it unset for cuda-sorted"
        )
    return choice, value.lower() == "race"


def mesh_scatter() -> Tuple[str, Callable]:
    """``(name, step)`` of the scatter every shard of a mesh runs, as
    :func:`pantas_scatter` with ``mesh`` names it."""
    name, _ = pantas_scatter(mesh=True)
    return name, SCATTER_IMPLS[name]


# minimum projected stage-scatter seconds (under the plain step) before the
# end-to-end race explores the sorted kernel, as in the JAX package; there
# the bound paid for a Pallas compile of minutes, here for a first call
# that may build the kernel library (seconds)
EXPLORE_BUDGET_S = 30.0


def _verdict_file() -> str:
    base = os.environ.get(
        "PANTAS_TORCH_CACHE", os.path.join(os.path.expanduser("~"), ".cache", "pantas_tpu_torch")
    )
    return os.path.join(base, "scatter_verdict.json")


def _backend_key(n_slots: int, batch: int, device) -> str:
    """``<backend>:<device name>:<pow2 bucket of n_slots>:<batch>``, and on
    CUDA ``:<kernel library hash>`` after it: a verdict measured with other
    kernel sources must not decide for these."""
    dev = torch.device(device)
    bucket = 1
    while bucket < n_slots:
        bucket <<= 1
    if dev.type != "cuda":
        return f"{dev.type}:{dev.type}:{bucket}:{batch}"
    lib_hash = _build.library_path().stem.rsplit("_", 1)[1]
    return f"cuda:{torch.cuda.get_device_name(dev)}:{bucket}:{batch}:{lib_hash}"


def _decide(stats: dict, batches_hint) -> str:
    """Deployment decision from measured stats: minimize the PROJECTED
    stage cost ``first_s + batches_hint × median step`` rather than step
    rate alone. With no ``batches_hint``, pure step rate (the kernel-bench
    view)."""

    def score(name):
        st = stats[name]
        step = statistics.median(st["times"]) if st["times"] else float("inf")
        if batches_hint is None:
            return step
        return st.get("first_s", 0.0) + batches_hint * step

    return min(stats, key=score)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_step(fn, counts, idx, device) -> float:
    """Host seconds of one step, launch cost included: the JAX race's real
    dispatch path view (CUDA events alone would hide the wrapper's
    allocation and the ctypes call's host time)."""
    t0 = time.perf_counter()
    fn(counts, idx)
    _sync(device)
    return time.perf_counter() - t0


def _probe_check(n_slots: int, idx_np: np.ndarray, rng, device):
    """A verifier for ``counts`` after one step on zeros: 4096 probed slots
    and the total against a sorted search of the batch (no host array of
    ``n_slots``: counts reach 1 GiB at genome scale). It raises if they
    disagree."""
    valid = np.sort(idx_np[(idx_np >= 0) & (idx_np < n_slots)])
    probes_np = rng.integers(0, n_slots, size=4096)
    expect_probe = (
        np.searchsorted(valid, probes_np, side="right")
        - np.searchsorted(valid, probes_np, side="left")
    ).astype(np.int32)
    probes = torch.from_numpy(probes_np).to(device)

    def check(name: str, counts: torch.Tensor) -> None:
        got_probe = counts[probes].cpu().numpy()
        got_sum = int(counts.sum())
        if got_sum != len(valid) or not np.array_equal(got_probe, expect_probe):
            raise RuntimeError(
                f"scatter impl {name!r} verified wrong on {device}: sum {got_sum} "
                f"(expected {len(valid)}), {int((got_probe != expect_probe).sum())} of "
                f"{len(probes_np)} probes differ"
            )

    return check


def _load_verdict(vf: str) -> dict:
    try:
        with open(vf) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:
        print(f"[device] ignoring unreadable scatter verdict {vf}: {e}", file=sys.stderr)
        return {}


def _save_verdict(vf: str, verdict: dict) -> None:
    """Atomic replace; a cache that cannot be written costs a new race in
    the next process, not this stage."""
    tmp = f"{vf}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(vf), exist_ok=True)
        with open(tmp, "w") as fh:
            json.dump(verdict, fh, indent=1)
        os.replace(tmp, vf)
    except OSError as e:
        print(f"[device] scatter verdict not saved to {vf}: {e}", file=sys.stderr)


def pick_scatter_endtoend(
    n_slots: int,
    batch: int,
    sample=None,
    trials: int = 5,
    force_race: bool = False,
    batches_hint=None,
    *,
    device=None,
):
    """Pick the deployment scatter impl by racing END-TO-END steps.

    Measures the deployment shape (``n_slots`` counts, ``batch`` indices, on
    the real batch ``sample``) on ``device`` (the first card when None,
    :func:`.backend.default_device`), with chained counts (each timed
    step adds into the previous step's counts, as the stage does) and
    interleaved trials so drift hits both candidates. The stats (first-call
    seconds and step times) persist in :func:`_verdict_file` under
    :func:`_backend_key` ``+ ":v2"`` (on CUDA the key holds the kernel
    library's content hash); a later call decides from them by
    :func:`_decide` unless ``force_race`` is set, or the cached verdict holds
    only ``plain`` from a race that skipped exploration and this stage is big
    enough to explore.

    ``cuda-sorted`` is explored only when ``force_race`` is set, there is no
    ``batches_hint``, or ``batches_hint`` × the plain median step reaches
    :data:`EXPLORE_BUDGET_S`; the verdict's ``explored`` records that it was
    attempted. A candidate that raises, or verifies wrong, makes the race
    raise.

    Returns ``(name, step)`` with ``step`` from :data:`SCATTER_IMPLS`.
    """
    device = backend.default_device(device)
    key = _backend_key(n_slots, batch, device) + ":v2"
    vf = _verdict_file()
    verdict = _load_verdict(vf)
    if not force_race and key in verdict:
        stats = {
            k: v
            for k, v in verdict[key]["stats"].items()
            if k in SCATTER_IMPLS and v["times"]
        }
        # a verdict recorded when exploration was skipped holds only plain
        # stats; a stage big enough to explore must not be held to it
        unexplored_big_stage = (
            "cuda-sorted" not in stats
            and not verdict[key].get("explored")
            and "plain" in stats
            and batches_hint is not None
            and batches_hint * statistics.median(stats["plain"]["times"]) >= EXPLORE_BUDGET_S
        )
        if stats and not unexplored_big_stage:
            name = _decide(stats, batches_hint)
            return name, SCATTER_IMPLS[name]

    verdict[key] = _race(n_slots, batch, sample, trials, force_race, batches_hint, device)
    _save_verdict(vf, verdict)
    name = verdict[key]["impl"]
    return name, SCATTER_IMPLS[name]


def _race(n_slots, batch, sample, trials, force_race, batches_hint, device) -> dict:
    """Measure the candidates as :func:`pick_scatter_endtoend` says; return
    the verdict entry, its decision under ``impl``."""
    rng = np.random.default_rng(0)
    if sample is not None and len(sample):
        idx_np = np.asarray(sample, dtype=np.int32)
        if len(idx_np) != batch:
            idx_np = np.resize(idx_np, batch)
    else:
        idx_np = rng.integers(0, n_slots, size=batch, dtype=np.int32)
    idx = torch.from_numpy(np.ascontiguousarray(idx_np)).to(device)
    check = _probe_check(n_slots, idx_np, rng, device)

    def measure(name):
        """First call on zeros with its verification (``first_s``); the
        timed steps come later."""
        fn = SCATTER_IMPLS[name]
        t0 = time.perf_counter()
        counts = fn(torch.zeros(n_slots, dtype=torch.int32, device=device), idx)
        _sync(device)
        first_s = time.perf_counter() - t0
        check(name, counts)
        return {"fn": fn, "counts": counts, "times": [], "first_s": round(first_s, 6)}

    stats = {"plain": measure("plain")}
    explore = force_race or batches_hint is None
    if not explore:
        ps = stats["plain"]
        for _ in range(3):  # median of 3: one stall must not decide exploration
            ps["times"].append(_timed_step(ps["fn"], ps["counts"], idx, device))
        explore = batches_hint * statistics.median(ps["times"]) >= EXPLORE_BUDGET_S
    if explore:
        stats["cuda-sorted"] = measure("cuda-sorted")
        for _ in range(trials):  # interleaved A/B, chained like deployment
            for st in stats.values():
                st["times"].append(_timed_step(st["fn"], st["counts"], idx, device))

    return {
        "impl": _decide(stats, batches_hint),  # decision at race time
        # whether cuda-sorted was ATTEMPTED: without it every later big-stage
        # call would re-race
        "explored": explore,
        "batches_hint": batches_hint,
        "stats": {
            k: {
                "first_s": st["first_s"],
                "median_s": round(statistics.median(st["times"]), 6),
                "times": [round(t, 6) for t in st["times"]],
            }
            for k, st in stats.items()
        },
        "trials": trials,
    }


def raw_race(n_slots: int, stream: int, device, reps: int = 3, seed: int = 0) -> dict:
    """Every impl of :data:`SCATTER_IMPLS` once on zeros (verified by 4096
    probes and the sum), then ``reps`` timed calls on fresh zeros each.

    ``stream`` indices in ``[-1, n_slots)`` (``-1`` is padding) from
    ``seed``. Returns ``{name: {"first_run_s", "best_s"}}``; raises on a
    candidate that fails or verifies wrong. ``stream`` must be a multiple of
    :data:`kernels.BLOCK` (the direct kernel's batches are).
    """
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    idx_np = rng.integers(-1, n_slots, size=stream, dtype=np.int32)
    idx = torch.from_numpy(idx_np).to(device)
    check = _probe_check(n_slots, idx_np, rng, device)
    counts = torch.zeros(n_slots, dtype=torch.int32, device=device)
    out = {}
    for name, fn in SCATTER_IMPLS.items():
        times = []
        for _ in range(1 + reps):
            counts.zero_()
            _sync(device)
            times.append(_timed_step(fn, counts, idx, device))
            if len(times) == 1:
                check(name, counts)
        out[name] = {"first_run_s": times[0], "best_s": min(times[1:])}
    return out


def pick_scatter_impl(n_slots_hint: int = 1 << 20, stream_hint: int = 1 << 22, *, device=None):
    """Race every impl's RAW rate at a synthetic shape on ``device`` (the
    first card when None); return ``(name, step)`` of the fastest. Uncached:
    the answer depends on the device and the hints."""
    times = raw_race(n_slots_hint, stream_hint, backend.default_device(device))
    name = min(times, key=lambda k: times[k]["best_s"])
    return name, SCATTER_IMPLS[name]
