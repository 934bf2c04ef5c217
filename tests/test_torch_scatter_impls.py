"""The port's scatter selection vs the JAX package's, on the CPU.

Mirrors ``test_pallas_kernel.py`` (``_decide``, the persisted verdict, the
re-race of an unexplored verdict, ``pick_scatter_impl``) and
``test_compile_cache.py`` (the ``PANTAS_SCATTER`` default and the forced
race) against ``pantas_tpu_torch.coverage.scatter_impls`` and the port's
``DeviceCoverage``, and holds the port's deliberate differences: a candidate
that raises or verifies wrong makes the race raise, an unknown
``PANTAS_SCATTER`` raises, and the verdict lives under ``PANTAS_TORCH_CACHE``.
Every counts comparison is exact equality (integer adds).
"""

import io
import json
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from fixtures_micro import write_micro
from test_augment_fuzz import make_gaf, make_graph

from pantas_tpu.coverage import augment_gfa
from pantas_tpu.coverage import pallas_kernel as pk
from pantas_tpu.graph.compiler import compile_gfa
from pantas_tpu_torch import cli
from pantas_tpu_torch.coverage import bench_scatter, kernels
from pantas_tpu_torch.coverage import device as port
from pantas_tpu_torch.coverage import scatter_impls as si

TO_PORT = {"xla": "plain", "pallas-sorted": "cuda-sorted", "pallas-onehot": "cuda-direct"}
CPU = torch.device("cpu")


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PANTAS_TORCH_CACHE", str(tmp_path / "cache"))
    return tmp_path / "cache" / "scatter_verdict.json"


def _refuse(counts, idx):
    raise AssertionError("the cached verdict should have decided without measuring")


def test_registry_maps_the_jax_names():
    assert [TO_PORT[k] for k in pk.SCATTER_IMPLS] == list(si.SCATTER_IMPLS)
    assert si.SCATTER_IMPLS["cuda-sorted"] is kernels.sorted_coverage_scatter_add
    assert si.SCATTER_IMPLS["cuda-direct"] is kernels.coverage_scatter_add
    assert si.EXPLORE_BUDGET_S == pk.EXPLORE_BUDGET_S


@pytest.mark.parametrize("hint", [23, 10_000, None])
def test_decide_matches_jax(hint):
    """The projection ``first_s + hint × median step``: a faster step with a
    large fixed cost loses at 23 batches and wins at 10,000 and on step
    rate alone, in both packages."""
    stats = {
        "xla": {"first_s": 0.1, "times": [0.037, 0.036, 0.037]},
        "pallas-sorted": {"first_s": 60.0, "times": [0.028, 0.029, 0.028]},
    }
    ported = {TO_PORT[k]: v for k, v in stats.items()}
    assert si._decide(ported, hint) == TO_PORT[pk._decide(stats, hint)]


def test_verdict_file_and_key(tmp_path, monkeypatch):
    monkeypatch.delenv("PANTAS_TORCH_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("PANTAS_JAX_CACHE", str(tmp_path / "jax"))
    assert si._verdict_file() == str(tmp_path / ".cache" / "pantas_tpu_torch" / "scatter_verdict.json")
    assert si._verdict_file() != pk._verdict_file()
    monkeypatch.setenv("PANTAS_TORCH_CACHE", str(tmp_path / "c"))
    assert si._verdict_file() == str(tmp_path / "c" / "scatter_verdict.json")
    assert si._backend_key(5000, 256, "cpu") == "cpu:cpu:8192:256"
    assert si._backend_key(1 << 12, 1 << 20, CPU) == "cpu:cpu:4096:1048576"


def test_a_verdict_of_other_kernel_sources_is_not_used(cache, monkeypatch):
    """On CUDA the key holds the kernel library's content hash: a verdict
    cached under the same hash decides without a race; one cached under
    another hash (an older kernel's) is not used, and the new race is cached
    beside it. The race itself is replaced and the card is stubbed, so this
    runs without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "Card")
    monkeypatch.setattr(si._build, "library_path",
                        lambda: Path("build/kernels/libpantas_kernels_00000000000000aa.so"))
    old = si._backend_key(1 << 12, 256, "cuda") + ":v2"
    assert old == "cuda:Card:4096:256:00000000000000aa:v2"
    stats = {"plain": {"first_s": 0.0, "median_s": 1.0, "times": [1.0]},
             "cuda-sorted": {"first_s": 0.0, "median_s": 0.001, "times": [0.001]}}
    cache.parent.mkdir(parents=True)
    cache.write_text(json.dumps({old: {"impl": "cuda-sorted", "explored": True,
                                       "batches_hint": 8, "trials": 5, "stats": stats}}))
    raced = []

    def race(*args):
        raced.append(args)
        return {"impl": "plain", "explored": True, "batches_hint": 8, "trials": 5,
                "stats": {"plain": stats["plain"]}}

    monkeypatch.setattr(si, "_race", race)
    name, _ = si.pick_scatter_endtoend(1 << 12, 256, batches_hint=8, device="cuda")
    assert name == "cuda-sorted" and not raced

    monkeypatch.setattr(si._build, "library_path",
                        lambda: Path("build/kernels/libpantas_kernels_00000000000000bb.so"))
    name, fn = si.pick_scatter_endtoend(1 << 12, 256, batches_hint=8, device="cuda")
    assert name == "plain" and fn is si.SCATTER_IMPLS["plain"] and len(raced) == 1
    assert set(json.loads(cache.read_text())) == {old, old.replace(":00000000000000aa:", ":00000000000000bb:")}


def test_pick_scatter_endtoend_persists_verdict(cache, monkeypatch):
    """A small stage measures plain only (8 batches never reach the
    budget); the verdict persists under PANTAS_TORCH_CACHE and a second
    call decides from it without measuring."""
    name, fn = si.pick_scatter_endtoend(1 << 12, 256, batches_hint=8, device=CPU)
    assert name == "plain" and fn is si.SCATTER_IMPLS["plain"]
    data = json.loads(cache.read_text())
    (key,) = data
    assert key == si._backend_key(1 << 12, 256, CPU) + ":v2"
    assert len(data[key]["stats"]["plain"]["times"]) == 3
    assert data[key]["explored"] is False and data[key]["batches_hint"] == 8
    before = cache.read_bytes()

    for k in si.SCATTER_IMPLS:
        monkeypatch.setitem(si.SCATTER_IMPLS, k, _refuse)
    name2, _ = si.pick_scatter_endtoend(1 << 12, 256, batches_hint=8, device=CPU)
    assert name2 == "plain" and cache.read_bytes() == before


def test_forced_race_explores_and_chains(cache):
    sample = np.arange(256, dtype=np.int32)
    name, fn = si.pick_scatter_endtoend(1 << 12, 256, sample=sample, trials=4,
                                        force_race=True, batches_hint=8, device=CPU)
    entry = json.loads(cache.read_text())[si._backend_key(1 << 12, 256, CPU) + ":v2"]
    assert entry["explored"] is True and entry["trials"] == 4 and entry["impl"] == name
    assert set(entry["stats"]) == {"plain", "cuda-sorted"}
    assert all(len(st["times"]) == 4 for st in entry["stats"].values())
    counts = fn(torch.zeros(1 << 12, dtype=torch.int32), torch.from_numpy(sample))
    assert np.array_equal(counts.numpy()[:256], np.ones(256, np.int32))


def test_cached_plain_only_verdict_reexplores_big_stages(cache):
    """A verdict recorded when exploration was skipped holds only plain
    stats: used as is without a hint, re-raced for a stage whose projected
    plain cost clears EXPLORE_BUDGET_S."""
    key = si._backend_key(1 << 12, 256, CPU) + ":v2"
    cache.parent.mkdir(parents=True)
    cache.write_text(json.dumps({key: {
        "impl": "plain", "batches_hint": 8, "trials": 5,
        "stats": {"plain": {"first_s": 0.0, "median_s": 9999.0, "times": [9999.0]}},
    }}))
    name, _ = si.pick_scatter_endtoend(1 << 12, 256, batches_hint=None, device=CPU)
    assert name == "plain"
    assert json.loads(cache.read_text())[key]["stats"]["plain"]["times"] == [9999.0]

    # 500 batches x 9999 s >> budget: re-race; the measured plain steps
    # (microseconds here) then decide that exploring does not pay
    si.pick_scatter_endtoend(1 << 12, 256, batches_hint=500, device=CPU)
    entry = json.loads(cache.read_text())[key]
    assert entry["batches_hint"] == 500 and entry["explored"] is False
    new = entry["stats"]["plain"]["times"]
    assert new != [9999.0] and all(t < 100 for t in new)


def test_pick_scatter_impl_returns_working_fn():
    name, fn = si.pick_scatter_impl(1 << 12, 1 << 14, device=CPU)
    assert name in si.SCATTER_IMPLS
    rng = np.random.default_rng(3)
    idx_np = rng.integers(-1, 1 << 12, size=1 << 14, dtype=np.int32)
    out = fn(torch.zeros(1 << 12, dtype=torch.int32), torch.from_numpy(idx_np)).numpy()
    expect = np.bincount(idx_np[idx_np >= 0], minlength=1 << 12).astype(np.int32)
    assert np.array_equal(out, expect)


def _raises(counts, idx):
    raise RuntimeError("kernel failed to launch")


def _adds_twice(counts, idx):
    si.SCATTER_IMPLS["plain"](counts, idx)
    return si.SCATTER_IMPLS["plain"](counts, idx)


@pytest.mark.parametrize("bad, match", [(_raises, "failed to launch"), (_adds_twice, "verified wrong")])
def test_a_failing_candidate_makes_the_race_raise(cache, monkeypatch, bad, match):
    """The JAX race drops such a candidate; the port never replaces a
    broken kernel with index_add_ in silence."""
    monkeypatch.setitem(si.SCATTER_IMPLS, "cuda-sorted", bad)
    with pytest.raises(RuntimeError, match=match):
        si.pick_scatter_endtoend(1 << 12, 256, force_race=True, batches_hint=8, device=CPU)
    assert not cache.exists()
    monkeypatch.setitem(si.SCATTER_IMPLS, "cuda-sorted", kernels.sorted_coverage_scatter_add)
    monkeypatch.setitem(si.SCATTER_IMPLS, "cuda-direct", bad)
    with pytest.raises(RuntimeError, match=match):
        si.pick_scatter_impl(1 << 12, 1 << 12, device=CPU)


@pytest.mark.parametrize(
    "value, choice",
    [("", "cuda-sorted"), ("xla", "plain"), ("off", "plain"), ("plain", "plain"),
     ("pallas", "cuda-sorted"), ("sorted", "cuda-sorted"), ("pallas-sorted", "cuda-sorted"),
     ("cuda-sorted", "cuda-sorted"), ("race", "race"), ("auto", "race"), ("RACE", "race")],
)
def test_pantas_scatter_spellings(tmp_path, monkeypatch, value, choice):
    monkeypatch.setenv("PANTAS_SCATTER", value)
    assert si.pantas_scatter() == (choice, value.lower() == "race")
    if choice == "race":
        with pytest.raises(ValueError, match=f"PANTAS_SCATTER={value} cannot be combined"):
            si.mesh_scatter()
    else:
        assert si.mesh_scatter() == (choice, si.SCATTER_IMPLS[choice])
    gfa, _ = write_micro(tmp_path)
    dev = port.DeviceCoverage(compile_gfa(gfa), "cpu", log=io.StringIO())
    if choice == "race":
        assert dev._step is None and dev._force_race == (value.lower() == "race")
    else:
        assert dev._step is si.SCATTER_IMPLS[choice] and not dev._force_race


def test_unknown_pantas_scatter_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PANTAS_SCATTER", "pallas-onehot")
    with pytest.raises(ValueError, match="cuda-sorted"):
        si.pantas_scatter()
    monkeypatch.setenv("PANTAS_SCATTER", "fast")
    for ask in (si.pantas_scatter, si.mesh_scatter):
        with pytest.raises(ValueError) as refused:
            ask()
        assert str(refused.value) == (
            "PANTAS_SCATTER='fast' is not one of xla, off, plain, pallas, sorted, "
            "pallas-sorted, cuda-sorted, race, auto")
    gfa, gaf = write_micro(tmp_path)
    with pytest.raises(ValueError, match="PANTAS_SCATTER='fast'"):
        port.DeviceCoverage(compile_gfa(gfa), "cpu", log=io.StringIO())
    out = tmp_path / "o.gfa"
    with pytest.raises(ValueError, match="PANTAS_SCATTER"):
        cli.main(["augment", "--engine", "device", "--device", "cpu", gaf, gfa, "-o", str(out)])
    assert not out.exists()


# a read of the variable: os.environ.get / os.getenv, or os.environ[...] not assigned to
ENV_READ = re.compile(r"""(environ\.get|getenv)\(\s*["']PANTAS_SCATTER["']"""
                      r"""|environ\[\s*["']PANTAS_SCATTER["']\s*\](?!\s*=[^=])""")


def test_pantas_scatter_is_read_in_scatter_impls_alone():
    """One owner of the choice: every other module of the port, the smoke
    and the graft entry ask :func:`pantas_scatter` or :func:`mesh_scatter`."""
    root = Path(__file__).resolve().parent.parent
    sources = [root / "chip_smoke.py", *sorted((root / "pantas_tpu_torch").rglob("*.py"))]
    readers = sorted({str(p.relative_to(root)) for p in sources if ENV_READ.search(p.read_text())})
    assert readers == ["pantas_tpu_torch/coverage/scatter_impls.py"]


def test_cpu_default_runs_the_sorted_wrapper_without_a_race(tmp_path, cache, monkeypatch):
    monkeypatch.delenv("PANTAS_SCATTER", raising=False)
    gfa, _ = write_micro(tmp_path)
    log = io.StringIO()
    dev = port.DeviceCoverage(compile_gfa(gfa), "cpu", log=log)
    dev.add_slots(np.array([0, 1, 1, -1], dtype=np.int32), pad_to=8)
    out = dev.result()
    assert out[0] == 1 and out[1] == 2
    assert "[device] scatter impl: cpu-sorted-plain" in log.getvalue()
    assert not cache.exists()


def test_all_padding_first_batch_keeps_the_race_pending(tmp_path, cache, monkeypatch):
    monkeypatch.setenv("PANTAS_SCATTER", "race")
    gfa, _ = write_micro(tmp_path)
    t = compile_gfa(gfa)
    log = io.StringIO()
    dev = port.DeviceCoverage(t, "cpu", batches_hint=3, log=log)
    assert "[device] scatter impl: race pending (4096 slots, ~3 batches expected)" in log.getvalue()
    dev.add_slots(np.full(64, -1, dtype=np.int32))
    assert dev._step is None and dev.batches == 1 and not cache.exists()
    real = np.array([2, 2, 2, -1, 5], dtype=np.int32)
    dev.add_slots(real, pad_to=64)
    assert dev._step is not None and dev.batches == 2 and cache.exists()
    decided = [ln for ln in log.getvalue().splitlines() if ln.startswith("[device] scatter impl: ")]
    assert decided[-1] in ("[device] scatter impl: plain", "[device] scatter impl: cpu-sorted-plain")
    flat = dev.result()
    assert flat[2] == 3 and flat[5] == 1 and int(flat.sum()) == 4
    assert "(batches: 2)" in log.getvalue()


@pytest.mark.parametrize("graph", ["micro", "fuzz0", "fuzz3", "fuzz7"])
def test_raced_device_augment_cli_is_byte_identical(tmp_path, cache, monkeypatch, capsys, graph):
    monkeypatch.setenv("PANTAS_SCATTER", "race")
    if graph == "micro":
        gfa, gaf = write_micro(tmp_path)
    else:
        rng = random.Random(int(graph[4:]))
        gfa_text, lens = make_graph(rng)
        gfa, gaf = tmp_path / "g.gfa", tmp_path / "g.gaf"
        gfa.write_text(gfa_text)
        gaf.write_text(make_gaf(rng, lens, 60))
    out = tmp_path / "o.gfa"
    assert cli.main(["augment", "--engine", "device", "--device", "cpu",
                     str(gaf), str(gfa), "-o", str(out)]) == 0
    host = io.StringIO()
    augment_gfa(str(gaf), str(gfa), out=host, log=io.StringIO())
    assert out.read_text() == host.getvalue()
    err = capsys.readouterr().err
    assert "[device] scatter impl: race pending" in err
    assert ("[device] scatter impl: plain\n" in err) or ("[device] scatter impl: cpu-sorted-plain\n" in err)
    (entry,) = json.loads(cache.read_text()).values()
    assert entry["explored"] is True and set(entry["stats"]) == {"plain", "cuda-sorted"}


def test_bench_scatter_records_on_the_cpu():
    recs = list(bench_scatter.run(1 << 12, [1 << 12, 1 << 13], CPU))
    assert [(r["stream"], r["impl"]) for r in recs] == [
        (m, k) for m in (1 << 12, 1 << 13) for k in si.SCATTER_IMPLS
    ]
    assert all(r["correct"] and r["best_s"] > 0 and r["m_idx_per_s"] > 0 for r in recs)


def test_bench_scatter_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench_scatter.main(["4096", "4096"])
