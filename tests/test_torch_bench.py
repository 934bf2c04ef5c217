"""The port's bench (``python -m pantas_tpu_torch.bench``) against the root
``bench.py`` on the same inputs: a tiny synthetic example/4 (``gen_inputs``
at 0.05 Mbp and reads of ``sim``) in a temporary reference checkout. The root
bench is pointed at it by setting its ``EXAMPLE``, ``CACHE`` and
``MULTIPLIER``; the port's bench through ``PANTAS_REFERENCE`` and its
``CACHE``. Every artifact both write must be byte-equal and the host caller's
event count equal (tolerance 0); timings are not compared. The device runs go
to the CPU (``--device cpu``)."""

import ast
import contextlib
import gzip
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from conftest import REPO_ROOT

# imported here, not under a test's captured stderr: their ``log=sys.stderr``
# defaults are bound when the module is first imported
import pantas_tpu_torch.build.pipeline  # noqa: F401
import pantas_tpu_torch.mapping.mapper  # noqa: F401

MULTIPLIER = 4
DEVICE_RUNS = 8  # the warm-up, three A/B pairs and the CPU run


def write_example(ref: Path) -> Path:
    """A reference checkout holding only ``example/``: 4.fa, 4.gtf and
    4.vcf.gz of ``gen_inputs`` at 0.05 Mbp, and one condition of ``sim`` on
    them as reads_{1,2}.fq. Returns ``ref``."""
    from pantas_tpu_torch.eval.simulate import simulate
    from pantas_tpu_torch.eval.synth import gen_inputs

    ex = ref / "example"
    ex.mkdir(parents=True)
    gen_inputs(ex, mbp=0.05, n_var=500, n_genes=5, n_samples=4)
    os.replace(ex / "g.fa", ex / "4.fa")
    os.replace(ex / "g.gtf", ex / "4.gtf")
    with open(ex / "g.vcf", "rb") as src, gzip.open(ex / "4.vcf.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    (ex / "g.vcf").unlink()
    simulate(str(ex / "4.fa"), str(ex / "4.gtf"), str(ex / "sim"), n_events=4,
             reads_per_isoform=20, seed=7, log=io.StringIO())
    os.replace(ex / "sim_c1_1.fq", ex / "reads_1.fq")
    os.replace(ex / "sim_c1_2.fq", ex / "reads_2.fq")
    for p in ex.glob("sim*"):
        p.unlink()
    return ref


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", REPO_ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    return write_example(tmp_path_factory.mktemp("reference"))


@pytest.fixture(scope="module")
def jax_bench(example, tmp_path_factory):
    """The root bench's workload and its ``bench_call`` up to the reference
    caller, which is absent: (its cache, its log)."""
    root = _root_bench()
    cache = tmp_path_factory.mktemp("jax_cache")
    said = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stderr(said):
        mp.setattr(root, "EXAMPLE", example / "example")
        mp.setattr(root, "CACHE", cache)
        mp.setattr(root, "MULTIPLIER", MULTIPLIER)
        gfa, _, _ = root.ensure_workload()
        with contextlib.suppress(subprocess.CalledProcessError):
            root.bench_call(gfa)  # fails on the absent reference after logging ours
    return cache, said.getvalue()


@pytest.fixture(scope="module")
def port_run(example, tmp_path_factory):
    """``main`` of the port's bench on the CPU, on the same example: (its
    cache, its workload, stdout, its log)."""
    from pantas_tpu_torch import bench

    cache = tmp_path_factory.mktemp("port_cache")
    out, said = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PANTAS_REFERENCE", str(example))
        mp.setattr(bench, "CACHE", cache)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(said):
            assert bench.main(["--device", "cpu", "--multiplier", str(MULTIPLIER)]) == 0
            workload = bench.ensure_workload(MULTIPLIER)  # cached: returns at once
    return cache, workload, out.getvalue(), said.getvalue()


@pytest.mark.parametrize("artifact", ["gfa", "sample", "big", "augmented"])
def test_workload_is_byte_equal_to_the_root_bench(jax_bench, port_run, artifact):
    jax_cache, _ = jax_bench
    _, (gfa, _, big, _), _, _ = port_run
    pairs = {
        "gfa": (jax_cache / "pantranscriptome-annotated.gfa", gfa),
        "sample": (jax_cache / "sample.gaf", gfa.parent.parent / "sample.gaf"),
        "big": (jax_cache / "big.gaf", big),
        "augmented": (jax_cache / "augmented_big.gfa", big.with_name(f"augmented_{big.stem}.gfa")),
    }
    theirs, ours = pairs[artifact]
    assert ours.stat().st_size > 0
    assert ours.read_bytes() == theirs.read_bytes()


def test_host_event_count_equals_the_root_bench(jax_bench, port_run):
    (_, theirs), (_, _, _, ours) = jax_bench, port_run
    pattern = r"\[bench\] call \(ours\): (\d+) events"
    assert re.findall(pattern, ours) == re.findall(pattern, theirs)
    assert int(re.search(pattern, ours).group(1)) > 0


def test_device_call_rows_equal_the_host_rows(port_run):
    said = port_run[3]
    host = int(re.search(r"call \(ours\): (\d+) events", said).group(1))
    line = next(ln for ln in said.splitlines() if "call --engine device (cpu)" in ln)
    assert f": {host} events in" in line and "rows equal to the host caller's" in line


def test_device_call_rows_that_differ_fail(port_run, monkeypatch):
    from pantas_tpu_torch import bench
    from pantas_tpu_torch.events import batched

    _, (gfa, gtf, big, _), _, _ = port_run
    inner = batched.call_events_device
    monkeypatch.setattr(batched, "call_events_device",
                        lambda *a, **k: list(inner(*a, **k))[:-1])
    with pytest.raises(RuntimeError, match="rows differ from the host caller's"):
        bench.bench_call(gfa, gtf, big, "cpu")


def test_last_line_has_the_root_bench_keys(port_run):
    line = json.loads(port_run[2].strip().splitlines()[-1])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert (line["metric"], line["unit"], line["vs_baseline"]) == \
        ("augment_reads_per_s", "reads/s", None)
    assert line["value"] > 0
    assert port_run[2].strip().count("\n") == 0  # nothing else on stdout


def test_every_device_run_has_the_native_bytes(port_run):
    said = port_run[3]
    assert said.count("sha256 == native engine's") == DEVICE_RUNS
    # no card: no kernel launch, and the warm-up's auto choice is logged (C2)
    assert "kernel #1 launches over the bench: 0, one a batch in each of the 0 device" in said
    assert "auto on a fresh cache chose plain" in said
    assert "reference augmenter absent" in said


def test_device_run_split_is_the_program_spans(port_run, tmp_path, monkeypatch):
    """``device_run`` times the stage by the program's own spans: each key of
    its split is the sum of its span in the snapshot the run leaves, and its
    batches are the counter ``device.batches``, one ``device.add_slots`` span
    a batch."""
    from pantas_tpu_torch import bench, trace

    _, (gfa, _, big, _), _, _ = port_run
    monkeypatch.delenv("PANTAS_SCATTER", raising=False)
    try:
        rec = bench.device_run(big, gfa, tmp_path / "device.gfa", "cpu")
        assert not trace.enabled()
        snap = trace.snapshot()
    finally:
        trace.reset()
    totals = trace.span_totals(snap)
    spans = {"tensorize_s": "graph.compile_gfa", "engine_s": "native.engine_init",
             "stream_s": "native.stream", "batches_host_s": "device.add_slots",
             "readback_s": "device.readback", "emit_s": "native.emit"}
    assert sorted(rec["split"]) == sorted([*spans, "parse_s"])
    for key, name in spans.items():
        assert totals[name] > 0 and rec["split"][key] == round(totals[name], 4), key
    assert rec["split"]["parse_s"] == round(snap["counters"]["slots.parse_ns"] / 1e9, 4)
    batches = snap["counters"]["device.batches"]
    assert rec["batches"] == batches == sum(s[0] == "device.add_slots" for s in snap["spans"])
    assert batches >= 1 and rec["impl"][0].startswith("cpu-sorted-plain (")
    assert "verdict" not in rec


@pytest.mark.parametrize("evals,ok", [({("annotated_es", "cpu"): 3}, True),
                                       ({("annotated_es", "cpu"): 3, ("ir", "cuda"): 2}, False),
                                       ({}, False)], ids=["on-the-device", "elsewhere", "none"])
def test_device_evals_must_all_run_on_the_device(monkeypatch, evals, ok):
    from collections import Counter

    from pantas_tpu_torch import bench
    from pantas_tpu_torch.events import batched

    monkeypatch.setattr(batched, "EVALS", Counter(evals))
    got = {"spans": {"call.es.match": 0.25, "call.ir.match": 0.5}, "counters": {}}
    if ok:
        assert bench.device_evals(got, "cpu") == {"annotated_es": {"candidates": 3,
                                                                   "eval_s": 0.25}}
    else:
        with pytest.raises(RuntimeError, match="expected every one on cpu"):
            bench.device_evals(got, "cpu")


def _program_patches(path: Path) -> list:
    """Each ``setattr`` call in ``path``, and each assignment to an attribute
    of a name it imports from ``pantas_tpu_torch``."""
    tree = ast.parse(path.read_text())
    program = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("pantas_tpu_torch"):
            program.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            program.update((a.asname or a.name).split(".")[0] for a in node.names
                           if a.name.startswith("pantas_tpu_torch"))
    hits = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "setattr"):
            hits.append(f"{path.name}:{node.lineno} setattr")
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, (ast.AugAssign, ast.AnnAssign)) else [])
        while any(isinstance(t, (ast.Tuple, ast.List)) for t in targets):
            targets = [e for t in targets
                       for e in (t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t])]
        for target in targets:
            base = target
            while isinstance(base, (ast.Attribute, ast.Subscript)):
                base = base.value
            if (isinstance(target, ast.Attribute) and isinstance(base, ast.Name)
                    and base.id in program):
                hits.append(f"{path.name}:{node.lineno} {ast.unparse(target)} =")
    return hits


@pytest.mark.parametrize("name", ["pantas_tpu_torch/bench.py", "chip_smoke.py"])
def test_no_timer_patches_the_program(name):
    """The bench and the smoke read the program's spans; neither replaces a
    function or method of the program to time it."""
    assert _program_patches(REPO_ROOT / name) == []


@pytest.mark.parametrize("code,message", [
    ("import sys; print('broken', file=sys.stderr); sys.exit(3)", "exited 3: broken"),
    ("import time; time.sleep(60)", "timed out"),
])
def test_a_failed_device_run_raises(port_run, monkeypatch, code, message):
    from pantas_tpu_torch import bench

    _, (gfa, _, big, n_reads), _, _ = port_run
    monkeypatch.setattr(bench, "DEVICE_RUN", code)
    monkeypatch.setattr(bench, "DEVICE_RUN_TIMEOUT_S", 5)
    with pytest.raises(RuntimeError, match=message):
        bench.bench_device(gfa, big, n_reads, "cpu")


def test_main_exits_nonzero_when_a_device_run_fails(example, port_run):
    """Through the module as ``python -m`` runs it, with the device run's
    code broken: a non-zero exit and no result line."""
    probe = ("import sys\nfrom pathlib import Path\nfrom pantas_tpu_torch import bench\n"
             "bench.CACHE = Path(sys.argv[1])\nbench.DEVICE_RUN = 'raise SystemExit(5)'\n"
             "sys.exit(bench.main(['--device', 'cpu', '--multiplier', sys.argv[2]]))\n")
    proc = subprocess.run([sys.executable, "-c", probe, str(port_run[0]), str(MULTIPLIER)],
                          capture_output=True, text=True, cwd=REPO_ROOT, timeout=300,
                          env=dict(os.environ, PANTAS_REFERENCE=str(example),
                                   PYTHONPATH=str(REPO_ROOT)))
    assert proc.returncode != 0
    assert "exited 5" in proc.stderr
    assert proc.stdout == ""


def test_the_card_is_the_default_and_never_replaced(monkeypatch):
    from pantas_tpu_torch import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main([])


@pytest.mark.parametrize("present", [[], ["out/pantranscriptome-annotated.gfa", "reads1m.gaf"]],
                         ids=["empty", "the-root-bench-name"])
def test_absent_genome_cache_is_skipped(tmp_path, monkeypatch, capsys, present):
    """No cache, or one under the root bench's ``reads1m.gaf``, which no
    script writes: logged as skipped."""
    from pantas_tpu_torch import bench

    for name in present:
        (tmp_path / "stress100m" / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / "stress100m" / name).write_text("")
    monkeypatch.setattr(bench, "CACHE", tmp_path)
    assert bench.bench_genome_augment("cpu") is None
    assert "cached 100 Mbp workload absent" in capsys.readouterr().err


@pytest.fixture
def synthetic(tmp_path, monkeypatch):
    """The bench with no reference, its synthetic graph cut to 0.05 Mbp and
    both caches in ``tmp_path``."""
    from pantas_tpu_torch import bench
    from pantas_tpu_torch.eval import synth

    monkeypatch.delenv("PANTAS_REFERENCE", raising=False)
    monkeypatch.setattr(synth, "CACHE", tmp_path / "synth")
    monkeypatch.setattr(bench, "CACHE", tmp_path / "bench")
    monkeypatch.setattr(bench, "SYNTH_MBP", 0.05)
    return bench


def test_synthetic_example_without_the_reference(synthetic, monkeypatch, capsys):
    bench = synthetic
    monkeypatch.setattr(bench, "MIN_RECORDS", 1)
    gfa, gtf, big, n_reads = bench.ensure_workload(3)
    assert "the synthetic example" in capsys.readouterr().err
    assert gfa.parent.parent.name == "stress0.05m" and gtf.name == "g.gtf"
    sample = big.with_name("sample.gaf").read_bytes()
    assert sample and big.read_bytes() == 3 * sample and n_reads == 3 * sample.count(b"\n")
    assert big.parent.name == f"bench_synth0.05m_s{bench.SYNTH_SEED}"
    assert bench.ensure_workload(3) == (gfa, gtf, big, n_reads)  # cached


def test_synthetic_sample_must_reach_a_million_records(synthetic):
    with pytest.raises(RuntimeError, match="stays under 1000000"):
        synthetic.ensure_workload(2)


def test_present_genome_cache_is_read_from_reads_1000000(port_run, tmp_path, monkeypatch,
                                                          capsys):
    """A tiny graph under the 100 Mbp cache's names: its reads are read from
    ``reads_1000000.gaf`` (the name the port's scale scripts write), and both device
    runs give the native engine's bytes."""
    from pantas_tpu_torch import bench
    from pantas_tpu_torch.eval.synth import synth_gaf

    gfa = port_run[1][0]
    wd = tmp_path / "stress100m"
    (wd / "out").mkdir(parents=True)
    shutil.copy(gfa, wd / "out" / gfa.name)
    synth_gaf(wd / "out" / gfa.name, 3000, wd / "reads_1000000.gaf")
    monkeypatch.setattr(bench, "CACHE", tmp_path)
    got = bench.bench_genome_augment("cpu")
    said = capsys.readouterr().err
    assert got["batches"] == 1 and got["launches"] == got["runs"] == 0
    assert "3000 reads in" in said
    assert said.count("sha256 == native engine's") == 2


# each file at the root of the checkout that runs the system, and the port's
# counterpart (chip_smoke.py is the port's own)
ROOT_COUNTERPARTS = {
    "bench.py": "pantas_tpu_torch/bench.py",
    "__graft_entry__.py": "pantas_tpu_torch/graft_entry.py",
    "chip_smoke.py": "chip_smoke.py",
}


def test_every_root_entry_point_has_a_counterpart():
    assert sorted(p.name for p in REPO_ROOT.glob("*.py")) == sorted(ROOT_COUNTERPARTS)
    for port in ROOT_COUNTERPARTS.values():
        assert (REPO_ROOT / port).is_file()
    from pantas_tpu_torch import bench

    names = ["ensure_workload", "bench_reference", "bench_native", "bench_call",
             "bench_device", "bench_genome_augment", "main"]
    assert [n for n in names if callable(getattr(bench, n, None))] == names
    root = (REPO_ROOT / "bench.py").read_text()
    assert all(f"def {n}(" in root for n in names)
