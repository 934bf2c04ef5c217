"""The port's copies of the scale drivers under ``scripts/``
(``pantas_tpu_torch/scripts/``): each held line by line against its original,
with only the listed lines changed, then run at a tiny size through both
packages on the same inputs. What the two write must be equal, exactly
(tolerance 0); timings are not compared."""

import ast
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import REPO_ROOT

MBP = "0.05"  # ensure_graph's smallest useful graph: 5 genes, 500 SNPs

# The lines that differ once the package name is swapped: original lines a..b
# became the port's lines c..d (b = a - 1 is an insertion, d = c - 1 a
# deletion). Everywhere: the checkout root is one directory further up,
# ``scripts/`` is never put on the path and a sibling script is imported from
# ``pantas_tpu_torch.scripts``, the usage names ``python -m``, and no line names
# a directory outside the checkout (the reference's is ``PANTAS_REFERENCE``).
CHANGED = {
    # --device, and the mesh step on torch tensors checked against np.bincount
    "stress_build": [(10, 10, 10, 10), (14, 13, 14, 16), (22, 22, 25, 25), (32, 31, 35, 35),
                     (44, 43, 48, 58), (175, 181, 190, 190), (183, 182, 192, 192),
                     (184, 183, 194, 195), (187, 186, 199, 199), (189, 188, 202, 202),
                     (194, 198, 208, 212), (200, 200, 214, 214), (202, 202, 216, 217),
                     (205, 205, 220, 222), (207, 206, 224, 227), (220, 219, 241, 241)],
    # the device engine on the card unless CALL_SCALE_PLATFORM=cpu; the child
    # re-exec through -m
    "bench_call_scale": [(12, 13, 12, 15), (19, 19, 21, 21), (21, 21, 23, 23), (33, 33, 35, 35),
                         (35, 35, 37, 36), (56, 56, 57, 57), (142, 142, 143, 143),
                         (144, 148, 145, 146), (153, 153, 151, 152), (158, 158, 157, 157),
                         (218, 218, 217, 218)],
    # --device, the mesh's private partials and its one reduction in torch
    "bench_scaling": [(4, 9, 4, 9), (11, 11, 11, 11), (15, 15, 15, 14), (20, 20, 19, 23),
                      (25, 39, 28, 27), (41, 40, 29, 29), (42, 41, 31, 32), (45, 44, 36, 36),
                      (48, 47, 40, 45), (49, 49, 47, 49), (60, 62, 60, 62), (65, 65, 65, 65),
                      (67, 68, 67, 68), (72, 72, 72, 73), (87, 87, 88, 88)],
    # --device for the ranks; no JAX environment
    "bench_scaling_e2e": [(6, 10, 6, 10), (12, 13, 12, 13), (29, 29, 29, 29), (31, 30, 31, 34),
                          (63, 63, 67, 67), (70, 71, 74, 73), (78, 78, 80, 80),
                          (98, 98, 100, 100)],
    "run_sim_experiment": [(22, 22, 22, 22), (27, 27, 27, 27), (36, 36, 36, 36),
                           (46, 46, 46, 46), (48, 48, 48, 47), (50, 50, 49, 50),
                           (79, 79, 79, 79)],
    # --engine and --device: the staged layout on the device engines, each
    # device stage's log kept and checked, each device GFA held to the native
    # engine's
    "run_fullscale_experiment": [(7, 7, 7, 7), (23, 23, 23, 24), (29, 28, 30, 30), (31, 30, 33, 33),
                                 (36, 36, 39, 39), (38, 38, 41, 40), (58, 57, 60, 69),
                                 (59, 58, 71, 72), (60, 59, 74, 79), (136, 137, 156, 158),
                                 (144, 143, 165, 165), (146, 146, 168, 168), (159, 158, 181, 184),
                                 (169, 168, 195, 243), (171, 171, 246, 246), (212, 212, 287, 287),
                                 (226, 226, 301, 301), (228, 228, 303, 303), (232, 234, 307, 309),
                                 (236, 235, 311, 312), (240, 240, 317, 317), (242, 242, 319, 319),
                                 (244, 243, 321, 322), (268, 268, 347, 347), (276, 277, 355, 356)],
}
NAMES = sorted(CHANGED)

# Runs one script of either package in this subprocess: as ``python -m`` runs
# it, except that a script whose cache is ``.bench/`` at the root of the
# checkout gets ``cache`` in its place. Its last line on stderr names what it
# loaded from the JAX package, jax, or ``scripts/``.
RUNNER = """
import importlib, json, runpy, sys
from pathlib import Path
pkg, name, argv, cache = json.loads(sys.argv[1])
sys.argv = [name, *argv]
prefix = "pantas_tpu_torch.scripts." if pkg == "pantas_tpu_torch" else ""
if not prefix:
    sys.path.insert(0, str(Path("scripts").resolve()))
if cache:
    importlib.import_module(prefix + "bench_call_scale").CACHE = Path(cache)
if name in ("bench_call_scale", "bench_scaling_e2e"):
    mod = importlib.import_module(prefix + name)
    mod.CACHE = Path(cache) if cache else mod.CACHE
    mod.main()
elif prefix:
    runpy.run_module(prefix + name, run_name="__main__")
else:
    runpy.run_path(f"scripts/{name}.py", run_name="__main__")
scripts = Path("scripts").resolve()
print(json.dumps({
    "foreign": sorted(m for m in sys.modules if m.split(".")[0] in ("pantas_tpu", "jax")),
    "scripts": sorted(m for m, mod in list(sys.modules.items())
                      if getattr(mod, "__file__", None)
                      and Path(mod.__file__).resolve().parent == scripts),
}), file=sys.stderr)
"""


def run_script(pkg, name, argv, tmp, cache=None, env=None, ok=True):
    """One run of ``name`` from ``pkg`` (``pantas_tpu`` runs ``scripts/``);
    ``tmp`` is its ``TMPDIR``. Returns the finished process and its report of
    what it loaded; with ``ok`` False, the process alone, which must have
    failed."""
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), PYTHONHASHSEED="0", MPLBACKEND="Agg",
               TMPDIR=str(tmp), **(env or {}))
    proc = subprocess.run([sys.executable, "-c", RUNNER,
                           json.dumps([pkg, name, [str(a) for a in argv],
                                       str(cache) if cache else None])],
                          capture_output=True, text=True, cwd=REPO_ROOT, env=env, timeout=600)
    if not ok:
        assert proc.returncode != 0, proc.stderr[-3000:]
        return proc
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc, json.loads(proc.stderr.strip().splitlines()[-1])


def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _e2e_workload(cache: Path) -> None:
    """``bench_scaling_e2e``'s workload contract, pre-placed: the annotated
    GFA and ``big.gaf`` in the cache, here the 0.05 Mbp graph and 3,000 of
    its synthetic reads."""
    from pantas_tpu_torch.eval import synth

    saved = synth.CACHE
    synth.CACHE = cache
    try:
        wd = synth.ensure_graph(float(MBP))
    finally:
        synth.CACHE = saved
    os.link(wd / "out" / "pantranscriptome-annotated.gfa", cache / "pantranscriptome-annotated.gfa")
    synth.synth_gaf(cache / "pantranscriptome-annotated.gfa", 3000, cache / "big.gaf")


def script_argv(name: str, tmp: Path):
    """(argv, cache) of ``name``'s tiny run on the CPU in ``tmp``."""
    cache = tmp / "cache"
    cache.mkdir(exist_ok=True)
    if name == "stress_build":  # mbp variants genes samples chroms threads
        return [MBP, "500", "5", "4", "1", "1", "--device", "cpu"], None
    if name == "bench_call_scale":
        return [MBP, "2000", "host", "device"], cache
    if name == "bench_scaling":
        return ["4", str(1 << 16), "--device", "cpu"], None
    if name == "bench_scaling_e2e":
        _e2e_workload(cache)
        return ["2000", "1", "2", "--device", "cpu"], cache
    if name == "run_sim_experiment":  # workdir sample events depth mbp replicates
        return [tmp / "sim", "s3", "4", "10", "0.1", "1"], None
    # pairs replicates mbp
    return ["3000", "1", MBP, "--mode", "both", "--wd", tmp / "full"], cache


# the full-scale experiment's staged layout on the device engines, on the CPU
FULLSCALE_DEVICE = ["--engine", "device", "--device", "cpu"]

# The JAX package's staged layout on its own device call engine, by hand on
# the JAX script's reads (that script has no engine choice): augment --engine
# native, call --engine device, quant, remap, into argv[2]. Its call engine
# writes the host caller's rows in another order, and quant keeps the order.
JAX_DEVICE_STAGED = """
import sys
from pantas_tpu import cli
full, out, gfa, gtf = sys.argv[1:5]
for tag in ("c1_r1", "c2_r1"):
    aug = f"{out}/{tag}.aug.gfa"
    assert cli.main(["augment", "--engine", "native", f"{full}/{tag}.gaf", gfa, "-o", aug]) == 0
    assert cli.main(["call", "--engine", "device", "--rca", "3", aug, gtf,
                     "-o", f"{out}/{tag}.events.csv"]) == 0
assert cli.main(["quant", "-a", "--c1", f"{out}/c1_r1.events.csv", "--c2",
                 f"{out}/c2_r1.events.csv", "-o", f"{out}/quant.csv"]) == 0
assert cli.main(["remap", f"{out}/quant.csv", gtf, "-o", f"{out}/quant-remap.csv"]) == 0
"""


@pytest.mark.parametrize("name", NAMES)
def test_script_copy_differs_only_in_the_listed_lines(name):
    original = (REPO_ROOT / "scripts" / f"{name}.py").read_text()
    original = original.replace("pantas_tpu", "pantas_tpu_torch").split("\n")
    port = (REPO_ROOT / "pantas_tpu_torch" / "scripts" / f"{name}.py").read_text().split("\n")
    expected, at = [], 0
    for a, b, c, d in CHANGED[name]:
        expected += original[at : a - 1]
        assert len(expected) == c - 1, f"original line {a} is not the port's line {c}"
        expected += port[c - 1 : d]
        at = b
    expected += original[at:]
    assert port == expected
    text = "\n".join(port)
    assert 'REPO / "scripts"' not in text and "jax" not in text.replace("JAX", "")
    init = ast.parse((REPO_ROOT / "pantas_tpu_torch" / "scripts" / "__init__.py").read_text())
    assert [type(node) for node in init.body] == [ast.Expr]  # its docstring alone


def test_every_script_but_the_tpu_bench_is_ported():
    theirs = {p.stem for p in (REPO_ROOT / "scripts").glob("*.py")}
    ours = {p.stem for p in (REPO_ROOT / "pantas_tpu_torch" / "scripts").glob("*.py")}
    assert theirs - ours == {"bench_scatter_tpu"} and ours - theirs == {"__init__"}


def test_stress_build_through_both_packages(tmp_path):
    """The same GFA from both builds, the same graph figures, and the port's
    node-sharded step on a logical 2x4 mesh equal to ``np.bincount``."""
    argv, _ = script_argv("stress_build", tmp_path)
    outs = {}
    for pkg in ("pantas_tpu", "pantas_tpu_torch"):
        tmp = tmp_path / pkg
        tmp.mkdir()
        proc, report = run_script(pkg, "stress_build", argv, tmp)
        (built,) = tmp.glob("stress_*/out/pantranscriptome-annotated.gfa")
        outs[pkg] = (_sha256(built), _json_lines(proc.stdout)[-1], proc.stderr)
    (sha_a, rec_a, _), (sha_b, rec_b, log) = outs["pantas_tpu"], outs["pantas_tpu_torch"]
    assert sha_a == sha_b
    figures = ("nodes", "edges", "paths", "slots", "mbp", "variants", "samples", "chroms")
    assert {k: rec_a[k] for k in figures} == {k: rec_b[k] for k in figures}
    assert rec_b["slots"] > 100_000
    assert "node-sharded scatter on cpu (sorted_coverage_scatter_add): == np.bincount" in log


def test_stress_build_mesh_step_refuses_a_race(tmp_path):
    argv, _ = script_argv("stress_build", tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), TMPDIR=str(tmp_path), PANTAS_SCATTER="race")
    proc = subprocess.run([sys.executable, "-m", "pantas_tpu_torch.scripts.stress_build", *argv],
                          capture_output=True, text=True, cwd=REPO_ROOT, env=env, timeout=300)
    assert proc.returncode != 0 and "cannot be combined with a mesh" in proc.stderr


def test_bench_call_scale_through_both_packages(tmp_path):
    """Host and device engines of both packages on the CPU: one event count,
    and the cached graph, reads and augmented GFA byte-equal to each other
    and to ``eval/synth.py``'s."""
    from pantas_tpu_torch.eval import synth

    rows, caches = {}, {}
    for pkg in ("pantas_tpu", "pantas_tpu_torch"):
        tmp = tmp_path / pkg
        tmp.mkdir()
        argv, cache = script_argv("bench_call_scale", tmp)
        proc, report = run_script(pkg, "bench_call_scale", argv, tmp, cache=cache,
                                  env={"CALL_SCALE_PLATFORM": "cpu"})
        rows[pkg] = {r["engine"]: r for r in _json_lines(proc.stdout)}
        caches[pkg] = cache / f"stress{MBP}m"
    events = {(pkg, e): r["events"] for pkg, by in rows.items() for e, r in by.items()}
    assert len(events) == 4 and len(set(events.values())) == 1 and events[("pantas_tpu", "host")] > 10
    names = ["g.fa", "g.gtf", "g.vcf", "out/pantranscriptome-annotated.gfa", "reads_2000.gaf",
             "augmented_2000.gfa"]
    for name in names:
        assert (caches["pantas_tpu"] / name).read_bytes() == (caches["pantas_tpu_torch"] / name).read_bytes()
    gaf = tmp_path / "synth.gaf"
    synth.synth_gaf(caches["pantas_tpu_torch"] / "out" / "pantranscriptome-annotated.gfa", 2000, gaf)
    assert gaf.read_bytes() == (caches["pantas_tpu_torch"] / "reads_2000.gaf").read_bytes()


def test_bench_scaling_bit_exact_on_the_cpu(tmp_path):
    argv, _ = script_argv("bench_scaling", tmp_path)
    xla = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}  # JAX: 4 virtual devices
    for pkg, args, env in (("pantas_tpu", argv[:2], xla), ("pantas_tpu_torch", argv, None)):
        proc, _ = run_script(pkg, "bench_scaling", args, tmp_path, env=env)
        (rec,) = _json_lines(proc.stdout)
        assert [r["devices"] for r in rec["scaling"]] == [1, 2, 4]
        assert all(r["bit_exact"] for r in rec["scaling"]) and rec["platform"] == "cpu"


def test_bench_scaling_e2e_one_and_two_ranks_through_both_packages(tmp_path):
    """Each package's ranks byte-equal to its own host engine (the script
    asserts it), and the two host engines' GFAs sha256-equal."""
    from pantas_tpu.coverage import augment_gfa as theirs
    from pantas_tpu_torch.coverage.host import augment_gfa as ours

    argv, cache = script_argv("bench_scaling_e2e", tmp_path)
    for pkg in ("pantas_tpu", "pantas_tpu_torch"):
        proc, _ = run_script(pkg, "bench_scaling_e2e", argv if pkg == "pantas_tpu_torch" else argv[:3],
                             tmp_path, cache=cache)
        recs = _json_lines(proc.stdout)
        assert [(r["procs"], r["reads"], r["byte_identical"]) for r in recs] == [
            (1, 2000, True), (2, 2000, True)]
    gfa, gaf = cache / "pantranscriptome-annotated.gfa", cache / "scal_2000.gaf"
    shas = []
    for fn, out in ((theirs, tmp_path / "a.gfa"), (ours, tmp_path / "b.gfa")):
        with open(out, "w") as fh:
            fn(str(gaf), str(gfa), out=fh, log=io.StringIO())
        shas.append(_sha256(out))
    assert shas[0] == shas[1]


def test_run_sim_experiment_genome_mode_through_both_packages(tmp_path):
    """Genome mode on a 0.1 Mbp synthetic genome: each mode's per-cut scores
    byte-equal under one hash seed, and the printed tables equal."""
    printed = {}
    for pkg in ("pantas_tpu", "pantas_tpu_torch"):
        tmp = tmp_path / pkg
        tmp.mkdir()
        argv, _ = script_argv("run_sim_experiment", tmp)
        proc, _ = run_script(pkg, "run_sim_experiment", argv, tmp)
        printed[pkg] = proc.stdout
    a, b = tmp_path / "pantas_tpu" / "sim", tmp_path / "pantas_tpu_torch" / "sim"
    scores = sorted(p.name for p in a.glob("scores_*_w*.csv"))
    assert scores == ["scores_anno_w3.csv", "scores_anno_w5.csv", "scores_novel_w3.csv",
                      "scores_novel_w5.csv"]
    for name in [*scores, "sim_truth.csv", "consensus.fa", "scores_anno_cmp.csv"]:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    assert printed["pantas_tpu"] == printed["pantas_tpu_torch"]
    assert "### Sim accuracy (novel mode" in printed["pantas_tpu_torch"]


@pytest.fixture(scope="module")
def fullscale_jax(tmp_path_factory):
    """The JAX package's ``--mode both`` run at 3,000 pairs on the 0.05 Mbp
    graph (its staged layout on the native engine and the host caller); its
    work dir."""
    tmp = tmp_path_factory.mktemp("pantas_tpu")
    argv, cache = script_argv("run_fullscale_experiment", tmp)
    proc, _ = run_script("pantas_tpu", "run_fullscale_experiment", argv, tmp, cache=cache)
    assert "fused == staged" in proc.stderr
    return tmp / "full"


def _stages(wd: Path) -> list:
    return sorted(ln.split(",")[1] for ln in (wd / "bench.csv").read_text().splitlines()[1:])


@pytest.fixture(scope="module")
def fullscale_torch(tmp_path_factory):
    """The port's ``--mode both`` run beside :func:`fullscale_jax`, on the
    native engine; its directory (``full`` the work dir, ``cache`` the
    graph) and its stderr."""
    tmp = tmp_path_factory.mktemp("pantas_tpu_torch")
    argv, cache = script_argv("run_fullscale_experiment", tmp)
    proc, _ = run_script("pantas_tpu_torch", "run_fullscale_experiment", argv, tmp, cache=cache)
    return tmp, proc.stderr


def test_run_fullscale_experiment_both_modes_through_both_packages(fullscale_torch, fullscale_jax):
    """``--mode both`` (fused == staged is asserted by the script) at 3,000
    pairs on the 0.05 Mbp graph: the event rows of every replicate, the quant
    and the remapped quant byte-equal under one hash seed, and every stage
    timed in ``bench.csv``."""
    tmp, stderr = fullscale_torch
    assert "fused == staged" in stderr
    a, b = fullscale_jax, tmp / "full"
    for name in ["c1_r1.gaf", "c2_r1.gaf", "c1_r1.events.csv", "c2_r1.events.csv",
                 "c1_r1.events.fused.csv", "c2_r1.events.fused.csv", "quant.csv",
                 "quant-remap.csv", "reads/c1_r1_1.fq", "reads/c2_r1_2.fq"]:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    assert (b / "quant-remap.csv").read_text().count("\n") > 1
    assert _stages(b) == sorted(["map", "augment", "call", "replicate"] * 2 + ["quant", "remap"])
    assert not list(b.glob("*.log")) and not list(b.glob("*.device.json"))


def test_run_fullscale_experiment_device_engines_after_a_native_run_in_one_work_dir(
        tmp_path, fullscale_torch):
    """``--engine device`` in a copy of a native run's work dir reuses its
    reads, GAFs and fused rows but none of its staged artifacts: each device
    stage runs and is held (its augment log and record), its events go to
    ``<tag>.events.device.csv`` beside the native ones, and fused == staged
    compares those."""
    tmp, _ = fullscale_torch
    shutil.copytree(tmp / "full", tmp_path / "full")
    native = {p.name: p.read_bytes() for p in (tmp_path / "full").glob("*.events*.csv")}
    argv = ["3000", "1", MBP, "--mode", "both", "--wd", tmp_path / "full", *FULLSCALE_DEVICE]
    proc, _ = run_script("pantas_tpu_torch", "run_fullscale_experiment", argv, tmp_path,
                         cache=tmp / "cache")
    b = tmp_path / "full"
    assert "map c1_r1:" not in proc.stderr and "replicate(fused)" not in proc.stderr
    for tag in ("c1_r1", "c2_r1"):
        assert f"augment {tag}:" in proc.stderr and f"call {tag}:" in proc.stderr
        assert f"{tag}: fused == staged" in proc.stderr
        rec = json.loads((b / f"{tag}.device.json").read_text())
        assert rec["sha256"] == rec["native_sha256"] and (b / f"{tag}.augment.log").exists()
        ours = (b / f"{tag}.events.device.csv").read_text()
        assert sorted(ours.splitlines()) == sorted(native[f"{tag}.events.csv"].decode().splitlines())
    assert {p.name: p.read_bytes() for p in b.glob("*.events.csv")} == {
        k: v for k, v in native.items() if k.endswith(".events.csv")}
    assert _stages(b) == sorted(["map", "augment", "augment-native", "call", "replicate"] * 2
                                + ["quant", "remap"])


def test_run_fullscale_experiment_device_engines_on_the_cpu(tmp_path, fullscale_jax):
    """``--mode both --engine device --device cpu`` at 3,000 pairs, under one
    hash seed: the device-staged rows of every replicate, the quant and the
    remapped quant equal as row multisets to the JAX package's native-staged
    ones and byte-equal to the JAX package's staged layout on its device call
    engine; fused == staged; every device GFA sha256-equal to the native
    engine's; each augment's log with its scatter and its launches line (0
    launches on the CPU, where the kernels' wrappers run their plain
    versions)."""
    argv, cache = script_argv("run_fullscale_experiment", tmp_path)
    proc, report = run_script("pantas_tpu_torch", "run_fullscale_experiment",
                              argv + FULLSCALE_DEVICE, tmp_path, cache=cache)
    assert report == {"foreign": [], "scripts": []}
    b, jax_device = tmp_path / "full", tmp_path / "jax_device"
    jax_device.mkdir()
    graph = fullscale_jax.parent / "cache" / f"stress{MBP}m"
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), PYTHONHASHSEED="0", JAX_PLATFORMS="cpu",
               TMPDIR=str(tmp_path))
    made = subprocess.run([sys.executable, "-c", JAX_DEVICE_STAGED, str(fullscale_jax),
                           str(jax_device), str(graph / "out" / "pantranscriptome-annotated.gfa"),
                           str(graph / "g.gtf")], capture_output=True, text=True, cwd=REPO_ROOT,
                          env=env, timeout=300)
    assert made.returncode == 0, made.stderr[-3000:]
    assert (fullscale_jax / "c1_r1.gaf").read_bytes() == (b / "c1_r1.gaf").read_bytes()
    for name in ["c1_r1.events.csv", "c2_r1.events.csv", "quant.csv", "quant-remap.csv"]:
        ours = (b / name.replace(".events.", ".events.device.")).read_text()
        assert sorted(ours.splitlines()) == sorted((fullscale_jax / name).read_text().splitlines())
        assert ours == (jax_device / name).read_text(), name
    assert (b / "quant-remap.csv").read_text().count("\n") > 1
    for tag in ("c1_r1", "c2_r1"):
        assert f"{tag}: fused == staged" in proc.stderr
        rec = json.loads((b / f"{tag}.device.json").read_text())
        assert rec["sha256"] == rec["native_sha256"] and len(rec["sha256"]) == 64
        assert (rec["device"], rec["scatter"], rec["launches"]) == ("cpu", "cpu-sorted-plain", 0)
        assert rec["batches"] >= 1 and rec["batches_expected"] >= 1
        assert f"{tag}: device GFA sha256 {rec['sha256']} == native engine's" in proc.stderr
        log = (b / f"{tag}.augment.log").read_text()
        assert f"[device] kernel launches: 0 (batches: {rec['batches']})" in log.splitlines()
        assert "[device] scatter impl: cpu-sorted-plain" in log
        assert not (b / f"{tag}.call.log").exists()  # kept only where the call failed
        assert not list(b.glob(f"{tag}.aug*.gfa*"))  # both GFAs deleted once compared
    assert _stages(b) == sorted(["map", "augment", "augment-native", "call", "replicate"] * 2
                                + ["quant", "remap"])


def test_run_fullscale_experiment_device_stage_failure_exits_nonzero(tmp_path):
    """A device stage that fails (``--device cuda`` with no card visible)
    stops the script with a non-zero exit and the stage's log; nothing falls
    back to the CPU and no GFA or event row is left."""
    argv, cache = script_argv("run_fullscale_experiment", tmp_path)
    proc = run_script("pantas_tpu_torch", "run_fullscale_experiment",
                      argv + ["--engine", "device", "--device", "cuda"], tmp_path, cache=cache,
                      env={"CUDA_VISIBLE_DEVICES": ""}, ok=False)
    assert "augment c1_r1 failed" in proc.stderr and "c1_r1.augment.log" in proc.stderr
    wd = tmp_path / "full"
    assert (wd / "c1_r1.gaf").exists() and not list(wd.glob("*.aug*.gfa"))
    assert not list(wd.glob("*.events*.csv")) and not (wd / "quant.csv").exists()


def test_run_fullscale_experiment_device_engine_refuses_the_fused_mode(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m", "pantas_tpu_torch.scripts.run_fullscale_experiment",
                           "--mode", "fused", "--engine", "device"], capture_output=True,
                          text=True, cwd=REPO_ROOT, env=env, timeout=120)
    assert proc.returncode == 2 and "use --mode staged or both" in proc.stderr


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


@pytest.mark.cuda
def test_cuda_bench_scaling_bit_exact_on_a_logical_mesh(cuda, tmp_path):
    proc, report = run_script("pantas_tpu_torch", "bench_scaling", ["8", str(1 << 20)], tmp_path)
    (rec,) = _json_lines(proc.stdout)
    assert rec["platform"] == "cuda" and [r["devices"] for r in rec["scaling"]] == [1, 2, 4, 8]
    assert all(r["bit_exact"] for r in rec["scaling"])
    assert report == {"foreign": [], "scripts": []}


@pytest.mark.cuda
def test_cuda_stress_build_mesh_step_equals_bincount(cuda, tmp_path):
    argv, _ = script_argv("stress_build", tmp_path)
    proc, report = run_script("pantas_tpu_torch", "stress_build", argv[:-2], tmp_path)
    assert "node-sharded scatter on cuda:0 (sorted_coverage_scatter_add): == np.bincount" in proc.stderr
    assert report == {"foreign": [], "scripts": []}
