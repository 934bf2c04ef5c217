"""The mapped-reads slice as a whole on the CPU, small: ``sim`` -> ``map`` ->
``augment --engine device`` -> ``call --engine device --novel`` -> ``quant`` ->
``remap`` -> ``eval`` through ``python -m pantas_tpu_torch`` (its device
engines on ``--device cpu``), against the same chain through ``python -m
pantas_tpu`` (its device engines on JAX's CPU backend, where its scatter is
the XLA one its Pallas kernels are verified against). Every process runs
under ``PYTHONHASHSEED=0``. Tolerance: exact, bytes for every artifact but the
call rows, which are compared as sorted rows.

The graph is the 0.05 Mbp synthetic one (5 genes, 500 SNPs); the reads are
about 2,500 simulated pairs a condition with 1% substitutions."""

import sys

import pytest
from conftest import run_cli

PACKAGES = ("pantas_tpu", "pantas_tpu_torch")
CONDITIONS = ("c1", "c2")
ENV = {"JAX_PLATFORMS": "cpu"}


def _run(pkg, *args, out_path=None):
    return run_cli([sys.executable, "-m", pkg, *map(str, args)], out_path=out_path,
                   hashseed="0", env_extra=ENV)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Both chains, each in a directory of its own on inputs of its own
    making; returns ``{package: (directory, {step: stderr})}``."""
    from pantas_tpu_torch.eval.synth import gen_inputs

    done = {}
    for pkg in PACKAGES:
        wd = tmp_path_factory.mktemp(pkg)
        gen_inputs(wd, mbp=0.05, n_var=500, n_genes=5, n_samples=4)
        fa, gtf = wd / "g.fa", wd / "g.gtf"
        logs = {}
        _run(pkg, "build", fa, gtf, wd / "g.vcf", "-o", wd / "graph", "-t", "1")
        gfa = wd / "graph" / "pantranscriptome-annotated.gfa"
        _run(pkg, "sim", fa, gtf, "-o", wd / "sim", "-n", "4", "-r", "120", "-e", "0.01",
             "--seed", "11", "--etypes", "ES", "IR")
        device = ["--device", "cpu"] if pkg == "pantas_tpu_torch" else []
        for cond in CONDITIONS:
            logs[f"map_{cond}"] = _run(
                pkg, "map", gfa, wd / f"sim_{cond}_1.fq", wd / f"sim_{cond}_2.fq", "-t", "2",
                "--index", wd / "index", "-o", wd / f"{cond}.gaf").stderr
            logs[f"augment_{cond}"] = _run(
                pkg, "augment", "--engine", "device", *device, wd / f"{cond}.gaf", gfa,
                "-o", wd / f"{cond}.aug.gfa").stderr
            _run(pkg, "call", "--engine", "device", *device, "--rca", "3", "--novel",
                 "--minintronsize", "20", wd / f"{cond}.aug.gfa", gtf,
                 "-o", wd / f"{cond}.events.csv")
        _run(pkg, "quant", "-a", "--c1", wd / "c1.events.csv", "--c2", wd / "c2.events.csv",
             "-o", wd / "quant.csv")
        _run(pkg, "remap", wd / "quant.csv", gtf, "-i", "20", "-o", wd / "remap.csv")
        _run(pkg, "eval", wd / "sim_truth.csv", wd / "remap.csv", "--relax", "5",
             "--min-dpsi", "0.1", out_path=wd / "scores.txt")
        done[pkg] = (wd, logs)
    return done


def _pair(chains, name):
    return [(chains[pkg][0] / name).read_bytes() for pkg in PACKAGES]


@pytest.mark.parametrize("name", [
    "sim_c1_1.fq", "sim_c1_2.fq", "sim_c2_1.fq", "sim_c2_2.fq", "sim_truth.csv",
    "sim_event_annotation.tsv", "sim_exon_junction.tsv", "sim_variants.gtf"])
def test_sim_artifact_equal(chains, name):
    theirs, ours = _pair(chains, name)
    assert ours == theirs and ours


@pytest.mark.parametrize("cond", CONDITIONS)
def test_mapped_gaf_equal_and_native(chains, cond):
    theirs, ours = _pair(chains, f"{cond}.gaf")
    assert ours == theirs
    n_reads = sum(_pair(chains, f"sim_{cond}_{m}.fq")[1].count(b"\n") // 4 for m in (1, 2))
    assert ours.count(b"\n") == n_reads > 2000
    # reads with mismatches and spliced reads are in it, and the native core
    # made it: the first run built and saved the index, the second loaded it
    assert b"*" in ours.split(b"cs:Z:", 1)[1]
    log = chains["pantas_tpu_torch"][1][f"map_{cond}"]
    assert "[map] phases" in log and "python path" not in log
    assert ("[map] index cache hit" in log) == (cond == "c2")
    assert ("[map] native alignment core" in log) == (cond == "c1")
    assert " 0 spliced joins" not in log


@pytest.mark.parametrize("cond", CONDITIONS)
def test_device_augmented_gfa_equal(chains, cond):
    theirs, ours = _pair(chains, f"{cond}.aug.gfa")
    assert ours == theirs and b"RC:i:" in ours
    log = chains["pantas_tpu_torch"][1][f"augment_{cond}"]
    assert "[device] scatter impl: cpu-sorted-plain" in log and "fallback" not in log
    # the same bytes as the port's native engine gives on the mapped reads
    wd = chains["pantas_tpu_torch"][0]
    native = _run("pantas_tpu_torch", "augment", "--engine", "native", wd / f"{cond}.gaf",
                  wd / "graph" / "pantranscriptome-annotated.gfa").stdout
    assert native.encode() == ours


@pytest.mark.parametrize("cond", CONDITIONS)
def test_device_call_rows_equal(chains, cond):
    theirs, ours = (sorted(b.splitlines()) for b in _pair(chains, f"{cond}.events.csv"))
    # condition 1 is read from annotated isoforms only: it may call nothing
    assert ours == theirs and len(ours) > (1 if cond == "c2" else 0)
    wd = chains["pantas_tpu_torch"][0]
    host = _run("pantas_tpu_torch", "call", "--rca", "3", "--novel", "--minintronsize", "20",
                wd / f"{cond}.aug.gfa", wd / "g.gtf").stdout
    assert sorted(host.encode().splitlines()) == ours


@pytest.mark.parametrize("name", ["quant.csv", "remap.csv", "scores.txt"])
def test_quant_remap_and_scores_equal(chains, name):
    theirs, ours = _pair(chains, name)
    assert ours == theirs and ours.count(b"\n") > 1


def test_simulated_es_and_ir_events_recovered(chains):
    """The detectability contract of the JAX package's own simulation test:
    every injected ES and IR event is called, and none that is not there."""
    from pantas_tpu_torch.eval.compare import parse_quant_remap, parse_truth, score

    wd = chains["pantas_tpu_torch"][0]
    truth = parse_truth(str(wd / "sim_truth.csv"))
    results = score(truth, parse_quant_remap(str(wd / "remap.csv")), relax=5, min_dpsi=0.1)
    assert len(truth) == 4
    for etype in ("ES", "IR"):
        assert results[etype]["tp"] == sum(1 for t in truth if t.etype == etype) > 0
        assert results[etype]["precision"] == 1.0
