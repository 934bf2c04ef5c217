"""``exp``, the two-condition experiment, through ``python -m pantas_tpu``
and ``python -m pantas_tpu_torch`` on the same config: build (or a pre-placed
pangenome) -> map -> fused native coverage + call per replicate -> novel sites
and their quantification -> quant -> remap -> eval with a cut sweep and its
P/R figure. Every process runs under ``PYTHONHASHSEED=0`` and
``MPLBACKEND=Agg``. Tolerance: exact, bytes for every artifact.

The graph is the 0.05 Mbp synthetic one (5 genes, 500 SNPs, samples s0..s3);
the reads are about 800 simulated pairs a condition with 1% substitutions,
made once by the port's ``sim``."""

import json
import os
import subprocess
import sys

import pytest
from conftest import REPO_ROOT, run_cli

PACKAGES = ("pantas_tpu", "pantas_tpu_torch")
ENV = {"JAX_PLATFORMS": "cpu", "MPLBACKEND": "Agg"}
TAGS = ("c1_r1", "c2_r1")


def _exp_both(configs):
    """``exp`` of each package on its config, the two processes side by side.
    Returns each package's log."""
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), PYTHONHASHSEED="0", **ENV)
    procs = {pkg: subprocess.Popen([sys.executable, "-m", pkg, "exp", str(config)], env=env,
                                   stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
             for pkg, config in configs.items()}
    logs = {}
    for pkg, proc in procs.items():
        logs[pkg] = proc.communicate(timeout=300)[1]
        assert proc.returncode == 0, logs[pkg][-2000:]
    return logs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The synthetic FA, GTF and VCF, the port's pangenome built from them,
    and ``sim`` reads of four ES and IR events."""
    from pantas_tpu_torch.eval.synth import gen_inputs

    wd = tmp_path_factory.mktemp("inputs")
    gen_inputs(wd, mbp=0.05, n_var=500, n_genes=5, n_samples=4)
    run_cli([sys.executable, "-m", "pantas_tpu_torch", "build", str(wd / "g.fa"),
             str(wd / "g.gtf"), str(wd / "g.vcf"), "-o", str(wd / "graph"), "-t", "1"])
    run_cli([sys.executable, "-m", "pantas_tpu_torch", "sim", str(wd / "g.fa"), str(wd / "g.gtf"),
             "-o", str(wd / "sim"), "-n", "4", "-r", "60", "-e", "0.01", "--seed", "11",
             "--etypes", "ES", "IR"])
    return wd


def _config(inputs, workdir, **extra):
    """The config of ``workdir``, written beside it; a key given as None is
    left out."""
    cfg = {
        "fa": str(inputs / "g.fa"), "gtf": str(inputs / "g.gtf"), "vcf": str(inputs / "g.vcf"),
        "workdir": str(workdir),
        "conditions": {c: [[str(inputs / f"sim_{c}_1.fq"), str(inputs / f"sim_{c}_2.fq")]]
                       for c in ("c1", "c2")},
        "call": {"w": 3, "novel": True, "minintronsize": 20},
        "remap": {"min_intron_size": 20},
        "novel_sites": {"quant": True},
        "eval": {"truth": str(inputs / "sim_truth.csv"), "min_dpsi": 0.1, "relax": 5,
                 "cuts": [1, 3, 5], "figures": True},
        "threads": 2,
        **extra,
    }
    path = workdir.parent / f"{workdir.name}.json"
    path.write_text(json.dumps({k: v for k, v in cfg.items() if v is not None}))
    return path


@pytest.fixture(scope="module")
def placed(inputs, tmp_path_factory):
    """``exp`` of both packages, each in a workdir of its own holding the
    port's pangenome, so the build is skipped. Returns ``{package: (workdir,
    config, log)}``."""
    configs = {}
    for pkg in PACKAGES:
        wd = tmp_path_factory.mktemp(f"exp_{pkg}") / "wd"
        wd.mkdir()
        (wd / "pantranscriptome-annotated.gfa").write_bytes(
            (inputs / "graph" / "pantranscriptome-annotated.gfa").read_bytes())
        configs[pkg] = _config(inputs, wd)
    logs = _exp_both(configs)
    return {pkg: (configs[pkg].with_suffix(""), configs[pkg], logs[pkg]) for pkg in PACKAGES}


ARTIFACTS = [*(f"{t}.{kind}" for t in TAGS for kind in ("gaf", "events.csv", "sites.csv")),
             "sites_quant.csv", "quant.csv", "quant-remap.csv", "scores.csv",
             "scores_by_cut.csv", "scores_cmp.csv", "scores_pr.png"]


@pytest.mark.parametrize("name", ARTIFACTS)
def test_exp_artifact_equal(placed, name):
    theirs, ours = ((placed[pkg][0] / name).read_bytes() for pkg in PACKAGES)
    assert ours == theirs and ours
    if name.endswith(".png"):
        assert len(ours) > 10_000


def test_exp_log_shows_the_native_engines_and_the_recovered_events(placed):
    """Both fallbacks of ``exp`` are silent but for the log; the log of the
    port names the native alignment core for each replicate, and the scores
    recover every simulated event."""
    wd, _, log = placed["pantas_tpu_torch"]
    assert "build: reusing existing pangenome" in log
    assert log.count("[map] native alignment core") == 2 and "python path" not in log
    assert "native coverage unavailable" not in log and "figure render skipped" not in log
    assert all(f"[exp] {t}: map+call" in log for t in TAGS)
    # condition 1 is read from annotated isoforms only: it may call nothing
    assert (wd / "c2_r1.events.csv").read_text().count("\n") > 1
    scores = {row.split(",")[0]: row.split(",") for row in
              (wd / "scores.csv").read_text().splitlines()[1:]}
    for etype in ("ES", "IR"):
        assert int(scores[etype][1]) > 0 and scores[etype][3] == "0"  # tp > 0, fn == 0


def test_exp_rerun_reuses_every_stage(placed):
    """A second run reuses the pangenome and each replicate's events, maps
    and calls nothing, and rewrites the tables with the same bytes. It
    renders no figure: the first run's stays."""
    before = {pkg: {n: (placed[pkg][0] / n).read_bytes() for n in ARTIFACTS} for pkg in PACKAGES}
    configs = {}
    for pkg in PACKAGES:
        _, config, _ = placed[pkg]
        cfg = json.loads(config.read_text())
        del cfg["eval"]["figures"]
        configs[pkg] = config.with_name("rerun.json")
        configs[pkg].write_text(json.dumps(cfg))
    for pkg, log in _exp_both(configs).items():
        assert "build: reusing existing pangenome" in log and "map+call" not in log
        assert all(f"[exp] {t}: reusing" in log for t in TAGS)
        assert {n: (placed[pkg][0] / n).read_bytes() for n in ARTIFACTS} == before[pkg]


@pytest.mark.parametrize("held_out", [None, "s0"], ids=["all-samples", "exclude-s0"])
def test_exp_builds_the_same_pangenome(inputs, tmp_path, held_out):
    """With no pangenome in the workdir ``exp`` builds it; with
    ``build.exclude_sample`` from a VCF without that sample's haplotypes.
    Built GFA (and the filtered VCF) byte-equal through both CLIs. The
    replicates are the first 40 read pairs of each condition, and neither
    novel sites nor the scores are asked for: the build is what is held."""
    reads = tmp_path / "reads"
    reads.mkdir()
    conditions = {}
    for c in ("c1", "c2"):
        for mate in (1, 2):
            lines = (inputs / f"sim_{c}_{mate}.fq").read_text().splitlines(keepends=True)
            (reads / f"{c}_{mate}.fq").write_text("".join(lines[:160]))
        conditions[c] = [[str(reads / f"{c}_1.fq"), str(reads / f"{c}_2.fq")]]
    extra = {"build": {"exclude_sample": held_out}} if held_out else {}
    configs = {}
    for pkg in PACKAGES:
        (tmp_path / pkg).mkdir()
        configs[pkg] = _config(inputs, tmp_path / pkg / "wd", conditions=conditions,
                               novel_sites=None, eval=None, **extra)
    names = ["pantranscriptome-annotated.gfa"] + (["variants.heldout.vcf"] if held_out else [])
    built = {}
    for pkg, log in _exp_both(configs).items():
        assert "build: reusing" not in log and "[exp] build: " in log
        assert (f"build: held out sample {held_out}" in log) == bool(held_out)
        built[pkg] = [(tmp_path / pkg / "wd" / n).read_bytes() for n in names]
    assert built["pantas_tpu_torch"] == built["pantas_tpu"]
    gfa = built["pantas_tpu_torch"][0]
    plain = (inputs / "graph" / "pantranscriptome-annotated.gfa").read_bytes()
    assert (gfa == plain) == (held_out is None)
    if held_out:
        assert b"\ts0" not in built["pantas_tpu_torch"][1].split(b"#CHROM", 1)[1].split(b"\n")[0]


def test_exp_needs_exactly_two_conditions(inputs, tmp_path):
    """Both packages refuse a config of one condition before any work."""
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), **ENV)
    for pkg in PACKAGES:
        wd = tmp_path / pkg
        config = _config(inputs, wd)
        cfg = json.loads(config.read_text())
        cfg["conditions"].pop("c2")
        config.write_text(json.dumps(cfg))
        proc = subprocess.run([sys.executable, "-m", pkg, "exp", str(config)],
                              capture_output=True, text=True, env=env)
        assert proc.returncode != 0
        assert "ValueError: exactly two conditions required, got 1" in proc.stderr
        assert not wd.exists()

