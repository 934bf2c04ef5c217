"""The port stands on its own: no subcommand it owns, no script of
``pantas_tpu_torch.scripts`` (nor anything under ``scripts/``), neither
entry point of ``graft_entry``, and not its bench loads ``jax`` or any
module of ``pantas_tpu``, its sources import neither, and its CLI owns every
subcommand of ``pantas_tpu``'s."""

import io
import json
import os
import re
import socket
import subprocess
import sys

import pytest
from conftest import REPO_ROOT
from fixtures_call import write_call_fixtures
from fixtures_micro import write_micro
from fixtures_quant import write_quant_fixtures
from test_torch_bench import write_example
from test_torch_cli import REPLICATE_GTF
from test_torch_scripts import NAMES as SCRIPT_NAMES
from test_torch_scripts import FULLSCALE_DEVICE, run_script, script_argv

FOREIGN_IMPORT = re.compile(r"^\s*(from|import)\s+(pantas_tpu(\.|\s|$)|jax(\.|\s|$))", re.M)

PROBE = """
import json, sys
from pantas_tpu_torch import cli
rc = cli.main(json.loads(sys.argv[1]))
foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("pantas_tpu", "jax"))
print(json.dumps({"rc": rc, "foreign": foreign}), file=sys.stderr)
"""


def _argv(case, tmp_path):
    """The owned subcommand's arguments on the micro fixtures."""
    out = str(tmp_path / "out")
    if case == "build":
        from pantas_tpu_torch.eval.synth import gen_inputs

        gen_inputs(tmp_path, mbp=0.05, n_var=500, n_genes=5, n_samples=4)
        return ["build", str(tmp_path / "g.fa"), str(tmp_path / "g.gtf"),
                str(tmp_path / "g.vcf"), "-o", out, "-t", "1"]
    if case.startswith("augment:"):
        gfa, gaf = write_micro(tmp_path)
        engine = case.split(":")[1].split()
        flags = ["--engine", engine[0], *engine[1:]]
        if engine[0].startswith("device"):
            flags += ["--device", "cpu"]
        return ["augment", *flags, gaf, gfa, "-o", out]
    if case.startswith("call"):
        gfa, gtf = write_call_fixtures(tmp_path)["splice"]
        flags = ["--engine", case.split(":")[1]]
        if flags[1] == "device":
            flags += ["--device", "cpu"]
        return ["call", *flags, "--rca", "0", "--novel", gfa, gtf, "-o", out]
    if case == "augment-dist":
        gfa, gaf = write_micro(tmp_path)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        return ["augment-dist", gaf, gfa, "-o", out, "--coordinator", f"127.0.0.1:{port}",
                "--nprocs", "1", "--procid", "0", "--device", "cpu"]
    if case == "replicate":  # rows on stdout
        gfa, gaf = write_micro(tmp_path)
        gtf = tmp_path / "t.gtf"
        gtf.write_text(REPLICATE_GTF)
        return ["replicate", "--rca", "0", gaf, gfa, str(gtf)]
    if case == "reduce":  # the reduced graph on stdout
        gfa = tmp_path / "plain.gfa"
        gfa.write_text("S\t1\tAC\nS\t2\tGT\nS\t3\tAA\nL\t1\t+\t2\t+\t0M\nL\t2\t+\t3\t+\t0M\n"
                       "P\tchrZ\t1+,2+,3+\t*\nP\tENST1\t1+,2+\t*\n")
        return ["reduce", str(gfa)]
    if case == "novel-sites":  # the site rows on stdout
        from test_novel_sites import _fixture

        gaf, gfa = _fixture(tmp_path)
        return ["novel-sites", str(gaf), str(gfa)]
    if case in HOST_TOOLS:
        return HOST_TOOLS[case](tmp_path, out)
    c1, c2, gtf = write_quant_fixtures(tmp_path)
    if case == "quant":
        return ["quant", "-a", *c1, *c2, "-o", out]
    quant = str(tmp_path / "quant.csv")
    from pantas_tpu_torch import cli

    assert cli.main(["quant", "-a", *c1, *c2, "-o", quant]) == 0
    return ["remap", quant, gtf, "-o", out]


def _mapper_inputs(tmp_path):
    """One path of eight nodes, and four reads along it (one with a gap)."""
    from test_mapper_indel import _mk_path

    rec = _mk_path()
    lines = [f"S\t{nid}\t{rec.seq[i * 25:(i + 1) * 25]}" for i, nid in enumerate(rec.nodes)]
    lines += [f"L\t{a}\t+\t{b}\t+\t*" for a, b in zip(rec.nodes, rec.nodes[1:])]
    lines.append("P\tT1_R1\t" + ",".join(n + "+" for n in rec.nodes) + "\t*")
    gfa, fq = tmp_path / "g.gfa", tmp_path / "r.fq"
    gfa.write_text("\n".join(lines) + "\n")
    reads = [rec.seq[5:155], rec.seq[10:80] + rec.seq[84:150], rec.seq[40:190], "ACGT" * 30]
    fq.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)))
    return str(gfa), str(fq)


def _synthetic_annotation(tmp_path):
    from pantas_tpu_torch.eval.synth import gen_inputs

    gen_inputs(tmp_path, mbp=0.05, n_var=50, n_genes=5, n_samples=2)
    return str(tmp_path / "g.fa"), str(tmp_path / "g.gtf")


def _prefilter_argv(tmp_path, out):
    from test_prefilter import _mk_inputs

    fa, p1, p2, _ = _mk_inputs(tmp_path, n_pairs=10)
    return ["prefilter", "-r", str(fa), "-1", str(p1), "-2", str(p2), "-o", out,
            "-p", str(tmp_path / "out2")]


def _filter_reads_argv(tmp_path, out):
    from test_exps_helpers import FQ1, FQ2

    (tmp_path / "a_1.fq").write_text(FQ1)
    (tmp_path / "a_2.fq").write_text(FQ2)
    return ["filter-reads", "--seed", "1", str(tmp_path / "a_1.fq"), str(tmp_path / "a_2.fq")]


def _gamp_argv(tmp_path, out):
    from test_gamp_differential import _write_inputs

    js, gfa = _write_inputs(tmp_path)
    return ["gamp", str(js), str(tmp_path / "walks"), str(gfa)]


def _gaf2sam_argv(tmp_path, out):
    from test_gaf2sam import _fixture

    gfa, _, gaf = _fixture(tmp_path)
    return ["gaf2sam", str(gaf), str(gfa)]


def _legacy_argv(name):
    def argv(tmp_path, out):
        from test_legacy_tools import _make_gfa

        gfa = str(_make_gfa(tmp_path))
        return ["prune", "-w", "2", gfa] if name == "prune" else ["reintroduce-paths", gfa, gfa]
    return argv


def _annotator_argv(name):
    def argv(tmp_path, out):
        import test_legacy_annotators as inputs

        make = inputs._mk_junction_inputs if name == "add-junctions" else inputs._mk_haplotype_inputs
        return [name, *map(str, make(tmp_path))]
    return argv


def _fix_vidx_argv(tmp_path, out):
    vcf = tmp_path / "v.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n##contig=<ID=chr4,length=100>\n"
                   "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                   "chr4\t10\t.\tA\tT\t.\t.\t.\n")
    return ["fix-vidx", str(vcf)]


def _clean_gtf_argv(tmp_path, out):
    from test_exps_helpers import GTF

    (tmp_path / "g.gtf").write_text(GTF)
    return ["clean-gtf", str(tmp_path / "g.gtf")]


def _support_argv(name):
    def argv(tmp_path, out):
        from test_support import _gtf

        events, sam = tmp_path / "ev.txt", tmp_path / "a.sam"
        events.write_text("c:300-400\n")
        sam.write_text("@HD\tVN:1.5\nr1\t0\tc\t150\t60\t51M99N50M\t*\t0\t0\t*\t*\n")
        tail = [str(sam)] if name == "check-coverage" else []
        return [name, str(events), str(_gtf(tmp_path)), *tail]
    return argv


def _scoring_argv(name):
    def argv(tmp_path, out):
        from test_cmp_tools import _fixture

        truth, pantas, rmats, whippet, suppa = map(str, _fixture(tmp_path))
        if name == "eval":  # the simulator's truth table, not the comparator's
            (tmp_path / "sim_truth.csv").write_text(
                "etype,gene,transcript,chrom,strand,region1,region2,region3\n"
                "ES,G1,T1,c,+,c:100-200,c:300-400,c:100-400\n")
            return ["eval", str(tmp_path / "sim_truth.csv"), pantas]
        return ["cmp", "-t", truth, "-p", pantas, "-r", rmats, "-w", whippet, "-s", suppa]
    return argv


def _convert_rmats_argv(tmp_path, out):
    from test_converters import _rmats_dir

    return ["convert-rmats", str(_rmats_dir(tmp_path)), "-o", out]


def _convert_suppa_argv(tmp_path, out):
    dpsi = tmp_path / "cmp.dpsi"
    dpsi.write_text("name\tdPSI\tpval\ng1;SE:2L:100-200:300-400:+\t0.5\t0.01\n")
    return ["convert-suppa", str(dpsi), "-o", out]


def _bench_table_argv(tmp_path, out):
    from test_bench_tools import SAMPLE

    (tmp_path / "bench").mkdir()
    (tmp_path / "bench" / "rmats.time").write_text(SAMPLE)
    return ["bench-table", str(tmp_path / "bench")]


def _exp_argv(tmp_path, out):
    """A two-condition experiment on the 0.05 Mbp graph, its figure included."""
    from pantas_tpu_torch.build.pipeline import build_pangenome
    from pantas_tpu_torch.eval.simulate import simulate

    fa, gtf = _synthetic_annotation(tmp_path)
    build_pangenome(fa, gtf, str(tmp_path / "g.vcf"), out, threads=1, log=io.StringIO())
    simulate(fa, gtf, str(tmp_path / "sim"), n_events=2, reads_per_isoform=10,
             etypes=("ES", "IR"), log=io.StringIO())
    config = tmp_path / "exp.json"
    config.write_text(json.dumps({
        "gtf": gtf, "workdir": out, "threads": 1,
        "conditions": {c: [[str(tmp_path / f"sim_{c}_1.fq"), str(tmp_path / f"sim_{c}_2.fq")]]
                       for c in ("c1", "c2")},
        "eval": {"truth": str(tmp_path / "sim_truth.csv"), "cuts": [1], "figures": True}}))
    return ["exp", str(config)]


def _rtpcr_argv(tmp_path, out):
    from test_rtpcr import PANTAS, RMATS, SUPPA, TRUTH, WHIPPET

    paths = []
    for name, text in (("truth.tsv", TRUTH), ("pantas.csv", PANTAS), ("rmats.txt", RMATS),
                       ("whippet.diff", WHIPPET), ("suppa.dpsi", SUPPA)):
        paths.append(str(tmp_path / name))
        (tmp_path / name).write_text(text)
    return ["compare-rtpcr", *paths]


def _parse_res_argv(tmp_path, out):
    from test_aggregate import _write_fixtures

    p3, p5, rmats, suppa, whippet = map(str, _write_fixtures(tmp_path))
    return ["parse-res", "-o", out, "--pantas", f"3={p3}", f"5={p5}", "--rmats", rmats,
            "--suppa", suppa, "--whippet", whippet, "--min-dpsi", "0.05", "--figures"]


def _compare_csv(tmp_path):
    from test_plots import _write_compare_csv

    _write_compare_csv(tmp_path / "cmp.csv")
    return str(tmp_path / "cmp.csv")


# the host tools: arguments of each on the inputs its own tests build
HOST_TOOLS = {
    "map": lambda tmp_path, out: ["map", *_mapper_inputs(tmp_path), "-o", out],
    "map-accuracy": lambda tmp_path, out: ["map-accuracy", _mapper_inputs(tmp_path)[0],
                                           "-n", "20", "-l", "60", "-d", "0,0.02"],
    "prefilter": _prefilter_argv,
    "filter-reads": _filter_reads_argv,
    "gamp": _gamp_argv,
    "gaf2sam": _gaf2sam_argv,
    "prune": _legacy_argv("prune"),
    "reintroduce-paths": _legacy_argv("reintroduce-paths"),
    "add-junctions": _annotator_argv("add-junctions"),
    "add-haplotypes": _annotator_argv("add-haplotypes"),
    "fix-vidx": _fix_vidx_argv,
    "clean-gtf": _clean_gtf_argv,
    "introns": lambda tmp_path, out: ["introns", "-g", _synthetic_annotation(tmp_path)[1],
                                      "-o", out],
    "check-coverage": _support_argv("check-coverage"),
    "check-novel": _support_argv("check-novel"),
    "sim": lambda tmp_path, out: ["sim", *_synthetic_annotation(tmp_path), "-o", out,
                                  "-n", "2", "-r", "10"],
    "eval": _scoring_argv("eval"),
    "cmp": _scoring_argv("cmp"),
    "convert-rmats": _convert_rmats_argv,
    "convert-suppa": _convert_suppa_argv,
    "timev": lambda tmp_path, out: ["timev", "-o", out, "--", sys.executable, "-c", "pass"],
    "bench-table": _bench_table_argv,
    "exp": _exp_argv,
    "compare-rtpcr": _rtpcr_argv,
    "parse-res": _parse_res_argv,
    "plot-pr": lambda tmp_path, out: ["plot-pr", _compare_csv(tmp_path), "-o", f"{out}.png"],
    "latex-table": lambda tmp_path, out: ["latex-table", _compare_csv(tmp_path)],
}
# what a tool writes when it is neither ``-o out`` nor stdout
PRODUCED = {"filter-reads": "a_1.clean.fq", "sim": "out_truth.csv",
            "exp": "out/scores_pr.png", "plot-pr": "out.png"}


@pytest.mark.parametrize("case", [
    "build",
    "augment:native", "augment:host", "augment:device", "augment:device-py",
    "augment:device --mesh 4", "augment:device --mesh 2x2",
    "call:host", "call:device",
    "quant", "remap",
    "augment-dist", "replicate", "reduce", "novel-sites",
    *HOST_TOOLS,
])
def test_owned_subcommand_loads_nothing_foreign(tmp_path, case):
    argv = _argv(case, tmp_path)
    proc = subprocess.run([sys.executable, "-c", PROBE, json.dumps(argv)],
                          capture_output=True, text=True, cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stderr.strip().splitlines()[-1])
    assert report == {"rc": 0, "foreign": []}
    produced = tmp_path / PRODUCED.get(case, "out")
    if "-o" not in argv and case not in PRODUCED:
        produced.write_text(proc.stdout)
    assert produced.exists() and (produced.is_dir() or produced.stat().st_size > 0)


@pytest.mark.parametrize("case", ["augment:native", "augment:device-py", "augment-dist", "map"])
def test_compressed_output_loads_nothing_foreign(tmp_path, case):
    """A ``-o *.zst`` output goes through ``open_stage_output``'s pipe and
    drain thread and the libzstd binding, which load no module of
    ``pantas_tpu`` and no ``jax``."""
    argv = _argv(case, tmp_path)
    argv[argv.index("-o") + 1] += ".zst"
    proc = subprocess.run([sys.executable, "-c", PROBE, json.dumps(argv)],
                          capture_output=True, text=True, cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stderr.strip().splitlines()[-1]) == {"rc": 0, "foreign": []}
    assert (tmp_path / "out.zst").read_bytes()[:4] == b"\x28\xb5\x2f\xfd"


@pytest.mark.parametrize("name", SCRIPT_NAMES)
def test_script_loads_nothing_foreign(tmp_path, name):
    """``python -m pantas_tpu_torch.scripts.<name>`` at its tiny size on the
    CPU loads no module of ``pantas_tpu``, no ``jax`` and nothing under
    ``scripts/``."""
    argv, cache = script_argv(name, tmp_path)
    env = {"CALL_SCALE_PLATFORM": "cpu"} if name == "bench_call_scale" else None
    _, report = run_script("pantas_tpu_torch", name, argv, tmp_path, cache=cache, env=env)
    assert report == {"foreign": [], "scripts": []}


def test_fullscale_device_engines_load_nothing_foreign(tmp_path):
    """The full-scale experiment's staged layout on the device engines (on the
    CPU) loads no module of ``pantas_tpu``, no ``jax`` and nothing under
    ``scripts/``."""
    argv, cache = script_argv("run_fullscale_experiment", tmp_path)
    _, report = run_script("pantas_tpu_torch", "run_fullscale_experiment",
                           argv + FULLSCALE_DEVICE, tmp_path, cache=cache)
    assert report == {"foreign": [], "scripts": []}


BENCH_PROBE = """
import json, sys
from pathlib import Path
from pantas_tpu_torch import bench
bench.CACHE = Path(sys.argv[1])
rc = bench.main(["--device", "cpu", "--multiplier", "2"])
print(json.dumps({"rc": rc, "foreign": sorted(m for m in sys.modules
                                              if m.split(".")[0] in ("pantas_tpu", "jax"))}),
      file=sys.stderr)
"""


def test_bench_loads_nothing_foreign(tmp_path):
    """``python -m pantas_tpu_torch.bench --device cpu --multiplier 2`` (its
    ``main``, with its cache in ``tmp_path``) on a tiny example/4 loads no
    module of ``pantas_tpu`` and no ``jax``."""
    ref = write_example(tmp_path / "reference")
    proc = subprocess.run([sys.executable, "-c", BENCH_PROBE, str(tmp_path / "cache")],
                          capture_output=True, text=True, cwd=REPO_ROOT, timeout=300,
                          env={**os.environ, "PANTAS_REFERENCE": str(ref),
                               "PYTHONPATH": str(REPO_ROOT)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stderr.strip().splitlines()[-1]) == {"rc": 0, "foreign": []}
    assert list(json.loads(proc.stdout.strip().splitlines()[-1])) == \
        ["metric", "value", "unit", "vs_baseline"]


@pytest.mark.parametrize("call", ["entry('cpu')[0](*graft_entry.entry('cpu')[1])",
                                  "dryrun_multichip(2, 'cpu')"], ids=["entry", "dryrun"])
def test_graft_entry_loads_nothing_foreign(call):
    code = ("import json, sys\nfrom pantas_tpu_torch import graft_entry\n"
            f"graft_entry.{call}\n"
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('pantas_tpu', 'jax'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_port_sources_import_nothing_foreign():
    sources = [REPO_ROOT / "chip_smoke.py", *sorted((REPO_ROOT / "pantas_tpu_torch").rglob("*.py"))]
    assert len(sources) > 30
    hits = [f"{p.relative_to(REPO_ROOT)}: {m.group(0).strip()}"
            for p in sources for m in FOREIGN_IMPORT.finditer(p.read_text())]
    assert hits == []
    # and no script outside the package is imported by the smoke
    assert "scripts" not in re.findall(r"REPO / \"(\w+)\"", (REPO_ROOT / "chip_smoke.py").read_text())


def test_port_cli_knows_every_pantas_tpu_subcommand(capsys):
    from pantas_tpu import cli as tpu_cli
    from pantas_tpu_torch import cli

    assert set(cli._OWN) == set(tpu_cli._COMMANDS) and len(cli._OWN) == 36
    assert not hasattr(cli, "_NOT_PORTED") and not hasattr(cli, "_refuse")
    assert cli.main(["--help"]) == 0
    usage = capsys.readouterr().out
    for name in tpu_cli._COMMANDS:
        assert re.search(rf"^    {re.escape(name)} ", usage, re.M), name
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.startswith("pantas-tpu-torch, ")


def test_native_libraries_are_built_outside_the_jax_package():
    from pantas_tpu_torch.native import gafcov, gfaload

    lib = gafcov.build_library()
    assert lib.parent == REPO_ROOT / "build" / "native" and lib.exists()
    ext = gfaload.get_module()
    if ext is not None:  # the pure-Python loader stands in when the build fails
        assert str(REPO_ROOT / "build" / "native") in ext.__file__
