"""The port stands on its own: no subcommand it owns, and neither entry point
of ``graft_entry``, loads ``jax`` or any
module of ``pantas_tpu``, its sources import neither, and its CLI knows every
subcommand of ``pantas_tpu``'s."""

import json
import re
import socket
import subprocess
import sys

import pytest
from conftest import REPO_ROOT
from fixtures_call import write_call_fixtures
from fixtures_micro import write_micro
from fixtures_quant import write_quant_fixtures
from test_torch_cli import REPLICATE_GTF

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
    c1, c2, gtf = write_quant_fixtures(tmp_path)
    if case == "quant":
        return ["quant", "-a", *c1, *c2, "-o", out]
    quant = str(tmp_path / "quant.csv")
    from pantas_tpu_torch import cli

    assert cli.main(["quant", "-a", *c1, *c2, "-o", quant]) == 0
    return ["remap", quant, gtf, "-o", out]


@pytest.mark.parametrize("case", [
    "build",
    "augment:native", "augment:host", "augment:device", "augment:device-py",
    "augment:device --mesh 4", "augment:device --mesh 2x2",
    "call:host", "call:device",
    "quant", "remap",
    "augment-dist", "replicate", "reduce", "novel-sites",
])
def test_owned_subcommand_loads_nothing_foreign(tmp_path, case):
    argv = _argv(case, tmp_path)
    proc = subprocess.run([sys.executable, "-c", PROBE, json.dumps(argv)],
                          capture_output=True, text=True, cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stderr.strip().splitlines()[-1])
    assert report == {"rc": 0, "foreign": []}
    produced = tmp_path / "out"
    if "-o" not in argv:
        produced.write_text(proc.stdout)
    assert produced.exists() and (produced.is_dir() or produced.stat().st_size > 0)


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

    assert set(cli._COMMANDS) == set(tpu_cli._COMMANDS)
    assert set(cli._OWN) == {"build", "augment", "augment-dist", "call", "quant", "remap",
                             "replicate", "reduce", "novel-sites"}
    assert cli.main(["--help"]) == 0
    usage = capsys.readouterr().out
    for name in tpu_cli._COMMANDS:
        assert name in usage
    for name in set(cli._COMMANDS) - set(cli._OWN):
        assert cli.main([name, "x"]) == 2
        assert cli.NOT_PORTED in capsys.readouterr().err
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.startswith("pantas-tpu-torch, ")


def test_native_libraries_are_built_outside_the_jax_package():
    from pantas_tpu_torch.native import gafcov, gfaload

    lib = gafcov.build_library()
    assert lib.parent == REPO_ROOT / "build" / "native" and lib.exists()
    ext = gfaload.get_module()
    if ext is not None:  # the pure-Python loader stands in when the build fails
        assert str(REPO_ROOT / "build" / "native") in ext.__file__
