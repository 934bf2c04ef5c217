"""The port's CLI: augment on the port's engines, an unknown subcommand
answered with the usage, the native-feed fallback narrowed, no jax loaded on
its main path, and ``replicate``, ``reduce`` and ``novel-sites`` through both
CLIs. That it owns every subcommand of pantas_tpu and loads nothing of it is
checked in test_torch_isolation.py; ``augment-dist`` in
test_torch_distributed.py; ``exp`` in test_torch_experiment.py; the
comparison and figure tools in test_torch_eval_tools.py."""

import io
import subprocess
import sys

import pytest
import torch
from conftest import REPO_ROOT, run_cli
from fixtures_micro import write_micro

from pantas_tpu_torch import backend, cli
from pantas_tpu_torch.coverage import scatter_impls


@pytest.mark.parametrize("engine", ["device", "device-py"])
def test_device_augment_cli_matches_host_engine(tmp_path, engine):
    gfa, gaf = write_micro(tmp_path)
    host, ported = tmp_path / "host.gfa", tmp_path / "port.gfa"
    run_cli([sys.executable, "-m", "pantas_tpu", "augment", "--engine", "host",
             str(gaf), str(gfa), "-o", str(host)])
    proc = run_cli([sys.executable, "-m", "pantas_tpu_torch", "augment", "--engine", engine,
                    "--device", "cpu", str(gaf), str(gfa), "-o", str(ported)])
    assert ported.read_bytes() == host.read_bytes()
    assert "[device] scatter impl: cpu-sorted-plain" in proc.stderr
    assert "fallback" not in proc.stderr


def test_unknown_subcommand_prints_the_usage_and_exits_1(capsys):
    assert cli.main(["no-such-subcommand", "x"]) == 1
    captured = capsys.readouterr()
    assert captured.err.startswith("pantas-tpu-torch [build|augment|") and not captured.out
    assert "  evaluation harness:\n    exp " in captured.err


def test_cuda_device_is_never_replaced_by_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        backend.device("cuda")
    assert backend.device("cpu") == torch.device("cpu")


def test_native_feed_unavailable_falls_back(tmp_path, capsys):
    """A graph the native engine cannot key (non-canonical ids) takes the
    Python tokenizer, with the same bytes as the host engine."""
    gfa = tmp_path / "g.gfa"
    gfa.write_text("H\tVN:Z:1.1\nS\t007\tACGT\nS\t8\tACGT\nL\t007\t+\t8\t+\t*\n")
    gaf = tmp_path / "g.gaf"
    gaf.write_text("r\t8\t0\t8\t+\t>007>8\t8\t0\t8\t8\t8\t60\tcs:Z::8\tdv:f:0.0\n")
    out = tmp_path / "o.gfa"
    assert cli.main(["augment", "--engine", "device", "--device", "cpu",
                     str(gaf), str(gfa), "-o", str(out)]) == 0
    assert "python tokenizer fallback" in capsys.readouterr().err
    host = io.StringIO()
    from pantas_tpu.coverage import augment_gfa

    augment_gfa(str(gaf), str(gfa), out=host, log=io.StringIO())
    assert out.read_text() == host.getvalue()


def test_device_errors_do_not_fall_back(tmp_path, monkeypatch):
    def broken(counts, idx):
        raise RuntimeError("kernel failed")

    monkeypatch.setitem(scatter_impls.SCATTER_IMPLS, "cuda-sorted", broken)
    gfa, gaf = write_micro(tmp_path)
    with pytest.raises(RuntimeError, match="kernel failed"):
        cli.main(["augment", "--engine", "device", "--device", "cpu",
                  str(gaf), str(gfa), "-o", str(tmp_path / "o.gfa")])


def test_port_device_augment_loads_no_jax(tmp_path):
    gfa, gaf = write_micro(tmp_path)
    code = (
        "import sys\n"
        "from pantas_tpu_torch import cli\n"
        f"rc = cli.main(['augment', '--engine', 'device', '--device', 'cpu', "
        f"{str(gaf)!r}, {str(gfa)!r}, '-o', {str(tmp_path / 'o.gfa')!r}])\n"
        "assert rc == 0\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO_ROOT, check=True)
    assert proc.stdout.strip() == "[]", proc.stdout


def _both_clis(args, **kw):
    """stdout of ``args`` through the JAX package's CLI and the port's."""
    return [run_cli([sys.executable, "-m", pkg, *args], **kw)
            for pkg in ("pantas_tpu", "pantas_tpu_torch")]


REPLICATE_GTF = (
    'c\tx\ttranscript\t1\t30\t.\t+\t.\tgene_id "G1"; transcript_id "T1";\n'
    'c\tx\texon\t1\t10\t.\t+\t.\tgene_id "G1"; transcript_id "T1";\n'
    'c\tx\texon\t21\t30\t.\t+\t.\tgene_id "G1"; transcript_id "T1";\n'
    'c\tx\ttranscript\t1\t30\t.\t+\t.\tgene_id "G1"; transcript_id "T2";\n'
    'c\tx\texon\t1\t12\t.\t+\t.\tgene_id "G1"; transcript_id "T2";\n'
    'c\tx\texon\t21\t30\t.\t+\t.\tgene_id "G1"; transcript_id "T2";\n'
)


def test_replicate_matches_the_jax_cli_and_staged(tmp_path):
    """``replicate`` (the from_engine path) through both CLIs under one hash
    seed: sorted rows equal to each other and to the port's staged
    ``augment`` then ``call``."""
    gfa, gaf = write_micro(tmp_path)
    gtf = tmp_path / "t.gtf"
    gtf.write_text(REPLICATE_GTF)
    theirs, ours = _both_clis(["replicate", "--rca", "0", gaf, gfa, str(gtf)], hashseed="0")
    assert "fallback" not in ours.stderr and "Rejected alignments: 1" in ours.stderr
    rows = sorted(ours.stdout.splitlines())
    assert rows == sorted(theirs.stdout.splitlines()) and len(rows) > 1
    aug = tmp_path / "aug.gfa"
    run_cli([sys.executable, "-m", "pantas_tpu_torch", "augment", gaf, gfa, "-o", str(aug)])
    staged = run_cli([sys.executable, "-m", "pantas_tpu_torch", "call", "--rca", "0",
                      str(aug), str(gtf)], hashseed="0")
    assert rows == sorted(staged.stdout.splitlines())


def test_replicate_host_fallback_on_noncanonical_ids(tmp_path):
    """A graph the native engine cannot key takes the host accumulator, and
    says so; the rows equal the JAX CLI's."""
    gfa = tmp_path / "g.gfa"
    gfa.write_text("H\tVN:Z:1.1\nS\t007\tACGT\nS\t8\tACGT\nL\t007\t+\t8\t+\t*\n")
    gaf = tmp_path / "g.gaf"
    gaf.write_text("r\t8\t0\t8\t+\t>007>8\t8\t0\t8\t8\t8\t60\tcs:Z::8\tdv:f:0.0\n")
    gtf = tmp_path / "t.gtf"
    gtf.write_text(REPLICATE_GTF)
    theirs, ours = _both_clis(["replicate", "--rca", "0", str(gaf), str(gfa), str(gtf)],
                              hashseed="0")
    assert "[replicate] native engine unavailable (" in ours.stderr
    assert "host fallback" in ours.stderr and "Rejected alignments: 0" in ours.stderr
    assert sorted(ours.stdout.splitlines()) == sorted(theirs.stdout.splitlines())
    assert ours.stdout.startswith("event_type,")


def test_replicate_engine_errors_do_not_fall_back(tmp_path, monkeypatch):
    """Only "the engine is unavailable" leads to the host accumulator: an
    error while it parses propagates."""
    from pantas_tpu_torch.native import NativeCoverage

    def broken(self, *a, **kw):
        raise RuntimeError("parse failed")

    monkeypatch.setattr(NativeCoverage, "process_file", broken)
    gfa, gaf = write_micro(tmp_path)
    gtf = tmp_path / "t.gtf"
    gtf.write_text(REPLICATE_GTF)
    with pytest.raises(RuntimeError, match="parse failed"):
        cli.main(["replicate", "--rca", "0", gaf, gfa, str(gtf)])


@pytest.fixture(scope="module")
def plain_graph(tmp_path_factory):
    """The 0.05 Mbp synthetic graph without its annotation tags (``reduce``
    reads three-column S lines), its transcript paths named ``T…``."""
    from pantas_tpu_torch.eval import synth

    cache = tmp_path_factory.mktemp("port_cache")
    saved, synth.CACHE = synth.CACHE, cache
    try:
        wd = synth.ensure_graph(0.05)
    finally:
        synth.CACHE = saved
    plain = cache / "plain.gfa"
    with open(wd / "out" / "pantranscriptome-annotated.gfa") as src, open(plain, "w") as dst:
        for line in src:
            width = {"S": 3, "L": 6, "P": 4}.get(line[0])
            if width:
                dst.write("\t".join(line.rstrip("\n").split("\t")[:width]) + "\n")
    return plain


@pytest.mark.parametrize("flags", [[], ["-k", "1", "-t", "T"]], ids=["default", "k1-prefix"])
def test_reduce_identical_through_both_clis(plain_graph, tmp_path, flags):
    gfa = plain_graph
    if not flags:  # the default prefix: rename the transcript paths to ENST…
        gfa = tmp_path / "enst.gfa"
        gfa.write_text(plain_graph.read_text().replace("P\tT", "P\tENST"))
    theirs, ours = _both_clis(["reduce", *flags, str(gfa)])
    assert ours.stdout == theirs.stdout
    kept = ours.stdout.splitlines()
    assert 100 < len(kept) < len(gfa.read_text().splitlines())
    assert any(ln.startswith("P\tchr0.") for ln in kept)
    assert ("experimental" in ours.stderr) == bool(flags)


@pytest.mark.parametrize("mode", ["plain", "events", "quant"])
def test_novel_sites_identical_through_both_clis(tmp_path, mode):
    from test_novel_sites import CE_GFA, CE_GTF, GTF, _fixture, _gaf

    gaf, gfa = _fixture(tmp_path)
    gtf = tmp_path / "a.gtf"
    gtf.write_text(GTF)
    if mode == "plain":
        args, header, rows = [str(gaf), str(gfa)], "chrom,pos,side,", 3
    elif mode == "events":
        args, header, rows = [str(gaf), str(gfa), "--events", str(gtf)], "event_type,", 3
    else:  # the cassette-exon pairing: long clips at both ends of one intron
        gfa, gtf = tmp_path / "ce.gfa", tmp_path / "ce.gtf"
        gfa.write_text(CE_GFA)
        gtf.write_text(CE_GTF)
        skip = [_gaf(f"k{i}", 40, 0, 40, ">1>3", 40, 0, 39) for i in range(5)]
        c1, c2 = tmp_path / "c1.gaf", tmp_path / "c2.gaf"
        c1.write_text("\n".join(
            [_gaf(f"d{i}", 100, 0, 60, ">1", 20, 0, 19) for i in range(3)]
            + [_gaf(f"a{i}", 100, 40, 100, ">3", 20, 0, 19) for i in range(3)] + skip) + "\n")
        c2.write_text("\n".join(skip) + "\n")
        args = ["--quant", "--c1", str(c1), "--c2", str(c2), "--gfa", str(gfa),
                "--events", str(gtf)]
        header, rows = "etype,", 1
    theirs, ours = _both_clis(["novel-sites", *args])
    assert ours.stdout == theirs.stdout
    lines = ours.stdout.splitlines()
    assert lines[0].startswith(header) and len(lines) == 1 + rows
