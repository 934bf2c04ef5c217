"""The port's CLI: augment on the port's engines, subcommands not yet ported
refused, the native-feed fallback narrowed, and no jax loaded on its main
path. That it knows every subcommand of pantas_tpu and loads nothing of it
is checked in test_torch_isolation.py."""

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


@pytest.mark.parametrize(
    "argv",
    [
        ["map", "x.gfa", "x.fq"],
        ["augment-dist", "x.gaf", "x.gfa", "-o", "o", "--coordinator", "h:1",
         "--nprocs", "2", "--procid", "0"],
    ],
    ids=["map", "augment-dist"],
)
def test_unported_device_paths_refuse(argv, capsys):
    assert cli.main(argv) == 2
    assert "ROADMAP.md" in capsys.readouterr().err


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
