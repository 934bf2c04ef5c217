"""The measurement path fails, rather than falling back to the CPU, where the
card or the program is missing; on a card a tiny cell runs whole."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import REPO, make_root

CMD = ["-m", "pbench.run", "--workload", "augment-dmreal10-skew", "--seed", "1",
       "--seconds", "1", "--trace", "0"]


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, *CMD], cwd=REPO, env=_env(), capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(REPO / "pbench", tmp_path / "pbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    script = ("import sys\nfrom pbench import run\nrun.require_cards = lambda n: 'cpu'\n"
              "sys.exit(run.main(sys.argv[1:]))\n")
    p = subprocess.run([sys.executable, "-c", script, *CMD[2:]], cwd=tmp_path, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "No module named 'pantas_tpu_torch'" in p.stderr


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tmp_path, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from pbench import run

    root = make_root(tmp_path, pairs=2000)
    rc = run.main(CMD[2:], root=root, t_start=0.0)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"] and out["device"]["platform"] == "gpu"
