"""Fixtures of the benchmark's CPU tests: copies of the benchmark in a
temporary checkout whose configurations are cut to a 0.05 Mbp graph, so a
whole run takes seconds here. The program runs on the CPU in them, named
explicitly: the harness's look for a card is the one step they skip."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# bound here, while pytest's own stderr stands: the build code's functions take
# ``sys.stderr`` as a default argument, and a test's captured stream closes
import pbench.reference.build.pipeline  # noqa: E402,F401

TINY_MBP = 0.05


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where torch.cuda.is_available() is false")


def make_root(dest: Path, pairs: int) -> Path:
    """A checkout holding ``BENCHMARK.json`` and ``pbench/`` with every
    configuration cut to ``TINY_MBP`` and ``pairs``."""
    shutil.copytree(REPO / "pbench", dest / "pbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for path in (dest / "pbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["graph"]["mbp"] = TINY_MBP
        cfg["reads"]["pairs"] = pairs
        path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"), pairs=2000)


@pytest.fixture(scope="session")
def deep_root(tmp_path_factory):
    """Deep enough that the busiest slots pass 2,048 reads (the control's stop)."""
    return make_root(tmp_path_factory.mktemp("deep"), pairs=40000)


def run_cell(root: Path, workload: str, capsys, seed: int = 5, trace: int = 0, seconds: float = 0.3):
    """One run on the CPU; returns (exit code, the result line or None)."""
    from pbench import run

    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], root=root, device="cpu", t_start=0.0)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)
