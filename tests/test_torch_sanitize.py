"""``pantas_tpu_torch.coverage.sanitize``, the program that runs both CUDA
kernels for ``compute-sanitizer``: its batches here, and on a card with the
tool on the PATH that program under memcheck, racecheck and synccheck (no
hazard reported, each kernel exact against ``index_add_``). Where the tool
says the card is not supported (it cannot attach to any program there, a
plain CUDA one included), the test skips with that reason."""

import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import REPO_ROOT

from pantas_tpu_torch.coverage import sanitize


@pytest.fixture(scope="module")
def real_inputs(tmp_path_factory):
    """A 0.05 Mbp graph and 40,000 of its synthetic reads: more than one
    whole batch of 2^20 slots. Returns (GAF, GFA) as strings."""
    from pantas_tpu_torch.eval import synth

    cache = tmp_path_factory.mktemp("sanitize")
    saved = synth.CACHE
    synth.CACHE = cache
    try:
        wd = synth.ensure_graph(0.05)
    finally:
        synth.CACHE = saved
    gfa = wd / "out" / "pantranscriptome-annotated.gfa"
    synth.synth_gaf(gfa, 40_000, wd / "reads.gaf")
    return str(wd / "reads.gaf"), str(gfa)


def test_batches_are_whole_and_in_their_bucket(real_inputs):
    from pantas_tpu_torch.graph.compiler import compile_gfa

    got = sanitize.batches(real_inputs)
    n, uniform = got["uniform"]
    assert n == 1 << 25 and uniform.dtype == np.int32 and len(uniform) == sanitize.BATCH
    assert uniform.min() >= -1 and uniform.max() < n
    bucket, real = got["real"]
    slots = compile_gfa(real_inputs[1]).total_slots
    assert bucket == 1 << (slots - 1).bit_length() or (bucket == 1 << 12 and slots <= bucket)
    assert len(real) == sanitize.BATCH and real.min() >= 0 and real.max() < slots


@pytest.fixture(scope="module")
def sanitizer():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    exe = shutil.which("compute-sanitizer")
    if exe is None:
        pytest.skip("compute-sanitizer is not on the PATH")
    return exe


@pytest.mark.cuda
@pytest.mark.parametrize("tool", ["memcheck", "racecheck", "synccheck"])
def test_kernels_under_compute_sanitizer(sanitizer, real_inputs, tool):
    proc = subprocess.run(
        [sanitizer, "--tool", tool, "--error-exitcode", "1", sys.executable, "-m",
         "pantas_tpu_torch.coverage.sanitize", "--real", *real_inputs],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=1800,
    )
    said = proc.stdout + proc.stderr
    if "Error: Device not supported" in said:  # the tool cannot attach to this card at all
        pytest.skip("compute-sanitizer reports 'Device not supported' for this card")
    assert proc.returncode == 0, said[-3000:]
    assert "ERROR SUMMARY: 0 errors" in said
    assert said.count('"max_abs_err": 0') == 4  # two kernels on two batches
