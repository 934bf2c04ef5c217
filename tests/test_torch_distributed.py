"""The port's multi-process augment (``augment-dist`` on ``torch.distributed``)
against the JAX package: real OS processes over gloo on the CPU, each
streaming its byte range of the GAF, one int32 ``all_reduce``, first-seen
orders through sidecars. Equality is exact everywhere (integer counts, bytes).

Every multi-process test lives in this file, so that one worker runs them;
ranks are waited for with a timeout, and the first failure kills its siblings.
"""

import gzip
import io
import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch
from conftest import REPO_ROOT
from fixtures_micro import write_micro

from pantas_tpu.coverage import augment_gfa
from pantas_tpu_torch import cli
from pantas_tpu_torch.parallel import distributed

RANK_TIMEOUT_S = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_cmd(pkg, gaf, gfa, out, port, n, i):
    cmd = [sys.executable, "-m", pkg, "augment-dist", str(gaf), str(gfa), "-o", str(out),
           "--coordinator", f"127.0.0.1:{port}", "--nprocs", str(n), "--procid", str(i)]
    return cmd + (["--device", "cpu"] if pkg == "pantas_tpu_torch" else [])


def _run_ranks(gaf, gfa, out, n, pkg="pantas_tpu_torch", env_extra=None, ranks=None):
    """Start ranks ``ranks`` (all ``n`` by default) of one run and wait for
    each; the first failure or timeout kills the others before it is
    reported. Returns [(returncode, stderr)] in rank order."""
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # 1 local device per JAX process
    env.update(env_extra or {})
    port = _free_port()
    procs = [
        subprocess.Popen(_rank_cmd(pkg, gaf, gfa, out, port, n, i), env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in (range(n) if ranks is None else ranks)
    ]
    done = []
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            done.append((p.returncode, err))
            if p.returncode != 0:
                break
    except subprocess.TimeoutExpired:
        done.append((None, "timed out"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return done


def _ok(done, n):
    assert len(done) == n and all(rc == 0 for rc, _ in done), [
        (rc, err[-1500:]) for rc, err in done]
    return [err for _, err in done]


def _host_engine(gaf, gfa) -> str:
    expected = io.StringIO()
    augment_gfa(str(gaf), str(gfa), out=expected, log=io.StringIO())
    return expected.getvalue()


@pytest.fixture
def micro40(tmp_path):
    """The micro GAF 40 times over, so that every byte range holds records
    and novel edges / IL offsets are first seen in different shards."""
    gfa, gaf = write_micro(tmp_path)
    big = tmp_path / "big.gaf"
    big.write_text(open(gaf).read() * 40)
    return gfa, big


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_shard_byte_ranges_equal_and_cover(tmp_path, n):
    from pantas_tpu.parallel.distributed import shard_byte_ranges

    p = tmp_path / "f.txt"
    p.write_text("".join(f"line{i}\n" * (1 + i % 3) for i in range(100)))
    ranges = distributed.shard_byte_ranges(str(p), n)
    assert ranges == shard_byte_ranges(str(p), n) and len(ranges) == n
    data = p.read_bytes()
    assert ranges[0][0] == 0 and ranges[-1][1] == len(data)
    for (_, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c and (c == len(data) or data[c - 1 : c] == b"\n")


def test_two_ranks_byte_identical_to_every_engine(tmp_path, micro40):
    """2 ranks of the port == the JAX host engine == the port's
    single-process device engine == 2 ranks of the JAX package."""
    gfa, big = micro40
    expected = _host_engine(big, gfa)
    out = tmp_path / "dist.gfa"
    _ok(_run_ranks(big, gfa, out, 2), 2)
    assert out.read_text() == expected

    single = tmp_path / "single.gfa"
    assert cli.main(["augment", "--engine", "device", "--device", "cpu", str(big), gfa,
                     "-o", str(single)]) == 0
    assert single.read_text() == expected

    theirs = tmp_path / "jax_dist.gfa"
    _ok(_run_ranks(big, gfa, theirs, 2, pkg="pantas_tpu"), 2)
    assert theirs.read_bytes() == out.read_bytes()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_any_rank_count_gives_the_same_bytes(tmp_path, micro40, n):
    gfa, big = micro40
    out = tmp_path / "dist.gfa"
    logs = _ok(_run_ranks(big, gfa, out, n), n)
    assert out.read_text() == _host_engine(big, gfa)
    assert not [p.name for p in tmp_path.iterdir() if p.name.startswith(".augshard")]
    for i, log in enumerate(logs):
        assert f"[augment-dist] proc {i}: accumulate " in log
        assert "[augment-dist] reduction: gloo on the host vector (the device is the CPU)" in log
        assert "[device] scatter impl: cpu-sorted-plain" in log
        assert f"[augment-dist] proc {i}: " in log and " bytes reduced over gloo in " in log
        assert "python feed" not in log
    assert "[augment-dist] proc 0: merge and emit" in logs[0]


def test_python_tokenizer_feed_under_two_ranks(tmp_path):
    """A graph the native engine cannot key (non-canonical ids): both ranks
    take the Python tokenizer, and rank 0 merges their encoder sidecars."""
    gfa = tmp_path / "g.gfa"
    gfa.write_text("H\tVN:Z:1.1\nS\t007\tACGT\nS\t8\tACGT\nL\t007\t+\t8\t+\t*\n")
    gaf = tmp_path / "g.gaf"
    gaf.write_text("".join(
        f"r{i}\t8\t0\t8\t+\t>007>8\t8\t0\t8\t8\t8\t60\tcs:Z::8\tdv:f:0.0\n" for i in range(40)))
    out = tmp_path / "dist.gfa"
    logs = _ok(_run_ranks(gaf, gfa, out, 2), 2)
    assert all("[augment-dist] python feed (" in log for log in logs)
    assert out.read_text() == _host_engine(gaf, gfa)
    assert "RC:i:40" in out.read_text()


def test_compressed_input_refused_by_a_lone_rank(tmp_path, micro40):
    """Refused, with the JAX package's message, before the group is
    initialised: rank 0 of 2 returns at once with no peer started, and
    creates no output."""
    gfa, big = micro40
    gz = tmp_path / "big.gaf.gz"
    with gzip.open(gz, "wb") as fh:
        fh.write(big.read_bytes())
    out = tmp_path / "dist.gfa"
    t0 = time.monotonic()
    (rc, err), = _run_ranks(gz, gfa, out, 2, ranks=[0])
    assert rc not in (0, None) and time.monotonic() - t0 < 60
    assert "augment-dist does not support compressed GAF input; decompress first" in err
    assert not out.exists()


def test_unknown_scatter_refused_by_a_lone_rank(tmp_path, micro40):
    gfa, big = micro40
    out = tmp_path / "dist.gfa"
    (rc, err), = _run_ranks(big, gfa, out, 2, ranks=[0], env_extra={"PANTAS_SCATTER": "bogus"})
    assert rc not in (0, None) and "PANTAS_SCATTER='bogus'" in err
    assert not out.exists()


def test_race_under_two_ranks(tmp_path, micro40):
    """Each rank races alone on its first real batch and rewrites the shared
    verdict file; whatever each picks, the counts are exact."""
    gfa, big = micro40
    out, cache = tmp_path / "dist.gfa", tmp_path / "cache"
    logs = _ok(_run_ranks(big, gfa, out, 2, env_extra={
        "PANTAS_SCATTER": "race", "PANTAS_TORCH_CACHE": str(cache)}), 2)
    assert out.read_text() == _host_engine(big, gfa)
    for log in logs:
        names = [ln.split(": ", 1)[1] for ln in log.splitlines()
                 if ln.startswith("[device] scatter impl: ")]
        assert names[0].startswith("race pending") and names[-1] in ("plain", "cpu-sorted-plain")
    verdict = json.loads((cache / "scatter_verdict.json").read_text())  # not torn
    assert verdict and all(e["impl"] in ("plain", "cuda-sorted") for e in verdict.values())


def test_cuda_without_a_card_raises_before_the_group(tmp_path, micro40, monkeypatch):
    """``device="cuda"`` is never replaced by the CPU, and the refusal waits
    for no peer: rank 0 of 2 raises at once, with no output."""
    gfa, big = micro40
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "dist.gfa"
    with pytest.raises(RuntimeError, match="cuda"):
        distributed.augment_gfa_distributed(
            str(big), gfa, str(out), coordinator=f"127.0.0.1:{_free_port()}",
            n_procs=2, proc_id=0, log=io.StringIO())
    assert not out.exists() and not torch.distributed.is_initialized()


def test_two_calls_in_one_process(tmp_path, micro40):
    """The process group is destroyed on the way out, so a second call can
    initialise its own."""
    gfa, big = micro40
    expected = _host_engine(big, gfa)
    for k in range(2):
        out, log = tmp_path / f"dist{k}.gfa", io.StringIO()
        accum_s = distributed.augment_gfa_distributed(
            str(big), gfa, str(out), coordinator=f"127.0.0.1:{_free_port()}",
            n_procs=1, proc_id=0, log=log, device="cpu")
        assert accum_s >= 0 and out.read_text() == expected
        assert not torch.distributed.is_initialized()
        # the warm-up batch is a batch of the local engine
        assert "[device] kernel launches: 0 (batches: 2)" in log.getvalue()


@pytest.mark.parametrize("ranks, want", [
    ([("a", "cpu", False), ("a", "cpu", False)], ("gloo", "the device is the CPU")),
    ([("a", "GPU-1", False)], ("gloo", "this torch has no NCCL")),
    ([("a", "GPU-1", True), ("a", "GPU-1", True)], ("gloo", "2 ranks share GPU-1")),
    ([("a", "GPU-1", True), ("a", "GPU-2", True), ("b", "GPU-1", True)], ("nccl", "")),
    ([("a", "GPU-1", True)], ("nccl", "")),
], ids=["cpu", "no-nccl", "shared-card", "own-cards", "one-rank"])
def test_reduction_transport_rule(ranks, want):
    assert distributed.reduction_transport(ranks) == want


def test_initialize_distributed_reads_the_launch_variables(monkeypatch):
    for name in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        assert distributed.initialize_distributed() is True
        assert torch.distributed.get_world_size() == 1
    finally:
        torch.distributed.destroy_process_group()
