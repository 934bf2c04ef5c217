"""The port's coverage mesh on the CPU (logical shards) vs the host engine
and the JAX package's mesh engine.

Mirrors the mesh tests of ``test_device_coverage.py``: coverage counts are
integer adds, so any shard count and either mesh shape must emit the host
engine's bytes, and the reduced counts vector must equal the JAX engine's on
an 8-device CPU mesh. Equality is exact everywhere (tolerance 0).
"""

import io
import os
import pickle

import numpy as np
import pytest
import torch
from fixtures_micro import MICRO_GAF_LINES, write_micro

from pantas_tpu.coverage import augment_gfa
from pantas_tpu.coverage import device as tpu_device
from pantas_tpu.graph.compiler import compile_gfa
from pantas_tpu.parallel import mesh as tpu_mesh
from pantas_tpu_torch import backend, cli
from pantas_tpu_torch.coverage import device as port
from pantas_tpu_torch.coverage import kernels
from pantas_tpu_torch.parallel import mesh as port_mesh

CPU = torch.device("cpu")
MESHES = {
    "1": lambda: port_mesh.coverage_mesh([CPU]),
    "8": lambda: port_mesh.coverage_mesh([CPU] * 8),
    "2x4": lambda: port_mesh.coverage_mesh_2d([CPU] * 8, 2, 4),
    "4x2": lambda: port_mesh.coverage_mesh_2d([CPU] * 8, 4, 2),
}


def _host(gaf, gfa):
    buf = io.StringIO()
    augment_gfa(str(gaf), str(gfa), out=buf, log=io.StringIO())
    return buf.getvalue()


def _port(feed, gaf, gfa, **kw):
    fn = port.augment_gfa_device if feed == "python" else port.augment_gfa_device_native
    buf = io.StringIO()
    fn(str(gaf), str(gfa), out=buf, log=io.StringIO(), **kw)
    return buf.getvalue()


@pytest.mark.parametrize("flush_every", [4, 8, 1 << 20])
@pytest.mark.parametrize("feed", ["python", "native"])
@pytest.mark.parametrize("shape", list(MESHES))
def test_mesh_invariance(tmp_path, shape, feed, flush_every):
    gfa, gaf = write_micro(tmp_path)
    got = _port(feed, gaf, gfa, mesh=MESHES[shape](), flush_every=flush_every)
    assert got == _host(gaf, gfa)


@pytest.mark.parametrize("shape", ["8", "2x4", "4x2"])
def test_counts_equal_jax_mesh_engine(tmp_path, shape):
    """The same slot batches through both packages' DeviceCoverage under the
    same mesh shape: equal reduced counts, and equal partial layout."""
    import jax

    gfa, _ = write_micro(tmp_path)
    t = compile_gfa(gfa)
    if "x" in shape:
        d, k = (int(v) for v in shape.split("x"))
        jmesh = tpu_mesh.coverage_mesh_2d(jax.devices()[:8], d, k)
    else:
        jmesh = tpu_mesh.coverage_mesh(jax.devices()[:8])
    jdev = tpu_device.DeviceCoverage(t, mesh=jmesh)
    pdev = port.DeviceCoverage(t, mesh=MESHES[shape](), log=io.StringIO())
    assert pdev._padded_slots == jdev._padded_slots and pdev.n_shards == jdev.n_shards
    rng = np.random.default_rng(3)
    for size in (64, 40, 7):  # 7 is no multiple of the data axis: padded in both
        batch = rng.integers(-1, t.total_slots, size=size, dtype=np.int32)
        jdev.add_slots(batch, pad_to=64 if size != 7 else None)
        pdev.add_slots(batch, pad_to=64 if size != 7 else None)
    # the private partials row by row, then the one reduction
    jparts = np.asarray(jdev.counts)
    pparts = np.stack([torch.cat(row).numpy() for row in pdev.counts])
    assert np.array_equal(pparts, jparts)
    assert np.array_equal(pdev.result(), jdev.result())


def test_mesh_steps_against_plain_scatter():
    """Both mesh steps and the reduction against one plain scatter."""
    rng = np.random.default_rng(11)
    total = 1000
    idx = torch.from_numpy(rng.integers(-1, total, size=96, dtype=np.int32))
    want = port_mesh.scatter_add_counts(torch.zeros(total, dtype=torch.int32), idx)

    mesh = port_mesh.coverage_mesh([CPU] * 4)
    parts = port_mesh.new_parts(mesh, total)
    port_mesh.data_parallel_scatter_add(mesh, kernels.sorted_coverage_scatter_add)(parts, idx)
    assert [int(row[0].sum()) for row in parts] == [
        int((c >= 0).sum()) for c in idx.chunk(4)]  # private: each row holds its shard only
    assert torch.equal(port_mesh.reduce_data_parts(parts), want)

    mesh = port_mesh.coverage_mesh_2d([CPU] * 6, 2, 3)
    step, shard = port_mesh.node_sharded_scatter_add(
        mesh, total, kernels.sorted_coverage_scatter_add)
    assert shard == 334
    parts = port_mesh.new_parts(mesh, shard)
    step(parts, idx)
    merged = port_mesh.reduce_data_parts(parts)
    assert merged.numel() == 3 * shard and torch.equal(merged[:total], want)
    assert int(merged[total:].sum()) == 0
    assert len(port_mesh.pad_to_multiple(np.arange(5, dtype=np.int32), 4)) == 8


@pytest.mark.parametrize("shape", ["8", "2x4"])
def test_native_checkpoint_resume_under_mesh(tmp_path, shape):
    """A checkpoint written under a mesh holds the reduced vector in the
    single-device format: it resumes under the same mesh, under another
    shape, and on a single device."""
    gfa, gaf = write_micro(tmp_path)
    big = tmp_path / "big.gaf"
    big.write_text(open(gaf).read() * 20)
    expected = _host(big, gfa)
    ck = str(tmp_path / "ck.pkl")
    r = port.augment_gfa_device_native(
        str(big), str(gfa), out=io.StringIO(), mesh=MESHES[shape](), flush_every=64,
        checkpoint_path=ck, checkpoint_every=1, _stop_after=1, log=io.StringIO())
    assert r is None and os.path.exists(ck)
    saved = open(ck, "rb").read()
    state = pickle.loads(saved)
    assert state["total_slots"] == compile_gfa(gfa).total_slots and state["offset"] > 0
    for resume_kw in ({"mesh": MESHES[shape]()}, {"mesh": MESHES["4x2"]()}, {"device": "cpu"}):
        with open(ck, "wb") as fh:
            fh.write(saved)
        log = io.StringIO()
        buf = io.StringIO()
        port.augment_gfa_device_native(
            str(big), str(gfa), out=buf, flush_every=64, checkpoint_path=ck, resume=True,
            log=log, **resume_kw)
        assert "Resuming from checkpoint" in log.getvalue()
        assert buf.getvalue() == expected


def test_python_checkpoint_resume_under_mesh(tmp_path):
    gfa, gaf = write_micro(tmp_path)
    truncated = tmp_path / "part.gaf"
    truncated.write_text("\n".join(MICRO_GAF_LINES[:7]) + "\n")
    ck = str(tmp_path / "cov.ckpt")
    _port("python", truncated, gfa, mesh=MESHES["2x4"](), flush_every=8, checkpoint_path=ck)
    got = _port("python", gaf, gfa, mesh=MESHES["8"](), flush_every=8, checkpoint_path=ck,
                resume=True)
    assert got == _host(gaf, gfa)
    # the JAX engine (single device) resumes from the mesh run's checkpoint too
    _port("python", truncated, gfa, mesh=MESHES["2x4"](), flush_every=8, checkpoint_path=ck)
    buf = io.StringIO()
    tpu_device.augment_gfa_device(str(gaf), str(gfa), out=buf, flush_every=8,
                                  checkpoint_path=ck, resume=True, log=io.StringIO())
    assert buf.getvalue() == _host(gaf, gfa)


@pytest.mark.parametrize("spec", ["1", "8", "2x4", "4x2"])
def test_cli_mesh_matches_host_and_jax_mesh(tmp_path, spec):
    gfa, gaf = write_micro(tmp_path)
    out = tmp_path / "port.gfa"
    assert cli.main(["augment", "--engine", "device", "--device", "cpu", "--mesh", spec,
                     gaf, gfa, "-o", str(out)]) == 0
    assert out.read_text() == _host(gaf, gfa)
    from pantas_tpu import cli as tpu_cli

    jax_out = tmp_path / "jax.gfa"
    assert tpu_cli.main(["augment", "--engine", "device", "--mesh", spec,
                         gaf, gfa, "-o", str(jax_out)]) == 0
    assert out.read_bytes() == jax_out.read_bytes()


@pytest.mark.parametrize("value", ["race", "auto"])
def test_race_with_mesh_refused(tmp_path, monkeypatch, value):
    gfa, gaf = write_micro(tmp_path)
    out = tmp_path / "o.gfa"
    monkeypatch.setenv("PANTAS_SCATTER", value)
    with pytest.raises(ValueError, match="cannot be combined with a mesh"):
        cli.main(["augment", "--engine", "device", "--device", "cpu", "--mesh", "2",
                  gaf, gfa, "-o", str(out)])
    assert not out.exists()  # refused before the output is opened
    with pytest.raises(ValueError, match="cannot be combined with a mesh"):
        port.DeviceCoverage(compile_gfa(gfa), mesh=MESHES["8"](), log=io.StringIO())
    # a named scatter is honoured on every shard
    monkeypatch.setenv("PANTAS_SCATTER", "plain")
    log = io.StringIO()
    port.DeviceCoverage(compile_gfa(gfa), mesh=MESHES["8"](), log=log)
    assert "[device] scatter impl: plain on a 8 mesh" in log.getvalue()


def test_mesh_on_cuda_with_too_few_cards(tmp_path, monkeypatch, capsys):
    gfa, gaf = write_micro(tmp_path)
    out = tmp_path / "o.gfa"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices but only 1"):
        cli.main(["augment", "--engine", "device", "--device", "cuda", "--mesh", "2x2",
                  gaf, gfa, "-o", str(out)])
    assert not out.exists()
    # the N form shrinks to the cards there are, with a warning
    assert backend.mesh_devices("cuda", 4) == [torch.device("cuda", 0)]
    assert "--mesh 4 requested but only 1 device(s)" in capsys.readouterr().err


def test_mesh_without_a_card_fails_and_writes_nothing(tmp_path, monkeypatch):
    gfa, gaf = write_micro(tmp_path)
    out = tmp_path / "o.gfa"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["augment", "--engine", "device", "--mesh", "4", gaf, gfa, "-o", str(out)])
    assert not out.exists()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_logical_mesh_equals_index_add(cuda):
    """A logical mesh of 4 and of 2x2 on one card with the sorted kernel on
    every shard (partials of a length that is no multiple of the kernel's
    window) equals one ``index_add_``, and launches one kernel per shard."""
    rng = np.random.default_rng(7)
    total = 3 * kernels.WINDOW + 1234
    want = torch.zeros(total, dtype=torch.int32, device=cuda)
    batches = [torch.from_numpy(rng.integers(-1, total, size=1 << 16, dtype=np.int32))
               for _ in range(3)]
    for b in batches:
        port_mesh.scatter_add_counts(want, b.to(cuda))
    for mesh in (port_mesh.coverage_mesh([cuda] * 4),
                 port_mesh.coverage_mesh_2d([cuda] * 4, 2, 2)):
        before = kernels.LAUNCHES["sorted_coverage_scatter_add"]
        if mesh.node is None:
            shard = total
            step = port_mesh.data_parallel_scatter_add(mesh, kernels.sorted_coverage_scatter_add)
        else:
            step, shard = port_mesh.node_sharded_scatter_add(
                mesh, total, kernels.sorted_coverage_scatter_add)
        parts = port_mesh.new_parts(mesh, shard)
        for b in batches:
            step(parts, b)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["sorted_coverage_scatter_add"] - before == 4 * len(batches)
        assert torch.equal(port_mesh.reduce_data_parts(parts)[:total], want)
