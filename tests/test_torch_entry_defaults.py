"""The port's library entry points called with no device, as the JAX ones are.

A JAX entry point called with no device runs on the default backend, the
accelerator when there is one. Its counterpart in the port takes the first
card (``backend.default_device``), and with no card it raises a
``RuntimeError`` naming ``cuda`` before it reads a file or writes anything:
it never runs on the CPU unless the CPU is named. Named as ``"cpu"``, each
gives the JAX package's result on the same seeded inputs (JAX on the CPU):
rows for the call engine, hits for the finders and ``_eval_match``, counts
for ``DeviceCoverage`` and for the step each race picker returns. On the
card (``cuda``-marked) a call with no device evaluates on ``cuda`` only.
"""

import io

import numpy as np
import pytest
import torch
from fixtures_call import write_call_fixtures
from fixtures_micro import write_micro

from pantas_tpu.coverage import device as tpu_device
from pantas_tpu.coverage import pallas_kernel as pk
from pantas_tpu.events import batched as tpu
from pantas_tpu.events.caller import CallOptions as TpuCallOptions
from pantas_tpu.events.caller import SplicingGraph as TpuGraph
from pantas_tpu.graph.compiler import compile_gfa as tpu_compile_gfa
from pantas_tpu.io.gtf import parse_transcript_maps as tpu_transcript_maps
from pantas_tpu_torch import backend
from pantas_tpu_torch.coverage import device as port_device
from pantas_tpu_torch.coverage import kernels
from pantas_tpu_torch.coverage import scatter_impls as si
from pantas_tpu_torch.events import batched as port
from pantas_tpu_torch.events.caller import CallOptions, SplicingGraph
from pantas_tpu_torch.graph.compiler import compile_gfa
from pantas_tpu_torch.io.gtf import parse_transcript_maps

CPU = torch.device("cpu")
FINDERS = ["annotated_es", "annotated_ss", "novel_es", "annotated_ir", "novel_ss_exonic",
           "novel_ce"]
N_SLOTS, BATCH = 1 << 12, 256


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """name -> (gfa, gtf) of the call fixtures."""
    return write_call_fixtures(tmp_path_factory.mktemp("call"))


@pytest.fixture
def no_card(monkeypatch, tmp_path):
    """No card, and a fresh verdict cache: what each call must not write."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PANTAS_TORCH_CACHE", str(tmp_path / "cache"))
    return tmp_path / "cache"


def _find(mod, graph_cls, maps, name, gfa, gtf, opts, **kw):
    """Finder ``name`` of either package on one fixture, called as its
    ``call_events_device`` calls it."""
    graph = graph_cls.from_gfa(gfa)
    t2g, genestrand, _ = maps(gtf)
    fn = getattr(mod, f"find_{name}")
    if name == "annotated_ss":
        return fn(graph, t2g, genestrand, rca=opts.rca, **kw)
    if name == "novel_ss_exonic":
        return fn(graph, t2g, opts, **kw)
    if name == "novel_ce":
        return fn(graph, opts, **kw)
    return fn(graph, t2g, rca=opts.rca, **kw)


def _port_find(name, gfa, gtf, **kw):
    return _find(port, SplicingGraph, parse_transcript_maps, name, gfa, gtf,
                 CallOptions(rca=0, novel=True), **kw)


def _tpu_find(name, gfa, gtf):
    return _find(tpu, TpuGraph, tpu_transcript_maps, name, gfa, gtf,
                 TpuCallOptions(rca=0, novel=True))


def _caught_eval(mod, find, micro, monkeypatch):
    """The ``(match, tables, index_arrays)`` of ``mod``'s first ``_eval_match``
    call when the novel CE finder runs on the cassette fixture."""
    caught = []
    monkeypatch.setattr(mod, "_eval_match",
                        lambda match, tables, index, *a, **k: caught.append((match, tables, index))
                        or np.zeros(len(index[0]), dtype=bool))
    find("novel_ce", *micro["cassette"])
    monkeypatch.undo()
    return caught[0]


def _seeded_batches(total_slots, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(-1, total_slots, size=int(k), dtype=np.int32) for k in (40, 64, 7)]


# --- the resolver -------------------------------------------------------------


@pytest.mark.parametrize("name, want", [
    (None, torch.device("cuda", 0)), ("cuda", torch.device("cuda")),
    ("cuda:0", torch.device("cuda", 0)), ("cpu", CPU), (CPU, CPU)])
def test_default_device_with_a_card(name, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert backend.default_device(name) == want
    assert backend.default_devices(None if name is None else [name]) == [want]


@pytest.mark.parametrize("name", [None, "cuda", "cuda:0"])
def test_default_device_without_a_card_raises(name, no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        backend.default_device(name)
    with pytest.raises(RuntimeError, match="cuda"):
        backend.default_devices(None if name is None else [name, "cpu"])
    assert backend.default_device("cpu") == CPU
    assert backend.default_devices(["cpu", CPU]) == [CPU, CPU]


# --- with no card, no device named: the port's error, nothing run or written ----


def test_call_events_device_without_a_card_raises(micro, no_card, monkeypatch):
    read = []
    monkeypatch.setattr(SplicingGraph, "from_gfa", classmethod(lambda cls, p: read.append(p)))
    rows, log = [], io.StringIO()
    port.EVALS.clear()
    with pytest.raises(RuntimeError, match="cuda"):
        for row in port.call_events_device(*micro["splice"], CallOptions(rca=0), log=log):
            rows.append(row)
    assert rows == [] and log.getvalue() == "" and not read and not port.EVALS


@pytest.mark.parametrize("name", FINDERS)
def test_finder_without_a_card_raises(name, micro, no_card):
    port.EVALS.clear()
    for gfa, gtf in micro.values():
        with pytest.raises(RuntimeError, match="cuda"):
            _port_find(name, gfa, gtf)
    assert not port.EVALS


def test_eval_match_without_a_card_raises(no_card):
    a, b = np.arange(5, dtype=np.int32), np.full(5, 2, dtype=np.int32)
    port.EVALS.clear()
    with pytest.raises(RuntimeError, match="cuda"):
        port._eval_match(port.match_novel_ce, (), [a, b])
    assert not port.EVALS


def test_device_coverage_without_a_card_raises(tmp_path, no_card):
    gfa, _ = write_micro(tmp_path)
    t = compile_gfa(str(gfa))
    launches, log = dict(kernels.LAUNCHES), io.StringIO()
    with pytest.raises(RuntimeError, match="cuda"):
        port_device.DeviceCoverage(t, log=log)
    assert kernels.LAUNCHES == launches and log.getvalue() == ""


@pytest.mark.parametrize("picker", ["pick_scatter_impl", "pick_scatter_endtoend"])
def test_race_pickers_without_a_card_raise(picker, no_card):
    launches = dict(kernels.LAUNCHES)
    args = () if picker == "pick_scatter_impl" else (N_SLOTS, BATCH)
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(si, picker)(*args)
    assert kernels.LAUNCHES == launches
    assert not no_card.exists()  # no verdict written


# --- named "cpu": the JAX package's results ---------------------------------------


@pytest.mark.parametrize("rca", [-1, 0])
@pytest.mark.parametrize("fixture", ["splice", "cassette"])
def test_call_events_device_on_the_cpu_equals_jax(fixture, rca, micro):
    gfa, gtf = micro[fixture]
    want = sorted(tpu.call_events_device(gfa, gtf, TpuCallOptions(rca=rca, novel=True),
                                         log=io.StringIO()))
    port.EVALS.clear()
    got = sorted(port.call_events_device(gfa, gtf, CallOptions(rca=rca, novel=True),
                                         log=io.StringIO(), devices=["cpu"]))
    assert got == want and len(want) > 1
    assert port.EVALS and {dev for _, dev in port.EVALS} == {"cpu"}


@pytest.mark.parametrize("name", FINDERS)
def test_finder_on_the_cpu_equals_jax(name, micro):
    hits = 0
    for fixture, (gfa, gtf) in micro.items():
        want = _tpu_find(name, gfa, gtf)
        assert _port_find(name, gfa, gtf, devices=["cpu"]) == want, fixture
        hits += len(want)
    assert hits


def test_eval_match_on_the_cpu_equals_jax(micro, monkeypatch):
    """Each package's ``_eval_match`` on the candidates its own novel CE
    finder builds on the cassette fixture: the same hits."""
    jmatch, jtables, jindex = _caught_eval(tpu, _tpu_find, micro, monkeypatch)
    pmatch, ptables, pindex = _caught_eval(
        port, lambda *a: _port_find(*a, devices=["cpu"]), micro, monkeypatch)
    want = tpu._eval_match(jmatch, jtables, jindex)
    got = port._eval_match(pmatch, ptables, pindex, ["cpu"])
    assert got.dtype == np.bool_ and got.tolist() == np.asarray(want).tolist()
    assert 0 < got.sum() <= len(got)


def test_device_coverage_on_the_cpu_equals_jax(tmp_path):
    gfa, _ = write_micro(tmp_path)
    jdev = tpu_device.DeviceCoverage(tpu_compile_gfa(str(gfa)))
    dev = port_device.DeviceCoverage(compile_gfa(str(gfa)), "cpu", log=io.StringIO())
    assert dev.device == CPU
    for b in _seeded_batches(dev.t.total_slots, 11):
        jdev.add_slots(b, pad_to=64)
        dev.add_slots(b, pad_to=64)
    assert np.array_equal(dev.counts.numpy(), np.asarray(jdev.counts))
    assert np.array_equal(dev.result(), jdev.result()) and dev.result().sum() > 0


@pytest.mark.parametrize("picker", ["pick_scatter_impl", "pick_scatter_endtoend"])
def test_race_pickers_on_the_cpu_equal_jax_scatter(picker, tmp_path, monkeypatch):
    """The step either picker returns adds a seeded batch as the JAX
    package's scatter does (the race's timing decides only which step)."""
    import jax.numpy as jnp

    monkeypatch.setenv("PANTAS_TORCH_CACHE", str(tmp_path / "cache"))
    if picker == "pick_scatter_impl":
        name, step = si.pick_scatter_impl(N_SLOTS, 1 << 14, device="cpu")
    else:
        name, step = si.pick_scatter_endtoend(N_SLOTS, BATCH, None, 3, False, 8, device="cpu")
    assert step is si.SCATTER_IMPLS[name]
    idx = np.random.default_rng(13).integers(-1, N_SLOTS, size=1 << 14, dtype=np.int32)
    got = step(torch.zeros(N_SLOTS, dtype=torch.int32), torch.from_numpy(idx)).numpy()
    want = np.asarray(pk.xla_scatter_add(jnp.zeros(N_SLOTS, jnp.int32), jnp.asarray(idx)))
    assert np.array_equal(got, want) and got.sum() == (idx >= 0).sum()


# --- on the card: no device named is the card ----------------------------------


@pytest.mark.cuda
def test_no_device_named_runs_on_the_card(micro, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    for gfa, gtf in micro.values():
        opts = CallOptions(rca=0, novel=True)
        cpu = sorted(port.call_events_device(gfa, gtf, opts, log=io.StringIO(), devices=["cpu"]))
        port.EVALS.clear()
        card = sorted(port.call_events_device(gfa, gtf, opts, log=io.StringIO()))
        assert card == cpu
        assert port.EVALS and {dev for _, dev in port.EVALS} == {"cuda"}
    gfa, _ = write_micro(tmp_path)
    dev = port_device.DeviceCoverage(compile_gfa(str(gfa)), log=io.StringIO())
    assert dev.counts.device == torch.device("cuda", 0)
