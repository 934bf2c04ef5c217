"""The port's device call engine against the JAX package's and the host caller.

``pantas_tpu_torch.events.batched`` is held exactly against
``pantas_tpu.events.batched`` (jax on the CPU) and ``pantas_tpu``'s host
caller: the six match functions on seeded bitset tables, the six finders on
the micro fixtures of ``fixtures_call.py`` and on a 1 Mbp synthetic graph,
the rows of ``call_events_device`` and of the CLI, the split over
``devices=[cpu] * N``, and the CLI's device handling. Comparisons of rows
run in one process, or in subprocesses under one ``PYTHONHASHSEED``: the
novel exonic SS finder walks a ``set`` in its own order, as the host does.
"""

import argparse
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import REPO_ROOT
from fixtures_call import write_call_fixtures

from pantas_tpu import cli as tpu_cli
from pantas_tpu.events import batched as tpu
from pantas_tpu.events.caller import CallOptions, SplicingGraph, call_events
from pantas_tpu.io.gtf import parse_transcript_maps
from pantas_tpu_torch import backend, cli
from pantas_tpu_torch.events import batched as port

CPU = torch.device("cpu")
FINDERS = ["annotated_es", "annotated_ss", "novel_es", "annotated_ir", "novel_ss_exonic",
           "novel_ce"]
ANNOTATED = FINDERS[:2] + ["annotated_ir"]


def _case(gfa, gtf):
    return gfa, gtf, SplicingGraph.from_gfa(gfa), parse_transcript_maps(gtf)


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """name -> (gfa, gtf, graph, (t2g, genestrand, genechr))."""
    paths = write_call_fixtures(tmp_path_factory.mktemp("call"))
    return {name: _case(*p) for name, p in paths.items()}


@pytest.fixture(scope="module")
def mbp1(tmp_path_factory):
    """A 1 Mbp synthetic pangenome (100 genes, 6 isoforms x 8 exons, 20
    samples) augmented natively with 50k exact-match reads: ~7 s to build."""
    sys.path.insert(0, str(REPO_ROOT / "scripts"))
    import stress_build
    from bench_call_scale import synth_gaf

    from pantas_tpu.build.pipeline import build_pangenome
    from pantas_tpu.native import augment_gfa_native

    wd = tmp_path_factory.mktemp("mbp1")
    stress_build.gen_inputs(wd, mbp=1.0, n_var=10_000, n_genes=100, n_samples=20,
                            n_chroms=1, n_exons=8, n_tx=6)
    build_pangenome(str(wd / "g.fa"), str(wd / "g.gtf"), str(wd / "g.vcf"),
                    str(wd / "out"), threads=1, log=io.StringIO())
    gfa = wd / "out" / "pantranscriptome-annotated.gfa"
    synth_gaf(gfa, 50_000, wd / "r.gaf")
    aug = wd / "aug.gfa"
    with open(aug, "w") as out:
        augment_gfa_native(str(wd / "r.gaf"), str(gfa), out=out, log=io.StringIO())
    return _case(str(aug), str(wd / "g.gtf"))


def _find(mod, name, case, opts, **kw):
    """Finder ``name`` of either package, called as ``call_events_device``
    calls it."""
    _, _, graph, (t2g, genestrand, _) = case
    fn = getattr(mod, f"find_{name}")
    if name == "annotated_ss":
        return fn(graph, t2g, genestrand, rca=opts.rca, **kw)
    if name == "novel_ss_exonic":
        return fn(graph, t2g, opts, **kw)
    if name == "novel_ce":
        return fn(graph, opts, **kw)
    return fn(graph, t2g, rca=opts.rca, **kw)


def _rows(engine, case, opts, **kw):
    gfa, gtf, graph, _ = case
    return sorted(engine(gfa, gtf, opts, log=io.StringIO(), graph=graph, **kw))


# --- (a) the match functions ------------------------------------------------


def _jax_match(name, micro, monkeypatch):
    """The JAX finder's own match closure and its table and index arity,
    caught at its ``_eval_match`` call on the micro fixtures."""
    caught = []
    inner = tpu._eval_match

    def spy(match, tables, index_arrays, mesh=None):
        caught.append((match, len(tables), len(index_arrays)))
        return inner(match, tables, index_arrays, mesh)

    monkeypatch.setattr(tpu, "_eval_match", spy)
    for case in micro.values():
        _find(tpu, name, case, CallOptions(rca=0, novel=True))
    return caught[0]


def _bitsets(rng, rows, words, density):
    bits = rng.random((rows, words, 32)) < density
    return (bits * (np.uint64(1) << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)


@pytest.mark.parametrize("name", FINDERS)
def test_match_function_equals_jax(name, micro, monkeypatch):
    import jax
    import jax.numpy as jnp

    jax_match, n_tables, n_index = _jax_match(name, micro, monkeypatch)
    rng = np.random.default_rng(FINDERS.index(name))
    rows, m = 64, 4096
    tables = [_bitsets(rng, rows, 2, 0.25) for _ in range(n_tables)]
    index = [rng.integers(0, rows, size=m, dtype=np.int32) for _ in range(n_index)]

    want = np.asarray(jax.jit(jax_match)(*map(jnp.asarray, tables), *map(jnp.asarray, index)))
    got = getattr(port, f"match_{name}")(
        *(port._to_device(t, CPU) for t in tables), *map(torch.from_numpy, index)
    ).numpy()
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < m  # both outcomes occur


def test_to_device_keeps_every_bit():
    mat = np.array([[0xFFFFFFFF, 0x80000000], [1, 0]], dtype=np.uint32)
    t = port._to_device(mat, CPU)
    assert t.dtype == torch.int32
    assert t.numpy().view(np.uint32).tolist() == mat.tolist()


# --- (b) the finders on the micro fixtures ----------------------------------


@pytest.mark.parametrize("rca", [-1, 0])
@pytest.mark.parametrize("name", FINDERS)
def test_finder_equals_jax_micro(name, rca, micro):
    opts = CallOptions(rca=rca, novel=True)
    hits = 0
    for fixture, case in micro.items():
        want = _find(tpu, name, case, opts)
        got = _find(port, name, case, opts, devices=[CPU])
        assert type(got) is type(want)
        assert got == want, fixture
        hits += len(want)
    assert hits  # the fixtures exercise every finder


def test_finder_multiplicity_and_first_hit(micro):
    """``find_annotated_ss`` counts rows, and ``find_annotated_ir`` keeps the
    host caller's first pair, as the host caller emits them."""
    gfa, gtf, graph, (t2g, genestrand, _) = micro["splice"]
    assert port.find_annotated_ss(graph, t2g, genestrand, rca=0, devices=[CPU]) == \
        port.host_ss_rows(gfa, gtf, rca=0)
    assert port.find_annotated_es(graph, t2g, rca=0, devices=[CPU]) == \
        port.host_es_triples(gfa, gtf, rca=0)
    host_ir = {}
    for row in call_events(gfa, gtf, CallOptions(rca=0, events=["IR"]), log=io.StringIO()):
        cols = row.split(",")
        if cols[:2] == ["IR", "annotated"]:
            sub = cols[10].split(">")
            host_ir[tuple(cols[8].split(">"))] = (sub[0], sub[-1])
    oracle = port.find_annotated_ir(graph, t2g, rca=0, devices=[CPU])
    assert host_ir and all(oracle[j] == pair for j, pair in host_ir.items())


# --- (c) the 1 Mbp synthetic graph -----------------------------------------


@pytest.mark.parametrize("name", FINDERS)
def test_finder_equals_jax_1mbp(name, mbp1):
    opts = CallOptions(rca=0, novel=True)
    want = _find(tpu, name, mbp1, opts)
    assert _find(port, name, mbp1, opts, devices=[CPU]) == want
    if name in ANNOTATED:
        assert len(want) > 50


def test_rows_equal_host_and_jax_1mbp(mbp1):
    opts = CallOptions(rca=0)
    host = _rows(call_events, mbp1, opts)
    assert _rows(port.call_events_device, mbp1, opts, devices=[CPU]) == host
    assert _rows(tpu.call_events_device, mbp1, opts) == host
    events = [r for r in host if not r.startswith("event_type,")]
    assert {tuple(r.split(",")[:2]) for r in events} == {
        ("ES", "annotated"), ("A3", "annotated"), ("A5", "annotated"), ("IR", "annotated")}
    assert 600 < len(events) < 900  # ~718


# --- (d) rows through the CLIs ----------------------------------------------


def _cli_rows(argvs, tmp_path):
    """Run each command concurrently under PYTHONHASHSEED=0; sorted rows."""
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT), "PYTHONHASHSEED": "0"}
    procs = []
    for i, argv in enumerate(argvs):
        out = tmp_path / f"rows{i}.csv"
        procs.append((out, subprocess.Popen([sys.executable, "-m", *argv, "-o", str(out)],
                                            env=env, stderr=subprocess.PIPE, text=True)))
    rows = []
    for out, proc in procs:
        _, err = proc.communicate()
        assert proc.returncode == 0, err[-2000:]
        rows.append(sorted(out.read_text().splitlines()))
    return rows


@pytest.mark.parametrize(
    "flags", [[], ["--rca", "0"], ["--rca", "0", "--novel"], ["--junction", "nonsense"]],
    ids=["default", "rca0", "rca0-novel", "junction"],
)
@pytest.mark.parametrize("fixture", ["splice", "cassette"])
def test_cli_rows_equal_host_and_jax(fixture, flags, micro, tmp_path):
    gfa, gtf = micro[fixture][:2]
    ported, host, jax_dev = _cli_rows([
        ["pantas_tpu_torch", "call", "--engine", "device", "--device", "cpu", *flags, gfa, gtf],
        ["pantas_tpu", "call", *flags, gfa, gtf],
        ["pantas_tpu", "call", "--engine", "device", *flags, gfa, gtf],
    ], tmp_path)
    assert ported == host
    assert ported == jax_dev


# --- (e) the candidate axis split over N devices ----------------------------


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("fixture", ["splice", "cassette", "1mbp"])
def test_mesh_split_is_invariant(fixture, n, micro, request):
    case = request.getfixturevalue("mbp1") if fixture == "1mbp" else micro[fixture]
    opts = CallOptions(rca=0, novel=True)
    for name in FINDERS:
        one = _find(port, name, case, opts, devices=[CPU])
        assert _find(port, name, case, opts, devices=[CPU] * n) == one, name
    assert _rows(port.call_events_device, case, opts, devices=[CPU] * n) == \
        _rows(call_events, case, opts)


def test_eval_match_keeps_candidate_order_across_shards():
    """Shards are contiguous and come back in order, with fewer candidates
    than devices too; ``EVALS`` counts each device's candidates."""
    a = np.arange(5, dtype=np.int32)
    b = np.array([4, 0, 2, 9, 3], dtype=np.int32)
    port.EVALS.clear()
    for n in (1, 2, 3, 8):
        got = port._eval_match(port.match_novel_ce, (), [a, b], [CPU] * n)
        assert got.tolist() == [True, False, True, True, False]
    assert port.EVALS == {("novel_ce", "cpu"): 20}


# --- (f)-(h) the CLI --------------------------------------------------------


def _parser_of(cmd, monkeypatch):
    class Parsed(Exception):
        pass

    def grab(self, *args, **kwargs):
        raise Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Parsed) as caught:
            cmd([])
    return caught.value.args[0]


def test_call_parser_accepts_every_pantas_tpu_option(monkeypatch):
    def spec(parser):
        return {(tuple(a.option_strings) or a.dest): (a.dest, a.default, a.nargs, a.type,
                                                      a.const, a.choices)
                for a in parser._actions}

    theirs = spec(_parser_of(tpu_cli._cmd_call, monkeypatch))
    ours = spec(_parser_of(cli._cmd_call, monkeypatch))
    assert {k: ours.get(k) for k in theirs} == theirs
    assert set(ours) - set(theirs) == {("--device",)}
    assert ours[("--device",)][1:] == ("cuda", None, None, None, ["cuda", "cpu"])


def test_cli_device_call_loads_no_jax(micro, tmp_path):
    gfa, gtf = micro["splice"][:2]
    code = (
        "import sys\n"
        "from pantas_tpu_torch import cli\n"
        f"rc = cli.main(['call', '--engine', 'device', '--device', 'cpu', '--rca', '0', "
        f"'--novel', {gfa!r}, {gtf!r}, '-o', {str(tmp_path / 'o.csv')!r}])\n"
        "assert rc == 0\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO_ROOT, check=True)
    assert proc.stdout.strip() == "[]", proc.stdout
    assert len((tmp_path / "o.csv").read_text().splitlines()) > 1


def test_cli_cuda_without_a_card_fails_before_writing(micro, tmp_path, monkeypatch):
    gfa, gtf = micro["splice"][:2]
    out = tmp_path / "o.csv"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["call", "--engine", "device", gfa, gtf, "-o", str(out)])
    assert not out.exists()


def test_cli_device_errors_propagate(micro, tmp_path, monkeypatch):
    def broken(*args):
        raise RuntimeError("match failed")

    monkeypatch.setattr(port, "match_annotated_es", broken)
    gfa, gtf = micro["splice"][:2]
    with pytest.raises(RuntimeError, match="match failed"):
        cli.main(["call", "--engine", "device", "--device", "cpu", gfa, gtf,
                  "-o", str(tmp_path / "o.csv")])


def _cli_mesh_on_cpu(n, case, out, monkeypatch):
    """``call --engine device --device cpu --mesh n`` on ``case`` into
    ``out``; returns the number of devices each evaluation was split over."""
    gfa, gtf = case[:2]
    split = []
    inner = port._eval_match

    def spy(match, tables, index_arrays, devices=None):
        split.append(len(devices))
        return inner(match, tables, index_arrays, devices)

    monkeypatch.setattr(port, "_eval_match", spy)
    port.EVALS.clear()
    assert cli.main(["call", "--engine", "device", "--device", "cpu", "--mesh", str(n),
                     "--rca", "0", "--novel", gfa, gtf, "-o", str(out)]) == 0
    return split


def test_cli_mesh_uses_the_devices_there_are(micro, tmp_path, capsys, monkeypatch):
    """On the CPU ``--mesh 4`` is a logical mesh of 4, with no warning, as
    ``augment --device cpu --mesh 4`` is."""
    out = tmp_path / "o.csv"
    split = _cli_mesh_on_cpu(4, micro["cassette"], out, monkeypatch)
    assert "WARNING" not in capsys.readouterr().err
    assert split and set(split) == {4}
    assert port.EVALS and {dev for _, dev in port.EVALS} == {"cpu"}
    assert sorted(out.read_text().splitlines()) == \
        _rows(call_events, micro["cassette"], CallOptions(rca=0, novel=True))


@pytest.mark.parametrize("fixture", ["splice", "cassette"])
@pytest.mark.parametrize("n", [2, 8])
def test_cli_mesh_shards_the_candidates_on_the_cpu(n, fixture, micro, tmp_path, monkeypatch):
    """Every evaluation of the run is split over ``n`` shards, and the rows
    equal the host caller's (one process, so one hash seed)."""
    out = tmp_path / "o.csv"
    split = _cli_mesh_on_cpu(n, micro[fixture], out, monkeypatch)
    assert split and set(split) == {n}
    assert sorted(out.read_text().splitlines()) == \
        _rows(call_events, micro[fixture], CallOptions(rca=0, novel=True))


def test_cli_mesh_rows_equal_the_host_cli_under_one_hash_seed(micro, tmp_path):
    """Both CLIs in subprocesses under ``PYTHONHASHSEED=0``: the device
    engine on a logical CPU mesh of 2 and of 8 against the host caller."""
    gfa, gtf = micro["cassette"][:2]
    env = {**os.environ, "PYTHONHASHSEED": "0", "JAX_PLATFORMS": "cpu"}

    def rows(*argv):
        proc = subprocess.run([sys.executable, "-m", *argv, "--rca", "0", "--novel", gfa, gtf],
                              capture_output=True, text=True, cwd=REPO_ROOT, env=env, check=True)
        return sorted(proc.stdout.splitlines())

    host = rows("pantas_tpu", "call")
    assert len(host) > 1
    for n in ("2", "8"):
        assert rows("pantas_tpu_torch", "call", "--engine", "device", "--device", "cpu",
                    "--mesh", n) == host, n


def test_backend_devices(monkeypatch, capsys):
    assert backend.devices("cpu") == [CPU]
    assert backend.devices("cpu", 3) == [CPU] * 3  # a logical mesh, as mesh_devices gives
    assert backend.devices("cpu", 3) == backend.mesh_devices("cpu", 3)
    assert capsys.readouterr().err == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert backend.devices("cuda", 1) == [torch.device("cuda", 0)]
    assert backend.devices("cuda", 4) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert "--mesh 4 requested but only 2 device(s)" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        backend.devices("cuda")


# --- (i) on the card ----------------------------------------------------------


@pytest.mark.cuda
def test_cuda_equals_cpu(micro, mbp1):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    cuda = torch.device("cuda")
    opts = CallOptions(rca=0, novel=True)
    port.EVALS.clear()
    for case in [*micro.values(), mbp1]:
        for name in FINDERS:
            assert _find(port, name, case, opts, devices=[cuda]) == \
                _find(port, name, case, opts, devices=[CPU]), name
        assert _rows(port.call_events_device, case, opts, devices=[cuda]) == \
            _rows(port.call_events_device, case, opts, devices=[CPU])
    on_cuda = {f for f, dev in port.EVALS if dev == "cuda"}
    assert on_cuda == set(FINDERS)
