"""The plain reference of the call's novel pass (``pbench/reference/call_novel.py``)
against the port's host caller and its device caller on the CPU, the novel
call cell's faults and control, the novel recipe, and the isolation of both
new reference modules from the program.

The reference's rows equal, as multisets, those of ``call_events`` and of
``call_events_device(devices=["cpu"])`` with ``novel=True,
no_annotated=True`` on every case of the micro fixtures, at ``-l 4`` and
``-l 25``, and on a 0.05 Mbp graph of the novel recipe augmented by the
NumPy augment reference, where every injected kind yields rows. A run of the
tiny cell with a novel link dropped from the augmented GFA, a novel ``RC``
off by one, or one row twice reads ``call_jobs_differ`` on every job.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
from collections import Counter

import pytest
from conftest import REPO, run_cell

from pbench.reference import augment as ref_augment
from pbench.reference import call_novel as ref_novel
from pbench.reference import first_seen, inputs, novel
from pbench.run import load

sys.path.insert(0, str(REPO / "tests"))
from fixtures_call import write_call_fixtures  # noqa: E402

CELL = "call-dmsim10-novel"
CONFIG = json.loads((REPO / "pbench" / "configs" / "dm-sim-10mbp-novel.json").read_text())
MIX = json.loads((REPO / "pbench" / "traffic" / "call-novel.json").read_text())
GEN = load(REPO / "pbench" / "traffic" / "transcript_pairs.py")
FOREIGN = ("pantas_tpu_torch", "pantas_tpu", "jax", "jaxlib", "flax")
KINDS = {"ES", "A3", "A5", "IR", "CE"}


def _options(rca, minintronsize):
    from pantas_tpu_torch.events.caller import CallOptions

    return CallOptions(rca=rca, novel=True, no_annotated=True, isw=5, minintronsize=minintronsize)


def _port_rows(gfa, gtf, rca, minintronsize, device):
    from pantas_tpu_torch.events.batched import call_events_device
    from pantas_tpu_torch.events.caller import call_events

    opts = _options(rca, minintronsize)
    if device:
        return list(call_events_device(gfa, gtf, opts, log=io.StringIO(), devices=["cpu"]))
    return list(call_events(gfa, gtf, opts, log=io.StringIO()))


def _reference_rows(gfa, gtf, rca, minintronsize):
    with open(gfa) as fh:
        return ref_novel.novel_rows(fh, gtf, rca=rca, isw=5, minintronsize=minintronsize)


def _kinds(rows):
    return Counter(r.split(",")[0] for r in rows[1:])


@pytest.fixture(scope="module")
def augmented(tmp_path_factory):
    """A 0.05 Mbp graph of the novel recipe augmented by the NumPy reference."""
    tmp = tmp_path_factory.mktemp("novel")
    tables = inputs.GraphTables(novel.ensure_graph("tiny-novel", dict(CONFIG["graph"], mbp=0.05), tmp))
    config = dict(CONFIG, reads=dict(CONFIG["reads"], pairs=3000))
    reads = GEN.generate(tables, config, MIX, 11)
    gfa = tmp / "augmented.gfa"
    with open(gfa, "w") as out:
        ref_augment.emit(tables, ref_augment.counts(tables, reads), out.write)
    return str(gfa), str(tables.dir / "g.gtf")


@pytest.mark.parametrize("device", [False, True], ids=["host", "device-cpu"])
@pytest.mark.parametrize("minintronsize", [4, 25])
@pytest.mark.parametrize("rca", [0, 3])
@pytest.mark.parametrize("case", ["splice", "cassette"])
def test_reference_is_the_ports_on_the_fixtures(tmp_path, case, rca, minintronsize, device):
    gfa, gtf = write_call_fixtures(tmp_path)[case]
    rows = _reference_rows(gfa, gtf, rca, minintronsize)
    assert Counter(rows) == Counter(_port_rows(gfa, gtf, rca, minintronsize, device))
    assert all(",novel," in r for r in rows[1:]) and len(rows) > 1


def test_fixtures_reach_every_branch(tmp_path):
    """Between them the fixtures make novel ES, A3 and A5 (exonic and
    intronic), novel IR over a novel junction, CE and IR-2; ``-l 25`` drops
    the IR rows of their short introns."""
    fixtures = write_call_fixtures(tmp_path)
    rows = {case: _reference_rows(*fixtures[case], 0, 4) for case in fixtures}
    assert set(_kinds(rows["splice"])) == {"ES", "A3", "A5", "IR"}
    assert set(_kinds(rows["cassette"])) == {"A5", "CE", "IR"}
    ir = [r.split(",") for r in rows["splice"] + rows["cassette"] if r.startswith("IR,")]
    assert {r[6] == "?" for r in ir} == {True, False}  # over novel junctions, and IR-2
    ss = [r.split(",") for r in rows["splice"] + rows["cassette"] if r[:2] in ("A3", "A5")]
    assert {r[5] == "?" for r in ss} == {True, False}  # exonic, and intronic
    for case in fixtures:
        assert "IR" not in _kinds(_reference_rows(*fixtures[case], 0, 25))


@pytest.mark.parametrize("device", [False, True], ids=["host", "device-cpu"])
@pytest.mark.parametrize("rca", [0, 3])
def test_reference_is_the_ports_on_the_cells_recipe(augmented, rca, device):
    rows = _reference_rows(*augmented, rca, 25)
    assert Counter(rows) == Counter(_port_rows(*augmented, rca, 25, device))
    assert set(_kinds(rows)) == KINDS, _kinds(rows)


@pytest.mark.parametrize("hash_seed", ["0", "1"])
def test_reference_follows_the_process_hashes(augmented, hash_seed):
    """The intronic walk pops from a set and the IR rows list sets, whose
    orders follow the string hashes: under any hash seed the reference and
    the port agree within one process."""
    code = ("import sys, io\nfrom collections import Counter\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "from pbench.reference import call_novel\n"
            "from pantas_tpu_torch.events.batched import call_events_device\n"
            "from pantas_tpu_torch.events.caller import CallOptions\n"
            f"gfa, gtf = {augmented!r}\n"
            "ref = call_novel.novel_rows(open(gfa), gtf, rca=0, isw=5, minintronsize=25)\n"
            "opts = CallOptions(rca=0, novel=True, no_annotated=True, isw=5, minintronsize=25)\n"
            "dev = list(call_events_device(gfa, gtf, opts, log=io.StringIO(), devices=['cpu']))\n"
            "print(Counter(ref) == Counter(dev))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONHASHSEED": hash_seed})
    assert p.stdout.strip() == "True", p.stderr[-2000:]


def test_header_is_the_ports():
    from pantas_tpu_torch.events.caller import CSV_HEADER

    assert ref_novel.HEADER == CSV_HEADER


@pytest.mark.parametrize("seed", [5, 1])  # at seed 1 a reverse record first crosses two novel links
def test_sound_run_is_correct(tiny_root, capsys, seed):
    rc, out = run_cell(tiny_root, CELL, capsys, seed=seed)
    assert rc == 0 and out["correct"], out
    assert out["checks"] == {"gfa_jobs_differ": {"value": 0, "limit": 0},
                             "call_jobs_differ": {"value": 0, "limit": 0}}


def test_traced_run_reports_the_novel_metrics(tiny_root, capsys):
    rc, out = run_cell(tiny_root, CELL, capsys, trace=1)
    assert rc == 0 and out["correct"], out
    for name in ("call.novel_es_s", "call.novel_ss_s", "call.novel_ce_s", "call.novel_walk_s",
                 "native.emit_novel_s", "call.match_s", "call.graph_load_s"):
        assert out["metrics"][name]["value"] >= 0, name


def _rewrite_gfa(edit):
    """A fault in the program's augmented GFA: the job's file rewritten by
    ``edit(lines)`` once the augment has written it."""
    def wrap(inner):
        def augment(*a, **k):
            result = inner(*a, **k)
            out = k["out"]
            out.flush()
            with open(out.name) as fh:
                lines = fh.readlines()
            with open(out.name, "w") as fh:
                fh.writelines(edit(lines))
            return result
        return augment
    return wrap


def _busiest_novel(lines):
    novel = [i for i, line in enumerate(lines) if line.rstrip("\n").endswith("\tID:Z:N")]
    assert novel
    return max(novel, key=lambda i: int(lines[i].split("RC:i:")[1].split("\t")[0]))


def _drop_novel_link(lines):
    i = _busiest_novel(lines)
    return lines[:i] + lines[i + 1:]


def _novel_rc_off_by_one(lines):
    i = _busiest_novel(lines)
    head, rest = lines[i].split("RC:i:")
    rc, tail = rest.split("\t", 1)
    return lines[:i] + [f"{head}RC:i:{int(rc) + 1}\t{tail}"] + lines[i + 1:]


@pytest.mark.parametrize("fault", [_drop_novel_link, _novel_rc_off_by_one],
                         ids=["novel-link-dropped", "novel-rc-off-by-one"])
def test_gfa_fault_is_caught(tiny_root, capsys, monkeypatch, fault):
    from pantas_tpu_torch.coverage import device

    monkeypatch.setattr(device, "augment_gfa_device_native",
                        _rewrite_gfa(fault)(device.augment_gfa_device_native))
    rc, out = run_cell(tiny_root, CELL, capsys)
    assert rc == 0 and out["correct"] is False
    assert out["checks"]["call_jobs_differ"]["value"] == out["attempted"] > 0
    assert out["checks"]["gfa_jobs_differ"]["value"] == out["attempted"]


def test_row_twice_is_caught(tiny_root, capsys, monkeypatch):
    from pantas_tpu_torch.events import batched

    inner = batched.call_events_device
    monkeypatch.setattr(batched, "call_events_device", lambda *a, **k: (
        lambda rows: rows + rows[-1:])(list(inner(*a, **k))))
    rc, out = run_cell(tiny_root, CELL, capsys)
    assert rc == 0 and out["correct"] is False
    assert out["checks"]["call_jobs_differ"]["value"] == out["attempted"] > 0
    assert out["checks"]["gfa_jobs_differ"]["value"] == 0


@pytest.mark.parametrize("module", ["call_novel", "novel"])
def test_reference_loads_nothing_of_the_program(tmp_path, module):
    """Neither directly nor through another module."""
    gfa, gtf = write_call_fixtures(tmp_path)["splice"]
    use = {"call_novel": f"assert len(call_novel.novel_rows(open({gfa!r}), {gtf!r}, rca=0)) > 1\n",
           "novel": "from pathlib import Path\n(Path('w')).mkdir()\n"
                    "novel.gen_inputs(Path('w'), n_exons=5, mbp=0.02, n_var=50, n_genes=5, n_samples=2)\n"}
    code = (f"import sys\nsys.path.insert(0, {str(REPO)!r})\n"
            f"from pbench.reference import {module}\n{use[module]}"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-2000:]
    names = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "pbench" in names and names.isdisjoint(FOREIGN)
    source = (REPO / "pbench" / "reference" / f"{module}.py").read_text()
    assert not any(name in source.split('"""', 2)[2] for name in FOREIGN)


def test_control_is_not_correct(deep_root, capsys):
    """The references with the augment's counts held in float16 read both
    checks above their limits (``python3 -m pbench.control_call_novel``)."""
    from pbench import control_call_novel

    rc = control_call_novel.main(["--workload", CELL, "--seeds", "1", "2"], root=deep_root)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rc == 0 and len(lines) == 2
    for line in lines:
        assert line["correct"] is False
        for check in ("gfa_jobs_differ", "call_jobs_differ"):
            assert line["checks"][check]["value"] > line["checks"][check]["limit"]
        assert line["seen"]["novel_links"] > 0


def test_control_loads_nothing_of_the_program(deep_root):
    code = (f"import sys\nsys.path.insert(0, {str(REPO)!r})\nfrom pathlib import Path\n"
            "from pbench import control_call_novel\n"
            f"control_call_novel.main(['--workload', {CELL!r}, '--seeds', '4'], root=Path('.'))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=deep_root)
    assert p.returncode == 0, p.stderr[-2000:]
    names = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "pbench" in names and names.isdisjoint(FOREIGN)


def test_novel_recipe_turns_the_kind_and_serves_without_the_events(tmp_path):
    """Gene ``g``'s event is the frozen recipe's variant of kind ``g % 5``
    (a cassette for 4), the served chain and the rest of the inputs are the
    frozen recipe's, and the served graph holds nothing of the events: no
    label, no path, no link that only they need, and no GTF record."""
    kw = dict(mbp=0.05, n_var=200, n_genes=10, n_samples=4, n_exons=5)
    (tmp_path / "frozen").mkdir()
    (tmp_path / "novel").mkdir()
    inputs.gen_inputs(tmp_path / "frozen", n_tx=5, **kw)
    novel.gen_inputs(tmp_path / "novel", **kw)

    def transcripts(path):
        out = {}
        for line in path.read_text().splitlines():
            tid = line.split('transcript_id "')[1].split('"')[0]
            if line.split("\t")[2] == "exon":
                out.setdefault(tid, []).append(tuple(int(x) for x in line.split("\t")[3:5]))
        return out

    frozen = transcripts(tmp_path / "frozen" / "g.gtf")
    every = transcripts(tmp_path / "novel" / "all.gtf")
    served = transcripts(tmp_path / "novel" / "g.gtf")
    assert set(served) == {f"T0_{g}_1" for g in range(10)} and len(every) == 20
    for g in range(10):
        assert every[f"T0_{g}_1"] == served[f"T0_{g}_1"] == frozen[f"T0_{g}_1"]
        chain, event = frozen[f"T0_{g}_1"], every[f"T0_{g}_2"]
        if g % 5 < 4:
            assert event == frozen[f"T0_{g}_{2 + g % 5}"], g
        else:
            (cassette,) = set(event) - set(chain)
            assert event == chain[:3] + [cassette] + chain[3:]
            assert cassette[1] - cassette[0] + 1 == novel.CASSETTE_BP
            assert cassette[0] - chain[2][1] - 1 == chain[3][0] - cassette[1] - 1 >= 25
    for name in ("g.fa", "g.vcf"):
        assert (tmp_path / "frozen" / name).read_bytes() == (tmp_path / "novel" / name).read_bytes()

    graph = novel.ensure_graph("recipe", dict(CONFIG["graph"], mbp=0.05), tmp_path)
    text = (graph / "out" / inputs.GFA_NAME).read_text()
    assert "_2_R1" not in text and "_2_H" not in text
    paths = [line.split("\t")[1] for line in text.splitlines() if line.startswith("P\t")]
    assert paths[0] == "chr0" and all(p.endswith("_1_R1") for p in paths[1:])
    tables = inputs.GraphTables(graph)
    assert {n.rsplit("_", 1)[1] for n in tables.tx_names.tolist()} == {"1", "2"}
    links = {tuple(line.split("\t")[1:4:2]) for line in text.splitlines() if line.startswith("L\t")}
    walked = set()
    for i in range(len(tables.path_off) - 1):
        steps = tables.ids[tables.steps[tables.path_off[i]:tables.path_off[i + 1]]].astype(str)
        walked.update(zip(steps[:-1], steps[1:]))
    assert walked - links  # the events' splice links, left out
    assert _kinds(_reference_rows(*_augment_text(tables, graph), 0, 25))


def _augment_text(tables, graph):
    config = dict(CONFIG, reads=dict(CONFIG["reads"], pairs=3000))
    reads = GEN.generate(tables, config, MIX, 7)
    gfa = graph / "augmented.gfa"
    with open(gfa, "w") as out:
        ref_augment.emit(tables, ref_augment.counts(tables, reads), out.write)
    return str(gfa), str(graph / "g.gtf")


def test_novel_links_follow_the_walks_as_written(tmp_path):
    """A reverse record ``<c<b<a`` crosses ``(b, c)`` first, as upstream's
    augmenter and the program count it: where such a record is the first to
    cross two absent links, :mod:`pbench.reference.first_seen` writes the
    program's bytes and the forward order of ``augment.counts`` does not."""
    from pantas_tpu_torch.coverage.device import augment_gfa_device_native

    tables = inputs.GraphTables(novel.ensure_graph("walks", dict(CONFIG["graph"], mbp=0.05), tmp_path))
    reads = GEN.generate(tables, dict(CONFIG, reads=dict(CONFIG["reads"], pairs=2000)), MIX, 1)
    gaf = tmp_path / "reads.gaf"
    GEN.write_gaf(tables, reads, gaf)
    port = tmp_path / "port.gfa"
    with open(port, "w") as out:
        augment_gfa_device_native(str(gaf), str(tables.gfa), out=out, device="cpu", log=io.StringIO())

    def emitted(counts):
        chunks = []
        ref_augment.emit(tables, counts, chunks.append)
        return "".join(chunks)

    forward, written = ref_augment.counts(tables, reads), first_seen.counts(tables, reads)
    assert sorted(forward.novel) == sorted(written.novel) and forward.novel != written.novel
    assert emitted(written) == port.read_text() != emitted(forward)
