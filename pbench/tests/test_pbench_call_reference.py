"""The plain call reference (``pbench/reference/call.py``) against the port's
host caller and its device caller on the CPU, the call cell's faults, and
the reference's isolation from the program.

The reference's rows equal, as multisets, those of ``call_events`` and of
``call_events_device(devices=["cpu"])`` on every case of the micro fixtures
and on a 0.05 Mbp graph of the call cell's recipe augmented by the NumPy
augment reference, where every annotated kind appears. A run of the tiny
cell with one row dropped, one ``RC`` off by one or one row twice reads
``call_jobs_differ`` on every job.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
from conftest import REPO, run_cell

from pbench.reference import augment as ref_augment
from pbench.reference import call as ref_call
from pbench.reference import inputs, rotated
from pbench.run import load

sys.path.insert(0, str(REPO / "tests"))
from fixtures_call import write_call_fixtures  # noqa: E402

CELL = "call-dmreal10-annot"
CONFIG = json.loads((REPO / "pbench" / "configs" / "dm-real-10mbp-call.json").read_text())
MIX = json.loads((REPO / "pbench" / "traffic" / "call-annot.json").read_text())
GEN = load(REPO / "pbench" / "traffic" / "transcript_pairs.py")
FOREIGN = ("pantas_tpu_torch", "pantas_tpu", "jax", "jaxlib", "flax")


def _port_rows(gfa, gtf, rca, device):
    from pantas_tpu_torch.events.batched import call_events_device
    from pantas_tpu_torch.events.caller import CallOptions, call_events

    opts = CallOptions(rca=rca)
    if device:
        return list(call_events_device(gfa, gtf, opts, log=io.StringIO(), devices=["cpu"]))
    return list(call_events(gfa, gtf, opts, log=io.StringIO()))


def _reference_rows(gfa, gtf, rca):
    with open(gfa) as fh:
        return ref_call.annotated_rows(fh, gtf, rca=rca)


@pytest.fixture(scope="module")
def augmented(tmp_path_factory):
    """A 0.05 Mbp graph of the cell's recipe augmented by the NumPy reference."""
    tmp = tmp_path_factory.mktemp("call")
    tables = inputs.GraphTables(rotated.ensure_graph("tiny-call", dict(CONFIG["graph"], mbp=0.05), tmp))
    config = dict(CONFIG, reads=dict(CONFIG["reads"], pairs=3000))
    reads = GEN.generate(tables, config, MIX, 11)
    gfa = tmp / "augmented.gfa"
    with open(gfa, "w") as out:
        ref_augment.emit(tables, ref_augment.counts(tables, reads), out.write)
    return str(gfa), str(tables.dir / "g.gtf")


@pytest.mark.parametrize("device", [False, True], ids=["host", "device-cpu"])
@pytest.mark.parametrize("rca", [0, 3])
@pytest.mark.parametrize("case", ["splice", "cassette"])
def test_reference_is_the_ports_on_the_fixtures(tmp_path, case, rca, device):
    gfa, gtf = write_call_fixtures(tmp_path)[case]
    want = _port_rows(gfa, gtf, rca, device)
    assert Counter(_reference_rows(gfa, gtf, rca)) == Counter(want)


@pytest.mark.parametrize("device", [False, True], ids=["host", "device-cpu"])
@pytest.mark.parametrize("rca", [0, 3])
def test_reference_is_the_ports_on_the_cells_recipe(augmented, rca, device):
    rows = _reference_rows(*augmented, rca)
    assert Counter(rows) == Counter(_port_rows(*augmented, rca, device))
    kinds = Counter(r.split(",")[0] for r in rows[1:])
    assert set(kinds) == {"ES", "A3", "A5", "IR"}, kinds


@pytest.mark.parametrize("hash_seed", ["0", "1"])
def test_reference_follows_the_process_hashes(augmented, hash_seed):
    """The IR walk takes the first shared label in the set's order, which
    follows the string hashes: under any hash seed the reference and the
    port agree within one process."""
    code = ("import sys, io\nfrom collections import Counter\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "from pbench.reference import call\n"
            "from pantas_tpu_torch.events.batched import call_events_device\n"
            "from pantas_tpu_torch.events.caller import CallOptions\n"
            f"gfa, gtf = {augmented!r}\n"
            "ref = call.annotated_rows(open(gfa), gtf, rca=3)\n"
            "dev = list(call_events_device(gfa, gtf, CallOptions(rca=3), log=io.StringIO(), devices=['cpu']))\n"
            "print(Counter(ref) == Counter(dev))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env={**__import__("os").environ, "PYTHONHASHSEED": hash_seed})
    assert p.stdout.strip() == "True", p.stderr[-2000:]


def test_header_is_the_ports():
    from pantas_tpu_torch.events.caller import CSV_HEADER

    assert ref_call.HEADER == CSV_HEADER


def test_sound_run_is_correct(tiny_root, capsys):
    rc, out = run_cell(tiny_root, CELL, capsys)
    assert rc == 0 and out["correct"], out
    assert out["checks"] == {"gfa_jobs_differ": {"value": 0, "limit": 0},
                             "call_jobs_differ": {"value": 0, "limit": 0}}


def _drop_one(rows):
    return rows[:-1]


def _rc_off_by_one(rows):
    cols = rows[1].split(",")
    cols[9] = str(int(cols[9]) + 1)
    return [rows[0], ",".join(cols), *rows[2:]]


def _one_twice(rows):
    return rows + rows[-1:]


@pytest.mark.parametrize("fault", [_drop_one, _rc_off_by_one, _one_twice],
                         ids=["row-dropped", "rc-off-by-one", "row-twice"])
def test_call_fault_is_caught(tiny_root, capsys, monkeypatch, fault):
    from pantas_tpu_torch.events import batched

    inner = batched.call_events_device
    monkeypatch.setattr(batched, "call_events_device", lambda *a, **k: fault(list(inner(*a, **k))))
    rc, out = run_cell(tiny_root, CELL, capsys)
    assert rc == 0 and out["correct"] is False
    assert out["checks"]["call_jobs_differ"]["value"] == out["attempted"] > 0
    assert out["checks"]["gfa_jobs_differ"]["value"] == 0


def test_reference_loads_nothing_of_the_program(tmp_path):
    """Neither directly nor through another module."""
    gfa, gtf = write_call_fixtures(tmp_path)["splice"]
    code = (f"import sys\nsys.path.insert(0, {str(REPO)!r})\n"
            "from pbench.reference import call\n"
            f"rows = call.annotated_rows(open({gfa!r}), {gtf!r}, rca=0)\n"
            "assert len(rows) > 1\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-2000:]
    names = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "pbench" in names and names.isdisjoint(FOREIGN)
    source = (REPO / "pbench" / "reference" / "call.py").read_text()
    assert not any(name in source.split('"""', 2)[2] for name in FOREIGN)


def test_control_is_not_correct(deep_root, capsys):
    """The references with the augment's counts held in float16 read both
    checks above their limits (``python3 -m pbench.control_call``)."""
    from pbench import control_call

    rc = control_call.main(["--workload", CELL, "--seeds", "1", "2"], root=deep_root)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rc == 0 and len(lines) == 2
    for line in lines:
        assert line["correct"] is False
        assert line["checks"]["call_jobs_differ"]["value"] > line["checks"]["call_jobs_differ"]["limit"]


def test_control_loads_nothing_of_the_program(deep_root):
    code = (f"import sys\nsys.path.insert(0, {str(REPO)!r})\nfrom pathlib import Path\n"
            "from pbench import control_call\n"
            f"control_call.main(['--workload', {CELL!r}, '--seeds', '4'], root=Path('.'))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=deep_root)
    assert p.returncode == 0, p.stderr[-2000:]
    names = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "pbench" in names and names.isdisjoint(FOREIGN)


def test_rotated_recipe_turns_the_kind_from_gene_to_gene(tmp_path):
    """Gene ``g``'s second isoform is the frozen recipe's isoform
    ``2 + g % 4`` of the same gene, and the rest of the inputs are the frozen
    recipe's, byte for byte."""
    kw = dict(mbp=0.05, n_var=200, n_genes=8, n_samples=4, n_exons=5)
    (tmp_path / "frozen").mkdir()
    (tmp_path / "rotated").mkdir()
    inputs.gen_inputs(tmp_path / "frozen", n_tx=5, **kw)
    rotated.gen_inputs(tmp_path / "rotated", **kw)

    def transcripts(path):
        out = {}
        for line in (path / "g.gtf").read_text().splitlines():
            tid = line.split('transcript_id "')[1].split('"')[0]
            out.setdefault(tid, []).append("\t".join(line.split("\t")[2:5]))
        return out

    frozen, turned = transcripts(tmp_path / "frozen"), transcripts(tmp_path / "rotated")
    assert len(turned) == 2 * 8
    for g in range(8):
        assert turned[f"T0_{g}_1"] == frozen[f"T0_{g}_1"]
        assert turned[f"T0_{g}_2"] == frozen[f"T0_{g}_{2 + g % 4}"], g
    for name in ("g.fa", "g.vcf"):
        assert (tmp_path / "frozen" / name).read_bytes() == (tmp_path / "rotated" / name).read_bytes()
