"""A configuration, a traffic mix and a per-layer metric are added as new
files and ``BENCHMARK.json`` entries alone: the harness finds them by name,
runs the new cell and reports the new metric, and no file of ``pbench/`` that
was there is edited."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

from conftest import REPO, make_root, run_cell


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "pbench").rglob("*"))
            if p.is_file() and ".cache" not in p.parts and "__pycache__" not in p.parts}


def test_new_files_make_a_new_cell(tmp_path, capsys):
    root = make_root(tmp_path, pairs=1500)
    before = _digests(root)
    pb = root / "pbench"
    cfg = json.loads((pb / "configs" / "dm-real-10mbp.json").read_text())
    cfg["name"] = "dm-real-tiny-3iso"
    cfg["graph"]["isoforms"] = 3
    (pb / "configs" / "dm-real-tiny-3iso.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "augment-skew.json").read_text())
    mix["abundance"]["lognormal_sigma"] = 0.0
    (pb / "traffic" / "augment-uniform.json").write_text(json.dumps(mix))
    (pb / "layers" / "augment.records_per_job.py").write_text(
        "def install(ctx):\n    pass\n\n\n"
        "def read(run):\n    return 7.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dm-real-tiny-3iso", "source": "test",
                             "file": "pbench/configs/dm-real-tiny-3iso.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "augment-tiny-uniform", "config": "dm-real-tiny-3iso",
                               "traffic": "augment-uniform", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "augment.records_per_job", "unit": "records/job",
                               "better": "higher", "source": "program_counter",
                               "layer": "native engine", "moves": "augment_records_per_s",
                               "workloads": ["augment-tiny-uniform"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("augment_records_per_s", "augment.emit_s"):
            m["workloads"].append("augment-tiny-uniform")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, out = run_cell(root, "augment-tiny-uniform", capsys, trace=0)
    assert rc == 0 and out["correct"]
    assert set(out["metrics"]) == {"augment_records_per_s", "setup_s"}
    rc, out = run_cell(root, "augment-tiny-uniform", capsys, trace=1)
    assert rc == 0 and out["correct"]
    assert out["metrics"]["augment.records_per_job"] == {"value": 7.0, "unit": "records/job"}
    assert set(out["metrics"]) == {"augment.records_per_job", "augment.emit_s"}
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"pbench/configs/dm-real-tiny-3iso.json",
                                        "pbench/traffic/augment-uniform.json",
                                        "pbench/layers/augment.records_per_job.py"}


def test_every_named_file_exists():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = REPO / "pbench"
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        mix = json.loads((pb / "traffic" / f"{w['traffic']}.json").read_text())
        assert (pb / "traffic" / f"{mix['generator']}.py").is_file()
        assert (pb / "stages" / f"{mix['stage']}.py").is_file()
    for m in bench["end_to_end"]:
        assert (pb / "metrics" / f"{m['name']}.py").is_file()
    for m in bench["per_layer"]:
        assert (pb / "layers" / f"{m['name']}.py").is_file()
