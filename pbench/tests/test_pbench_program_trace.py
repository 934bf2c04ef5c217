"""The per-layer metrics that read the program's own spans and counters
(``pbench/program_trace.py``): a ``--trace 1`` run of the tiny cell reports
each of them beside the benchmark's older metrics, a ``--trace 0`` run loads
none of them, and a program without the tracing module leaves them out."""

from __future__ import annotations

import json
import sys

from conftest import REPO, run_cell

CELL = "augment-dmreal10-skew"


def _program_metrics() -> set:
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    return {m["name"] for m in bench["per_layer"] if m["source"] != "device_trace"
            and (REPO / "pbench" / "layers" / f"{m['name']}.py").read_text().count("program_trace")}


def test_traced_run_reports_the_program_metrics(tiny_root, capsys):
    from pantas_tpu_torch import trace

    new = _program_metrics()
    assert len(new) == 9
    rc, out = run_cell(tiny_root, CELL, capsys, trace=1)
    assert rc == 0 and out["correct"]
    metrics = out["metrics"]
    older = {"augment.tensorize_s", "augment.parse_s", "augment.emit_s", "augment.feed_s",
             "augment.readback_s"}
    assert new | older <= set(metrics)
    for name in new | older:
        assert metrics[name]["unit"] == "s/replicate" and metrics[name]["value"] > 0, name
    assert metrics["device.h2d_s"]["value"] <= metrics["device.add_slots_s"]["value"]
    assert metrics["native.emit_format_s"]["value"] < metrics["native.emit_s"]["value"]
    assert not trace.enabled()  # off again once the window has closed

    rc, out = run_cell(tiny_root, CELL, capsys, trace=0)
    assert rc == 0 and out["correct"]
    assert set(out["metrics"]) == {"augment_records_per_s", "setup_s"}


def test_program_without_tracing_reports_none(tiny_root, capsys, monkeypatch):
    """A program that lacks ``pantas_tpu_torch.trace``, as the commit before
    it: the run succeeds and the new metrics are left out."""
    monkeypatch.setitem(sys.modules, "pantas_tpu_torch.trace", None)  # import raises
    rc, out = run_cell(tiny_root, CELL, capsys, trace=1)
    assert rc == 0 and out["correct"]
    assert not _program_metrics() & set(out["metrics"])
    assert "augment.emit_s" in out["metrics"]
