"""A run with the timed path broken underneath comes out not correct: for
each fault the cells can have, the harness drives a whole run on the CPU (its
look for a card skipped) with the fault planted in the program, and reads
``correct`` false. The cells run on one card, so no exchange between cards
can be left out."""

from __future__ import annotations

import numpy as np
import pytest
from conftest import run_cell

AUGMENT = "augment-dmreal10-skew"


def test_sound_runs_are_correct(tiny_root, capsys):
    rc, out = run_cell(tiny_root, AUGMENT, capsys)
    assert rc == 0 and out["correct"], out


def _unchanged(monkeypatch):
    from pantas_tpu_torch.coverage.device import DeviceCoverage

    monkeypatch.setattr(DeviceCoverage, "add_slots", lambda self, slots, pad_to=None: None)


def _half_batch(monkeypatch):
    from pantas_tpu_torch.coverage.device import DeviceCoverage

    inner = DeviceCoverage.add_slots

    def add_slots(self, slots, pad_to=None):
        half = np.array(slots, copy=True)
        valid = np.flatnonzero(half >= 0)
        half[valid[len(valid) // 2:]] = -1
        return inner(self, half, pad_to=pad_to)

    monkeypatch.setattr(DeviceCoverage, "add_slots", add_slots)


def _count_altered(monkeypatch):
    from pantas_tpu_torch.native.gafcov import NativeCoverage

    inner = NativeCoverage.set_counts

    def set_counts(self, flat):
        flat = np.array(flat, copy=True)
        flat[int(np.flatnonzero(flat)[0])] += 1
        return inner(self, flat)

    monkeypatch.setattr(NativeCoverage, "set_counts", set_counts)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _count_altered],
                         ids=["step-unchanged", "half-batch", "answer-altered"])
def test_augment_fault_is_caught(tiny_root, capsys, monkeypatch, fault):
    fault(monkeypatch)
    rc, out = run_cell(tiny_root, AUGMENT, capsys)
    assert rc == 0 and out["correct"] is False
    assert out["checks"]["gfa_jobs_differ"]["value"] == out["attempted"]
