"""The port's graft entry points (``pantas_tpu_torch/graft_entry.py``)
against ``__graft_entry__.py``: the same example arguments, the same counts
after one step (exact, integers), and the multi-device dry run on logical
meshes of the CPU device."""

import numpy as np
import pytest
import torch

from pantas_tpu_torch import graft_entry


def test_entry_equals_the_jax_entry():
    import __graft_entry__ as theirs

    fn, (counts, idx) = graft_entry.entry("cpu")
    jfn, (jcounts, jidx) = theirs.entry()
    assert counts.dtype == torch.int32 and idx.dtype == torch.int32
    assert counts.device.type == idx.device.type == "cpu"
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    got = fn(counts, idx).numpy()
    assert np.array_equal(got, np.asarray(jfn(jcounts, jidx)))
    raw = idx.numpy()
    assert np.array_equal(got, np.bincount(raw[raw >= 0], minlength=4096))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip_on_a_logical_cpu_mesh(n, capsys):
    graft_entry.dryrun_multichip(n, "cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"dryrun_multichip({n}): OK — counts sum 1000, ")
    assert line.endswith("call candidate-axis sharding hit-identical")


def test_dryrun_multichip_takes_a_device_list(capsys):
    graft_entry.dryrun_multichip(4, "cuda", devices=["cpu"] * 4)
    assert "dryrun_multichip(4): OK" in capsys.readouterr().out
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        graft_entry.dryrun_multichip(4, "cpu", devices=["cpu"] * 2)


def test_too_few_cards_raise_and_never_move_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices but only 1"):
        graft_entry.dryrun_multichip(4)


def test_a_race_is_refused_on_the_mesh(monkeypatch):
    monkeypatch.setenv("PANTAS_SCATTER", "race")
    with pytest.raises(ValueError, match="race"):
        graft_entry.dryrun_multichip(2, "cpu")
