"""The kernel library's name follows every file its build reads.

``pantas_tpu_torch.coverage._build.library_path`` only hashes, so this runs
with no compiler: a temporary ``csrc/`` stands in for the package's, and the
name must move when a source or a header changes (a header that changed under
an unchanged name would leave a stale library in ``build/kernels/``, and the
scatter verdict's key, which holds the same hash, would not move either).
"""

import shutil

import pytest

from pantas_tpu_torch.coverage import _build, scatter_impls


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the package's ``csrc/`` that ``_build`` reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _touch(path):
    with open(path, "a") as fh:
        fh.write("// changed\n")


CHANGES = {
    "source": lambda d: _touch(d / "coverage_direct.cu"),
    "header": lambda d: _touch(d / "device_guard.cuh"),
    "new-cuh": lambda d: (d / "extra.cuh").write_text("#pragma once\n"),
    "new-h": lambda d: (d / "extra.h").write_text("#pragma once\n"),
    "renamed-header": lambda d: (d / "device_guard.cuh").rename(d / "guard.cuh"),
}


def test_the_copy_names_the_same_library(csrc):
    name = _build.library_path().name
    assert name.startswith("libpantas_kernels_") and name.endswith(".so")
    assert (csrc / "device_guard.cuh").exists()
    assert _build.library_path().name == name  # stable for unchanged bytes


@pytest.mark.parametrize("change", CHANGES)
def test_library_name_moves_with_every_file_the_build_reads(change, csrc, monkeypatch):
    monkeypatch.setattr(scatter_impls.torch.cuda, "get_device_name", lambda dev=None: "card")
    before = _build.library_path().name
    key = scatter_impls._backend_key(1 << 20, 1 << 11, "cuda:0")
    CHANGES[change](csrc)
    assert _build.library_path().name != before
    assert scatter_impls._backend_key(1 << 20, 1 << 11, "cuda:0") != key  # the verdict's key too


def test_library_name_ignores_what_the_build_does_not_read(csrc):
    before = _build.library_path().name
    (csrc / "NOTES.md").write_text("not a source\n")
    assert _build.library_path().name == before


def test_hashed_files_are_the_sources_and_their_headers(csrc):
    hashed = {f.name for f in _build._hashed_files()}
    assert "device_guard.cuh" in hashed
    assert {f.name for f in csrc.glob("*.cu")} == {"coverage_direct.cu", "coverage_scatter.cu"}
    assert hashed == {"coverage_direct.cu", "coverage_scatter.cu", "device_guard.cuh"}
