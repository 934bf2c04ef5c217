"""The port's coverage scatters vs the JAX package's, exact.

The same seeded numpy inputs go through
``pantas_tpu.coverage.pallas_kernel.sorted_coverage_scatter_add`` (the Pallas
TPU kernel, in interpret mode on the CPU), its XLA scatter, and the port's
``sorted_coverage_scatter_add`` (its plain version on the CPU, which shares
the kernel wrapper's sort and window bounds), ``coverage_scatter_add`` (the
direct kernel's plain version on the CPU) and ``scatter_add_counts``.
Integer adds are exact in any order, so every comparison is equality. The
direct kernel against its Pallas counterpart in interpret mode is in
``test_torch_direct_interpret.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pantas_tpu.coverage.pallas_kernel import (
    coverage_scatter_add as tpu_direct_scatter,
    sorted_coverage_scatter_add as tpu_sorted_scatter,
    xla_scatter_add,
)
from pantas_tpu_torch.coverage import kernels
from pantas_tpu_torch.parallel.mesh import scatter_add_counts


def _case(name):
    """(preloaded counts, index batch) for one named case, from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    mixes = {"mix-5000x4096": (5000, 4096), "mix-40000x8192": (40000, 8192),
             "mix-131072x16384": (1 << 17, 1 << 14)}
    if name in mixes:
        n, m = mixes[name]
        idx = rng.integers(-1, n, size=m, dtype=np.int32)
    elif name == "all-padding":
        n = 5000
        idx = np.full(4096, -1, dtype=np.int32)
    elif name == "last-slot":
        n = 40000  # ragged last window: 40000 = 2 * 16384 + 7232
        idx = rng.integers(-1, n, size=4096, dtype=np.int32)
        idx[::7] = n - 1
    elif name == "all-equal":
        n = 5000
        idx = np.full(4096, 1234, dtype=np.int32)
    elif name == "below-one-window":
        n = 1000
        idx = rng.integers(-1, n, size=2048, dtype=np.int32)
    else:
        raise KeyError(name)
    counts = rng.integers(0, 5, size=n, dtype=np.int32)
    return counts, idx


CASES = ["mix-5000x4096", "mix-40000x8192", "mix-131072x16384",
         "all-padding", "last-slot", "all-equal", "below-one-window"]


def _expected(counts, idx):
    valid = idx[idx >= 0]
    return counts + np.bincount(valid, minlength=len(counts)).astype(np.int32)


@pytest.mark.parametrize("case", CASES)
def test_port_scatter_matches_pallas_and_xla(case):
    counts, idx = _case(case)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(tpu_sorted_scatter(jnp.asarray(counts), jnp.asarray(idx)))
    xla = np.asarray(jax.jit(xla_scatter_add)(jnp.asarray(counts), jnp.asarray(idx)))

    port = kernels.sorted_coverage_scatter_add(
        torch.from_numpy(counts.copy()), torch.from_numpy(idx)
    ).numpy()
    plain = scatter_add_counts(torch.from_numpy(counts.copy()), torch.from_numpy(idx)).numpy()

    expect = _expected(counts, idx)
    assert np.array_equal(pallas, expect)
    assert np.array_equal(xla, expect)
    assert np.array_equal(port, expect)
    assert np.array_equal(plain, expect)


@pytest.mark.parametrize("case", CASES)
def test_port_direct_scatter_matches_xla(case):
    counts, idx = _case(case)
    xla = np.asarray(jax.jit(xla_scatter_add)(jnp.asarray(counts), jnp.asarray(idx)))
    port = kernels.coverage_scatter_add(
        torch.from_numpy(counts.copy()), torch.from_numpy(idx)
    ).numpy()
    assert np.array_equal(port, xla)
    assert np.array_equal(port, _expected(counts, idx))


def test_direct_scatter_refuses_batches_off_the_block_in_both_packages():
    """The JAX kernel asserts ``m % BLOCK == 0``; the port raises ValueError
    on the same batches, on its plain version and its wrapper alike."""
    counts, idx = np.zeros(5000, np.int32), np.zeros(kernels.BLOCK + 8, np.int32)
    with pytest.raises(AssertionError, match=str(kernels.BLOCK)):
        tpu_direct_scatter(jnp.asarray(counts), jnp.asarray(idx))
    for fn in (kernels.coverage_scatter_add, kernels.coverage_scatter_add_plain):
        with pytest.raises(ValueError, match=str(kernels.BLOCK)):
            fn(torch.from_numpy(counts), torch.from_numpy(idx))


def test_direct_scatter_in_place_drops_padding_and_slots_past_n():
    """Slots at or past ``n`` are dropped, as the sorted kernel masks at n."""
    counts = torch.zeros(16, dtype=torch.int32)
    idx = torch.full((kernels.BLOCK,), -1, dtype=torch.int32)
    idx[:5] = torch.tensor([3, 3, 0, 16, 1 << 20], dtype=torch.int32)
    assert kernels.coverage_scatter_add(counts, idx) is counts
    assert counts[3] == 2 and counts[0] == 1 and int(counts.sum()) == 3
    sorted_counts = kernels.sorted_coverage_scatter_add(torch.zeros(16, dtype=torch.int32), idx)
    assert torch.equal(sorted_counts, counts)


def test_scatter_updates_in_place_and_drops_padding():
    counts = torch.zeros(16, dtype=torch.int32)
    idx = torch.tensor([3, -1, 3, 0, -1], dtype=torch.int32)
    out = kernels.sorted_coverage_scatter_add(counts, idx)
    assert out is counts
    assert counts[3] == 2 and counts[0] == 1 and int(counts.sum()) == 3
    assert scatter_add_counts(counts, idx) is counts and int(counts.sum()) == 6


def test_window_bounds_partition_the_sorted_stream():
    """bounds[c] .. bounds[c+1] holds exactly the slots of window c; the
    padding lies before bounds[0]."""
    counts, idx = _case("last-slot")
    s, bounds = kernels.sorted_window_bounds(torch.from_numpy(idx), len(counts))
    s, bounds = s.numpy(), bounds.numpy()
    assert bounds.dtype == np.int32 and len(bounds) == -(-len(counts) // kernels.WINDOW) + 1
    assert bounds[0] == np.count_nonzero(idx < 0) and bounds[-1] == len(idx)
    for c in range(len(bounds) - 1):
        seg = s[bounds[c] : bounds[c + 1]]
        assert ((seg // kernels.WINDOW) == c).all()


@pytest.mark.parametrize(
    "counts, idx, err",
    [
        (torch.zeros(8, dtype=torch.int64), torch.zeros(2, dtype=torch.int32), TypeError),
        (torch.zeros(8, dtype=torch.int32), torch.zeros(2, dtype=torch.int64), TypeError),
        (torch.zeros(16, dtype=torch.int32)[::2], torch.zeros(2, dtype=torch.int32), ValueError),
        (torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, dtype=torch.int32), ValueError),
        (torch.zeros(8, dtype=torch.int32, device="meta"),
         torch.zeros(2, dtype=torch.int32, device="meta"), ValueError),
    ],
    ids=["counts-int64", "idx-int64", "strided", "2-d", "meta-device"],
)
def test_scatter_rejects_what_the_kernel_does_not_take(counts, idx, err):
    with pytest.raises(err):
        kernels.sorted_coverage_scatter_add(counts, idx)
    with pytest.raises(err):
        kernels.coverage_scatter_add(counts, idx)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda):
    for case in CASES:
        counts, idx = _case(case)
        d_idx = torch.from_numpy(idx).to(cuda)
        got = torch.from_numpy(counts).to(cuda)
        want = got.clone()
        before = kernels.LAUNCHES["sorted_coverage_scatter_add"]
        kernels.sorted_coverage_scatter_add(got, d_idx)
        scatter_add_counts(want, d_idx)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["sorted_coverage_scatter_add"] == before + 1
        assert torch.equal(got, want), case
        assert np.array_equal(got.cpu().numpy(), _expected(counts, idx)), case


@pytest.mark.cuda
def test_cuda_direct_kernel_matches_plain(cuda):
    for case in CASES:
        counts, idx = _case(case)
        d_idx = torch.from_numpy(idx).to(cuda)
        got = torch.from_numpy(counts).to(cuda)
        want = got.clone()
        before = kernels.LAUNCHES["coverage_scatter_add"]
        kernels.coverage_scatter_add(got, d_idx)
        kernels.coverage_scatter_add_plain(want, d_idx)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["coverage_scatter_add"] == before + 1
        assert torch.equal(got, want), case
        assert np.array_equal(got.cpu().numpy(), _expected(counts, idx)), case
