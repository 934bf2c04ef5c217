"""The port's coverage scatters vs the JAX package's, exact.

The same seeded numpy inputs go through
``pantas_tpu.coverage.pallas_kernel.sorted_coverage_scatter_add`` (the Pallas
TPU kernel, in interpret mode on the CPU), its XLA scatter, and the port's
``sorted_coverage_scatter_add`` (its plain version on the CPU: the plain
window partition, then a ``bincount`` per window), ``coverage_scatter_add``
(the direct kernel's plain version on the CPU) and ``scatter_add_counts``.
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
    elif name == "heavy-window":
        n = 1 << 17  # 8 windows; 3/4 of the batch spread over window 3's slots
        idx = rng.integers(-1, n, size=8192, dtype=np.int32)
        heavy = rng.random(8192) < 0.75
        idx[heavy] = rng.integers(3 * 16384, 4 * 16384, size=int(heavy.sum()), dtype=np.int32)
    elif name == "negatives":
        n = 40000  # every negative index is dropped, not only the -1 padding
        idx = rng.integers(-1, n, size=4096, dtype=np.int32)
        idx[::5] = -2
        idx[1::7] = -7
        idx[2::11] = np.iinfo(np.int32).min
    elif name == "runs-cross-block":
        n = 5000  # long runs of equal neighbours, over the 2,048 boundary and to the batch's end
        idx = np.repeat(rng.integers(0, n, size=64, dtype=np.int32),
                        rng.integers(1, 300, size=64))[:4096]
        idx = np.resize(idx, 4096).astype(np.int32)
        idx[:130] = 0  # longer than a warp's 128 consecutive indices
        idx[1900:2200] = 77
        idx[2200:2204] = [78, 78, 77, 77]  # the same slot again after a break
        idx[4000:] = n - 1
    elif name == "equal-far-apart":
        n = 40000  # equal slots 61 places apart, and slots equal modulo 256, 4,096 and 8,192
        slots = np.concatenate([5 + 256 * np.arange(20), 9 + 4096 * np.arange(9),
                                [5 + 8192, 5 + 16384, 5 + 32768], rng.integers(0, n, size=29)])
        idx = slots[np.arange(4096) % len(slots)].astype(np.int32)
        idx[rng.random(4096) < 0.05] = -1
    elif name == "past-n":
        n = 5000  # slots at and past n are dropped (the direct scatters only)
        idx = rng.integers(-1, n + 50, size=2048, dtype=np.int32)
        idx[100:140] = n
        idx[140:150] = n - 1
        idx[500:520] = [n + 1, 8191, 8192, np.iinfo(np.int32).max] * 5
    elif name == "at-n":
        n = 5000  # slots at and just past n, inside the TPU kernel's last (8, 128) tile of counts
        idx = rng.integers(-1, n, size=2048, dtype=np.int32)
        idx[100:140] = n
        idx[140:150] = n - 1
        idx[500:520] = [n + 1, n + 119] * 10
    else:
        raise KeyError(name)
    counts = rng.integers(0, 5, size=n, dtype=np.int32)
    return counts, idx


CASES = ["mix-5000x4096", "mix-40000x8192", "mix-131072x16384",
         "all-padding", "last-slot", "all-equal", "below-one-window",
         "heavy-window", "negatives", "runs-cross-block", "equal-far-apart"]
# the direct scatters also mask at n, as the XLA scatter drops what is out of bounds
DIRECT_CASES = [*CASES, "at-n", "past-n"]


def _expected(counts, idx):
    valid = idx[(idx >= 0) & (idx < len(counts))]
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


@pytest.mark.parametrize("case", DIRECT_CASES)
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


@pytest.mark.parametrize("case", ["mix-5000x4096", "runs-cross-block", "past-n"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_direct_scatter_takes_a_batch_off_the_16_byte_boundary(case, offset):
    """A contiguous view that starts ``offset`` int32 into its storage is a
    batch like any other: not refused, not copied, same counts. (On the CPU
    the wrapper runs its plain version; the card's test is
    ``test_cuda_direct_kernel_on_a_misaligned_view``.)"""
    counts, idx = _case(case)
    storage = torch.from_numpy(np.concatenate([np.full(offset, 7, np.int32), idx]))
    view = storage[offset:]
    assert view.is_contiguous() and view.data_ptr() == storage.data_ptr() + 4 * offset
    assert view.data_ptr() % 16 != storage.data_ptr() % 16
    before = storage.clone()
    got = kernels.coverage_scatter_add(torch.from_numpy(counts.copy()), view).numpy()
    assert np.array_equal(got, _expected(counts, idx))
    assert torch.equal(storage, before)


def test_direct_scatter_in_place_drops_padding_and_slots_past_n():
    """Slots at or past ``n`` are dropped, as the sorted kernel masks at n;
    the sorted path's partition already drops slots at or past
    ``n_windows * WINDOW`` (here 16384 and up)."""
    counts = torch.zeros(16, dtype=torch.int32)
    idx = torch.full((kernels.BLOCK,), -1, dtype=torch.int32)
    idx[:7] = torch.tensor([3, 3, 0, 16, 1 << 20, kernels.WINDOW, kernels.INT32_MAX],
                           dtype=torch.int32)
    assert kernels.coverage_scatter_add(counts, idx) is counts
    assert counts[3] == 2 and counts[0] == 1 and int(counts.sum()) == 3
    sorted_counts = kernels.sorted_coverage_scatter_add(torch.zeros(16, dtype=torch.int32), idx)
    assert torch.equal(sorted_counts, counts)
    bucketed, bounds = kernels.window_partition(idx, 16)
    assert bounds.tolist() == [0, 4]
    assert sorted(bucketed[:4].tolist()) == [0, 3, 3, 16]


def test_scatter_updates_in_place_and_drops_padding():
    counts = torch.zeros(16, dtype=torch.int32)
    idx = torch.tensor([3, -1, 3, 0, -1], dtype=torch.int32)
    out = kernels.sorted_coverage_scatter_add(counts, idx)
    assert out is counts
    assert counts[3] == 2 and counts[0] == 1 and int(counts.sum()) == 3
    assert scatter_add_counts(counts, idx) is counts and int(counts.sum()) == 6


def _segments(bucketed, bounds):
    """Each window's segment of the partitioned stream, sorted."""
    return [np.sort(bucketed[bounds[c] : bounds[c + 1]]) for c in range(len(bounds) - 1)]


def _kept_by_window(idx, n):
    n_windows = -(-n // kernels.WINDOW)
    kept = idx[(idx >= 0) & (idx < n_windows * kernels.WINDOW)]
    return kept, [np.sort(kept[kept // kernels.WINDOW == c]) for c in range(n_windows)]


@pytest.mark.parametrize("case", CASES)
def test_window_partition_contract(case):
    """bounds[c] .. bounds[c+1] holds exactly the multiset of kept slots of
    window c; bounds[0] == 0 and bounds[-1] is the number kept."""
    counts, idx = _case(case)
    bucketed, bounds = kernels.window_partition(torch.from_numpy(idx), len(counts))
    bucketed, bounds = bucketed.numpy(), bounds.numpy()
    kept, want = _kept_by_window(idx, len(counts))
    assert bounds.dtype == np.int32 and len(bounds) == len(want) + 1
    assert len(bucketed) == len(idx)
    assert bounds[0] == 0 and bounds[-1] == len(kept)
    assert all(np.array_equal(got, w) for got, w in zip(_segments(bucketed, bounds), want))


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


def _sorted_once(counts, idx):
    """The sorted kernel once, checking that it counted exactly one launch."""
    before = kernels.LAUNCHES["sorted_coverage_scatter_add"]
    kernels.sorted_coverage_scatter_add(counts, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sorted_coverage_scatter_add"] == before + 1


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda):
    for case in CASES:
        counts, idx = _case(case)
        d_idx = torch.from_numpy(idx).to(cuda)
        got = torch.from_numpy(counts).to(cuda)
        want = got.clone()
        _sorted_once(got, d_idx)
        scatter_add_counts(want, d_idx)
        assert torch.equal(got, want), case
        assert np.array_equal(got.cpu().numpy(), _expected(counts, idx)), case


@pytest.mark.cuda
def test_cuda_window_partition_matches_plain(cuda):
    """The CUDA partition equals its plain version window by window, as
    sorted segments (the order inside a window is free)."""
    for case in CASES:
        counts, idx = _case(case)
        d_idx = torch.from_numpy(idx).to(cuda)
        before = dict(kernels.LAUNCHES)
        got_b, got_bounds = kernels.window_partition(d_idx, len(counts))
        want_b, want_bounds = kernels.window_partition_plain(d_idx, len(counts))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == before, case
        got_bounds, want_bounds = got_bounds.cpu().numpy(), want_bounds.cpu().numpy()
        assert np.array_equal(got_bounds, want_bounds), case
        got, want = _segments(got_b.cpu().numpy(), got_bounds), _segments(want_b.cpu().numpy(), want_bounds)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), case


@pytest.mark.cuda
def test_cuda_heavy_window_spans_ctas(cuda):
    """One window holds 2^18 entries, 128 work items of CHUNK: they run on
    many CTAs at once and add into the same slots; exact against
    index_add_. A second batch puts 2^18 entries on one slot."""
    rng = np.random.default_rng(18)
    n = 1 << 20
    idx = rng.integers(-1, n, size=1 << 19, dtype=np.int32)
    idx[: 1 << 18] = rng.integers(5 * kernels.WINDOW, 6 * kernels.WINDOW, size=1 << 18)
    assert (1 << 18) > 64 * kernels.CHUNK
    for batch in (idx, np.where(np.arange(len(idx)) % 2 == 0, 5 * kernels.WINDOW + 7, idx)):
        d_idx = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.int32)).to(cuda)
        got = torch.zeros(n, dtype=torch.int32, device=cuda)
        want = got.clone()
        _sorted_once(got, d_idx)
        scatter_add_counts(want, d_idx)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_count_pass_above_the_shared_cap(cuda):
    """More windows than the shared window-id histogram holds: the count and
    scatter passes take their global-atomic path; exact against index_add_,
    partition equal to its plain version."""
    n = (kernels.PARTITION_CAP + 3) * kernels.WINDOW - 5  # ragged last window
    free, _ = torch.cuda.mem_get_info(cuda)
    if free < 3 * 4 * n:
        pytest.skip(f"needs {3 * 4 * n} B free on the card, has {free}")
    rng = np.random.default_rng(29)
    idx = rng.integers(-3, n + 10, size=1 << 20, dtype=np.int32)
    idx[:4096] = n - 1
    d_idx = torch.from_numpy(idx).to(cuda)
    got = torch.zeros(n, dtype=torch.int32, device=cuda)
    want = got.clone()
    _sorted_once(got, d_idx)
    scatter_add_counts(want, torch.where(d_idx < n, d_idx, -1))
    assert torch.equal(got, want)
    del got, want
    got_b, got_bounds = kernels.window_partition(d_idx, n)
    want_b, want_bounds = kernels.window_partition_plain(d_idx, n)
    got_bounds, want_bounds = got_bounds.cpu().numpy(), want_bounds.cpu().numpy()
    assert np.array_equal(got_bounds, want_bounds)
    got, want = _segments(got_b.cpu().numpy(), got_bounds), _segments(want_b.cpu().numpy(), want_bounds)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def _direct_once(counts, idx):
    """The direct kernel once, checking that it counted exactly one launch."""
    before = kernels.LAUNCHES["coverage_scatter_add"]
    kernels.coverage_scatter_add(counts, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["coverage_scatter_add"] == before + 1


@pytest.mark.cuda
def test_cuda_direct_kernel_matches_plain(cuda):
    for case in DIRECT_CASES:
        counts, idx = _case(case)
        d_idx = torch.from_numpy(idx).to(cuda)
        want = torch.from_numpy(counts).to(cuda)
        kernels.coverage_scatter_add_plain(want, d_idx)
        assert np.array_equal(want.cpu().numpy(), _expected(counts, idx)), case
        got = torch.from_numpy(counts).to(cuda)
        _direct_once(got, d_idx)
        assert torch.equal(got, want), case


@pytest.mark.cuda
def test_cuda_direct_kernel_on_one_slot_and_long_runs(cuda):
    """2^20 indices all on one slot; 2^24 indices (every warp of the
    persistent grid takes many rounds of its loop) in runs of 1 to 5,000
    equal neighbours, which cross lanes, rows, steps, CTAs and rounds; 97
    slots 16,384 apart, each named ~10,000 times, far from each other; a
    batch of BLOCK indices; all padding. Exact against index_add_."""
    rng = np.random.default_rng(20)
    n, m = 1 << 22, 1 << 20
    runs = np.repeat(rng.integers(-1, n, size=8192, dtype=np.int32),
                     rng.integers(1, 5000, size=8192))[: 1 << 24]
    assert len(runs) == 1 << 24
    far_apart = (3 + (1 << 14) * rng.integers(0, 97, size=m)).astype(np.int32)
    batches = {
        "one-slot": np.full(m, n // 3, dtype=np.int32),
        "runs": runs,
        "far-apart": far_apart,
        "one-block": rng.integers(-1, n, size=kernels.BLOCK, dtype=np.int32),
        "all-padding": np.full(m, -1, dtype=np.int32),
    }
    for what, idx in batches.items():
        d_idx = torch.from_numpy(idx).to(cuda)
        want = torch.zeros(n, dtype=torch.int32, device=cuda)
        scatter_add_counts(want, d_idx)
        assert int(want.sum()) == int((idx >= 0).sum()), what
        got = torch.zeros(n, dtype=torch.int32, device=cuda)
        _direct_once(got, d_idx)
        assert torch.equal(got, want), what


@pytest.mark.cuda
def test_cuda_direct_kernel_on_a_misaligned_view(cuda):
    """The batch starts 4, 8 and 12 bytes past a 16-byte boundary: the
    kernel takes the head and the tail one by one; nothing is copied."""
    rng = np.random.default_rng(16)
    n, m = 100_000, 4 * kernels.BLOCK
    for offset in (1, 2, 3):
        idx = rng.integers(-1, n, size=m + offset, dtype=np.int32)
        idx[offset : offset + 300] = 4242  # a run that starts in the scalar head
        idx[-200:] = 99_999  # and one that ends in the scalar tail
        view = torch.from_numpy(idx).to(cuda)[offset:]
        assert view.data_ptr() % 16 == 4 * offset and view.numel() == m
        want = torch.zeros(n, dtype=torch.int32, device=cuda)
        scatter_add_counts(want, view)
        got = torch.zeros(n, dtype=torch.int32, device=cuda)
        _direct_once(got, view)
        assert torch.equal(got, want), offset


@pytest.mark.cuda
def test_cuda_direct_kernel_makes_the_tensors_device_current(cuda):
    """``counts`` on ``cuda:1`` while ``cuda:0`` is current: the kernel runs
    on ``cuda:1``'s stream and the caller's device is current afterwards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: one card cannot show a missing device guard")
    other = torch.device("cuda", 1)
    rng = np.random.default_rng(21)
    n = 100_000
    idx = torch.from_numpy(rng.integers(-1, n, size=4 * kernels.BLOCK, dtype=np.int32)).to(other)
    got = torch.zeros(n, dtype=torch.int32, device=other)
    want = got.clone()
    with torch.cuda.device(0):
        _direct_once(got, idx)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(other)
    scatter_add_counts(want, idx)
    assert torch.equal(got, want)
