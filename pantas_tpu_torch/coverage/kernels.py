"""Coverage scatter-add, ``counts[idx] += 1`` for every ``idx >= 0``.

Two hand-written kernels, each with its plain PyTorch version:

- :func:`sorted_coverage_scatter_add` replaces
  ``pantas_tpu/coverage/pallas_kernel.py::sorted_coverage_scatter_add``. The
  batch is not sorted: it is partitioned by window of :data:`WINDOW` count
  slots with a one-digit counting sort on ``slot >> 14``
  (:func:`window_partition`), and each window's bucket becomes a histogram
  added into its slots by a persistent grid of CTAs
  (``csrc/coverage_scatter.cu``; one C call per batch).
- :func:`coverage_scatter_add` replaces
  ``pantas_tpu/coverage/pallas_kernel.py::coverage_scatter_add``: no
  partition; a persistent grid reads the batch with 16-byte streaming loads,
  each warp lays its 128 consecutive indices out so that the lanes of one
  atomic instruction hold neighbouring indices, folds each run of equal
  neighbours with shuffles and ballots, and adds each run once with a global
  atomic (``csrc/coverage_direct.cu``). Its batches are a multiple of
  :data:`BLOCK`, as the TPU kernel's are.

On the card both are bound by memory traffic, not by arithmetic: the counts
vector reaches 1 GiB at genome scale while a batch holds 2^20 indices, so
each kernel touches only the slots its indices name, with no padding copy
of ``counts``.

``counts`` is updated in place (the JAX step donated its buffer for the same
reason: an undonated 1 GiB update would copy it every batch).
"""

from __future__ import annotations

import functools

import torch

from pantas_tpu_torch.coverage import _build
from pantas_tpu_torch.parallel.mesh import scatter_add_counts

WINDOW_SHIFT = 14
WINDOW = 1 << WINDOW_SHIFT  # slots per window; equals kWindow in csrc/coverage_scatter.cu
CHUNK = 2048  # most entries of one histogram work item; equals kChunk there
PARTITION_CAP = 16384  # most windows counted in shared memory; equals kCountCap there
PARTITION_CTAS_PER_SM = 1  # partition grid bound: its per-(CTA, window) atomics grow with it
BLOCK = 2048  # batch granule of the direct kernel; equals kBlock in csrc/coverage_direct.cu
INT32_MAX = 2**31 - 1

# kernel launches in this process, by wrapper; chip_smoke.py reads them to
# prove which kernel a path ran through
LAUNCHES = {"sorted_coverage_scatter_add": 0, "coverage_scatter_add": 0}

_checked_lib = None


def _check_idx(idx: torch.Tensor) -> None:
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("idx must be 1-D and contiguous")
    if idx.numel() > INT32_MAX:
        raise ValueError(f"{idx.numel()} indices exceed int32 positions")


def _n_windows(n: int) -> int:
    n_windows = -(-n // WINDOW)
    if n < 0 or n_windows * WINDOW > INT32_MAX:
        raise ValueError(f"{n} count slots exceed int32 window arithmetic")
    return n_windows


def _check(counts: torch.Tensor, idx: torch.Tensor) -> int:
    if counts.dtype != torch.int32:
        raise TypeError(f"counts must be int32, got {counts.dtype}")
    if counts.dim() != 1 or not counts.is_contiguous():
        raise ValueError("counts must be 1-D and contiguous")
    _check_idx(idx)
    if counts.device != idx.device:
        raise ValueError(f"counts on {counts.device} but idx on {idx.device}")
    n = counts.numel()
    _n_windows(n)
    return n


def window_partition_plain(idx: torch.Tensor, n: int):
    """:func:`window_partition`'s plain PyTorch version: a mask, ``bincount``
    of the window ids, ``cumsum``, and a stable ``argsort`` of the window ids
    (dropped indices take id ``n_windows`` and go last)."""
    _check_idx(idx)
    n_windows = _n_windows(n)
    keep = (idx >= 0) & (idx < n_windows * WINDOW)
    win = torch.where(keep, idx >> WINDOW_SHIFT, n_windows)
    bounds = torch.zeros(n_windows + 1, dtype=torch.int32, device=idx.device)
    bounds[1:] = torch.cumsum(torch.bincount(win[keep], minlength=n_windows), 0)
    return idx[torch.argsort(win, stable=True)], bounds


def window_partition(idx: torch.Tensor, n: int):
    """``(bucketed, bounds)``: the batch bucketed by window of :data:`WINDOW`
    slots, for ``n`` count slots.

    ``bounds`` is int32, one per window plus one: ``bucketed[bounds[c] :
    bounds[c + 1]]`` holds exactly the kept slots of window ``c``, in no
    particular order; ``bounds[0] == 0`` and ``bounds[-1]`` is the number of
    kept indices. Kept are ``0 <= idx < n_windows * WINDOW``; any negative
    index is dropped. ``bucketed`` has ``idx.numel()`` entries; those past
    ``bounds[-1]`` are unspecified.

    On a CUDA tensor this launches only the partition passes of
    ``csrc/coverage_scatter.cu`` on the current stream (it does not count in
    :data:`LAUNCHES`); on a CPU tensor it runs :func:`window_partition_plain`.
    """
    if idx.device.type == "cpu":
        return window_partition_plain(idx, n)
    _check_cuda(idx)
    _check_idx(idx)
    n_windows = _n_windows(n)
    buf, ptr, at = _scratch(idx.device, n_windows, idx.numel(), with_items=False)
    lib = _lib()
    err = lib.coverage_window_partition(
        idx.device.index, idx.data_ptr(), idx.numel(), n_windows, ptr["ctas"],
        ptr["bucketed"], ptr["bounds"], ptr["win_count"], ptr["cta_off"],
        _stream(idx.device),
    )
    _raise_on(lib, err, "coverage_window_partition")
    return buf[at["bucketed"] :], buf[at["bounds"] : at["bounds"] + n_windows + 1]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _scratch(device: torch.device, n_windows: int, m: int, with_items: bool):
    """One int32 allocation for the partition and histogram passes, laid out
    ``[items | item_start | win_count | bounds | cta_off | bucketed]`` (the int4 work items
    first, so that they are 16-byte aligned), the addresses of its parts,
    and their offsets in it.

    ``ctas`` is the partition grid's bound: :data:`PARTITION_CTAS_PER_SM` a
    SM. ``cta_off`` holds one row of window offsets per partition CTA when
    the window ids fit the shared histogram (:data:`PARTITION_CAP`)."""
    ctas = _sm_count(device.index) * PARTITION_CTAS_PER_SM
    max_items = min(n_windows, m) + m // CHUNK if with_items else 0
    sizes = {
        "items": 4 * max_items,
        "item_start": n_windows + 1 if with_items else 0,
        "win_count": n_windows + 1,
        "bounds": n_windows + 1,
        "cta_off": ctas * n_windows if n_windows <= PARTITION_CAP else 0,
        "bucketed": m,
    }
    buf = torch.empty(sum(sizes.values()), dtype=torch.int32, device=device)
    ptr, at, offset = {"ctas": ctas}, {}, 0
    for name, size in sizes.items():
        ptr[name], at[name] = buf.data_ptr() + 4 * offset, offset
        offset += size
    return buf, ptr, at


def sorted_coverage_scatter_add_plain(counts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: the same checks, the plain window
    partition, then one ``torch.bincount`` per non-empty window, masked at
    ``n``."""
    n = _check(counts, idx)
    bucketed, bounds = window_partition_plain(idx, n)
    for c in torch.nonzero(bounds[1:] > bounds[:-1]).flatten().tolist():
        lo, hi = int(bounds[c]), int(bounds[c + 1])
        base = c * WINDOW
        width = min(WINDOW, n - base)
        hist = torch.bincount(bucketed[lo:hi] - base, minlength=WINDOW)[:width]
        counts[base : base + width] += hist.to(counts.dtype)
    return counts


def sorted_coverage_scatter_add(counts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``counts[idx] += 1`` for ``0 <= idx < n`` (any negative index is
    padding), in place.

    On a CUDA tensor this makes one C call that launches the window partition
    and the histogram pass on the current stream, with no synchronisation,
    and raises if a launch fails; on a CPU tensor it runs
    :func:`sorted_coverage_scatter_add_plain`. Any other device raises.
    """
    if counts.device.type == "cpu":
        return sorted_coverage_scatter_add_plain(counts, idx)
    _check_cuda(counts)
    n = _check(counts, idx)
    n_windows = _n_windows(n)
    # held until the launches are queued; the caching allocator then reuses
    # it in stream order
    scratch, ptr, _ = _scratch(counts.device, n_windows, idx.numel(), with_items=True)
    lib = _lib()
    err = lib.coverage_scatter_sorted(
        counts.device.index, counts.data_ptr(), n, idx.data_ptr(), idx.numel(), ptr["ctas"],
        ptr["bucketed"], ptr["bounds"], ptr["win_count"], ptr["cta_off"], ptr["item_start"],
        ptr["items"],
        _stream(counts.device),
    )
    del scratch
    _raise_on(lib, err, "coverage_scatter_sorted")
    LAUNCHES["sorted_coverage_scatter_add"] += 1
    return counts


def _check_direct(counts: torch.Tensor, idx: torch.Tensor) -> int:
    n = _check(counts, idx)
    if idx.numel() % BLOCK:
        # the JAX kernel asserts the same (pallas_kernel.py:43)
        raise ValueError(f"index batch of {idx.numel()} must be padded to a multiple of {BLOCK}")
    return n


def coverage_scatter_add_plain(counts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The direct kernel's plain PyTorch version: the same checks, then a
    masked ``index_add_`` that also drops slots at or past ``n``."""
    n = _check_direct(counts, idx)
    return scatter_add_counts(counts, torch.where(idx < n, idx, -1))


def coverage_scatter_add(counts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``counts[idx] += 1`` for ``0 <= idx < n`` (any negative index is
    padding), in place; ``idx.numel()`` must be a multiple of :data:`BLOCK`.

    ``idx`` may be a contiguous view that starts at any element of its
    storage: the kernel reads the batch as 16-byte vectors from the first
    aligned address and takes the few indices before and after them one by
    one, so a misaligned batch is neither refused nor copied.

    On a CUDA tensor this makes ``counts``' device current, launches the
    direct kernel on that device's current stream with no synchronisation,
    and raises if the launch fails; on a CPU tensor it runs
    :func:`coverage_scatter_add_plain`. Any other device raises.
    """
    dev = counts.device
    if dev.type == "cpu":
        return coverage_scatter_add_plain(counts, idx)
    _check_cuda(counts)
    n = _check_direct(counts, idx)
    lib = _lib()
    err = lib.coverage_scatter_direct(
        dev.index, counts.data_ptr(), n, idx.data_ptr(), idx.numel(), _stream(dev),
    )
    _raise_on(lib, err, "coverage_scatter_direct")
    LAUNCHES["coverage_scatter_add"] += 1
    return counts


def _check_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no coverage scatter kernel for device {t.device}")


def _stream(device: torch.device) -> int:
    """The current CUDA stream's handle on ``device``: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without building
    a ``Stream`` object (that took ~8 us a call on the card; PyTorch's own
    compiler reads the handle the same way)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _lib():
    """The kernel library, its constants checked against this module's once."""
    global _checked_lib
    if _checked_lib is None:
        lib = _build.load()
        got = {
            "WINDOW": (lib.coverage_scatter_window(), WINDOW),
            "CHUNK": (lib.coverage_scatter_chunk(), CHUNK),
            "PARTITION_CAP": (lib.coverage_partition_cap(), PARTITION_CAP),
            "BLOCK": (lib.coverage_direct_block(), BLOCK),
        }
        bad = {k: v for k, v in got.items() if v[0] != v[1]}
        if bad:
            raise RuntimeError(f"csrc constants disagree with kernels.py (csrc, py): {bad}")
        _checked_lib = lib
    return _checked_lib


def _raise_on(lib, err: int, entry: str) -> None:
    if err:
        msg = lib.coverage_scatter_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} ({err})")
