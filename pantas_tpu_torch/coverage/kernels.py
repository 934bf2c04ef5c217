"""Coverage scatter-add, ``counts[idx] += 1`` for every ``idx >= 0``.

Two hand-written kernels, each with its plain PyTorch version:

- :func:`sorted_coverage_scatter_add` replaces
  ``pantas_tpu/coverage/pallas_kernel.py::sorted_coverage_scatter_add``. The
  batch is sorted and split at windows of :data:`WINDOW` count slots
  (``torch.sort`` + ``torch.searchsorted``, outside the kernel as on the
  TPU); each window's segment of the sorted stream then becomes a histogram
  added into its slots (``csrc/coverage_scatter.cu``).
- :func:`coverage_scatter_add` replaces
  ``pantas_tpu/coverage/pallas_kernel.py::coverage_scatter_add``: one global
  atomic add per index, no sort (``csrc/coverage_direct.cu``). Its batches
  are a multiple of :data:`BLOCK`, as the TPU kernel's are.

On the card both are bound by memory traffic, not by arithmetic: the counts
vector reaches 1 GiB at genome scale while a batch holds 2^20 indices, so
each kernel touches only the slots its indices name, with no padding copy
of ``counts``.

``counts`` is updated in place (the JAX step donated its buffer for the same
reason: an undonated 1 GiB update would copy it every batch).
"""

from __future__ import annotations

import torch

from pantas_tpu_torch.coverage import _build
from pantas_tpu_torch.parallel.mesh import scatter_add_counts

WINDOW = 16384  # slots per window; equals kWindow in csrc/coverage_scatter.cu
BLOCK = 2048  # batch granule of the direct kernel; equals kBlock in csrc/coverage_direct.cu
INT32_MAX = 2**31 - 1

# kernel launches in this process, by wrapper; chip_smoke.py reads them to
# prove which kernel a path ran through
LAUNCHES = {"sorted_coverage_scatter_add": 0, "coverage_scatter_add": 0}


def _check(counts: torch.Tensor, idx: torch.Tensor) -> int:
    if counts.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"counts and idx must be int32, got {counts.dtype} and {idx.dtype}")
    if counts.dim() != 1 or idx.dim() != 1:
        raise ValueError("counts and idx must be 1-D")
    if not (counts.is_contiguous() and idx.is_contiguous()):
        raise ValueError("counts and idx must be contiguous")
    if counts.device != idx.device:
        raise ValueError(f"counts on {counts.device} but idx on {idx.device}")
    n = counts.numel()
    if -(-n // WINDOW) * WINDOW > INT32_MAX:
        raise ValueError(f"{n} count slots exceed int32 window arithmetic")
    return n


def sorted_window_bounds(idx: torch.Tensor, n: int):
    """Sorted stream and ``bounds`` (int32, one per window plus one):
    window ``c`` owns sorted positions ``[bounds[c], bounds[c + 1])``. The -1
    padding sorts first and lies before ``bounds[0]``; slots at or past the
    last window edge lie after ``bounds[-1]``."""
    s = torch.sort(idx).values
    n_windows = -(-n // WINDOW)
    edges = torch.arange(
        0, n_windows * WINDOW + 1, WINDOW, dtype=torch.int32, device=idx.device
    )
    return s, torch.searchsorted(s, edges, out_int32=True)


def sorted_coverage_scatter_add_plain(counts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: the same sort and window bounds,
    then one ``torch.bincount`` per non-empty window, masked at ``n``."""
    n = _check(counts, idx)
    s, bounds = sorted_window_bounds(idx, n)
    for c in torch.nonzero(bounds[1:] > bounds[:-1]).flatten().tolist():
        lo, hi = int(bounds[c]), int(bounds[c + 1])
        base = c * WINDOW
        width = min(WINDOW, n - base)
        hist = torch.bincount(s[lo:hi] - base, minlength=WINDOW)[:width]
        counts[base : base + width] += hist.to(counts.dtype)
    return counts


def sorted_coverage_scatter_add(counts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``counts[idx] += 1`` for ``idx >= 0`` (``-1`` is padding), in place.

    On a CUDA tensor this launches the hand-written kernel on the current
    stream and raises if the launch fails; on a CPU tensor it runs
    :func:`sorted_coverage_scatter_add_plain`. Any other device raises.
    """
    if counts.device.type == "cpu":
        return sorted_coverage_scatter_add_plain(counts, idx)
    _check_cuda(counts)
    n = _check(counts, idx)
    s, bounds = sorted_window_bounds(idx, n)
    lib = _build.load()
    if lib.coverage_scatter_window() != WINDOW:
        raise RuntimeError("csrc/coverage_scatter.cu kWindow disagrees with WINDOW")
    err = lib.coverage_scatter_sorted(
        counts.data_ptr(), n, s.data_ptr(), bounds.data_ptr(), bounds.numel() - 1,
        torch.cuda.current_stream(counts.device).cuda_stream,
    )
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
    """``counts[idx] += 1`` for ``0 <= idx < n`` (``-1`` is padding), in
    place; ``idx.numel()`` must be a multiple of :data:`BLOCK`.

    On a CUDA tensor this launches the direct kernel on the current stream
    and raises if the launch fails; on a CPU tensor it runs
    :func:`coverage_scatter_add_plain`. Any other device raises.
    """
    if counts.device.type == "cpu":
        return coverage_scatter_add_plain(counts, idx)
    _check_cuda(counts)
    n = _check_direct(counts, idx)
    lib = _build.load()
    if lib.coverage_direct_block() != BLOCK:
        raise RuntimeError("csrc/coverage_direct.cu kBlock disagrees with BLOCK")
    err = lib.coverage_scatter_direct(
        counts.data_ptr(), n, idx.data_ptr(), idx.numel(),
        torch.cuda.current_stream(counts.device).cuda_stream,
    )
    _raise_on(lib, err, "coverage_scatter_direct")
    LAUNCHES["coverage_scatter_add"] += 1
    return counts


def _check_cuda(counts: torch.Tensor) -> None:
    if counts.device.type != "cuda":
        raise ValueError(f"no coverage scatter kernel for device {counts.device}")


def _raise_on(lib, err: int, entry: str) -> None:
    if err:
        msg = lib.coverage_scatter_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} ({err})")
