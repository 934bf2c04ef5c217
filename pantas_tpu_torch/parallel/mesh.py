"""The coverage scatter as a plain PyTorch op, and the coverage mesh.

Counterpart of ``pantas_tpu/parallel/mesh.py``. :func:`scatter_add_counts`
(the XLA scatter there) is the oracle the hand-written kernels are held
against and the plain baseline they are timed against.

The mesh is one process driving several devices, with no
``torch.distributed``: every device of the mesh holds a PRIVATE partial-counts
tensor, a batch is cut into ``data`` contiguous shards, each shard is copied
to its device and scatter-added there with no communication, and the single
reduction the math needs (integer adds are associative, so the result is
bit-exact for any shard count) happens once at the end of the stream
(:func:`reduce_data_parts`). A device may appear in a mesh more than once;
that gives a *logical* mesh on one device, which exercises the sharding
arithmetic and measures nothing about scaling.

The per-shard scatter ``step`` is whichever single-device scatter the caller
selected (``pantas_tpu_torch.coverage.scatter_impls.SCATTER_IMPLS``): on a
CUDA device the hand-written kernel, on the CPU its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def scatter_add_counts(counts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """counts[idx] += 1 for every valid (>= 0) index; -1 entries are padding.

    Updates ``counts`` in place and returns it.
    """
    valid = idx >= 0
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    return counts.index_add_(0, safe, valid.to(counts.dtype))


@dataclass(frozen=True)
class CoverageMesh:
    """``data`` × ``node`` devices, row-major: ``devices[d * K + k]`` is
    device ``(d, k)`` with ``K = node or 1``. ``node`` is ``None`` for the 1-D
    data-parallel mesh; a 2-D mesh shards the counts over its node axis
    (``node`` may be 1)."""

    devices: Tuple[torch.device, ...]
    data: int
    node: Optional[int] = None

    @property
    def columns(self) -> int:
        return self.node or 1

    def device(self, d: int, k: int = 0) -> torch.device:
        return self.devices[d * self.columns + k]

    def __str__(self) -> str:
        return f"{self.data}" if self.node is None else f"{self.data}x{self.node}"


def coverage_mesh(devices: Sequence) -> CoverageMesh:
    """1-D data-parallel mesh over the given devices."""
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a coverage mesh needs at least one device")
    return CoverageMesh(devs, len(devs))


def coverage_mesh_2d(devices: Sequence, data: int, node: int) -> CoverageMesh:
    """2-D mesh: data-parallel GAF shards × node-axis-sharded counts. Node
    ids are topologically sorted and chromosome-contiguous, so contiguous
    count shards keep each chromosome's traffic on one shard group."""
    devs = tuple(torch.device(d) for d in devices)
    if data < 1 or node < 1 or len(devs) != data * node:
        raise ValueError(f"a {data}x{node} mesh needs {data * node} devices, got {len(devs)}")
    return CoverageMesh(devs, data, node)


def new_parts(mesh: CoverageMesh, slots: int) -> List[List[torch.Tensor]]:
    """Zeroed private partials: ``parts[d][k]`` on device ``(d, k)``,
    ``slots`` int32 counts each."""
    return [
        [torch.zeros(slots, dtype=torch.int32, device=mesh.device(d, k))
         for k in range(mesh.columns)]
        for d in range(mesh.data)
    ]


def data_parallel_scatter_add(mesh: CoverageMesh, step: Callable):
    """The sharded coverage accumulator of a 1-D mesh.

    Returns ``fn(parts, idx) -> parts``: ``idx`` is a host int32 tensor whose
    length is a multiple of ``mesh.data``; data shard ``d`` is copied to
    device ``d`` and ``step`` adds it into ``parts[d][0]``, in place, with
    no communication between devices.
    """

    def _dp(parts, idx: torch.Tensor):
        for d, shard in enumerate(idx.chunk(mesh.data)):
            part = parts[d][0]
            step(part, shard.contiguous().to(part.device))
        return parts

    return _dp


def node_sharded_scatter_add(mesh: CoverageMesh, total_slots: int, step: Callable):
    """Coverage step over a 2-D (data × node) mesh; returns ``(fn, shard)``.

    Device ``(d, k)`` owns slots ``[k * shard, (k + 1) * shard)`` with
    ``shard = ceil(total_slots / K)``. It gets data shard ``d``, rewrites
    every index to ``idx - k * shard`` and masks what falls outside its range
    to ``-1``, then ``step`` adds the rest into ``parts[d][k]`` (``shard``
    counts long). Ownership is by slot range, so no device talks to another
    until the one data-axis reduction at the end of the stream.
    """
    n_node = mesh.columns
    shard = -(-total_slots // n_node)  # ceil; counts padded to shard * n_node

    def _step(parts, idx: torch.Tensor):
        for d, data_shard in enumerate(idx.chunk(mesh.data)):
            data_shard = data_shard.contiguous()
            on_dev = {}  # one copy per distinct device of this row
            for k in range(n_node):
                part = parts[d][k]
                if part.device not in on_dev:
                    on_dev[part.device] = data_shard.to(part.device)
                mine = on_dev[part.device]
                local = mine - k * shard
                ok = (mine >= 0) & (local >= 0) & (local < shard)
                step(part, torch.where(ok, local, -1))
        return parts

    return _step, shard


def reduce_data_parts(parts) -> torch.Tensor:
    """The one end-of-stream reduction: the partials of every data row are
    copied to the first device and summed there in int32, and the node
    ranges are concatenated. ``parts`` is left as it was."""
    first = parts[0][0].device
    cols = []
    for k in range(len(parts[0])):
        acc = parts[0][k].to(first, copy=True)
        for row in parts[1:]:
            acc += row[k].to(first)
        cols.append(acc)
    return cols[0] if len(cols) == 1 else torch.cat(cols)


def pad_to_multiple(idx, multiple: int) -> np.ndarray:
    """Pad an int32 index array with -1 so it splits evenly over devices."""
    n = len(idx)
    padded = -np.ones((-(-n // multiple)) * multiple or multiple, dtype=np.int32)
    padded[:n] = idx
    return padded
