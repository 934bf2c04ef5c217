"""Graft entry points of the port (counterpart of ``__graft_entry__.py``).

* ``entry(device)`` — the single-device forward step of the flagship compute
  path: the coverage scatter-add over the flat counts vector, with example
  arguments on ``device``.
* ``dryrun_multichip(n, device)`` — the full data-parallel pipeline step over
  a mesh of ``n`` devices: each shard scatter-adds its part of the slot-index
  stream into a private partial (the selected scatter: on a CUDA device the
  hand-written kernel) and the partials merge with one integer reduction,
  bit-exact for any shard count; then the micro GFA + GAF through the device
  augment on both mesh shapes, and the call stage's candidate-axis sharding.

``device`` is ``cuda`` unless the caller asks for ``cpu`` (a logical mesh: the
CPU ``n`` times). With fewer than ``n`` cards ``dryrun_multichip`` raises; it
never moves to the CPU on its own.
"""

from __future__ import annotations

import io
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from pantas_tpu_torch import backend

_TESTS = Path(__file__).resolve().parent.parent / "tests"


def entry(device="cuda"):
    from pantas_tpu_torch.parallel.mesh import scatter_add_counts

    dev = backend.device(device)
    counts = torch.zeros(4096, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(-1, 4096, size=(8192,), dtype=np.int32)).to(dev)
    return scatter_add_counts, (counts, idx)


def dryrun_multichip(n_devices: int, device="cuda", devices=None) -> None:
    """``devices``, when given, takes the place of the ``n_devices`` devices
    of type ``device`` (a logical mesh that repeats one card, say)."""
    from pantas_tpu_torch.coverage.device import augment_gfa_device
    from pantas_tpu_torch.coverage.scatter_impls import mesh_scatter
    from pantas_tpu_torch.parallel.mesh import (
        coverage_mesh,
        coverage_mesh_2d,
        data_parallel_scatter_add,
        new_parts,
        node_sharded_scatter_add,
        pad_to_multiple,
        reduce_data_parts,
    )

    if devices is None:
        devices = backend.mesh_devices(device, n_devices, strict=True)
    devices = [backend.device(d) for d in devices]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    # a mesh runs a named step: a race is refused, as the device engine does
    _, scatter = mesh_scatter()
    mesh = coverage_mesh(devices)
    step = data_parallel_scatter_add(mesh, scatter)

    total_slots = 1024
    # per-device PRIVATE partials: each device accumulates its stream
    # shard locally (zero per-batch communication); the single data-axis
    # reduction at stream end is the framework's entire cross-device
    # communication for the stage
    parts = new_parts(mesh, total_slots)
    rng = np.random.default_rng(42)
    raw = rng.integers(0, total_slots, size=(1000,), dtype=np.int32)
    step(parts, torch.from_numpy(pad_to_multiple(raw, n_devices)))
    got = reduce_data_parts(parts).cpu().numpy()

    # bit-exactness: the reduced partials equal the host histogram
    expect = np.bincount(raw, minlength=total_slots).astype(np.int32)
    if not np.array_equal(got, expect):
        raise AssertionError("sharded scatter-add mismatch")

    # 2-D mesh: data-parallel streams × node-axis-sharded counts (the
    # model/graph-parallel axis for whole-human pantranscriptomes)
    two_d = n_devices >= 2 and n_devices % 2 == 0
    if two_d:
        data, node = (n_devices // 2, 2)
        mesh2 = coverage_mesh_2d(devices, data, node)
        step2, shard = node_sharded_scatter_add(mesh2, total_slots, scatter)
        parts2 = new_parts(mesh2, shard)
        step2(parts2, torch.from_numpy(pad_to_multiple(raw, data)))
        got2 = reduce_data_parts(parts2).cpu().numpy()[:total_slots]
        if not np.array_equal(got2, expect):
            raise AssertionError("node-sharded scatter-add mismatch")

    # REAL pipeline: a hand-built micro GFA + GAF (every augmenter branch)
    # through host tokenize -> sharded device scatter-add -> reduction ->
    # byte emission on both mesh shapes, byte-identical to the single device
    if str(_TESTS) not in sys.path:
        sys.path.insert(0, str(_TESTS))
    from fixtures_call import SPLICE_GFA, SPLICE_GTF
    from fixtures_micro import write_micro

    with tempfile.TemporaryDirectory() as td:
        gfa, gaf = write_micro(Path(td))

        def run(mesh):
            buf = io.StringIO()
            augment_gfa_device(gaf, gfa, out=buf, device=devices[0], mesh=mesh,
                               log=io.StringIO())
            return buf.getvalue()

        single = run(None)
        if not single:
            raise AssertionError("empty emission")
        if run(mesh) != single:
            raise AssertionError("1-D mesh emission differs")
        if two_d and run(mesh2) != single:
            raise AssertionError("2-D mesh emission differs")

    # call stage over the mesh: each finder's candidate axis shards
    # data-parallel (replicated bitset tables, no collectives) — hits must
    # be identical to the unsharded device engine
    from pantas_tpu_torch.events.batched import find_annotated_es
    from pantas_tpu_torch.events.caller import SplicingGraph
    from pantas_tpu_torch.io.gtf import parse_transcript_maps

    with tempfile.TemporaryDirectory() as td:
        gfa_p = Path(td) / "splice.gfa"
        gtf_p = Path(td) / "splice.gtf"
        gfa_p.write_text(SPLICE_GFA)
        gtf_p.write_text(SPLICE_GTF)
        graph = SplicingGraph.from_gfa(str(gfa_p))
        t2g, _, _ = parse_transcript_maps(str(gtf_p))
        es_single = find_annotated_es(graph, t2g, rca=0, devices=devices[:1])
        es_mesh = find_annotated_es(graph, t2g, rca=0, devices=devices)
        if not (es_mesh == es_single and es_single):
            raise AssertionError("sharded call hits differ")

    print(
        f"dryrun_multichip({n_devices}): OK — counts sum {int(got.sum())}, "
        "real micro-GAF augment byte-identical on 1-D and 2-D meshes, "
        "call candidate-axis sharding hit-identical"
    )
