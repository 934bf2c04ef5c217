"""Compile an annotated GFA into dense tensors for device-side coverage.

This replaces the reference's per-stage ad-hoc dict graph loads
(``alignments_augmentation_from_gaf.py:120-126``, ``call.py:145-181``) with
one immutable tensor bundle shared by the coverage engine and (later) the
batched caller:

* ``node_len[N]``           — segment lengths,
* ``edge_key[E]`` (sorted)  — packed ``(src_idx << 32) | dst_idx`` edge keys
  for O(log E) vectorized membership probes (the same packing the reference's
  native annotator uses, ``annotate.cpp:14,131``),
* ``il_base[N] / ol_base[N]`` — CSR bases of per-node offset histograms
  (node i owns ``node_len[i] + 2`` slots per side: link offsets range over
  ``-1..len`` — a full-node deletion compacts to an OL offset of -1 in the
  reference semantics — so slot = base + offset + 1),
* one flat ``counts`` vector layout: ``[NC | IL | OL | RC]`` so the entire
  augment stage is a single scatter-add onto one array.
"""

from __future__ import annotations

from pantas_tpu_torch import trace
from pantas_tpu_torch.io.xopen import xopen

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class GraphTensors:
    # identity
    node_names: List[str]  # index -> GFA segment id
    node_index: Dict[str, int]  # GFA segment id -> index
    node_len: np.ndarray  # int32[N]
    # edges, sorted by packed key; parallel arrays
    edge_key: np.ndarray  # uint64[E], sorted
    edge_src: np.ndarray  # int32[E] (node indices, aligned with edge_key)
    edge_dst: np.ndarray  # int32[E]
    # counts layout
    il_base: np.ndarray  # int64[N] — base slot of node's IL histogram
    ol_base: np.ndarray  # int64[N]
    rc_base: int  # base slot of edge counts
    total_slots: int  # len of the flat counts vector

    @property
    def n_nodes(self) -> int:
        return len(self.node_len)

    @property
    def n_edges(self) -> int:
        return len(self.edge_key)

    def nc_slot(self, idx: int) -> int:
        return idx

    def edge_lookup(self, src_idx: int, dst_idx: int) -> int:
        """Edge slot in the sorted table, or -1 if the edge is novel."""
        key = np.uint64((src_idx << 32) | dst_idx)
        pos = int(np.searchsorted(self.edge_key, key))
        if pos < len(self.edge_key) and self.edge_key[pos] == key:
            return pos
        return -1


def compile_gfa(gfa_path: str, engine: str = "auto") -> GraphTensors:
    """GFA -> GraphTensors. ``engine="auto"`` tries the native structural
    scan (mmap + strtoll in C++, ~10× the Python loop; falls back here for
    non-canonical-integer segment ids); ``"python"`` forces the fallback."""
    with trace.span("graph.compile_gfa"):
        return _compile(gfa_path, engine)


def _compile(gfa_path: str, engine: str) -> GraphTensors:
    if engine != "python":
        scanned = None
        with trace.span("graph.scan"):
            try:
                from pantas_tpu_torch.native.gafcov import scan_gfa_structure

                scanned = scan_gfa_structure(gfa_path)
            except Exception:
                scanned = None
        if scanned is not None:
            with trace.span("graph.index"):
                ids, lens_arr, esrc_ids, edst_ids = scanned
                names = [str(i) for i in ids.tolist()]
                index = {n: i for i, n in enumerate(names)}
                if len(esrc_ids):
                    if len(ids) > 1 and bool(np.all(ids[1:] > ids[:-1])):
                        spos = np.searchsorted(ids, esrc_ids)
                        dpos = np.searchsorted(ids, edst_ids)
                        spos_c = np.minimum(spos, len(ids) - 1)
                        dpos_c = np.minimum(dpos, len(ids) - 1)
                        if not (
                            np.array_equal(ids[spos_c], esrc_ids)
                            and np.array_equal(ids[dpos_c], edst_ids)
                        ):
                            bad = esrc_ids[ids[spos_c] != esrc_ids]
                            bad = bad if len(bad) else edst_ids[ids[dpos_c] != edst_ids]
                            raise KeyError(str(int(bad[0])))  # same as index[...] miss
                        src_i, dst_i = spos_c.astype(np.int64), dpos_c.astype(np.int64)
                    else:
                        id2i = {int(v): i for i, v in enumerate(ids.tolist())}
                        try:
                            src_i = np.asarray([id2i[int(v)] for v in esrc_ids], np.int64)
                            dst_i = np.asarray([id2i[int(v)] for v in edst_ids], np.int64)
                        except KeyError:
                            raise
                else:
                    src_i = dst_i = np.zeros(0, np.int64)
            with trace.span("graph.assemble"):
                return _assemble(names, index, lens_arr.astype(np.int32), src_i, dst_i)

    names: List[str] = []
    lens: List[int] = []
    index: Dict[str, int] = {}
    edges: List[Tuple[int, int]] = []

    with trace.span("graph.scan"), xopen(gfa_path) as fh:
        for line in fh:
            c = line[0] if line else ""
            if c == "S":
                # manual field scan: S<TAB>id<TAB>seq<TAB>tags... — slicing
                # out only id keeps the (large) tag payload uncopied
                t1 = line.index("\t")
                t2 = line.index("\t", t1 + 1)
                t3 = line.find("\t", t2 + 1)
                if t3 == -1:
                    t3 = len(line) - 1 if line.endswith("\n") else len(line)
                sid = line[t1 + 1 : t2]
                index[sid] = len(names)
                names.append(sid)
                lens.append(t3 - t2 - 1)
            elif c == "L":
                t = line.split("\t", 5)
                edges.append((index[t[1]], index[t[3]]))

    with trace.span("graph.assemble"):
        node_len = np.asarray(lens, dtype=np.int32)
        if edges:
            src = np.asarray([a for a, _ in edges], dtype=np.int64)
            dst = np.asarray([b for _, b in edges], dtype=np.int64)
        else:
            src = dst = np.zeros(0, dtype=np.int64)
        return _assemble(names, index, node_len, src, dst)


def _assemble(
    names: List[str],
    index: Dict[str, int],
    node_len: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
) -> GraphTensors:
    n = len(names)
    if len(src):
        key = (src.astype(np.uint64) << np.uint64(32)) | dst.astype(np.uint64)
        order = np.argsort(key)
        key, src, dst = key[order], src[order], dst[order]
    else:
        key = np.zeros(0, dtype=np.uint64)
        src = dst = np.zeros(0, dtype=np.int64)

    # counts layout: [NC (N) | IL hist | OL hist | RC (E)]; per-side slot
    # count is len+2 (offsets -1..len, slot = base + off + 1)
    hist_sizes = (node_len.astype(np.int64) + 2)
    il_base = n + np.concatenate(([0], np.cumsum(hist_sizes)[:-1]))
    hist_total = int(hist_sizes.sum())
    ol_base = il_base + hist_total
    rc_base = n + 2 * hist_total
    total = rc_base + len(key)

    return GraphTensors(
        node_names=names,
        node_index=index,
        node_len=node_len,
        edge_key=key,
        edge_src=src.astype(np.int32),
        edge_dst=dst.astype(np.int32),
        il_base=il_base,
        ol_base=ol_base,
        rc_base=rc_base,
        total_slots=total,
    )
