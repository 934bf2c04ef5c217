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
from typing import Dict, List, Optional, Tuple

import numpy as np


class _FromIds:
    """A ``GraphTensors`` identity field that, on a graph the native scan
    compiled, is built from ``node_ids`` on its first read and then kept."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, owner=None):
        if obj is None:
            raise AttributeError(self.name)  # a dataclass field with no default
        if obj.__dict__[self.name] is None:
            obj._build_names()
        return obj.__dict__[self.name]

    def __set__(self, obj, value):
        obj.__dict__[self.name] = value


@dataclass
class GraphTensors:
    # identity; on the native scan's graphs both are built from node_ids
    # when first read (the device augment reads neither)
    node_names: List[str] = _FromIds()  # index -> GFA segment id
    node_index: Dict[str, int] = _FromIds()  # GFA segment id -> index
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
    # the native scan's canonical int64 segment ids, in file order; None
    # where the Python parser compiled the graph (not a dataclass field)
    node_ids = None

    def _build_names(self) -> None:
        names = [str(i) for i in self.node_ids.tolist()]
        self.node_names = names
        self.node_index = {n: i for i, n in enumerate(names)}
        trace.add("graph.names_built", len(names))

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
    scan (one mmap pass in C++, ~10× the Python loop; falls back here for
    segment ids that are not canonical integers), whose int64 ids the result
    keeps as ``node_ids``; ``"python"`` forces the fallback."""
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
                if ids_dense(ids):  # an id's index is id - 1
                    order = sorted_ids = None
                else:
                    order = np.argsort(ids, kind="stable")
                    sorted_ids = ids[order]
                src_i = _index_of(esrc_ids, len(ids), sorted_ids, order)
                dst_i = _index_of(edst_ids, len(ids), sorted_ids, order)
            with trace.span("graph.assemble"):
                t = _assemble(None, None, lens_arr.astype(np.int32), src_i, dst_i)
                t.node_ids = ids
                trace.add("graph.names_built", 0)  # no names until a reader asks
                return t

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

    trace.add("graph.names_built", len(names))
    with trace.span("graph.assemble"):
        node_len = np.asarray(lens, dtype=np.int32)
        if edges:
            src = np.asarray([a for a, _ in edges], dtype=np.int64)
            dst = np.asarray([b for _, b in edges], dtype=np.int64)
        else:
            src = dst = np.zeros(0, dtype=np.int64)
        return _assemble(names, index, node_len, src, dst)


def ids_dense(ids: np.ndarray) -> bool:
    """The segment ids are exactly 1..N (the native engine then indexes a
    segment by ``id - 1``)."""
    return bool(len(ids) and ids[0] == 1 and np.array_equal(ids, np.arange(1, len(ids) + 1)))


def _index_of(edge_ids: np.ndarray, n: int, sorted_ids, order) -> np.ndarray:
    """Segment index of each id in ``edge_ids``. ``order`` sorts the ``n``
    segment ids stably into ``sorted_ids``; both are None where the ids are
    1..N. Of segments that share an id the last wins, as in the Python
    parser's dict; an id that no segment has raises its ``KeyError``."""
    if order is None:
        pos = edge_ids - 1
        hit = (pos >= 0) & (pos < n)
    elif n:
        pos = np.searchsorted(sorted_ids, edge_ids, side="right") - 1
        hit = (pos >= 0) & (sorted_ids[np.maximum(pos, 0)] == edge_ids)
    else:
        pos, hit = edge_ids, np.zeros(len(edge_ids), bool)
    if not hit.all():
        raise KeyError(str(int(edge_ids[~hit][0])))
    return pos if order is None else order[pos]


def _assemble(
    names: Optional[List[str]],
    index: Optional[Dict[str, int]],
    node_len: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
) -> GraphTensors:
    n = len(node_len)
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
