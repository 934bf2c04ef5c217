"""The port's ``compile_gfa`` keeps the native scan's int64 segment ids.

On a graph the native structural scan compiled, ``GraphTensors`` carries the
scan's ids and builds the ``str`` names and the ``{str: int}`` index only when
a reader first asks for them (the trace counter ``graph.names_built``); the
native engine takes the ids as they are. The scan refuses every id that is
not a canonical integer, so such graphs take the Python parser, keep their
names as spelled, and never reach the native feed.
"""

import io
import re

import numpy as np
import pytest
from fixtures_micro import MICRO_GAF, MICRO_GFA, write_micro

from pantas_tpu.coverage import augment_gfa
from pantas_tpu_torch import trace
from pantas_tpu_torch.coverage.device import NativeFeedUnavailable, augment_gfa_device_native
from pantas_tpu_torch.graph.compiler import compile_gfa
from pantas_tpu_torch.native.gafcov import scan_gfa_structure

# the micro graph's segments 1..6 renamed to sorted ids that are not 1..N
SPARSE = {"1": "3", "2": "5", "3": "10", "4": "11", "5": "40", "6": "41"}
FIELDS = ("edge_src", "edge_dst", "il_base", "ol_base")
BAD_IDS = ["007", "+7", "-7", " 7", "12345678901234567890"]


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _sparse(tmp_path):
    def seg(m):
        return SPARSE[m.group(0)]

    gfa_lines = []
    for line in MICRO_GFA.splitlines():
        f = line.split("\t")
        if f[0] == "S":
            f[1] = SPARSE[f[1]]
        elif f[0] == "L":
            f[1], f[3] = SPARSE[f[1]], SPARSE[f[3]]
        elif f[0] == "P":
            f[2] = re.sub(r"\d+", seg, f[2])
        gfa_lines.append("\t".join(f))
    gaf_lines = []
    for line in MICRO_GAF.splitlines():
        f = line.split("\t")
        f[5] = re.sub(r"\d+", seg, f[5])
        gaf_lines.append("\t".join(f))
    gfa, gaf = tmp_path / "sparse.gfa", tmp_path / "sparse.gaf"
    gfa.write_text("\n".join(gfa_lines) + "\n")
    gaf.write_text("\n".join(gaf_lines) + "\n")
    return str(gfa), str(gaf)


GRAPHS = {"micro": write_micro, "sparse": _sparse}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_native_compile_keeps_the_ids_and_names_on_demand(tmp_path, graph):
    gfa, gaf = GRAPHS[graph](tmp_path)
    trace.enable()
    native = compile_gfa(gfa)
    assert trace.snapshot()["counters"]["graph.names_built"] == 0
    python = compile_gfa(gfa, engine="python")
    assert native.node_ids is not None and python.node_ids is None
    assert native.node_ids.tolist() == [int(n) for n in python.node_names]
    assert native.node_names == python.node_names
    assert native.node_index == python.node_index
    n = len(python.node_names)
    # the Python parser's names, then the native graph's, each built once
    assert trace.snapshot()["counters"]["graph.names_built"] == 2 * n
    assert native.node_names is native.node_names
    for f in FIELDS:
        a, b = getattr(native, f), getattr(python, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert native.total_slots == python.total_slots
    assert trace.snapshot()["counters"]["graph.names_built"] == 2 * n

    # the device augment reads no name, and writes what the host augment writes
    trace.reset()
    out = tmp_path / "out.gfa"
    with open(out, "w") as fh:
        augment_gfa_device_native(gaf, gfa, out=fh, device="cpu", flush_every=64,
                                  log=io.StringIO())
    assert trace.snapshot()["counters"]["graph.names_built"] == 0
    host = io.StringIO()
    augment_gfa(gaf, gfa, out=host, log=io.StringIO())
    assert out.read_bytes() == host.getvalue().encode()


@pytest.mark.parametrize("where", ["S", "L"])
@pytest.mark.parametrize("bad", BAD_IDS)
def test_non_canonical_ids_never_reach_the_native_feed(tmp_path, bad, where):
    """The id spelled in a segment alone (``S``), or in a segment and a link
    to it (``L``): the scan refuses it, the Python parser keeps it as spelled,
    and the native feed refuses the graph."""
    lines = ["S\t1\tACGT", "S\t2\tAC", f"S\t{bad}\tGTT", "L\t1\t+\t2\t+\t*"]
    if where == "L":
        lines.append(f"L\t2\t+\t{bad}\t+\t*")
    gfa = tmp_path / "odd.gfa"
    gfa.write_text("\n".join(lines) + "\n")
    gaf = tmp_path / "odd.gaf"
    gaf.write_text("r1\t6\t0\t6\t+\t>1>2\t6\t0\t6\t6\t6\t60\tcs:Z::6\tdv:f:0.0\n")
    assert scan_gfa_structure(str(gfa)) is None
    t = compile_gfa(str(gfa))
    assert t.node_ids is None
    assert t.node_names == ["1", "2", bad] and t.node_index[bad] == 2
    assert t.n_edges == (2 if where == "L" else 1)
    with pytest.raises(NativeFeedUnavailable):
        augment_gfa_device_native(str(gaf), str(gfa), out=io.StringIO(), device="cpu",
                                  log=io.StringIO())


@pytest.mark.parametrize("end", ["src", "dst"])
@pytest.mark.parametrize("bad", BAD_IDS)
def test_the_scan_refuses_a_non_canonical_id_in_a_link(tmp_path, bad, end):
    """The id spelled in a link alone: the scan refuses the link, and the
    graph then fails as the Python parser fails it, on the spelling no
    segment has."""
    link = f"L\t{bad}\t+\t1\t+\t*" if end == "src" else f"L\t1\t+\t{bad}\t+\t*"
    gfa = tmp_path / "odd.gfa"
    gfa.write_text(f"S\t1\tACGT\nS\t7\tAC\n{link}\n")
    assert scan_gfa_structure(str(gfa)) is None
    with pytest.raises(KeyError) as python:
        compile_gfa(str(gfa), engine="python")
    with pytest.raises(KeyError) as auto:
        compile_gfa(str(gfa))
    assert auto.value.args == python.value.args == (bad,)


def test_canonical_ids_at_the_int64_edge(tmp_path):
    """The largest int64 id is canonical and scanned; one more overflows."""
    top = str(2**63 - 1)
    gfa = tmp_path / "top.gfa"
    gfa.write_text(f"S\t1\tAC\nS\t{top}\tGT\nL\t1\t+\t{top}\t+\t*\n")
    ids, _, src, dst = scan_gfa_structure(str(gfa))
    assert ids.tolist() == [1, 2**63 - 1] and (src.tolist(), dst.tolist()) == ([1], [2**63 - 1])
    assert compile_gfa(str(gfa)).node_names == ["1", top]
    gfa.write_text(f"S\t1\tAC\nS\t{2**63}\tGT\n")
    assert scan_gfa_structure(str(gfa)) is None
