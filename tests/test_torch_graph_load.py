"""The port's on-demand GFA loader against its pure-Python loader.

``SplicingGraph.from_gfa`` of ``pantas_tpu_torch`` keeps the file as native
tables (``native/gfaload.cpp``): ``seg`` and ``link`` are mappings that build
a record on its first lookup. Everything a caller can see is held here
against ``SplicingGraph._from_gfa_py``, the port's pure-Python loader, on the
call fixtures, a tiled many-gene fixture and fuzzed graphs: key order and
every attribute, the hash-ordered junction sets and endpoint indexes (also in
processes under pinned ``PYTHONHASHSEED``\\ s), mutations that persist, missing
keys, the loader's errors, the records-built counts and the rows of the host
and the device call, in exact order.
"""

import gc
import io
import os
import random
import re
import subprocess
import sys

import pytest
from conftest import REPO_ROOT
from fixtures_call import SPLICE_GFA, SPLICE_GTF, write_call_fixtures
from fixtures_micro import MICRO_GFA

from pantas_tpu_torch import trace
from pantas_tpu_torch.events.batched import call_events_device
from pantas_tpu_torch.events.caller import (
    _EXT,
    CallOptions,
    LinkInfo,
    SplicingGraph,
    call_events,
    record_counts,
)

TAGS_GFA = """H\tVN:Z:1.1
S\t1\tACGT\tNC:i:9
S\t2\tGG\tEX:Z:T1_R1.1,T1_H1.1\tNC:i:-5
S\t3\tTTT\tNC:i:0\tEX:Z:T1_R1.2
S\t4\tC\tEX:Z:T1_H1.2\tNC:i:1\tIL:Z:0,0\tOL:Z:0,0
S\t5\tACGTACGT\tLN:i:8\tNC:i:7\tEX:Z:T1_R1.2,T1_H1.3
S\t6\tA\tEX:Z:\tNC:i:0
S\tsegment-long-7\t*
L\t1\t+\t2\t+\t*\tRC:i:3
L\t2\t+\t3\t+\t*\tJN:Z:T1_R1.1.2,T1_H1.1.2\tRC:i:4
L\t2\t+\t4\t+\t*\tRC:i:1\tID:Z:N
L\t3\t+\t5\t+\t*\tRC:i:-2
L\t4\t+\t5\t+\t*\tJN:Z:T1_H1.2.3\tRC:i:2
L\t5\t+\t6\t+\t*
L\t6\t+\tsegment-long-7\t+\t*\tJN:Z:\tRC:i:0
L\t2\t+\t3\t+\t*\tRC:i:8
P\tref\t1+,2+,3+,5+,6+\t*
W\ts1\t1\tT1_H1\t0\t9\t>1>2>4>5
"""


def _tag(line: str, fields: list) -> str:
    return "\t".join([line, *fields]) + "\n"


def fuzz_gfa(seed: int) -> str:
    """A random GFA: numeric ids and long ids that share their first 8
    bytes, each L line after the S lines it names, tags present or absent
    (negative NC/RC, empty EX/JN, ID), repeated pairs, P and W lines."""
    rng = random.Random(seed)
    n = rng.randint(20, 160)
    ids = [str(i + 1) if rng.random() < 0.7 else f"abcdefgh{rng.randint(0, 10**6)}_{i}"
           for i in range(n)]
    out, links = ["H\tVN:Z:1.1\n"], []
    for i, nid in enumerate(ids):
        tags = []
        if rng.random() < 0.8:
            tags.append(f"NC:i:{rng.randint(-3, 60)}")
        if rng.random() < 0.5:
            labels = [f"T{rng.randint(0, 4)}_R{rng.randint(1, 2)}.{rng.randint(1, 6)}"
                      for _ in range(rng.randint(0, 3))]
            tags.append("EX:Z:" + ",".join(labels))
        rng.shuffle(tags)
        out.append(_tag(f"S\t{nid}\t{'ACGT'[: rng.randint(1, 4)] * rng.randint(1, 5)}", tags))
        for _ in range(rng.randint(0, 3)):
            if i == 0:
                break
            a, b = ids[rng.randrange(i + 1)], ids[rng.randrange(i + 1)]
            if links and rng.random() < 0.1:
                a, b = links[rng.randrange(len(links))]
            links.append((a, b))
            tags = []
            if rng.random() < 0.8:
                tags.append(f"RC:i:{rng.randint(-2, 40)}")
            r = rng.random()
            if r < 0.3:
                tags.append(f"JN:Z:T{rng.randint(0, 4)}_R1.{rng.randint(1, 5)}.{rng.randint(1, 6)}")
            elif r < 0.35:
                tags.append("JN:Z:")
            if rng.random() < 0.2:
                tags.append("ID:Z:N")
            rng.shuffle(tags)
            out.append(_tag(f"L\t{a}\t+\t{b}\t{rng.choice('+-')}\t*", tags))
        if rng.random() < 0.05:
            out.append(f"P\tp{i}\t{ids[0]}+,{nid}+\t*\n")
    out.append(f"W\ts\t1\tT0_R1\t0\t9\t>{ids[0]}\n")
    return "".join(out)


def tiled(n_genes: int, spacer: int):
    """The splice fixture's gene ``n_genes`` times, gene g's segments and
    transcripts renamed (ids 100 * g + n, ``TA`` -> ``TA<g>``), with an
    unannotated chain of ``spacer`` segments after each gene: a GFA and a
    GTF where most segments lie outside every gene."""
    s_lines, l_lines, gtf = [], [], []
    label = re.compile(r"\bT([A-Z])_")
    for g in range(1, n_genes + 1):
        off = 100 * g
        for line in SPLICE_GFA.splitlines():
            f = line.split("\t")
            if f[0] == "S":
                f[1] = str(off + int(f[1]))
                s_lines.append(label.sub(rf"T\g<1>{g}_", "\t".join(f)))
            elif f[0] == "L":
                f[1], f[3] = str(off + int(f[1])), str(off + int(f[3]))
                l_lines.append(label.sub(rf"T\g<1>{g}_", "\t".join(f)))
        chain = [str(off + 8)] + [str(off + 50 + i) for i in range(spacer)]
        s_lines += [f"S\t{c}\tACGTACGTAC\tNC:i:{g + i}" for i, c in enumerate(chain[1:])]
        l_lines += [f"L\t{a}\t+\t{b}\t+\t*\tRC:i:{g}" for a, b in zip(chain, chain[1:])]
        for line in SPLICE_GTF.splitlines():
            line = line.replace('"G1"', f'"G{g}"')
            gtf.append(re.sub(r'transcript_id "T([A-Z])"', rf'transcript_id "T\g<1>{g}"', line))
    gfa = "H\tVN:Z:1.1\n" + "".join(x + "\n" for x in s_lines + l_lines)
    return gfa, "".join(x + "\n" for x in gtf)


CASES = ["micro", "splice", "cassette", "tags", "tiled"] + [f"fuzz{s}" for s in range(8)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> (gfa path, gtf path or None) for every case."""
    d = tmp_path_factory.mktemp("graph_load")
    out = {k: v for k, v in write_call_fixtures(d).items()}
    tiled_gfa, tiled_gtf = tiled(12, 40)
    texts = {"micro": MICRO_GFA, "tags": TAGS_GFA, "tiled": tiled_gfa}
    texts.update({f"fuzz{s}": fuzz_gfa(s) for s in range(8)})
    for name, text in texts.items():
        (d / f"{name}.gfa").write_text(text)
        out[name] = (str(d / f"{name}.gfa"), None)
    (d / "tiled.gtf").write_text(tiled_gtf)
    out["tiled"] = (out["tiled"][0], str(d / "tiled.gtf"))
    return out


def _both(path):
    return SplicingGraph.from_gfa(path), SplicingGraph._from_gfa_py(path)


def _seg_fields(s):
    return s.length, s.nc, s.ex_raw, list(s.incoming), list(s.outgoing)


def _link_fields(li):
    return li.rc, li.jn_raw, li.novel, li.jn


def test_native_loader_is_built():
    assert _EXT is not None, "the native gfaload extension failed to build"


@pytest.mark.parametrize("case", CASES)
def test_keys_and_every_attribute_equal(files, case):
    """Key order and every attribute, through each way a caller reads them:
    ``[k]``, ``.get``, ``in``, ``len``, iteration, ``keys``/``values``/
    ``items`` and ``frozenset``."""
    g, p = _both(files[case][0])
    assert type(g.seg).__name__ == "Map"
    for mine, theirs, fields in ((g.seg, p.seg, _seg_fields), (g.link, p.link, _link_fields)):
        assert len(mine) == len(theirs) and mine.built == 0
        assert list(mine) == list(theirs) == mine.keys()
        assert frozenset(mine) == frozenset(theirs)
        for k in list(theirs)[::-2]:  # half by lookup, in reverse
            assert k in mine and fields(mine[k]) == fields(theirs[k]), k
            assert mine.get(k) is mine[k]
        built = mine.built
        assert built == len(list(theirs)[::-2])
        assert [fields(v) for v in mine.values()] == [fields(v) for v in theirs.values()]
        assert mine.built == len(theirs)
        assert [(k, fields(v)) for k, v in mine.items()] == \
            [(k, fields(v)) for k, v in theirs.items()]
        assert mine.built == len(theirs)  # each built once


@pytest.mark.parametrize("case", CASES)
def test_hash_ordered_structures_equal(files, case):
    """The junction sets and the four endpoint indexes are real sets and
    dicts built as the Python loader builds them: equal in iteration order."""
    g, p = _both(files[case][0])
    assert type(g.junctions) is set and type(g.j_by_head) is dict
    assert list(g.junctions) == list(p.junctions)
    assert list(g.novel_junctions) == list(p.novel_junctions)
    for attr in ("j_by_head", "j_by_tail", "nj_by_head", "nj_by_tail"):
        mine, theirs = getattr(g, attr), getattr(p, attr)
        assert list(mine) == list(theirs), attr
        assert [list(v) for v in mine.values()] == [list(v) for v in theirs.values()], attr


ORDER_SCRIPT = """
import sys
from pantas_tpu_torch.events.caller import SplicingGraph
for path in sys.argv[1:]:
    g, p = SplicingGraph.from_gfa(path), SplicingGraph._from_gfa_py(path)
    for attr in ("junctions", "novel_junctions"):
        assert list(getattr(g, attr)) == list(getattr(p, attr)), (path, attr)
    for attr in ("j_by_head", "j_by_tail", "nj_by_head", "nj_by_tail"):
        mine, theirs = getattr(g, attr), getattr(p, attr)
        assert [(k, list(v)) for k, v in mine.items()] == \\
            [(k, list(v)) for k, v in theirs.items()], (path, attr)
print("orders equal", len(sys.argv) - 1)
"""


@pytest.mark.parametrize("hashseed", ["0", "1", "4242"])
def test_hash_order_equal_under_a_pinned_hashseed(files, hashseed):
    paths = [files[c][0] for c in CASES]
    env = {**os.environ, "PYTHONHASHSEED": hashseed, "PYTHONPATH": str(REPO_ROOT)}
    r = subprocess.run([sys.executable, "-c", ORDER_SCRIPT, *paths], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f"orders equal {len(paths)}"


@pytest.mark.parametrize("case", ["splice", "tags", "tiled", "fuzz3"])
def test_mutations_persist(files, case):
    """``nc``, ``rc``, ``outgoing.append``, a novel ``[k] = v`` and a
    replaced file record persist, and iterate as in the Python loader's
    dicts: novel keys after the file's, in insertion order."""
    g, p = _both(files[case][0])
    segs, links = list(p.seg), list(p.link)
    novel = [(segs[-1], segs[0]), (segs[0], segs[-1] + "x"), (segs[1 % len(segs)], segs[-1])]
    novel = [k for k in dict.fromkeys(novel) if k not in p.link]
    for h in (g, p):
        h.seg[segs[0]].nc = 123
        h.seg[segs[-1]].outgoing.append("novel-target")
        h.link[links[0]].rc = 77
        for k in novel:
            h.link[k] = LinkInfo(rc=5, novel=True)
        h.link[links[-1]] = LinkInfo(rc=-9)
    assert g.seg[segs[0]].nc == 123 and g.seg.get(segs[0]).nc == 123
    assert g.seg[segs[-1]].outgoing[-1] == "novel-target"
    assert g.link[links[0]].rc == 77
    assert len(g.link) == len(p.link) == len(links) + len(novel)
    assert list(g.link) == list(p.link) == g.link.keys()
    assert all(k in g.link for k in novel)
    assert [(k, v.rc, v.novel) for k, v in g.link.items()] == \
        [(k, v.rc, v.novel) for k, v in p.link.items()]
    assert [_seg_fields(v) for v in g.seg.values()] == [_seg_fields(v) for v in p.seg.values()]
    assert frozenset(g.link) == frozenset(p.link)
    assert g.link.built == len(links) - 1  # the replaced record was never built


@pytest.mark.parametrize("key", ["nope", 5, ("1",), ("1", "2", "3"), ("1", 2), "1\udc80"])
def test_missing_keys(files, key):
    """A key the graph lacks raises ``KeyError(key)`` as a dict does, ``.get``
    gives the default, ``in`` is false; an unhashable key raises
    ``TypeError`` as a dict does."""
    g, p = _both(files["tags"][0])
    for mine, theirs in ((g.seg, p.seg), (g.link, p.link)):
        with pytest.raises(KeyError) as e:
            mine[key]
        assert e.value.args == (key,)
        assert mine.get(key) is None and mine.get(key, "d") == "d"
        assert (key in mine) is (key in theirs) is False
        with pytest.raises(TypeError):
            mine[["unhashable"]]
        with pytest.raises(TypeError):
            ["unhashable"] in mine
    assert ("segment-long-7",) not in g.link and ("6", "segment-long-7") in g.link
    assert g.link.built == g.seg.built == 0


BAD_GFAS = {
    "link_before_its_second_segment": "S\t1\tA\nL\t1\t+\t2\t+\t*\nS\t2\tC\n",
    "link_before_its_first_segment": "S\t2\tA\nL\t1\t+\t2\t+\t*\nS\t1\tC\n",
    "unknown_second_segment": "S\t1\tA\nS\t2\tC\nL\t1\t+\t2\t+\t*\nL\t2\t+\t9\t+\t*\n",
    "unknown_first_segment": "S\t1\tA\nS\t2\tC\nL\t9\t+\t2\t+\t*\n",
}


@pytest.mark.parametrize("name", sorted(BAD_GFAS))
def test_link_naming_an_unknown_or_later_segment_raises(tmp_path, name):
    path = tmp_path / "bad.gfa"
    path.write_text(BAD_GFAS[name])
    with pytest.raises(KeyError) as theirs:
        SplicingGraph._from_gfa_py(str(path))
    with pytest.raises(KeyError) as mine:
        SplicingGraph.from_gfa(str(path))
    assert mine.value.args == theirs.value.args


def test_an_empty_jn_is_no_junction(files):
    g, p = _both(files["tags"][0])
    pair = ("6", "segment-long-7")
    for h in (g, p):
        assert pair not in h.junctions and "6" not in h.j_by_head
        assert h.link[pair].jn_raw == "" and h.link[pair].jn == []
    assert g.link[("2", "3")].rc == p.link[("2", "3")].rc == 8  # a repeated pair's last line


def test_records_are_built_on_demand(files):
    """None right after the load, each one once on iteration, and in the
    annotated device call of the tiled fixture only those the call reads;
    ``call.graph.*`` count them once the call has ended."""
    gfa, gtf = files["tiled"]
    g = SplicingGraph.from_gfa(gfa)
    n_seg, n_link = len(g.seg), len(g.link)
    assert record_counts(g) == {"segments": n_seg, "links": n_link, "seg_built": 0,
                                 "link_built": 0}
    list(g.seg.values())
    list(g.link.items())
    assert (g.seg.built, g.link.built) == (n_seg, n_link)
    assert record_counts(SplicingGraph._from_gfa_py(gfa))["seg_built"] == n_seg

    trace.enable()
    trace.reset()
    try:
        rows = list(call_events_device(gfa, gtf, CallOptions(rca=0), log=io.StringIO(),
                                       devices=["cpu"]))
        c = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert len(rows) > 12
    assert (c["call.graph.segments"], c["call.graph.links"]) == (n_seg, n_link)
    assert 0 < c["call.graph.seg_built"] < n_seg // 2
    assert 0 < c["call.graph.link_built"] < n_link // 4


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("case,novel", [("splice", False), ("splice", True), ("cassette", True),
                                        ("tiled", False), ("tiled", True)])
def test_call_rows_equal_in_order(files, case, novel, engine):
    """The rows of the call on the on-demand graph are those on the Python
    loader's graph, in the same order (one process, one hash seed)."""
    gfa, gtf = files[case]
    opts = CallOptions(rca=0, novel=novel)

    def rows(graph):
        if engine == "host":
            return list(call_events(gfa, gtf, opts, log=io.StringIO(), graph=graph))
        return list(call_events_device(gfa, gtf, opts, log=io.StringIO(), graph=graph,
                                       devices=["cpu"]))

    theirs = rows(SplicingGraph._from_gfa_py(gfa))
    assert len(theirs) > 1
    assert rows(None) == rows(SplicingGraph.from_gfa(gfa)) == theirs


@pytest.mark.parametrize("via", ["coverage", "engine"])
def test_fused_constructors_equal(tmp_path, monkeypatch, via):
    """``from_coverage`` and ``from_engine`` iterate every record of the
    on-demand graph and add novel links: the graph is the one they build on
    the Python loader's."""
    from fixtures_micro import write_micro

    from pantas_tpu_torch.coverage.host import accumulate_gaf, load_node_lengths
    from pantas_tpu_torch.graph.compiler import compile_gfa
    from pantas_tpu_torch.native import NativeCoverage

    gfa, gaf = write_micro(tmp_path)

    def build():
        if via == "coverage":
            with open(gaf) as fh:
                counts = accumulate_gaf(fh, load_node_lengths(gfa))
            return SplicingGraph.from_coverage(gfa, counts)
        tensors = compile_gfa(gfa)
        eng = NativeCoverage(tensors)
        eng.process_file(gaf, 0)
        return SplicingGraph.from_engine(gfa, tensors, eng)

    g = build()
    monkeypatch.setattr(SplicingGraph, "from_gfa", classmethod(lambda cls, p: cls._from_gfa_py(p)))
    p = build()
    assert type(g.seg).__name__ == "Map" and type(p.seg) is dict
    assert len(g.link) > g.link.in_file  # novel links were added
    assert [(k, _seg_fields(v)) for k, v in g.seg.items()] == \
        [(k, _seg_fields(v)) for k, v in p.seg.items()]
    assert [(k, _link_fields(v)) for k, v in g.link.items()] == \
        [(k, _link_fields(v)) for k, v in p.link.items()]
    assert list(g.novel_junctions) == list(p.novel_junctions)
    assert [(k, list(v)) for k, v in g.nj_by_head.items()] == \
        [(k, list(v)) for k, v in p.nj_by_head.items()]


@pytest.mark.parametrize("finish", ["consumed", "closed", "already_off"])
def test_device_call_defers_the_cyclic_gc(files, finish):
    """The cyclic GC is off from the call's first row to its end, and then
    as it was before, also when the consumer stops early."""
    gfa, gtf = files["tiled"]
    if finish == "already_off":
        gc.disable()
    try:
        rows = call_events_device(gfa, gtf, CallOptions(rca=0), log=io.StringIO(),
                                  devices=["cpu"])
        assert next(rows).startswith("event_type,")
        during = gc.isenabled()
        if finish == "closed":
            rows.close()
        else:
            assert len(list(rows)) > 12
        assert not during and gc.isenabled() is (finish != "already_off")
    finally:
        gc.enable()
