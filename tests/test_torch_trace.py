"""The port's own spans and counters (``pantas_tpu_torch/trace.py``) on the
device augment, on the CPU.

Tracing is off by default and then costs no clock read; turned on, it leaves
the augmented GFA byte for byte as it was (and as the JAX package's host
engine writes it), records every span of the device augment nested where
the work happens, counts what the work did, and lines its spans up with the
``record_function`` twins of a ``torch.profiler`` trace on the host clock.
"""

import io
import json
import subprocess
import sys
import threading
import time

import pytest
import torch
from conftest import REPO_ROOT
from fixtures_micro import write_micro

from pantas_tpu.coverage import augment_gfa
from pantas_tpu_torch import trace
from pantas_tpu_torch.coverage import device as port
from pantas_tpu_torch.coverage import kernels
from pantas_tpu_torch.native.gafcov import EMIT_PHASES
from pantas_tpu_torch.parallel import mesh as port_mesh

FLUSH = 64  # slots a batch: the micro GAF's copies make many batches
COPIES = 40
# the device augment's spans on the CPU, each with its parent; the read-back
# of a CPU tensor copies at once, with no nonzero count to wait on
PARENTS = {
    "stage.augment": None,
    "graph.compile_gfa": "stage.augment",
    "graph.scan": "graph.compile_gfa",
    "graph.index": "graph.compile_gfa",
    "graph.assemble": "graph.compile_gfa",
    "native.engine_init": "stage.augment",
    "native.ids_check": "native.engine_init",
    "native.create": "native.engine_init",
    "device.init": "stage.augment",
    "native.stream": "stage.augment",
    "native.slots_next": "native.stream",
    "device.add_slots": "native.stream",
    "device.h2d": "device.add_slots",
    "device.launch": "device.add_slots",
    "device.readback": "native.stream",
    "device.readback_copy": "device.readback",
    "native.emit": "stage.augment",
    **{name: "native.emit" for name in EMIT_PHASES},
}


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture
def inputs(tmp_path):
    gfa, gaf = write_micro(tmp_path)
    big = tmp_path / "big.gaf"
    big.write_text(open(gaf).read() * COPIES)
    return gfa, big


def _augment(gaf, gfa, out_path, flush_every=FLUSH, **kw):
    """The device augment on the CPU into a file; returns (bytes, log)."""
    log = io.StringIO()
    with open(out_path, "w") as out:
        port.augment_gfa_device_native(str(gaf), str(gfa), out=out, device="cpu",
                                       flush_every=flush_every, log=log, **kw)
    return out_path.read_bytes(), log.getvalue()


def _host_bytes(gaf, gfa) -> bytes:
    buf = io.StringIO()
    augment_gfa(str(gaf), str(gfa), out=buf, log=io.StringIO())
    return buf.getvalue().encode()


def _names(spans) -> list:
    return [s[0] for s in spans]


def test_off_by_default_and_without_a_clock(inputs, tmp_path, monkeypatch):
    p = subprocess.run([sys.executable, "-c",
                        "from pantas_tpu_torch import trace; print(trace.enabled())"],
                       cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert p.stdout.strip() == "False", p.stderr

    def no_clock():
        raise AssertionError("a span read the clock while tracing is off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert trace.span("a") is trace.span("b")  # one shared object, nothing allocated
    with trace.span("a"):
        trace.add("c", 3)
        trace.record("d", 0, 1)
    gfa, gaf = inputs
    _augment(gaf, gfa, tmp_path / "off.gfa")
    assert trace.snapshot() == {"spans": [], "counters": {"kernels.launches": 0}}


def test_spans_nest_where_the_work_happens(inputs, tmp_path):
    gfa, gaf = inputs
    off, _ = _augment(gaf, gfa, tmp_path / "off.gfa")
    trace.enable()
    on, _ = _augment(gaf, gfa, tmp_path / "on.gfa")
    spans = trace.snapshot()["spans"]
    assert on == off == _host_bytes(gaf, gfa)
    assert set(_names(spans)) == set(PARENTS)
    me = threading.get_ident()
    for name, t0, t1, parent, thread in spans:
        assert thread == me and t0 <= t1, name
        want = PARENTS[name]
        if want is None:
            assert parent == -1
            continue
        p_name, p_t0, p_t1 = spans[parent][:3]
        assert p_name == want, name
        assert p_t0 <= t0 and t1 <= p_t1, name
    # device.h2d under device.add_slots under native.stream under stage.augment
    h2d = next(s for s in spans if s[0] == "device.h2d")
    chain = []
    while h2d[3] != -1:
        h2d = spans[h2d[3]]
        chain.append(h2d[0])
    assert chain == ["device.add_slots", "native.stream", "stage.augment"]


def _counts_agree_with_the_work(inputs, tmp_path, monkeypatch, flush=FLUSH, **kw) -> dict:
    """One traced augment; its counters against the work it did."""
    gfa, gaf = inputs
    read_back = []
    original = port.DeviceCoverage._read_back

    def keep(self, counts):
        flat = original(self, counts)
        read_back.append(int(flat.sum()))
        return flat

    monkeypatch.setattr(port.DeviceCoverage, "_read_back", keep)
    trace.enable()
    out, log = _augment(gaf, gfa, tmp_path / "on.gfa", flush_every=flush, **kw)
    assert out == _host_bytes(gaf, gfa)
    snap = trace.snapshot()
    c = snap["counters"]
    batches = int(log.split("(batches: ")[1].split(")")[0])
    assert batches > 1
    assert _names(snap["spans"]).count("device.add_slots") == batches == c["device.batches"]
    assert _names(snap["spans"]).count("native.slots_next") == batches + 1  # the last finds none
    records = [line for line in gaf.read_text().split("\n") if line.strip()]
    assert c["slots.records"] == len(records)
    assert c["slots.bytes"] == gaf.stat().st_size
    assert c["slots.delivered"] == sum(read_back) > 0
    assert c["device.h2d_bytes"] == 4 * flush * batches
    assert c["device.pad_slots"] == flush * batches - c["slots.delivered"]
    assert c["emit.bytes_out"] == len(out)
    assert c["slots.parse_ns"] > 0 and c["slots.handoff_ns"] > 0
    assert c["slots.threads"] >= 1 and c["slots.waves"] >= batches
    assert 0 < c["slots.merge_ns"] <= c["slots.parse_ns"]
    assert c["kernels.launches"] == 0  # the plain versions run on the CPU
    return c


def test_counts_agree_with_the_work(inputs, tmp_path, monkeypatch):
    c = _counts_agree_with_the_work(inputs, tmp_path, monkeypatch)
    # a GAF under a MiB is too short for two pieces a wave
    assert c["slots.threads"] == 1


def test_counts_agree_with_the_work_in_parallel_waves(tmp_path, monkeypatch):
    """Three threads a wave over a GAF of a few MiB, in batches that span
    more than three pieces: the same counts, the threads the session used,
    and the time its merges took."""
    gfa, gaf = write_micro(tmp_path)
    big = tmp_path / "big.gaf"
    big.write_text(open(gaf).read() * COPIES * 100)
    c = _counts_agree_with_the_work((gfa, big), tmp_path, monkeypatch, flush=1 << 18,
                                    threads=3)
    assert c["slots.threads"] == 3


@pytest.mark.parametrize("env, threads", [({}, 1),
                                          ({"PANTAS_EMIT_FORCE_MT": "1",
                                            "PANTAS_EMIT_THREADS": "2"}, 2)],
                         ids=["serial", "chunked"])
def test_emission_stats_follow_the_path(inputs, tmp_path, monkeypatch, env, threads):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    gfa, gaf = inputs
    trace.enable()
    out, _ = _augment(gaf, gfa, tmp_path / "on.gfa")
    snap = trace.snapshot()
    assert out == _host_bytes(gaf, gfa)
    c = snap["counters"]
    assert c["emit.bytes_out"] == len(out)
    if threads == 1:
        assert (c["emit.chunks"], c["emit.threads"]) == (1, 1)
    else:
        # about four chunks a thread, one line apiece at the least under the
        # hook; only the threads that have a chunk are started
        assert c["emit.chunks"] >= 2
        assert c["emit.threads"] == min(threads, c["emit.chunks"])
    phases = [s for s in snap["spans"] if s[0] in EMIT_PHASES]
    assert _names(phases) == list(EMIT_PHASES)
    order = sorted(phases, key=lambda s: s[1])
    assert _names(order) == ["emit.bin", "emit.slurp", "emit.format", "emit.novel", "emit.write"]
    for a, b in zip(order, order[1:]):
        assert a[2] <= b[1]  # one after the other, on one clock


def test_mesh_reduce_is_a_span(inputs, tmp_path):
    """Under a mesh the reduction is timed only while tracing is on; its
    log line keeps the byte count either way."""
    gfa, gaf = inputs
    mesh = port_mesh.coverage_mesh([torch.device("cpu")] * 2)
    off, log_off = _augment(gaf, gfa, tmp_path / "off.gfa", mesh=mesh)
    trace.enable()
    on, log_on = _augment(gaf, gfa, tmp_path / "on.gfa", mesh=mesh)
    spans = trace.snapshot()["spans"]
    assert on == off == _host_bytes(gaf, gfa)
    line_off = next(x for x in log_off.splitlines() if "partials reduced" in x)
    line_on = next(x for x in log_on.splitlines() if "partials reduced" in x)
    assert line_off.endswith("bytes of partials reduced")
    assert line_on.startswith(line_off + " in ") and line_on.endswith("s")
    (reduce,) = [s for s in spans if s[0] == "device.mesh_reduce"]
    assert spans[reduce[3]][0] == "native.stream"
    assert "device.h2d" not in _names(spans)  # the mesh step copies the shards itself
    assert _names(spans).count("device.launch") == _names(spans).count("device.add_slots")


def test_spans_line_up_with_their_profiler_twins(inputs, tmp_path):
    """Each span opened in Python enters ``record_function`` while a
    profiler records; mapped onto the host clock by the benchmark's window
    mark, each twin starts within 1 ms of the span. (The process's first
    ``record_function`` takes ~1.3 ms here, which would shift the mark's
    mapping by as much: one is entered before the mark.)"""
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path.insert(0, str(REPO_ROOT))
    from pbench.trace import WINDOW_MARK

    gfa, gaf = inputs
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        with record_function(WINDOW_MARK):
            t0 = time.perf_counter()
            _augment(gaf, gfa, tmp_path / "on.gfa")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    mark = next(e for e in events if e["name"] == WINDOW_MARK)
    base = float(mark["ts"]) - t0 * 1e6  # as pbench.trace.reduce_trace maps the device ops
    spans = [s for s in trace.snapshot()["spans"] if s[0] not in EMIT_PHASES]
    assert len(spans) > 50
    for name in set(_names(spans)):
        ours = sorted(s[1] / 1e9 for s in spans if s[0] == name)
        twins = sorted((float(e["ts"]) - base) / 1e6 for e in events if e["name"] == name)
        assert len(twins) == len(ours), name
        assert max(abs(a - b) for a, b in zip(ours, twins)) < 1e-3, name


def test_record_add_reset_and_threads(monkeypatch):
    monkeypatch.setitem(kernels.LAUNCHES, "coverage_scatter_add", 5)
    trace.enable()
    trace.reset()
    with trace.span("outer") as outer:
        trace.record("stamped", 10, 20)
        trace.add("n")
        trace.add("n", 4)
        worker = threading.Thread(target=lambda: trace.span("other").__enter__().__exit__())
        worker.start()
        worker.join()
    kernels.LAUNCHES["coverage_scatter_add"] += 3
    snap = trace.snapshot()
    by_name = {s[0]: s for s in snap["spans"]}
    assert by_name["outer"][3] == -1 and by_name["stamped"][3] == 0
    assert by_name["stamped"][1:3] == (10, 20)
    assert by_name["other"][3] == -1  # another thread's stack is its own
    assert by_name["other"][4] != by_name["outer"][4]
    assert outer.seconds >= 0
    assert snap["counters"] == {"n": 5, "kernels.launches": 3}
    trace.reset()
    assert trace.snapshot() == {"spans": [], "counters": {"kernels.launches": 0}}


@pytest.mark.cuda
def test_card_readback_waits_and_launches_count(inputs, tmp_path):
    """On the card: the read-back's nonzero count is its own span, and the
    launches since the reset equal the batches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    gfa, gaf = inputs
    trace.enable()
    log = io.StringIO()
    with open(tmp_path / "on.gfa", "w") as out:
        port.augment_gfa_device_native(str(gaf), str(gfa), out=out, device="cuda",
                                       flush_every=FLUSH, log=log)
    snap = trace.snapshot()
    assert (tmp_path / "on.gfa").read_bytes() == _host_bytes(gaf, gfa)
    spans = snap["spans"]
    (sync,) = [s for s in spans if s[0] == "device.readback_sync"]
    assert spans[sync[3]][0] == "device.readback"
    batches = _names(spans).count("device.add_slots")
    assert snap["counters"]["kernels.launches"] == batches == snap["counters"]["device.batches"]
    assert snap["counters"]["device.readback_nnz"] > 0


# --- the device call -------------------------------------------------------

FINDERS = ("es", "ss", "ir")
# the device call's spans on the CPU, each with its parents (``call.rows``
# closes each finder's part)
CALL_PARENTS = {
    "stage.call": {None},
    "call.graph_load": {"stage.call"},
    "call.gtf": {"stage.call"},
    **{f"call.{f}": {"stage.call"} for f in FINDERS},
    **{f"call.{f}.{part}": {f"call.{f}"} for f in FINDERS for part in ("candidates", "match")},
    "call.rows": {f"call.{f}" for f in FINDERS},
}
# the novel pass's spans under its root: each finder's span holds its host
# half and its match, the host enumerator's its two loops
NOVEL_PARENTS = {
    **{f"call.{f}": {"stage.call"} for f in ("novel_es", "novel_ss", "novel_ce", "novel_walk")},
    **{f"call.{f}.{part}": {f"call.{outer}"}
       for f, outer in (("novel_es", "novel_es"), ("novel_ss_exonic", "novel_ss"),
                        ("novel_ce", "novel_ce"))
       for part in ("candidates", "match")},
    "call.novel_walk.novel_junctions": {"call.novel_walk"},
    "call.novel_walk.annotated_junctions": {"call.novel_walk"},
}


@pytest.fixture
def call_inputs(tmp_path):
    from fixtures_call import write_call_fixtures

    return write_call_fixtures(tmp_path)["splice"]


def _call(gfa, gtf, **opts) -> list:
    from pantas_tpu_torch.events.batched import call_events_device
    from pantas_tpu_torch.events.caller import CallOptions

    return list(call_events_device(gfa, gtf, CallOptions(rca=0, **opts), log=io.StringIO(),
                                   devices=["cpu"]))


@pytest.mark.parametrize("novel", [False, True], ids=["annotated", "novel"])
def test_call_spans_nest_where_the_work_happens(call_inputs, novel):
    """Every span of the device call is there, nested where its work is, and
    the rows are those of an untraced call, in the same order."""
    off = _call(*call_inputs, novel=novel)
    trace.enable()
    on = _call(*call_inputs, novel=novel)
    spans = trace.snapshot()["spans"]
    assert on == off and len(on) > 1
    parents = dict(CALL_PARENTS, **(NOVEL_PARENTS if novel else {}))
    assert set(_names(spans)) == set(parents)
    assert _names(spans).count("call.rows") == len(FINDERS)
    # a root for the loads and one for each finder's part (one for the novel pass)
    roots = [s for s in spans if s[0] == "stage.call"]
    assert len(roots) == 1 + len(FINDERS) + novel
    assert all(a[2] <= b[1] for a, b in zip(roots, roots[1:]))
    me = threading.get_ident()
    for name, t0, t1, parent, thread in spans:
        assert thread == me and t0 <= t1, name
        if parent == -1:
            assert parents[name] == {None}, name
            continue
        p_name, p_t0, p_t1 = spans[parent][:3]
        assert p_name in parents[name], name
        assert p_t0 <= t0 and t1 <= p_t1, name
    # each finder's parts one after the other: candidates, match, rows
    for f in FINDERS:
        (outer,) = [i for i, s in enumerate(spans) if s[0] == f"call.{f}"]
        parts = [s for s in spans if s[3] == outer]
        assert _names(parts) == [f"call.{f}.candidates", f"call.{f}.match", "call.rows"]
        assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))


def test_call_streams_between_finders(call_inputs):
    """The header comes once the graph and the GTF are loaded, and each
    finder's part runs only when its first row is asked for."""
    from pantas_tpu_torch.events.batched import call_events_device
    from pantas_tpu_torch.events.caller import CSV_HEADER, CallOptions

    trace.enable()
    rows = call_events_device(*call_inputs, CallOptions(rca=0), log=io.StringIO(),
                              devices=["cpu"])
    assert next(rows) == CSV_HEADER
    assert _names(trace.snapshot()["spans"]) == ["stage.call", "call.graph_load", "call.gtf"]
    assert next(rows).startswith("ES,")
    names = _names(trace.snapshot()["spans"])
    assert "call.es" in names and "call.ss" not in names
    rows.close()


@pytest.mark.parametrize("novel", [False, True], ids=["annotated", "novel"])
def test_call_counts_agree_with_the_rows(call_inputs, novel):
    """``call.rows.<type>`` sum to the rows yielded, by type, and
    ``call.candidates.<finder>`` are the candidates that ``EVALS`` counted
    since the reset, the one count of them."""
    from collections import Counter

    from pantas_tpu_torch.events import batched

    trace.enable()
    trace.reset()
    before = Counter(batched.EVALS)
    rows = _call(*call_inputs, novel=novel)[1:]
    c = trace.snapshot()["counters"]
    by_type = Counter(r.split(",")[0] for r in rows)
    assert {k: v for k, v in c.items() if k.startswith("call.rows.")} == \
        {f"call.rows.{t}": n for t, n in by_type.items()}
    evals = Counter(batched.EVALS)
    evals.subtract(before)
    want = {f"call.candidates.{batched.finder_label(f)}": n for (f, _), n in evals.items() if n}
    assert {k: v for k, v in c.items() if k.startswith("call.candidates.")} == want
    assert set(want) >= {f"call.candidates.{f}" for f in FINDERS}
    assert c["call.h2d_bytes"] > 4 * sum(want.values())  # the indices and the tables
    trace.reset()
    assert trace.snapshot()["counters"] == {"kernels.launches": 0}


@pytest.mark.parametrize("case", ["splice", "cassette"])
def test_call_novel_junctions_counts_the_graphs_novel_links(tmp_path, case):
    """``call.novel_junctions`` is the number of the GFA's ``ID:Z:N`` links,
    counted once a novel call, and no annotated call counts it."""
    from fixtures_call import write_call_fixtures

    gfa, gtf = write_call_fixtures(tmp_path)[case]
    novel = sum(line.rstrip("\n").endswith("\tID:Z:N") for line in open(gfa))
    assert novel > 0
    trace.enable()
    _call(gfa, gtf)
    assert "call.novel_junctions" not in trace.snapshot()["counters"]
    rows = _call(gfa, gtf, novel=True, no_annotated=True, minintronsize=4)
    assert any(",novel," in r for r in rows)
    assert trace.snapshot()["counters"]["call.novel_junctions"] == novel


@pytest.mark.parametrize("threads", [1, 3])
def test_emitted_novel_links_are_counted_in_first_seen_order(tmp_path, threads):
    """A GAF whose records cross two absent links, the second one's first
    (1>3) a third of the way in and the first one's (3>5) two thirds in:
    the device augment appends both, in that order, as the host engine
    does, also when the parse's waves cut the file into pieces, and
    ``emit.novel_links`` counts them."""
    from fixtures_micro import MICRO_GAF_LINES

    gfa, _ = write_micro(tmp_path)
    by_name = {line.split("\t", 1)[0]: line for line in MICRO_GAF_LINES}
    plain = "".join(line + "\n" for name, line in by_name.items() if name not in ("r9", "r12"))
    block = plain * 1500
    gaf = tmp_path / "late.gaf"
    gaf.write_text(block + by_name["r12"] + "\n" + block + by_name["r9"] + "\n" + block)
    trace.enable()
    out, _ = _augment(gaf, gfa, tmp_path / "on.gfa", flush_every=1 << 18, threads=threads)
    c = trace.snapshot()["counters"]
    assert out == _host_bytes(gaf, gfa)
    novel = [line.split("\t")[1:4:2] for line in out.decode().splitlines()
             if line.endswith("\tID:Z:N")]
    assert novel == [["1", "3"], ["3", "5"]]
    assert c["emit.novel_links"] == len(novel)
    assert c["slots.threads"] == threads
