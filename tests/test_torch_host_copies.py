"""Every host module the port copied from ``pantas_tpu`` against its original,
on the same inputs: exact equality everywhere (tolerance 0). The synthetic
FA, GTF and VCF come from the generators under test, so no file outside the
repo is needed."""

import io
import sys
from dataclasses import fields
from pathlib import Path

import numpy as np
import pytest
from conftest import REPO_ROOT, run_cli
from fixtures_call import write_call_fixtures
from fixtures_micro import write_micro
from fixtures_quant import write_quant_fixtures

sys.path.insert(0, str(REPO_ROOT / "scripts"))

MBP = 0.05  # ensure_graph's smallest useful graph: 5 genes, 500 SNPs


def _same_files(a: Path, b: Path, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """``ensure_graph(0.05)`` of both packages, each in a cache of its own."""
    import bench_call_scale

    from pantas_tpu_torch.eval import synth

    theirs, ours = tmp_path_factory.mktemp("jax_cache"), tmp_path_factory.mktemp("port_cache")
    saved = bench_call_scale.CACHE, synth.CACHE
    bench_call_scale.CACHE, synth.CACHE = theirs, ours
    try:
        return bench_call_scale.ensure_graph(MBP), synth.ensure_graph(MBP)
    finally:
        bench_call_scale.CACHE, synth.CACHE = saved


def test_gen_inputs_identical(tmp_path):
    import stress_build

    from pantas_tpu_torch.eval import synth

    kw = dict(mbp=0.1, n_var=300, n_genes=6, n_samples=3, n_chroms=2, n_exons=6, n_tx=5)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    stress_build.gen_inputs(tmp_path / "a", **kw)
    synth.gen_inputs(tmp_path / "b", **kw)
    _same_files(tmp_path / "a", tmp_path / "b", ["g.fa", "g.gtf", "g.vcf"])
    # the defaults that the script took from its globals
    stress_build.gen_inputs(tmp_path / "a", mbp=0.02, n_var=50, n_genes=2)
    synth.gen_inputs(tmp_path / "b", mbp=0.02, n_var=50, n_genes=2)
    _same_files(tmp_path / "a", tmp_path / "b", ["g.fa", "g.gtf", "g.vcf"])


def test_ensure_graph_and_build_pangenome_identical(graphs):
    """The inputs and the port's own ``build_pangenome`` output, byte for
    byte: the annotated GFA and every other file of the build directory."""
    theirs, ours = graphs
    assert ours.name == theirs.name == "stress0.05m"
    _same_files(theirs, ours, ["g.fa", "g.gtf", "g.vcf"])
    built = sorted(p.name for p in (theirs / "out").iterdir() if p.is_file())
    assert "pantranscriptome-annotated.gfa" in built
    assert built == sorted(p.name for p in (ours / "out").iterdir() if p.is_file())
    _same_files(theirs / "out", ours / "out", built)
    assert (ours / "out" / "pantranscriptome-annotated.gfa").stat().st_size > 100_000


@pytest.mark.parametrize("mode", ["-a", "-r", "--no-prune", "--w-lines"])
def test_build_modes_identical(graphs, tmp_path, mode):
    theirs, _ = graphs
    inputs = [str(theirs / n) for n in ("g.fa", "g.gtf", "g.vcf")]
    from pantas_tpu import cli as tpu_cli
    from pantas_tpu_torch import cli

    assert tpu_cli.main(["build", *inputs, "-o", str(tmp_path / "a"), "-t", "1", mode]) == 0
    assert cli.main(["build", *inputs, "-o", str(tmp_path / "b"), "-t", "1", mode]) == 0
    _same_files(tmp_path / "a", tmp_path / "b", ["pantranscriptome-annotated.gfa"])


def test_synth_gaf_identical(graphs, tmp_path):
    import bench_call_scale

    from pantas_tpu_torch.eval import synth

    theirs, ours = graphs
    bench_call_scale.synth_gaf(theirs / "out" / "pantranscriptome-annotated.gfa", 2000,
                               tmp_path / "a.gaf")
    synth.synth_gaf(ours / "out" / "pantranscriptome-annotated.gfa", 2000, tmp_path / "b.gaf")
    assert (tmp_path / "a.gaf").read_bytes() == (tmp_path / "b.gaf").read_bytes()
    assert len((tmp_path / "b.gaf").read_text().splitlines()) == 2000


@pytest.mark.parametrize("engine", ["auto", "python"])
def test_compile_gfa_equal_arrays(graphs, tmp_path, engine):
    from pantas_tpu.graph import compiler as theirs
    from pantas_tpu_torch.graph import compiler as ours

    micro, _ = write_micro(tmp_path)
    for gfa in (micro, str(graphs[0] / "out" / "pantranscriptome-annotated.gfa")):
        a, b = theirs.compile_gfa(gfa, engine=engine), ours.compile_gfa(gfa, engine=engine)
        assert [f.name for f in fields(a)] == [f.name for f in fields(b)]
        for f in fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
            else:
                assert x == y, f.name


@pytest.mark.parametrize("engine", ["native", "host", "auto"])
def test_host_augment_engines_identical(graphs, tmp_path, engine):
    """The host engines on the micro fixture and on 2,000 reads of the
    synthetic graph, through both CLIs."""
    from pantas_tpu import cli as tpu_cli
    from pantas_tpu_torch import cli
    from pantas_tpu_torch.eval import synth

    big = graphs[1] / "out" / "pantranscriptome-annotated.gfa"
    reads = tmp_path / "reads.gaf"
    synth.synth_gaf(big, 2000, reads)
    for gfa, gaf in (write_micro(tmp_path), (str(big), str(reads))):
        a, b = tmp_path / "a.gfa", tmp_path / "b.gfa"
        assert tpu_cli.main(["augment", "--engine", engine, gaf, gfa, "-o", str(a)]) == 0
        assert cli.main(["augment", "--engine", engine, gaf, gfa, "-o", str(b)]) == 0
        assert a.read_bytes() == b.read_bytes()
        assert b"NC:i:" in b.read_bytes() or b"RC:i:" in b.read_bytes()


@pytest.mark.parametrize("fixture", ["splice", "cassette", "synthetic"])
@pytest.mark.parametrize("novel", [False, True], ids=["annotated", "novel"])
def test_host_caller_rows_equal(graphs, tmp_path, fixture, novel):
    """Sorted rows of the host caller under one ``PYTHONHASHSEED`` (the row
    content of the reference caller varies with the hash seed)."""
    if fixture == "synthetic":
        from pantas_tpu_torch import cli
        from pantas_tpu_torch.eval import synth

        wd = graphs[1]
        reads, aug = tmp_path / "reads.gaf", tmp_path / "aug.gfa"
        synth.synth_gaf(wd / "out" / "pantranscriptome-annotated.gfa", 2000, reads)
        assert cli.main(["augment", str(reads), str(wd / "out" / "pantranscriptome-annotated.gfa"),
                         "-o", str(aug)]) == 0
        gfa, gtf = str(aug), str(wd / "g.gtf")
    else:
        gfa, gtf = write_call_fixtures(tmp_path)[fixture]
    flags = ["--rca", "0", *(["--novel"] if novel else []), gfa, gtf]
    rows = {}
    for pkg in ("pantas_tpu", "pantas_tpu_torch"):
        out = tmp_path / f"{pkg}.csv"
        run_cli([sys.executable, "-m", pkg, "call", *flags, "-o", str(out)], hashseed="0")
        rows[pkg] = sorted(out.read_text().splitlines())
    assert rows["pantas_tpu_torch"] == rows["pantas_tpu"]
    # the cassette fixture holds novel events only
    assert len(rows["pantas_tpu"]) > 1 or (fixture == "cassette" and not novel)


@pytest.mark.parametrize("flags", [[], ["-a"], ["-w", "2"], ["--pool-w", "3"]],
                         ids=["both", "all", "w2", "pool"])
def test_quant_and_remap_identical(tmp_path, flags):
    from pantas_tpu import cli as tpu_cli
    from pantas_tpu_torch import cli

    c1, c2, gtf = write_quant_fixtures(tmp_path)
    outs = {}
    for name, main in (("a", tpu_cli.main), ("b", cli.main)):
        quant, remap = tmp_path / f"{name}_quant.csv", tmp_path / f"{name}_remap.csv"
        assert main(["quant", *flags, *c1, *c2, "-o", str(quant)]) == 0
        assert main(["remap", str(quant), gtf, "-o", str(remap)]) == 0
        outs[name] = (quant.read_bytes(), remap.read_bytes())
    assert outs["a"] == outs["b"]
    assert outs["a"][0].count(b"\n") >= 1


def test_novel_sites_identical(graphs, tmp_path):
    """``events/sites.py`` on both scan engines (the native one is the
    copied library's ``clip_sites``)."""
    from test_novel_sites import _fixture

    from pantas_tpu.events import sites as theirs
    from pantas_tpu_torch.events import sites as ours

    gaf, gfa = _fixture(tmp_path)
    for engine in ("python", "native"):
        kw = dict(w=3, min_clip=5, engine=engine)
        assert list(ours.detect_novel_sites(str(gaf), str(gfa), **kw)) == list(
            theirs.detect_novel_sites(str(gaf), str(gfa), **kw))
        both = dict(kw, include_boundary=True)
        assert list(ours.detect_novel_sites(str(gaf), str(gfa), **both)) == list(
            theirs.detect_novel_sites(str(gaf), str(gfa), **both))


@pytest.mark.parametrize("n", [1, 2, 5, 64])
@pytest.mark.parametrize("tail", ["\n", ""], ids=["newline-at-end", "no-newline-at-end"])
def test_shard_byte_ranges_identical(tmp_path, n, tail):
    """``parallel/distributed.py::shard_byte_ranges`` on the micro GAF, also
    with more ranges than the file has lines."""
    from pantas_tpu.parallel import distributed as theirs
    from pantas_tpu_torch.parallel import distributed as ours

    _, gaf = write_micro(tmp_path)
    path = tmp_path / "r.gaf"
    path.write_text(open(gaf).read().rstrip("\n") + tail)
    ranges = ours.shard_byte_ranges(str(path), n)
    assert ranges == theirs.shard_byte_ranges(str(path), n)
    assert len(ranges) == n and sum(hi - lo for lo, hi in ranges) == path.stat().st_size


def test_slot_encoder_and_counts_from_device_equal(tmp_path):
    """``SlotEncoder``, ``counts_from_device`` and ``_estimate_batches`` of
    the port's device module against the JAX package's."""
    import gzip

    from pantas_tpu.coverage import device as theirs
    from pantas_tpu.coverage.semantics import read_events
    from pantas_tpu.graph.compiler import compile_gfa
    from pantas_tpu.io.gaf import parse_gaf_line
    from pantas_tpu_torch.coverage import device as ours

    gfa, gaf = write_micro(tmp_path)
    t = compile_gfa(gfa)
    node_len = {n: int(l) for n, l in zip(t.node_names, t.node_len)}
    encs = theirs.SlotEncoder(t), ours.SlotEncoder(t)
    for pos, line in enumerate(open(gaf)):
        ev = read_events(parse_gaf_line(line), node_len, 20)
        if not isinstance(ev, str) and hasattr(ev, "nodes"):
            for enc in encs:
                enc.cur_pos = pos
                enc.add(ev)
    a, b = encs
    assert (a.il_seen, a.ol_seen, a.novel, a.novel_order, a.novel_first) == (
        b.il_seen, b.ol_seen, b.novel, b.novel_order, b.novel_first)
    slots_a, slots_b = a.take_slots(), b.take_slots()
    assert slots_a.dtype == slots_b.dtype and np.array_equal(slots_a, slots_b) and len(slots_a)
    flat = np.bincount(slots_a, minlength=t.total_slots).astype(np.int32)
    ca, cb = theirs.counts_from_device(t, a, flat), ours.counts_from_device(t, b, flat)
    assert (ca.nc, ca.il, ca.ol, ca.edge, ca.node_len) == (cb.nc, cb.il, cb.ol, cb.edge, cb.node_len)

    plain = tmp_path / "r.gaf"
    plain.write_text(open(gaf).read() * 500)
    gz = tmp_path / "r.gaf.gz"
    with gzip.open(gz, "wb") as fh:
        fh.write(plain.read_bytes())
    zst = tmp_path / "r.gaf.zst"
    zst.write_bytes(b"x" * 1000)
    for path in (plain, gz, zst, tmp_path / "missing.gaf"):
        for flush in (64, 1 << 20):
            assert ours._estimate_batches(str(path), flush) == theirs._estimate_batches(
                str(path), flush)


def test_io_parsers_equal(graphs, tmp_path):
    """The copied format layer on the synthetic inputs: same records."""
    import pantas_tpu.io.fasta as fa_a
    import pantas_tpu.io.gfa as gfa_a
    import pantas_tpu.io.gtf as gtf_a
    import pantas_tpu.io.vcf as vcf_a
    import pantas_tpu_torch.io.fasta as fa_b
    import pantas_tpu_torch.io.gfa as gfa_b
    import pantas_tpu_torch.io.gtf as gtf_b
    import pantas_tpu_torch.io.vcf as vcf_b

    wd = graphs[0]
    assert fa_a.read_fasta(str(wd / "g.fa")) == fa_b.read_fasta(str(wd / "g.fa"))
    assert gtf_a.parse_transcript_maps(str(wd / "g.gtf")) == gtf_b.parse_transcript_maps(
        str(wd / "g.gtf"))
    assert gtf_a.chromosomes(str(wd / "g.gtf")) == gtf_b.chromosomes(str(wd / "g.gtf"))
    sa, va = vcf_a.read_vcf(str(wd / "g.vcf"))
    sb, vb = vcf_b.read_vcf(str(wd / "g.vcf"))
    assert sa == sb and len(va) == len(vb) == 500
    assert [repr(v) for v in va] == [repr(v) for v in vb]
    gfa = str(wd / "out" / "pantranscriptome-annotated.gfa")
    assert [repr(r) for r in gfa_a.iter_gfa(gfa)] == [repr(r) for r in gfa_b.iter_gfa(gfa)]


@pytest.mark.parametrize("feed", ["python", "native"])
@pytest.mark.parametrize("mesh", [None, "2x4"], ids=["single", "mesh2x4"])
def test_checkpoint_payload_holds_no_package_class(tmp_path, feed, mesh):
    """Checkpoints carry between the packages because the pickle names
    nothing of either: every global it loads is numpy's or a builtin's."""
    import pickle

    import torch

    from pantas_tpu_torch.coverage import device as port
    from pantas_tpu_torch.parallel.mesh import coverage_mesh_2d

    gfa, gaf = write_micro(tmp_path)
    ck = tmp_path / "ck.pkl"
    fn = port.augment_gfa_device if feed == "python" else port.augment_gfa_device_native
    kw = {"mesh": coverage_mesh_2d([torch.device("cpu")] * 8, 2, 4)} if mesh else {"device": "cpu"}
    fn(gaf, gfa, out=io.StringIO(), log=io.StringIO(), flush_every=8, checkpoint_path=str(ck),
       checkpoint_every=1, **kw)
    modules = set()

    class Recorder(pickle.Unpickler):
        def find_class(self, module, name):
            modules.add(module)
            return super().find_class(module, name)

    with open(ck, "rb") as fh:
        state = Recorder(fh).load()
    assert state["total_slots"] > 0
    assert modules and all(m.split(".")[0] in ("numpy", "builtins") for m in modules), modules
