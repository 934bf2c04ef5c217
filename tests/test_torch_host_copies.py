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


# The mapper and the host tools around it: sixteen files copied with only the
# package name changed. Three lines of the originals are reworded in the port
# (a docstring that names a directory outside the repo, and one parameter's
# name): each is given here by its line number, with the port's text.
COPIED_FILES = {
    "mapping/__init__.py": {}, "mapping/mapper.py": {}, "mapping/prefilter.py": {},
    "eval/exps_helpers.py": {}, "build/legacy.py": {}, "coverage/gamp.py": {},
    "eval/simulate.py": {}, "eval/compare.py": {}, "eval/converters.py": {},
    "eval/mapper_accuracy.py": {}, "eval/gaf2sam.py": {}, "eval/support.py": {},
    "eval/introns.py": {}, "eval/bench.py": {},
    "eval/sim_truth.py": {
        6: "* :func:`simrc` — ``exps/1-dm-sim/scripts/simrc.py:1-187`` of the reference:"},
    "eval/cmp_tools.py": {
        317: "def _load_csv(path: str, make_event, min_dpsi: float, skip_haplotype=False,",
        326: "        e = make_event(fields)"},
}


@pytest.mark.parametrize("rel", sorted(COPIED_FILES))
def test_copied_source_differs_only_in_the_package_name(rel):
    original = (REPO_ROOT / "pantas_tpu" / rel).read_text()
    expected = original.replace("pantas_tpu", "pantas_tpu_torch").split("\n")
    for lineno, text in COPIED_FILES[rel].items():
        expected[lineno - 1] = text
    assert (REPO_ROOT / "pantas_tpu_torch" / rel).read_text().split("\n") == expected


SIM_FILES = ["c1_1.fq", "c1_2.fq", "c2_1.fq", "c2_2.fq", "truth.csv", "event_annotation.tsv",
             "exon_junction.tsv", "variants.gtf"]


@pytest.fixture(scope="module")
def sim_reads(graphs, tmp_path_factory):
    """``sim`` of both packages on the synthetic graph's FASTA and GTF, from
    one seed, with substitution errors: 4 events, about 850 pairs a
    condition. Returns the directory of each."""
    theirs, _ = graphs
    dirs = []
    for pkg in ("pantas_tpu", "pantas_tpu_torch"):
        wd = tmp_path_factory.mktemp(f"sim_{pkg}")
        run_cli([sys.executable, "-m", pkg, "sim", str(theirs / "g.fa"), str(theirs / "g.gtf"),
                 "-o", str(wd / "sim"), "-n", "4", "-r", "40", "-e", "0.01", "--seed", "3"])
        dirs.append(wd)
    return dirs


def test_sim_artifacts_identical(sim_reads):
    theirs, ours = sim_reads
    assert sorted(p.name for p in ours.iterdir()) == sorted(f"sim_{n}" for n in SIM_FILES)
    _same_files(theirs, ours, [f"sim_{n}" for n in SIM_FILES])
    assert (ours / "sim_truth.csv").read_text().count("\n") == 5


def test_sim_replicates_and_depths_identical(graphs, tmp_path):
    """The options the CLI does not reach (replicates, unequal depths, a
    weaker signal, every event kind), through the functions."""
    from pantas_tpu.eval.simulate import simulate as theirs
    from pantas_tpu_torch.eval.simulate import simulate as ours

    wd = graphs[0]
    kw = dict(n_events=5, reads_per_isoform=10, error_rate=0.02, seed=5, replicates=2, dpsi=0.3,
              depth_factors=(1.0, 0.5), min_pairs=2, etypes=("ES", "IR", "A3", "A5", "CE"),
              log=io.StringIO())
    for name, fn in (("a", theirs), ("b", ours)):
        (tmp_path / name).mkdir()
        fn(str(wd / "g.fa"), str(wd / "g.gtf"), str(tmp_path / name / "s"), **kw)
    names = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert len(names) == 12 and names == sorted(p.name for p in (tmp_path / "b").iterdir())
    _same_files(tmp_path / "a", tmp_path / "b", names)


def _map_cli(pkg, gfa, reads, out, *flags):
    proc = run_cli([sys.executable, "-m", pkg, "map", str(gfa), *map(str, reads), "-o", str(out),
                    *flags])
    return proc.stderr


def _native_core_ran(log: str) -> bool:
    """``map`` falls back to its Python path in silence; the log tells."""
    return (("[map] native alignment core" in log or "[map] index cache hit" in log)
            and "[map] phases" in log and "python path" not in log)


@pytest.mark.parametrize("ends", ["paired", "single"])
def test_map_native_identical_through_both_clis(graphs, sim_reads, tmp_path, ends):
    """The native core through both CLIs on simulated reads with errors:
    same bytes, for one thread and for four."""
    gfa = graphs[1] / "out" / "pantranscriptome-annotated.gfa"
    reads = [sim_reads[1] / "sim_c2_1.fq", sim_reads[1] / "sim_c2_2.fq"][: 2 if ends == "paired" else 1]
    _map_cli("pantas_tpu", gfa, reads, tmp_path / "a.gaf")
    log = _map_cli("pantas_tpu_torch", gfa, reads, tmp_path / "b.gaf")
    assert _native_core_ran(log)
    gaf = (tmp_path / "b.gaf").read_bytes()
    assert gaf == (tmp_path / "a.gaf").read_bytes()
    n_reads = sum(p.read_text().count("\n") // 4 for p in reads)
    assert gaf.count(b"\n") == n_reads and b"*" in gaf and b"\tcs:Z:" in gaf
    log = _map_cli("pantas_tpu_torch", gfa, reads, tmp_path / "t4.gaf", "-t", "4")
    assert _native_core_ran(log) and (tmp_path / "t4.gaf").read_bytes() == gaf


def test_map_python_engine_identical(graphs, sim_reads, tmp_path):
    """The Python path of both packages, and it against the native core."""
    from pantas_tpu.mapping.mapper import map_reads as theirs
    from pantas_tpu_torch.mapping.mapper import map_reads as ours

    gfa = str(graphs[1] / "out" / "pantranscriptome-annotated.gfa")
    fq1, fq2 = tmp_path / "r_1.fq", tmp_path / "r_2.fq"
    for src, dst in ((sim_reads[1] / "sim_c2_1.fq", fq1), (sim_reads[1] / "sim_c2_2.fq", fq2)):
        dst.write_text("".join(src.read_text().splitlines(keepends=True)[:400]))
    outs = []
    for fn, engine in ((theirs, "python"), (ours, "python"), (ours, "native")):
        buf, log = io.StringIO(), io.StringIO()
        mapped, total = fn(gfa, str(fq1), str(fq2), out=buf, log=log, engine=engine)
        assert total == 200 and mapped > 150
        assert ("native alignment core" in log.getvalue()) == (engine == "native")
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == outs[2]


def test_map_gz_input_identical(graphs, sim_reads, tmp_path):
    import gzip

    gfa = graphs[1] / "out" / "pantranscriptome-annotated.gfa"
    plain = sim_reads[1] / "sim_c1_1.fq"
    gz = tmp_path / "r.fq.gz"
    with gzip.open(gz, "wb") as fh:
        fh.write(plain.read_bytes())
    _map_cli("pantas_tpu", gfa, [gz], tmp_path / "a.gaf")
    assert _native_core_ran(_map_cli("pantas_tpu_torch", gfa, [gz], tmp_path / "b.gaf"))
    _map_cli("pantas_tpu_torch", gfa, [plain], tmp_path / "plain.gaf")
    assert ((tmp_path / "a.gaf").read_bytes() == (tmp_path / "b.gaf").read_bytes()
            == (tmp_path / "plain.gaf").read_bytes())
    # and a compressed GAF comes out the same once inflated
    _map_cli("pantas_tpu_torch", gfa, [gz], tmp_path / "c.gaf.gz")
    assert gzip.open(tmp_path / "c.gaf.gz").read() == (tmp_path / "b.gaf").read_bytes()


def test_map_indel_reads_identical(tmp_path):
    """Reads carrying a deletion and an insertion against one path: gap ops in
    the ``cs`` tag, the same from both packages and both engines."""
    from test_mapper_indel import _mk_path

    from pantas_tpu.mapping import mapper as theirs
    from pantas_tpu_torch.mapping import mapper as ours

    rec = _mk_path()
    gfa = tmp_path / "g.gfa"
    lines = [f"S\t{nid}\t{rec.seq[i * 25:(i + 1) * 25]}" for i, nid in enumerate(rec.nodes)]
    lines += [f"L\t{a}\t+\t{b}\t+\t*" for a, b in zip(rec.nodes, rec.nodes[1:])]
    lines.append("P\tT1_R1\t" + ",".join(n + "+" for n in rec.nodes) + "\t*")
    gfa.write_text("\n".join(lines) + "\n")
    seq = rec.seq
    reads = {"rd": seq[10:80] + seq[84:150], "ri": seq[10:90] + "ACGTA" + seq[90:150],
             "rp": seq[5:155], "rr": ours.revcomp(seq[10:80] + seq[84:150])}
    fq = tmp_path / "r.fq"
    fq.write_text("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads.items()))
    _map_cli("pantas_tpu", gfa, [fq], tmp_path / "a.gaf")
    assert _native_core_ran(_map_cli("pantas_tpu_torch", gfa, [fq], tmp_path / "b.gaf"))
    gaf = (tmp_path / "b.gaf").read_text()
    assert gaf == (tmp_path / "a.gaf").read_text()
    assert "-" in gaf.split("cs:Z:")[1] and "+acgta" in gaf
    for mod in (theirs, ours):
        buf = io.StringIO()
        mod.map_reads(str(gfa), str(fq), out=buf, log=io.StringIO(), engine="python")
        assert buf.getvalue() == gaf
    # the Python aligner's pieces, not only its text
    a = theirs.align_read(theirs.PathIndex([rec]), reads["ri"])
    b = ours.align_read(ours.PathIndex([ours.PathRecord(rec.name, rec.nodes, rec.offsets, rec.seq)]),
                        reads["ri"])
    assert [(p.ops, p.qstart, p.qend) for p in a.pieces] == [(p.ops, p.qstart, p.qend)
                                                             for p in b.pieces]


@pytest.mark.parametrize("writer", ["pantas_tpu", "pantas_tpu_torch"])
def test_map_index_cache_carries_between_packages(graphs, sim_reads, tmp_path, writer):
    """The cache is ``.npy`` files and ``meta.json``: written by one package,
    it is a hit in the other, and the GAF is the uncached one."""
    reader = "pantas_tpu_torch" if writer == "pantas_tpu" else "pantas_tpu"
    gfa = graphs[1] / "out" / "pantranscriptome-annotated.gfa"
    reads = [sim_reads[1] / "sim_c1_1.fq", sim_reads[1] / "sim_c1_2.fq"]
    cache = tmp_path / "idx"
    log = _map_cli(writer, gfa, reads, tmp_path / "w.gaf", "--index", str(cache))
    assert "[map] index cached ->" in log and "cache hit" not in log
    assert (cache / "meta.json").exists() and list(cache.glob("*.npy"))
    log = _map_cli(reader, gfa, reads, tmp_path / "r.gaf", "--index", str(cache), "-t", "2")
    assert "[map] index cache hit" in log and "[map] phases" in log and "rebuilding" not in log
    _map_cli(reader, gfa, reads, tmp_path / "plain.gaf")
    assert ((tmp_path / "w.gaf").read_bytes() == (tmp_path / "r.gaf").read_bytes()
            == (tmp_path / "plain.gaf").read_bytes())


@pytest.mark.parametrize("ends", ["paired", "single"])
def test_prefilter_identical_for_both_engines(tmp_path, ends):
    """The two FASTQs and the TSV of ``prefilter``, native and Python engine,
    through both CLIs: four runs, one answer."""
    from test_prefilter import _mk_inputs

    fa, p1, p2, truth = _mk_inputs(tmp_path)
    answers = []
    for pkg in ("pantas_tpu", "pantas_tpu_torch"):
        for engine in ("native", "python"):
            o1, o2 = tmp_path / f"{pkg}.{engine}.1.fq", tmp_path / f"{pkg}.{engine}.2.fq"
            mates = ["-2", str(p2), "-p", str(o2)] if ends == "paired" else []
            proc = run_cli([sys.executable, "-m", pkg, "prefilter", "-r", str(fa), "-1", str(p1),
                            "-o", str(o1), *mates, "--engine", engine, "--threads", "2"])
            answers.append((o1.read_text(), o2.read_text() if mates else "", proc.stdout))
    assert answers[0] == answers[1] == answers[2] == answers[3]
    kept = dict(line.split("\t") for line in answers[3][2].splitlines())
    if ends == "paired":
        assert kept == {n: g for n, g in truth.items() if g is not None}
    assert kept and answers[3][0].count("\n") == 4 * len(kept)


def test_prefilter_then_filter_reads_then_map(graphs, sim_reads, tmp_path):
    """The chain prefilter -> filter-reads -> map on the port alone, against
    the same chain on the JAX package."""
    wd = graphs[1]
    gfa = wd / "out" / "pantranscriptome-annotated.gfa"
    from pantas_tpu_torch.io.fasta import read_fasta
    from pantas_tpu_torch.io.gtf import parse_transcript_models

    chroms = read_fasta(str(wd / "g.fa"))
    models = parse_transcript_models(str(wd / "g.gtf"))
    panel = tmp_path / "panel.fa"
    genes = {}
    for tr in models.values():
        lo, hi = min(s for s, _ in tr.exons), max(e for _, e in tr.exons)
        genes.setdefault(tr.gene, chroms[tr.chrom][lo - 1:hi])
    panel.write_text("".join(f">{g}\n{s}\n" for g, s in sorted(genes.items())[:3]))
    gafs = []
    for pkg in ("pantas_tpu", "pantas_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        run_cli([sys.executable, "-m", pkg, "prefilter", "-r", str(panel),
                 "-1", str(sim_reads[1] / "sim_c2_1.fq"), "-2", str(sim_reads[1] / "sim_c2_2.fq"),
                 "-o", str(d / "f_1.fq"), "-p", str(d / "f_2.fq")], out_path=d / "assoc.tsv")
        run_cli([sys.executable, "-m", pkg, "filter-reads", "--seed", "1", str(d / "f_1.fq"),
                 str(d / "f_2.fq")])
        _map_cli(pkg, gfa, [d / "f_1.clean.fq", d / "f_2.clean.fq"], d / "out.gaf")
        gafs.append((d / "assoc.tsv").read_bytes() + (d / "out.gaf").read_bytes())
    assert gafs[0] == gafs[1] and gafs[1].count(b"\n") > 20


def test_map_accuracy_report_identical(graphs):
    gfa = str(graphs[1] / "out" / "pantranscriptome-annotated.gfa")
    args = ["map-accuracy", gfa, "-n", "150", "-l", "100", "-d", "0,0.02", "-s", "5"]
    theirs = run_cli([sys.executable, "-m", "pantas_tpu", *args])
    ours = run_cli([sys.executable, "-m", "pantas_tpu_torch", *args])
    assert ours.stdout == theirs.stdout and ours.stdout.count("\n") > 3
