"""The host tools around the mapper through both CLIs, ``python -m pantas_tpu``
and ``python -m pantas_tpu_torch``, in subprocesses on the same hand-built
inputs: every output byte-equal (tolerance 0). The inputs are the ones the JAX
package's own tests build; no file outside the repo is read."""

import subprocess
import sys

import pytest
from conftest import REPO_ROOT, run_cli

PACKAGES = ("pantas_tpu", "pantas_tpu_torch")


def _both(args, **kw):
    """``args`` through both CLIs; both exit 0 and print the same bytes."""
    theirs, ours = (run_cli([sys.executable, "-m", pkg, *map(str, args)], **kw)
                    for pkg in PACKAGES)
    assert ours.stdout == theirs.stdout
    return ours.stdout


def _twice(tmp_path):
    """A directory for each package, for tools that write beside their input."""
    dirs = [tmp_path / pkg for pkg in PACKAGES]
    for d in dirs:
        d.mkdir()
    return dirs


@pytest.mark.parametrize("flags", [[], ["-w", "0"], ["-w", "2"], ["-w", "1", "-t", "ENSTB"]],
                         ids=["default", "w0", "w2", "w1-prefix"])
def test_prune(tmp_path, flags):
    from test_legacy_tools import _make_gfa

    out = _both(["prune", *flags, _make_gfa(tmp_path)])
    assert out.startswith("H\t") and "\nP\t" in out


def test_reintroduce_paths(tmp_path):
    from test_legacy_tools import _make_gfa

    gfa = _make_gfa(tmp_path)
    pruned = tmp_path / "pruned.gfa"
    pruned.write_text(_both(["prune", "-w", "20", gfa]))
    out = _both(["reintroduce-paths", gfa, pruned])
    assert "P\tENSTA\t" in out


def test_reintroduce_paths_fails_empty_on_missing_edge(tmp_path):
    from test_legacy_tools import _make_gfa

    gfa = _make_gfa(tmp_path)
    pruned = tmp_path / "pruned.gfa"
    pruned.write_text("H\tVN:Z:1.1\nL\t1\t+\t2\t+\t*\n")
    codes = []
    for pkg in PACKAGES:
        proc = subprocess.run([sys.executable, "-m", pkg, "reintroduce-paths", str(gfa),
                               str(pruned)], capture_output=True, cwd=REPO_ROOT)
        assert proc.stdout == b""
        codes.append(proc.returncode)
    assert codes[0] == codes[1] != 0


@pytest.mark.parametrize("flags", [[], ["--IS"]], ids=["checked", "IS"])
def test_add_junctions(tmp_path, flags):
    from test_legacy_annotators import _mk_junction_inputs

    gfa, fa = _mk_junction_inputs(tmp_path)
    out = _both(["add-junctions", *flags, gfa, fa])
    assert "JN:Z:T1.1.2" in out and "EX:Z:" in out


def test_add_haplotypes(tmp_path):
    from test_legacy_annotators import _mk_haplotype_inputs

    gfa, vcf = _mk_haplotype_inputs(tmp_path)
    out = _both(["add-haplotypes", gfa, vcf])
    assert "_alt_" not in out and "10+" in out and "|" in out


def test_gamp(tmp_path):
    from test_gamp_differential import _write_inputs

    js, gfa = _write_inputs(tmp_path)
    paths = [tmp_path / f"{pkg}.path" for pkg in PACKAGES]
    outs = [run_cli([sys.executable, "-m", pkg, "gamp", str(js), str(p), str(gfa)]).stdout
            for pkg, p in zip(PACKAGES, paths)]
    assert outs[0] == outs[1] and "RC:i:" in outs[1]
    assert paths[0].read_bytes() == paths[1].read_bytes() != b""


def test_gaf2sam_graph_and_positions_modes(tmp_path):
    from test_gaf2sam import _fixture

    gfa, pos, gaf = _fixture(tmp_path)
    sam = _both(["gaf2sam", gaf, gfa, "--debug"])
    assert sam.startswith("@HD") and "r_fwd" in sam
    by_table = _both(["gaf2sam", gaf, gfa, pos, "--sq", "hg38"])
    assert by_table.count("\n") > 21 and "r_fwd" in by_table


def test_gaf2sam_refuses_positions_without_sq(tmp_path):
    from test_gaf2sam import _fixture

    gfa, pos, gaf = _fixture(tmp_path)
    for pkg in PACKAGES:
        proc = subprocess.run([sys.executable, "-m", pkg, "gaf2sam", str(gaf), str(gfa), str(pos)],
                              capture_output=True, text=True, cwd=REPO_ROOT)
        assert proc.returncode == 2 and proc.stdout == ""
        assert "positions-file mode needs an explicit --sq" in proc.stderr


def _support_inputs(tmp_path):
    from test_support import _gtf

    gtf = _gtf(tmp_path)
    sam = tmp_path / "a.sam"
    sam.write_text(
        "@HD\tVN:1.5\n"
        "r1\t0\tc\t150\t60\t51M99N50M\t*\t0\t0\t*\t*\n"
        "r2\t0\tc\t150\t60\t51M299N100M\t*\t0\t0\t*\t*\n"
        "r3\t0\tX\t150\t60\t51M99N50M\t*\t0\t0\t*\t*\n"
        "r5\t0\tc\t250\t60\t100M\t*\t0\t0\t*\t*\n"
    )
    events = tmp_path / "ev.txt"
    events.write_text("c:300-400\nc:1200-1300\n")
    return events, gtf, sam


def test_check_coverage(tmp_path):
    events, gtf, sam = _support_inputs(tmp_path)
    out = _both(["check-coverage", events, gtf, sam, sam])
    assert f"c:300-400 {sam} 1 1\n" in out


def test_check_novel(tmp_path):
    events, gtf, _ = _support_inputs(tmp_path)
    assert _both(["check-novel", events, gtf]) == "c:1200-1300 True\nc:300-400 False\n"


def test_introns_model_file(tmp_path):
    """The fitted model file on the 0.05 Mbp synthetic annotation."""
    from pantas_tpu_torch.eval.synth import gen_inputs

    gen_inputs(tmp_path, mbp=0.05, n_var=50, n_genes=5, n_samples=2)
    models = [tmp_path / f"{pkg}.model" for pkg in PACKAGES]
    for pkg, model in zip(PACKAGES, models):
        run_cli([sys.executable, "-m", pkg, "introns", "-g", str(tmp_path / "g.gtf"),
                 "-o", str(model)])
    assert models[0].read_bytes() == models[1].read_bytes()
    lines = models[1].read_text().splitlines()
    assert len(lines) == 1 + 3 * int(lines[0])


def test_timev_and_bench_table(tmp_path):
    """``timev`` writes the same fields (the times and the peak memory are
    the run's own); ``bench-table`` folds the same logs into the same CSV."""
    from test_bench_tools import SAMPLE

    logs = []
    for pkg in PACKAGES:
        log = tmp_path / f"{pkg}.time"
        run_cli([sys.executable, "-m", pkg, "timev", "-o", str(log), "--",
                 sys.executable, "-c", "x = sum(range(10**5))"])
        logs.append(log.read_text().splitlines())
    labels = [[line.split(": ")[0] for line in log] for log in logs]
    assert labels[0] == labels[1] and len(labels[1]) == 6
    assert logs[0][0] == logs[1][0] and logs[0][-1] == logs[1][-1] == "\tExit status: 0"
    failing = subprocess.run(
        [sys.executable, "-m", "pantas_tpu_torch", "timev", "-o", str(tmp_path / "f.time"),
         sys.executable, "-c", "raise SystemExit(3)"], cwd=REPO_ROOT)
    assert failing.returncode == 3

    bench = tmp_path / "bench"
    (bench / "pantas").mkdir(parents=True)
    (bench / "pantas" / "call.s1.w3.time").write_text(SAMPLE)
    (bench / "pantas" / "mpmap.s1.time").write_text(SAMPLE)
    (bench / "rmats.time").write_text(SAMPLE)
    table = _both(["bench-table", bench]).splitlines()
    assert table[0] == "tool,file_name,w,user_time,sys_time,wall_clock,max_mem"
    assert len(table) == 4


@pytest.mark.parametrize("flags", [
    ["-c", "5", "-d", "0.05", "--print"],
    ["-c", "0", "-d", "0.0", "--events", "ES", "A3", "--novel", "--tabs"],
    ["--supp", "1"],
], ids=["all-tools", "novel-tabs", "supp"])
def test_cmp(tmp_path, flags):
    from test_cmp_tools import _fixture

    truth, pantas, rmats, whippet, suppa = _fixture(tmp_path)
    tools = [] if "--novel" in flags else ["-r", rmats, "-w", whippet, "-s", suppa]
    out = _both(["cmp", "-t", truth, "-p", pantas, *tools, *flags])
    assert "pantas" in out


@pytest.mark.parametrize("flags", [[], ["--relax", "0", "--min-dpsi", "0.65"], ["--min-w", "6"]],
                         ids=["default", "strict", "min-w"])
def test_eval(tmp_path, flags):
    from test_cmp_tools import _pantas_row

    truth = tmp_path / "truth.csv"
    truth.write_text(
        "etype,gene,transcript,chrom,strand,region1,region2,region3\n"
        "ES,G1,T1,c,+,c:100-200,c:300-400,c:100-400\n"
        "IR,G1,T1,c,+,c:700-800,.,.\n"
    )
    remap = tmp_path / "remap.csv"
    remap.write_text(
        "etype,annotation_type,haplotype_type,chrom,gene,strand,junction1_name,"
        "junction2_name,junction3_name,junction1_nodes,junction2_nodes,"
        "junction3_nodes,junction1_positions,junction2_positions,"
        "junction3_positions,W1,W2,psi_c1,psi_c2,dpsi\n"
        + _pantas_row("ES", "G1", "c:101-199", "c:301-399", "c:101-399", 0.8, 0.1, 0.7).replace(
            ",5,5,", ",9/7,3/6,") + "\n"
        + _pantas_row("A3", "G1", "c:520-610", "c:520-640", ".", 0.7, 0.1, 0.6) + "\n"
    )
    out = _both(["eval", *flags, truth, remap])
    assert "ES" in out and "ALL" in out


def test_convert_rmats(tmp_path):
    from test_converters import _rmats_dir

    d = _rmats_dir(tmp_path)
    outs = [tmp_path / f"{pkg}.csv" for pkg in PACKAGES]
    for pkg, out in zip(PACKAGES, outs):
        run_cli([sys.executable, "-m", pkg, "convert-rmats", str(d), "-o", str(out)])
    assert outs[0].read_bytes() == outs[1].read_bytes()
    assert outs[1].read_bytes().count(b"\n") == 8


def test_convert_suppa(tmp_path):
    dpsi = tmp_path / "cmp.dpsi"
    dpsi.write_text(
        "name\tdPSI\tpval\n"
        "g1;SE:2L:100-200:300-400:+\t0.5\t0.01\n"
        "g1;SE:2L:100-200:300-400:+\t0.5\t0.9\n"
        "g2;A5:2L:100-200:100-300:+\t-0.4\t0.02\n"
        "g2;A3:2L:100-200:100-300:-\t-0.4\t0.02\n"
        "g4;RI:2L:100:200-300:400:+\t0.2\t0.04\n"
        "g5;RI:2L:100:200-300:400:-\tnan\tnan\n"
    )
    outs = [tmp_path / f"{pkg}.csv" for pkg in PACKAGES]
    for pkg, out in zip(PACKAGES, outs):
        run_cli([sys.executable, "-m", pkg, "convert-suppa", str(dpsi), "-o", str(out), "-p", "0.05"])
    assert outs[0].read_bytes() == outs[1].read_bytes()
    assert outs[1].read_bytes().count(b"\n") >= 4


def test_filter_reads(tmp_path):
    """The artifact pair goes and every N of a record becomes one base drawn
    from ``--seed``: the same bytes from the same seed."""
    from test_exps_helpers import FQ1, FQ2

    n_pair = "@r4/t2;mate1:1-2;mate2:3-4\n{}\n+\nIIII\n"
    cleaned = []
    for d in _twice(tmp_path):
        (d / "a_1.fq").write_text(FQ1 + n_pair.format("ANNA"))
        (d / "a_2.fq").write_text(FQ2 + n_pair.format("NCNC"))
        run_cli([sys.executable, "-m", d.name, "filter-reads", "--seed", "11",
                 str(d / "a_1.fq"), str(d / "a_2.fq")])
        cleaned.append(((d / "a_1.clean.fq").read_bytes(), (d / "a_2.clean.fq").read_bytes()))
    assert cleaned[0] == cleaned[1]
    assert b"r2/" not in cleaned[1][0] and b"N" not in cleaned[1][0].split(b"\n")[-4]


def test_fix_vidx(tmp_path):
    vcf = tmp_path / "v.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "##contig=<ID=chr4,length=100>\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        "chr4\t10\t.\tA\tT\t.\t.\t.\n"
        "chr4\t10\t.\tA\tG\t.\t.\t.\n"
        "5\t20\t.\tC\tG\t.\t.\t.\n"
    )
    out = _both(["fix-vidx", vcf])
    assert "##contig=<ID=4,length=100>" in out and "4-10.1" in out
    piped = [subprocess.run([sys.executable, "-m", pkg, "fix-vidx"], stdin=open(vcf),
                            capture_output=True, text=True, cwd=REPO_ROOT, check=True).stdout
             for pkg in PACKAGES]
    assert piped[0] == piped[1] == out


def test_clean_gtf(tmp_path):
    from test_exps_helpers import GTF

    gtf = tmp_path / "g.gtf"
    gtf.write_text(GTF)
    out = _both(["clean-gtf", gtf])
    assert {line.split('"')[1] for line in out.splitlines()} == {"G3", "G4"}


def test_sim_truth_module_equal(tmp_path):
    """``eval/sim_truth.py`` has no subcommand: ``simrc``, ``merge_rc`` and
    ``build_truth`` of both packages on one simulation of the synthetic
    annotation, same text from each."""
    import io

    from pantas_tpu.eval import sim_truth as theirs
    from pantas_tpu_torch.eval import sim_truth as ours
    from pantas_tpu_torch.eval.simulate import simulate
    from pantas_tpu_torch.eval.synth import gen_inputs

    gen_inputs(tmp_path, mbp=0.05, n_var=50, n_genes=5, n_samples=2)
    prefix = str(tmp_path / "sim")
    simulate(str(tmp_path / "g.fa"), str(tmp_path / "g.gtf"), prefix, n_events=5,
             reads_per_isoform=20, etypes=["ES", "IR", "A3", "A5", "CE"], log=io.StringIO())
    jun, ann = f"{prefix}_exon_junction.tsv", f"{prefix}_event_annotation.tsv"
    texts = []
    for mod in (theirs, ours):
        rcs = []
        for cond in ("c1", "c2"):
            rc = tmp_path / f"{mod.__name__}.{cond}.csv"
            with open(rc, "w") as fh:
                mod.simrc(f"{prefix}_{cond}_1.fq", jun, ann, fh)
            rcs.append(str(rc))
        counts = tmp_path / f"{mod.__name__}.counts.csv"
        with open(counts, "w") as fh:
            mod.merge_rc(rcs[:1], rcs[1:], fh)
        truth = io.StringIO()
        mod.build_truth(ann, str(counts), truth)
        texts.append((open(rcs[0]).read(), open(rcs[1]).read(), counts.read_text(),
                      truth.getvalue()))
    assert texts[0] == texts[1]
    assert all(part.count("\n") > 1 for part in texts[1])
