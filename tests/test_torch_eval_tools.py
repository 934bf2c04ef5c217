"""The comparison and figure layer of the evaluation harness through the CLI of
``pantas_tpu`` and of ``pantas_tpu_torch`` on the same inputs:
``compare-rtpcr``, ``parse-res`` (also ``--figures``), ``plot-pr`` and
``latex-table``. Tolerance: exact, stdout and every file byte for byte.

Each package runs every case in one process of its own (the two processes
side by side), in the same order, under ``PYTHONHASHSEED=0``
(``compare-rtpcr`` prints raw Python sets) and ``MPLBACKEND=Agg`` (the figure
layer sets seaborn's and matplotlib's global state, so the two packages never
share a process). A case's stdout and stderr are caught at the file
descriptors: ``compare-rtpcr`` binds ``sys.stdout`` when it is imported.

The inputs are the JAX package's own fixtures, taken by import from its
tests of these modules."""

import json
import os
import subprocess
import sys

import pytest
from conftest import REPO_ROOT
from test_aggregate import _write_fixtures
from test_plots import _write_compare_csv
from test_rtpcr import PANTAS, RMATS, SUPPA, TRUTH, WHIPPET

PACKAGES = ("pantas_tpu", "pantas_tpu_torch")

# runs each case of argv[2] through ``<argv[1]>.cli.main``; a case's stdout and
# stderr go to ``<case>.out`` and ``<case>.err``; prints the exit codes
CASE_RUNNER = """
import json, os, sys, traceback
from importlib import import_module
cli = import_module(sys.argv[1] + ".cli")
rcs = {}
for case, argv in json.loads(sys.argv[2]):
    saved = os.dup(1), os.dup(2)
    with open(case + ".out", "w") as out, open(case + ".err", "w") as err:
        os.dup2(out.fileno(), 1)
        os.dup2(err.fileno(), 2)
        try:
            rc = cli.main(argv)
        except SystemExit as e:
            rc = e.code
        except Exception:
            traceback.print_exc()
            rc = 1
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            os.dup2(saved[0], 1)
            os.dup2(saved[1], 2)
            os.close(saved[0])
            os.close(saved[1])
    rcs[case] = rc
print(json.dumps(rcs))
"""

RTPCR_FLAGS = {"default": [], "strict": ["--strict"], "delta": ["-d", "0.05"],
               "common": ["--common"], "pvalue-prob": ["-v", "0.05", "-p", "0.9"]}

SCORES_BY_CUT = {
    3: "cut,etype,tp,fp,fn,precision,recall,f1\n"
       "1,ES,25,0,0,1.000,1.000,1.000\n1,IR,20,2,5,0.909,0.800,0.851\n"
       "1,A3,3,4,22,0.429,0.120,0.188\n1,A5,2,1,23,0.667,0.080,0.143\n"
       "1,CE,25,0,0,1.000,1.000,1.000\n"
       "3,ES,24,0,1,1.000,0.960,0.980\n3,IR,18,1,7,0.947,0.720,0.818\n"
       "3,A3,2,2,23,0.500,0.080,0.138\n3,A5,2,0,23,1.000,0.080,0.148\n",
    5: "cut,etype,tp,fp,fn,precision,recall,f1\n"
       "1,ES,23,1,2,0.958,0.920,0.939\n1,IR,19,3,6,0.864,0.760,0.809\n"
       "1,A3,4,5,21,0.444,0.160,0.235\n1,A5,1,1,24,0.500,0.040,0.074\n"
       "3,ES,22,0,3,1.000,0.880,0.936\n3,IR,17,1,8,0.944,0.680,0.791\n"
       "3,A3,3,2,22,0.600,0.120,0.200\n3,A5,1,0,24,1.000,0.040,0.077\n",
}
SCORES = [f"{w}=scores_w{w}.csv" for w in SCORES_BY_CUT]

# plot-pr's modes: its arguments and the files it writes
PLOT_PR = {
    "csv-figure": (["cmp.csv", "-o", "pr_csv.png"], ["pr_csv.png"]),
    "csv-no-figure": (["cmp.csv", "--no-figure"], []),
    "scores-figure": (["conv_fig.csv", "--scores", *SCORES, "-o", "pr_scores.png"],
                      ["conv_fig.csv", "pr_scores.png"]),
    "scores-no-figure": (["conv.csv", "--scores", *SCORES, "--no-figure"], ["conv.csv"]),
}
PLOT_PR_ERRORS = {
    "no-input": ([], "need a compare CSV or --scores"),
    "bad-spec": (["--scores", "3"], "--scores expects W=CSV specs, got '3'"),
    "no-output": (["--scores", SCORES[0]], "--scores needs -o OUT.png or a positional csv"),
}


def _cases():
    cases = [(f"rtpcr-{k}", ["compare-rtpcr", "truth.tsv", "pantas.csv", "rmats.txt",
                             "whippet.diff", "suppa.dpsi", *v]) for k, v in RTPCR_FLAGS.items()]
    for mode in ("tables", "figures"):
        cases.append((f"parse-res-{mode}", [
            "parse-res", "-o", f"res_{mode}", "--pantas", "3=p3.csv", "5=p5.csv",
            "--rmats", "rmats.csv", "--suppa", "suppa.csv", "--whippet", "whippet.tsv",
            "--min-dpsi", "0.05", *(["--figures"] if mode == "figures" else [])]))
    cases += [(f"plot-pr-{k}", ["plot-pr", *args]) for k, (args, _) in PLOT_PR.items()]
    cases += [(f"plot-pr-error-{k}", ["plot-pr", *args]) for k, (args, _) in PLOT_PR_ERRORS.items()]
    cases += [("latex-table", ["latex-table", "cmp.csv"]),
              ("latex-table-unknown", ["latex-table", "unknown_tool.csv"])]
    return cases


def _write_inputs(d):
    for src, name in zip(_write_fixtures(d),
                         ("p3.csv", "p5.csv", "rmats.csv", "suppa.csv", "whippet.tsv")):
        src.rename(d / name)
    for name, text in (("truth.tsv", TRUTH), ("pantas.csv", PANTAS), ("rmats.txt", RMATS),
                       ("whippet.diff", WHIPPET), ("suppa.dpsi", SUPPA)):
        (d / name).write_text(text)
    _write_compare_csv(d / "cmp.csv")
    for w, text in SCORES_BY_CUT.items():
        (d / f"scores_w{w}.csv").write_text(text)
    (d / "unknown_tool.csv").write_text(
        "p-supp,tool,etype,mindpsi,mincov,TP,FN,FP,Prec,Rec,F1,TOT\n"
        "0,MAJIQ,ES,0.05,1,5,1,1,0.833,0.833,0.833,6\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through each package's CLI. Returns ``{package: (its
    directory, {case: exit code})}``."""
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), PYTHONHASHSEED="0", MPLBACKEND="Agg",
               JAX_PLATFORMS="cpu")
    cases = json.dumps(_cases())
    procs = {}
    for pkg in PACKAGES:
        d = tmp_path_factory.mktemp(pkg)
        _write_inputs(d)
        procs[pkg] = (d, subprocess.Popen([sys.executable, "-c", CASE_RUNNER, pkg, cases],
                                          cwd=d, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    done = {}
    for pkg, (d, proc) in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        done[pkg] = (d, json.loads(out.strip().splitlines()[-1]))
    return done


def _outputs(runs, case, names=()):
    """Exit code, stdout and the named files of ``case``, for each package."""
    return [(rcs[case], (d / f"{case}.out").read_text(), [(d / n).read_bytes() for n in names])
            for d, rcs in (runs[pkg] for pkg in PACKAGES)]


def _stderr(runs, pkg, case):
    d, _ = runs[pkg]
    return (d / f"{case}.err").read_text()


@pytest.mark.parametrize("flags", list(RTPCR_FLAGS))
def test_compare_rtpcr_stdout_equal(runs, flags):
    theirs, ours = _outputs(runs, f"rtpcr-{flags}")
    assert ours == theirs and ours[0] == 0 and ours[1].count("\n") > 10


@pytest.mark.parametrize("mode", ["tables", "figures"])
def test_parse_res_outputs_equal(runs, mode):
    case = f"parse-res-{mode}"
    names = sorted(p.name for p in (runs["pantas_tpu_torch"][0] / f"res_{mode}").iterdir())
    assert names == sorted(p.name for p in (runs["pantas_tpu"][0] / f"res_{mode}").iterdir())
    pngs = [n for n in names if n.endswith(".png")]
    assert {"res.csv", "res_mask.csv", "venn_counts.csv"} <= set(names)
    assert len(pngs) >= 3 if mode == "figures" else not pngs
    theirs, ours = _outputs(runs, case, [f"res_{mode}/{n}" for n in names])
    assert ours == theirs and ours[0] == 0 and all(ours[2])


@pytest.mark.parametrize("mode", list(PLOT_PR))
def test_plot_pr_equal(runs, mode):
    """The truth-support table on stdout and the P/R panel, from a compare
    CSV, or from ``scores_by_cut`` CSVs converted into one (the converted CSV
    is compared too)."""
    args, written = PLOT_PR[mode]
    theirs, ours = _outputs(runs, f"plot-pr-{mode}", written)
    assert ours == theirs and ours[0] == 0 and all(ours[2])
    assert ours[1].startswith("True Support (ω),ES,A3,A5,IR\n") and ours[1].count("\n") >= 3
    if mode.endswith("no-figure"):  # nor at the default path, <csv>.png
        assert not (runs["pantas_tpu_torch"][0] / f"{args[0]}.png").exists()


@pytest.mark.parametrize("error", list(PLOT_PR_ERRORS))
def test_plot_pr_usage_errors_exit_2(runs, error):
    _, message = PLOT_PR_ERRORS[error]
    for pkg in PACKAGES:
        assert runs[pkg][1][f"plot-pr-error-{error}"] == 2
        assert f"plot-pr: error: {message}" in _stderr(runs, pkg, f"plot-pr-error-{error}")


def test_latex_table_stdout_equal(runs):
    theirs, ours = _outputs(runs, "latex-table")
    assert ours == theirs and ours[0] == 0
    # two -w runs of five cuts, four tools and four event kinds
    assert ours[1].count("\\pantas") == 40 and ours[1].count("\n") == 1 + 160


def test_latex_table_unknown_tool_raises_key_error(runs):
    """A tool outside the macro map raises, as in the reference script."""
    theirs, ours = _outputs(runs, "latex-table-unknown")
    assert ours == theirs == (1, "", [])
    for pkg in PACKAGES:
        assert _stderr(runs, pkg, "latex-table-unknown").rstrip().endswith("KeyError: 'MAJIQ'")
