"""Figure layer for the evaluation harness (plot_pr / latex tables / parse_res
figures).

Reference behavior contracts:

* :func:`truth_support_lines` + :func:`render_pr` —
  ``exps/1-dm-sim/scripts/plot_pr.py:15-101`` of the reference.  The stdout
  truth-support table is byte-identical (the differential test executes the
  reference script, which runs in this environment), and the figure is the
  same 2x2 per-etype Precision/Recall panel: per-tool line plots with a
  marker style per true-support cut, legend only on the ES panel,
  ``[0, 1.01]`` axis limits, written to ``<input>.png`` at dpi=300.
* :func:`latex_table_lines` —
  ``exps/1-dm-sim/scripts/format_latex_table.py`` of the reference —
  byte-identical stdout ('' & ''-separated rows terminated by ``\\\\``),
  including the QUIRK that a tool absent from the 4-entry macro map raises
  ``KeyError``.
* :func:`render_res_figures` — the figure outputs of
  ``exps/2-dm-real/workflow/scripts/parse_res.py:320-816`` of the reference
  under the same filenames: ``full_corr.png`` (2x3 composite of pairwise
  dPSI joint grids, singleton-``Ws`` only), the ``corr_*.png`` pairwise and
  per-etype jointplots annotated with a Pearson correlation, and the
  ``venn_*.png`` diagrams over the ``res_mask.csv`` membership sets.

Redesigns (not translations) where the reference leans on unavailable or
private machinery:

* the ``venn`` PyPI package is absent here — :func:`_venn_regions` computes
  the ``2**n - 1`` exclusive region counts and :func:`render_venn` draws
  2-4-set circle/ellipse diagrams, placing each count at the numerically
  computed centroid of its region (rasterized point-in-ellipse masks)
  instead of hardcoding a label-coordinate table.  NaN cells are dropped
  from the membership sets before intersecting (the reference feeds raw
  ``set(column)`` including float NaN members to ``venn``, a bug that can
  add a phantom shared element; deliberate fix, not a translation target).
* ``SeabornFig2Grid`` transplants live axes across figures through private
  matplotlib internals — ``full_corr.png`` is instead composited from each
  joint grid's rendered RGBA buffer into the 2x3 grid (public API only,
  matplotlib-version-stable).
* the reference's incidental ``print(df)`` / ``print(len(pantas_set))``
  debug output (parse_res.py:562,773) is not reproduced.

Everything here is host-side and TPU-free by design; matplotlib/seaborn
imports are lazy and forced onto the Agg backend so the module works
headless.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence, Set, Tuple

ETYPES = ["ES", "IR", "A3", "A5"]

# format_latex_table.py:30-35 — unknown tools KeyError, as in the reference.
LATEX_MACROS = {
    "pantas": "\\pantas",
    "rMATS": "\\rmats",
    "Whippet": "\\whippet",
    "SUPPA2": "\\suppa",
}


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    return plt


# ---------------------------------------------------------------------------
# plot_pr.py equivalents
# ---------------------------------------------------------------------------


def parse_pr_csv(fpath: str):
    """Parse a concatenated compare CSV exactly as plot_pr.py:17-35.

    Returns ``(data, truth)`` where ``data`` rows are
    ``[tool, etype, mincov, precision, recall]`` (cuts 0 and 2 skipped) and
    ``truth[mincov][etype]`` is the TP+FN total, asserted consistent across
    tools/files as in the reference.
    """
    data: List[list] = []
    truth: Dict[int, Dict[str, int]] = {}
    for line in open(fpath):
        if line.startswith("p-supp"):
            continue
        w, tool, etype, dpsi, c, tp, fn, fp, p, r, f1, *tot = line.strip("\n").split(
            ","
        )
        # cuts can be fractional (experiment.py casts min_w=float(cut));
        # integral values stay ints so pinned outputs are unchanged
        c = float(c)
        c = int(c) if c.is_integer() else c
        if c in [0, 2]:
            continue
        tp, fn = int(tp), int(fn)
        if c not in truth:
            truth[c] = {}
        if etype not in truth[c]:
            truth[c][etype] = tp + fn
        else:
            assert truth[c][etype] == tp + fn
        data.append([tool, etype, c, float(p), float(r)])
    return data, truth


def truth_support_lines(fpath: str) -> List[str]:
    """The stdout table of plot_pr.py:37-43, byte-identical."""
    _, truth = parse_pr_csv(fpath)
    etypes = ["ES", "A3", "A5", "IR"]
    lines = ["True Support (ω)," + ",".join(etypes)]
    for c in truth:  # dict insertion order == first-seen order, as reference
        lines.append(str(c) + "".join("," + str(truth[c][et]) for et in etypes))
    return lines


def render_pr(fpath: str, out_png: str | None = None, dpi: int = 300) -> str:
    """The 2x2 P/R panel of plot_pr.py:48-101; returns the written path."""
    plt = _plt()
    import pandas as pd
    import seaborn as sns

    data, _ = parse_pr_csv(fpath)
    sns.set(font_scale=1.3)
    plt.rcParams.update({"font.size": 48})
    colors = [sns.color_palette("bright")[1]] + [
        sns.color_palette("dark")[i] for i in [0, 2, 6]
    ]
    tsl = "True Support ($\\mathcal{W}$)"
    df = pd.DataFrame(data, columns=["Tool", "E.Type", tsl, "Precision", "Recall"])
    ntools = df["Tool"].nunique()
    fig, axes = plt.subplots(2, 2, sharex=True, sharey=True, figsize=(11, 11))
    for ax, etype in zip(axes.flatten(), ["ES", "IR", "A3", "A5"]):
        sub = df[df["E.Type"] == etype]
        if len(sub):
            sns.lineplot(
                sub,
                y="Precision",
                x="Recall",
                hue="Tool",
                palette=colors[:ntools],
                legend=False,
                estimator=None,
                linewidth=2,
                alpha=0.2,
                sort=False,
                ax=ax,
            )
            sns.lineplot(
                sub,
                y="Precision",
                x="Recall",
                hue="Tool",
                palette=colors[:ntools],
                style=tsl,
                legend="auto" if etype == "ES" else False,
                markers=True,
                dashes=False,
                markersize=13,
                ax=ax,
            )
        ax.set_title(etype)
        ax.set_xlim(0, 1.01)
        ax.set_ylim(0, 1.01)
    plt.subplots_adjust(
        bottom=0.07, right=0.99, top=0.95, left=0.07, wspace=0.07, hspace=0.1
    )
    out = out_png if out_png is not None else fpath + ".png"
    fig.savefig(out, dpi=dpi)
    plt.close(fig)
    return out


def pr_csv_lines_from_scores(
    scores_csv: str, w, tool: str = "pantas"
) -> List[str]:
    """Convert an experiment ``scores_by_cut.csv`` (schema
    ``cut,etype,tp,fp,fn,precision,recall,f1`` — ``experiment.py:259``)
    into compare-CSV rows consumable by :func:`parse_pr_csv` /
    :func:`latex_table_lines`.  Etypes without a P/R panel slot (CE) are
    dropped.  No header line is emitted so multiple -w conversions can be
    concatenated under one header.
    """
    import csv as _csv

    lines = []
    for row in _csv.DictReader(open(scores_csv)):
        if row["etype"] not in ("ES", "A3", "A5", "IR"):
            continue
        tot = int(row["tp"]) + int(row["fn"])
        lines.append(
            f"{w},{tool},{row['etype']},0,{row['cut']},{row['tp']},"
            f"{row['fn']},{row['fp']},{row['precision']},{row['recall']},"
            f"{row['f1']},{tot}"
        )
    return lines


PR_CSV_HEADER = "p-supp,tool,etype,mindpsi,mincov,TP,FN,FP,Prec,Rec,F1,TOT"


# ---------------------------------------------------------------------------
# format_latex_table.py equivalent
# ---------------------------------------------------------------------------


def latex_table_lines(fpath: str) -> List[str]:
    """Byte-identical stdout of format_latex_table.py on the same CSV."""
    data: Dict[str, Dict[str, List[list]]] = {}
    for line in open(fpath):
        if line.startswith("p-supp"):
            continue
        _, tool, etype, _, mincov, TP, FN, FP, Prec, Rec, F1, _ = line.strip(
            "\n"
        ).split(",")
        if mincov not in data:
            data[mincov] = {}
        if etype not in data[mincov]:
            data[mincov][etype] = []
        data[mincov][etype].append([tool, TP, FN, FP, Prec, Rec, F1])

    header = [
        "True Support (ω)",
        "Event Type",
        "Tool",
        "TP",
        "FN",
        "FP",
        "Precision",
        "Recall",
        "F1",
    ]
    lines = [" & ".join(header) + " \\\\"]
    for c in data:
        for e in data[c]:
            for x in data[c][e]:
                lines.append(" & ".join([c, e, LATEX_MACROS[x[0]], *x[1:]]) + " \\\\")
    return lines


# ---------------------------------------------------------------------------
# venn rendering (replaces the `venn` package)
# ---------------------------------------------------------------------------

# Canonical n-set layouts in unit coordinates: (cx, cy, width, height, angle°).
# Circles for 2-3 sets, the classic 4-ellipse arrangement for 4.
_VENN_SHAPES: Dict[int, List[Tuple[float, float, float, float, float]]] = {
    2: [(0.375, 0.5, 0.55, 0.55, 0.0), (0.625, 0.5, 0.55, 0.55, 0.0)],
    3: [
        (0.405, 0.42, 0.6, 0.6, 0.0),
        (0.595, 0.42, 0.6, 0.6, 0.0),
        (0.5, 0.6, 0.6, 0.6, 0.0),
    ],
    4: [
        (0.35, 0.4, 0.72, 0.45, 140.0),
        (0.45, 0.5, 0.72, 0.45, 140.0),
        (0.544, 0.5, 0.72, 0.45, 40.0),
        (0.644, 0.4, 0.72, 0.45, 40.0),
    ],
}


def _clean_set(values) -> Set:
    out = set()
    for v in values:
        if v is None:
            continue
        if isinstance(v, float) and math.isnan(v):
            continue
        # pandas NA propagates as a singleton with __bool__ raising; filter
        # by string repr to stay pandas-optional.
        if v.__class__.__name__ == "NAType":
            continue
        out.add(v)
    return out


def _venn_regions(sets: Dict[str, Set]) -> Dict[Tuple[str, ...], int]:
    """Exclusive region sizes for every non-empty subset of set names."""
    names = list(sets)
    regions: Dict[Tuple[str, ...], int] = {}
    for mask in range(1, 1 << len(names)):
        inc = [n for i, n in enumerate(names) if mask >> i & 1]
        exc = [n for i, n in enumerate(names) if not mask >> i & 1]
        cur = set.intersection(*(sets[n] for n in inc))
        for n in exc:
            cur = cur - sets[n]
        regions[tuple(inc)] = len(cur)
    return regions


def render_venn(
    sets: Dict[str, Set],
    ax=None,
    fontsize: int = 13,
    cmap=None,
    legend_loc: str | None = "upper right",
    grid: int = 240,
):
    """Draw a 2-4-set venn of ``sets`` with exclusive region counts.

    Region labels are placed at the centroid of each region's rasterized
    mask, so no per-layout label table is needed.  Returns the axis.
    """
    plt = _plt()
    from matplotlib.patches import Ellipse, Rectangle

    names = [n for n in sets]
    n = len(names)
    if n not in _VENN_SHAPES:
        raise ValueError(f"render_venn supports 2-4 sets, got {n}")
    shapes = _VENN_SHAPES[n]
    clean = {k: _clean_set(v) for k, v in sets.items()}
    regions = _venn_regions(clean)

    if cmap is None:
        import seaborn as sns

        cmap = sns.color_palette()
    colors = [cmap[i % len(cmap)] for i in range(n)]

    if ax is None:
        _, ax = plt.subplots(figsize=(5, 5))
    for shape, color in zip(shapes, colors):
        cx, cy, w, h, ang = shape
        ax.add_patch(
            Ellipse(
                (cx, cy), w, h, angle=ang, facecolor=(*color[:3], 0.35),
                edgecolor="black", linewidth=1.0,
            )
        )

    # Rasterize membership over the unit square; centroid per region code
    # (vectorized: one (grid, grid) mask per ellipse, then a bincount over
    # the combined region codes).
    import numpy as np

    step = 1.0 / grid
    xs = (np.arange(grid) + 0.5) * step
    X, Y = np.meshgrid(xs, xs)  # Y varies along axis 0, X along axis 1
    code_grid = np.zeros((grid, grid), dtype=np.int32)
    for i, shape in enumerate(shapes):
        cx, cy, w, h, ang = shape
        t = math.radians(-ang)
        dx, dy = X - cx, Y - cy
        rx = dx * math.cos(t) - dy * math.sin(t)
        ry = dx * math.sin(t) + dy * math.cos(t)
        inside = (rx / (w / 2)) ** 2 + (ry / (h / 2)) ** 2 <= 1.0
        code_grid |= inside.astype(np.int32) << i
    flat = code_grid.ravel()
    ncodes = 1 << len(shapes)
    cnt = np.bincount(flat, minlength=ncodes)
    sx = np.bincount(flat, weights=X.ravel(), minlength=ncodes)
    sy = np.bincount(flat, weights=Y.ravel(), minlength=ncodes)
    sums: Dict[int, List[float]] = {
        c: [float(sx[c]), float(sy[c]), int(cnt[c])]
        for c in range(1, ncodes)
        if cnt[c]
    }
    for inc, count in regions.items():
        code = 0
        for i, name in enumerate(names):
            if name in inc:
                code |= 1 << i
        acc = sums.get(code)
        if acc is None or acc[2] == 0:
            continue  # geometrically absent region (cannot happen for 2-4)
        ax.text(
            acc[0] / acc[2],
            acc[1] / acc[2],
            str(count),
            ha="center",
            va="center",
            fontsize=fontsize,
        )
    if legend_loc is not None:
        handles = [
            Rectangle((0, 0), 1, 1, facecolor=c, edgecolor="black", linewidth=1)
            for c in colors
        ]
        ax.legend(handles, names, loc=legend_loc, fontsize=max(8, fontsize - 3))
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_aspect("equal")
    ax.axis("off")
    return ax


# ---------------------------------------------------------------------------
# parse_res.py figure suite
# ---------------------------------------------------------------------------


def _pearson_text(x, y) -> str:
    try:
        from scipy.stats import pearsonr

        corr, _ = pearsonr(x, y)
        corr = round(float(corr), 3)
    except Exception:
        corr = float("nan")
    return f"{corr}"


def _jointgrid_fig(df, x: str, y: str, xlabel: str | None):
    """One cell of full_corr.png: scatter+kde JointGrid with Pearson text
    (parse_res.py:324-434).  Returns the grid's figure."""
    import seaborn as sns

    sns.set(style="white", color_codes=True)
    g = sns.JointGrid(data=df, x=x, y=y, xlim=(-1.05, 1.05), ylim=(-1.05, 1.05))
    try:
        g.plot(sns.scatterplot, sns.kdeplot, color="black")
    except Exception:
        # kde is singular for tiny/degenerate marginals; scatter-only then.
        g.plot_joint(sns.scatterplot, color="black")
        g.plot_marginals(sns.histplot, color="black")
    if xlabel is not None:
        g.ax_joint.set_xlabel(xlabel)
    corr = _pearson_text(df[x], df[y])
    try:
        corr_f = f"{float(corr):.3f}"
    except ValueError:  # pragma: no cover
        corr_f = corr
    g.ax_joint.text(s=f"Pearson correlation: {corr_f}", x=-0.85, y=-1, fontsize=16)
    return g.figure


def _fig_to_rgba(fig):
    fig.canvas.draw()
    import numpy as np

    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf.copy()


def _jointplot_png(df, x: str, y: str, out_path: str) -> bool:
    """One corr_*.png: hue-by-type scatter jointplot + Pearson text
    (parse_res.py:446-462 and the per-etype variants). Returns whether a
    file was actually written (empty frames skip the figure)."""
    plt = _plt()
    import seaborn as sns

    if len(df) == 0:
        return False
    sns.jointplot(
        data=df, x=x, y=y, hue="type", kind="scatter",
        xlim=(-1.05, 1.05), ylim=(-1.05, 1.05),
    )
    plt.text(s=f"Pearson correlation: {_pearson_text(df[x], df[y])}", x=-0.3, y=-1)
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close("all")
    return True


def _pairs(lst: Sequence) -> List[Tuple]:
    out = []
    for i, a in enumerate(lst):
        for b in lst[i + 1 :]:
            out.append((a, b))
    return out


def render_res_figures(
    res_csv: str,
    mask_csv: str,
    outdir: str,
    Ws: Sequence,
    per_etype: bool = True,
) -> List[str]:
    """Render the parse_res.py figure suite from res/res_mask CSVs.

    Filenames match parse_res.py:320-816.  Returns the list of files
    written (relative to ``outdir``).
    """
    plt = _plt()
    import pandas as pd

    os.makedirs(outdir, exist_ok=True)
    Ws = [str(w) for w in Ws]
    pcols = [f"pantas_{w}" for w in Ws]
    df_full = pd.read_csv(res_csv)
    df_mask = pd.read_csv(mask_csv)
    df = df_full.dropna(how="any")
    written: List[str] = []

    def save(name: str):
        written.append(name)
        return os.path.join(outdir, name)

    def jp(df_, x, y, name):
        # record the figure only when a file was actually written (empty
        # frames skip it — reporting a nonexistent path misleads callers)
        if _jointplot_png(df_, x, y, os.path.join(outdir, name)):
            written.append(name)

    # --- full_corr.png composite (parse_res.py:322-446, singleton Ws) ---
    if len(Ws) == 1 and len(df) >= 2:
        p = pcols[0]
        cells = [
            (p, "rMATS", "pantas"),
            (p, "whippet", "pantas"),
            (p, "SUPPA2", "pantas"),
            ("rMATS", "whippet", None),
            ("rMATS", "SUPPA2", None),
            ("whippet", "SUPPA2", None),
        ]
        images = []
        for x, y, xlabel in cells:
            gfig = _jointgrid_fig(df, x, y, xlabel)
            images.append(_fig_to_rgba(gfig))
            plt.close(gfig)
        fig, axes = plt.subplots(2, 3, figsize=(15, 10))
        for ax, img in zip(axes.flatten(), images):
            ax.imshow(img)
            ax.axis("off")
        fig.savefig(save("full_corr.png"), bbox_inches="tight")
        plt.close(fig)

    # --- pairwise corr jointplots (parse_res.py:448-560) ---
    for w in Ws:
        p = f"pantas_{w}"
        jp(df, p, "rMATS", f"corr_pantas2_{w}_rmats.png")
        jp(df, p, "whippet", f"corr_pantas2_{w}_whippet.png")
        jp(df, p, "SUPPA2", f"corr_pantas2_{w}_suppa.png")
    if len(Ws) > 1:
        for w1, w2 in _pairs(Ws):
            jp(df,
                f"pantas_{w1}",
                f"pantas_{w2}", f"corr_pantas_{w1}_pantas2_{w2}.png")
    jp(df, "rMATS", "whippet", "corr_rmats_whippet.png")
    jp(df, "rMATS", "SUPPA2", "corr_rmats_suppa.png")
    jp(df, "whippet", "SUPPA2", "corr_whippet_suppa.png")

    # --- per-etype corr jointplots (parse_res.py:563-681) ---
    if per_etype:
        for e in ETYPES:
            tmp = df[df["type"] == e]
            if len(tmp) < 2:
                continue
            for w in Ws:
                p = f"pantas_{w}"
                jp(tmp, p, "rMATS", f"corr_{e}_pantas2_{w}_rmats.png")
                jp(tmp, p, "whippet", f"corr_{e}_pantas2_{w}_whippet.png")
                jp(tmp, p, "SUPPA2", f"corr_{e}_pantas2_{w}_suppa.png")
            if len(Ws) > 1:
                for w1, w2 in _pairs(Ws):
                    jp(tmp,
                        f"pantas_{w1}",
                        f"pantas_{w2}", f"corr_{e}_pantas_{w1}_pantas2_{w2}.png")
            jp(tmp, "rMATS", "whippet", f"corr_{e}_rmats_whippet.png")
            jp(tmp, "rMATS", "SUPPA2", f"corr_{e}_rmats_suppa.png")
            jp(tmp, "whippet", "SUPPA2", f"corr_{e}_whippet_suppa.png")

    # --- venns (parse_res.py:684-816) ---
    def venn_png(sets: Dict[str, Set], name: str, legends: List[str] | None = None):
        if not 2 <= len(sets) <= 4:  # renderer range; e.g. 5+ -w values
            return
        fig, ax = plt.subplots(1, 1, figsize=(5, 5))
        render_venn(sets, ax=ax, legend_loc=None if legends else "upper right")
        if legends:
            from matplotlib.patches import Rectangle

            import seaborn as sns

            handles = [
                Rectangle(
                    (0, 0), 1, 1, facecolor=sns.color_palette()[i],
                    linewidth=1, edgecolor="black",
                )
                for i in range(len(legends))
            ]
            ax.legend(
                handles,
                legends,
                title="Tool: #Events",
                loc="lower center",
                bbox_to_anchor=(0.5, -0.1),
                ncol=2,
            )
        plt.tight_layout()
        fig.savefig(save(name), bbox_inches="tight")
        plt.close(fig)

    if per_etype:
        for e in ETYPES:
            tmp = df_mask[df_mask["type"] == e]
            rmats_set = _clean_set(tmp["rMATS"])
            whippet_set = _clean_set(tmp["whippet"])
            suppa_set = _clean_set(tmp["SUPPA2"])
            for w in Ws:
                venn_png(
                    {
                        "rMATS": rmats_set,
                        "whippet": whippet_set,
                        "SUPPA2": suppa_set,
                        f"pantas_{w}": _clean_set(tmp[f"pantas_{w}"]),
                    },
                    f"venn_{e}_rmats_whippet_suppa_pantas_{w}.png",
                )
            if len(Ws) > 1:
                venn_png(
                    {k: _clean_set(tmp[k]) for k in pcols},
                    f"venn_{e}_pantas.png",
                )

    rmats_set = _clean_set(df_mask["rMATS"])
    whippet_set = _clean_set(df_mask["whippet"])
    suppa_set = _clean_set(df_mask["SUPPA2"])
    if len(Ws) == 1:
        p = pcols[0]
        pantas_set = _clean_set(df_mask[p])
        legends = []
        for t, s in [
            (p, pantas_set),
            ("rMATS", rmats_set),
            ("whippet", whippet_set),
            ("SUPPA2", suppa_set),
        ]:
            if t == p:
                t = "pantas"
            legends.append(f"{t}: {len(s)}")
        venn_png(
            {
                "pantas": pantas_set,
                "rMATS": rmats_set,
                "whippet": whippet_set,
                "SUPPA2": suppa_set,
            },
            "venn_full_rmats_whippet_suppa_pantas.png",
            legends=legends,
        )
    for w in Ws:
        venn_png(
            {
                "rMATS": rmats_set,
                "whippet": whippet_set,
                "SUPPA2": suppa_set,
                f"pantas_{w}": _clean_set(df_mask[f"pantas_{w}"]),
            },
            f"venn_full_rmats_whippet_suppa_pantas_{w}.png",
        )
    if len(Ws) > 1:
        venn_png(
            {k: _clean_set(df_mask[k]) for k in pcols},
            "venn_full_pantas.png",
        )
    return written
