"""Command-line interface of the PyTorch port: ``python -m pantas_tpu_torch``.

The subcommands are ``pantas_tpu``'s (see ``pantas_tpu/cli.py``), and so are
their flags. This CLI owns all 36 of them, each on this package's own code:
the pipeline's stages ``build``, ``augment``, ``call``, ``quant`` and
``remap``, the multi-process ``augment-dist``, ``replicate``, the mapper
(``map``, ``prefilter``, ``filter-reads``, ``map-accuracy``), the graph
tools, the analysis tools and the evaluation harness (``exp``, ``sim``,
``eval``, ``cmp``, ``compare-rtpcr``, the converters, ``parse-res``,
``plot-pr``, ``latex-table``, ``timev``, ``bench-table``).

``augment --engine device`` (native parse -> device scatter-add) and
``--engine device-py`` (Python tokenizer -> device) run on ``--device``
(``cuda`` by default, ``cpu`` for tests), on one device or, with ``--mesh N``
or ``--mesh DxK``, on a mesh of them; the host engines (``auto``, ``native``,
``host``) need no device. ``augment-dist`` is one rank of the sharded augment
over ``torch.distributed``, each rank on its own ``--device``. ``call
--engine device [--mesh N]`` runs the bitset finders on ``--device``,
``--engine host`` the host caller. Every other owned subcommand is host code
and takes no device: ``exp`` among them, which runs the native host
coverage engine as ``pantas_tpu``'s does. The figures of ``plot-pr`` and
``parse-res --figures`` need matplotlib, seaborn and pandas; ``plot-pr
--no-figure`` and ``latex-table`` need none of them.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

from pantas_tpu_torch import __version__

def _cmd_build(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch build")
    ap.add_argument("FA")
    ap.add_argument("GTF")
    ap.add_argument("VCF")
    ap.add_argument("-o", dest="outdir", default=".")
    ap.add_argument("-a", dest="aggressive", action="store_true", help="aggressive prune (hp=1)")
    ap.add_argument("-r", dest="reduce", action="store_true", help="reduce instead of prune (hp=2)")
    ap.add_argument("-t", dest="threads", type=int, default=8)
    ap.add_argument("-m", dest="max_node_len", type=int, default=32,
                    help="maximum node length (default 32, vg-compatible)")
    ap.add_argument("--no-prune", dest="no_prune", action="store_true",
                    help="keep alt nodes of alleles no haplotype carries "
                    "(hp=0 default prunes them, matching vg prune "
                    "--restore-paths semantics)")
    ap.add_argument("--w-lines", dest="w_lines", action="store_true",
                    help="emit haplotype transcript walks as GFA 1.1 W lines")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.build.pipeline import build_pangenome

    hp = 1 if args.aggressive else (2 if args.reduce else 0)
    build_pangenome(
        args.FA, args.GTF, args.VCF, args.outdir, hp=hp, threads=args.threads,
        max_node_len=args.max_node_len, w_lines=args.w_lines,
        prune=not args.no_prune,
    )
    return 0


@contextlib.contextmanager
def _stage_out(path):
    """Stage stdout or -o FILE; *.gz/*.zst names compress transparently
    (byte-identity contracts are on the decompressed content)."""
    if path is None:
        yield sys.stdout
        return
    from pantas_tpu_torch.io.xopen import open_stage_output

    with open_stage_output(path) as fh:
        yield fh


def _reset_output_or_raise(out, exc):
    """A failed engine may have written part of the GFA already; the
    fallback must start from byte 0 or not run at all — appending a
    complete output after a partial one silently corrupts the stage
    whose contract is byte-identity."""
    try:
        if out.seekable():
            out.seek(0)
            out.truncate()
            return
    except Exception:
        pass
    raise exc


def _cmd_augment(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch augment")
    ap.add_argument("GAF")
    ap.add_argument("GFA")
    ap.add_argument("thr", nargs="?", type=int, default=None, help="mapq threshold")
    ap.add_argument("-q", dest="mapq", type=int, default=20, help="mapq threshold")
    ap.add_argument(
        "--engine",
        choices=["auto", "host", "native", "device", "device-py"],
        default="auto",
        help="coverage engine: native C++ (fastest host), device (native parse"
        " -> hand-written CUDA scatter-add), device-py (pure-python parse -> "
        "device), host (pure python); auto prefers native",
    )
    ap.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device of the device engines (default cuda; never falls back)",
    )
    ap.add_argument("-t", dest="threads", type=int, default=None,
                    help="native parse threads (default: every CPU the process may run on)")
    ap.add_argument(
        "--mesh",
        default=None,
        help="device engine mesh: N (data-parallel over N devices) or DxK "
        "(D data shards x K node-axis count shards); with --device cpu the "
        "shards are logical",
    )
    ap.add_argument(
        "--checkpoint", default=None, metavar="FILE",
        help="device engines: persist counts + parse offset atomically "
        "(resume with --resume)",
    )
    ap.add_argument(
        "--resume", action="store_true",
        help="continue from an existing --checkpoint file",
    )
    ap.add_argument("-o", dest="out", default=None,
                    help="output GFA (default stdout; .gz/.zst compresses)")
    args = ap.parse_args(argv)
    args.thr = args.mapq if args.thr is None else args.thr
    dev = mesh = None
    if args.engine in ("device", "device-py"):
        from pantas_tpu_torch import backend
        from pantas_tpu_torch.coverage.device import check_mesh_scatter, scatter_choice

        # before the output is opened
        dev = backend.device(args.device)
        scatter_env = os.environ.get("PANTAS_SCATTER", "")
        scatter_choice(scatter_env)
        if args.mesh:
            check_mesh_scatter(scatter_env)
            mesh = _augment_mesh(args.mesh, args.device)
    with _stage_out(args.out) as out:
        return _run_augment(args, dev, mesh, out)


def _augment_mesh(spec: str, device_name: str):
    """The mesh of ``--mesh N`` or ``--mesh DxK`` on ``device_name``."""
    from pantas_tpu_torch import backend
    from pantas_tpu_torch.parallel.mesh import coverage_mesh, coverage_mesh_2d

    if "x" in spec:
        d, k = (int(v) for v in spec.split("x"))
        return coverage_mesh_2d(backend.mesh_devices(device_name, d * k, strict=True), d, k)
    return coverage_mesh(backend.mesh_devices(device_name, int(spec)))


def _run_augment(args, dev, mesh, out) -> int:
    engine = args.engine
    if engine in ("auto", "native"):
        try:
            from pantas_tpu_torch.native import augment_gfa_native

            augment_gfa_native(
                args.GAF, args.GFA, out=out, mapq_thr=args.thr,
                threads=args.threads,
            )
            return 0
        except Exception as e:
            if engine == "native":
                raise
            _reset_output_or_raise(out, e)
            print(f"[augment] native engine unavailable ({e}); falling back", file=sys.stderr)
    if engine in ("device", "device-py"):
        from pantas_tpu_torch.coverage.device import (
            NativeFeedUnavailable,
            augment_gfa_device,
            augment_gfa_device_native,
        )

        if engine == "device":
            try:
                augment_gfa_device_native(
                    args.GAF, args.GFA, out=out, mapq_thr=args.thr, device=dev, mesh=mesh,
                    checkpoint_path=args.checkpoint, resume=args.resume, threads=args.threads,
                )
                return 0
            except NativeFeedUnavailable as e:
                # raised before any output is written; errors of the kernel
                # or the device propagate instead
                _reset_output_or_raise(out, e)
                print(
                    f"[augment] native device feed unavailable ({e}); "
                    "python tokenizer fallback",
                    file=sys.stderr,
                )
        augment_gfa_device(
            args.GAF, args.GFA, out=out, mapq_thr=args.thr, device=dev, mesh=mesh,
            checkpoint_path=args.checkpoint, resume=args.resume,
        )
        return 0
    from pantas_tpu_torch.coverage.host import augment_gfa

    augment_gfa(args.GAF, args.GFA, out=out, mapq_thr=args.thr)
    return 0


def _cmd_augment_dist(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch augment-dist")
    ap.add_argument("GAF")
    ap.add_argument("GFA")
    ap.add_argument("-o", dest="out", required=True, help="output GFA (written by proc 0)")
    ap.add_argument("-q", dest="mapq", type=int, default=20)
    ap.add_argument("--coordinator", required=True, help="HOST:PORT of process 0")
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--procid", type=int, required=True)
    ap.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="this process's device (default cuda, the first card it sees; "
        "never falls back)",
    )
    args = ap.parse_args(argv)
    from pantas_tpu_torch.parallel.distributed import augment_gfa_distributed

    dt = augment_gfa_distributed(
        args.GAF, args.GFA, args.out,
        coordinator=args.coordinator, n_procs=args.nprocs, proc_id=args.procid,
        mapq_thr=args.mapq, device=args.device,
    )
    print(f"[augment-dist] proc {args.procid}: accumulate {dt:.2f}s", file=sys.stderr)
    return 0


def _cmd_call(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch call")
    ap.add_argument("GFA")
    ap.add_argument("GTF")
    ap.add_argument("--rca", "-w", dest="rca", type=int, default=-1)
    ap.add_argument("--novel", "-n", dest="novel", action="store_true")
    ap.add_argument("--no-annotated", "-a", dest="no_annotated", action="store_true")
    ap.add_argument("--events", "-e", dest="events", nargs="+", default=["ES", "SS", "IR"])
    ap.add_argument("--isw", "-i", dest="isw", type=int, default=5)
    ap.add_argument("--minintronsize", "-l", dest="minintronsize", type=int, default=100)
    ap.add_argument("--junction", dest="junction", type=str, default=None)
    ap.add_argument("--debug", dest="debug", action="store_true")
    # a documented no-op, as in pantas_tpu's call (its cli.py explains why)
    ap.add_argument("--rc", dest="rc_compat", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument(
        "--engine",
        choices=["host", "device"],
        default="host",
        help="host: reference-exact enumerator; device: the six bitset finders "
        "as torch ops on --device (same row multiset)",
    )
    ap.add_argument(
        "--mesh", type=int, default=None,
        help="device engine: shard the candidate axis over N cards, or with "
        "--device cpu over N logical shards (same rows for any N)",
    )
    ap.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device of the device engine (default cuda; never falls back)",
    )
    ap.add_argument("-o", dest="out", default=None,
                    help="output CSV (default stdout; .gz/.zst compresses)")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.events.caller import CallOptions, call_events

    events = []
    for e in args.events:
        events.extend(e.split(","))
    opts = CallOptions(
        rca=args.rca,
        novel=args.novel,
        no_annotated=args.no_annotated,
        events=events,
        isw=args.isw,
        minintronsize=args.minintronsize,
        junction=args.junction,
        debug=args.debug,
    )
    if args.engine == "device":
        import functools

        from pantas_tpu_torch import backend
        from pantas_tpu_torch.events.batched import call_events_device

        # before the output is opened
        devices = backend.devices(args.device, args.mesh or 1)
        call_fn = functools.partial(call_events_device, devices=devices)
    else:
        call_fn = call_events
    with _stage_out(args.out) as out:
        for row in call_fn(args.GFA, args.GTF, opts):
            print(row, file=out)
    return 0


def _cmd_quant(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch quant")
    ap.add_argument("-a", dest="report_all", action="store_true", help="report one-sided events")
    ap.add_argument("-w", dest="w", type=int, default=0)
    ap.add_argument("--pool-w", dest="pool_w", type=int, default=None,
                    help="EXTENSION: pooled-replicate junction coverage "
                    "threshold (feed from a w=0 call pass); replaces -w's "
                    "per-replicate drop — recovers consistent weak events")
    ap.add_argument("--c1", dest="c1", nargs="+", default=None)
    ap.add_argument("--c2", dest="c2", nargs="+", default=None)
    ap.add_argument("csvs", nargs="*", help="C1 replicates then C2 replicates")
    ap.add_argument("-o", dest="out", default=None,
                    help="output CSV (default stdout; .gz/.zst compresses)")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.quant import quantify

    if (args.c1 is None) != (args.c2 is None):
        print("ERROR: provide both --c1 and --c2 (or positional replicates).", file=sys.stderr)
        return 1
    if args.c1 and args.c2:
        c1, c2 = args.c1, args.c2
    elif not args.csvs:
        print("ERROR: no replicate CSVs given.", file=sys.stderr)
        return 1
    else:
        if len(args.csvs) % 2 != 0:
            print("ERROR: Wrong number of replicates.", file=sys.stderr)
            return 1
        half = len(args.csvs) // 2
        c1, c2 = args.csvs[:half], args.csvs[half:]
    if len(c1) != len(c2):
        print("Provide the same number of replicates for each condition", file=sys.stderr)
        return 1
    # the reference CLI defaults to --both; -a reports one-sided events too
    if args.pool_w is not None and args.w:
        print("ERROR: --pool-w and -w are mutually exclusive.", file=sys.stderr)
        return 1
    with _stage_out(args.out) as out:
        quantify(c1, c2, both=not args.report_all, min_w=args.w, out=out,
                 pool_w=args.pool_w)
    return 0


def _cmd_remap(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch remap")
    ap.add_argument("CSV")
    ap.add_argument("GTF")
    ap.add_argument("-i", dest="min_intron_size", type=int, default=100)
    ap.add_argument("-o", dest="out", default=None,
                    help="output CSV (default stdout; .gz/.zst compresses)")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.remap import remap

    with _stage_out(args.out) as out:
        remap(args.CSV, args.GTF, min_intron_size=args.min_intron_size, out=out)
    return 0


def _cmd_reduce(argv):
    """Standalone GFA reducer (the reference's ``build/reduce.py`` tool)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch reduce")
    ap.add_argument("GFA")
    ap.add_argument("-k", dest="k", type=int, default=0,
                    help="extend each transcript interval by k ids")
    ap.add_argument("-t", dest="tridx", type=str, default="ENST",
                    help="transcript-id prefix (default ENST)")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.build.reduce import reduce_gfa

    if args.k > 0:
        print("Setting k>0 is experimental and not tested", file=sys.stderr)
    reduce_gfa(args.GFA, sys.stdout, tridx=args.tridx, k=args.k)
    return 0


def _cmd_replicate(argv):
    """Fused per-replicate pipeline: GAF -> events, no augmented-GFA round trip."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch replicate")
    ap.add_argument("GAF")
    ap.add_argument("GFA", help="annotated (un-augmented) spliced pangenome")
    ap.add_argument("GTF")
    ap.add_argument("--mapq", dest="mapq", type=int, default=20)
    ap.add_argument("-t", dest="threads", type=int, default=1)
    ap.add_argument("--rca", "-w", dest="rca", type=int, default=-1)
    ap.add_argument("--novel", "-n", dest="novel", action="store_true")
    ap.add_argument("--no-annotated", "-a", dest="no_annotated", action="store_true")
    ap.add_argument("--events", "-e", dest="events", nargs="+", default=["ES", "SS", "IR"])
    ap.add_argument("--isw", "-i", dest="isw", type=int, default=5)
    ap.add_argument("--minintronsize", "-l", dest="minintronsize", type=int, default=100)
    args = ap.parse_args(argv)

    import subprocess

    from pantas_tpu_torch.events.caller import CallOptions, SplicingGraph, call_events
    from pantas_tpu_torch.graph.compiler import compile_gfa

    tensors = compile_gfa(args.GFA)
    try:
        from pantas_tpu_torch.native import NativeCoverage

        eng = NativeCoverage(tensors)
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        # the engine did not build or load, or cannot key this graph; an
        # error while it parses or while the graph is built propagates
        print(f"[replicate] native engine unavailable ({e}); host fallback", file=sys.stderr)
        from pantas_tpu_torch.coverage.host import accumulate_gaf, load_node_lengths
        from pantas_tpu_torch.io.xopen import xopen

        node_len = load_node_lengths(args.GFA)
        with xopen(args.GAF) as fh:
            counts = accumulate_gaf(fh, node_len, args.mapq)
        rejected = counts.rejected
        graph = SplicingGraph.from_coverage(args.GFA, counts)
    else:
        eng.process_file(args.GAF, args.mapq, threads=args.threads)
        rejected = int(eng.lib.gafcov_rejected(eng.handle))
        # counts apply straight from the engine's vector — no
        # CoverageCounts dict materialization (see from_engine)
        graph = SplicingGraph.from_engine(args.GFA, tensors, eng)
    print(f"Rejected alignments: {rejected}", file=sys.stderr)

    events = []
    for e in args.events:
        events.extend(e.split(","))
    opts = CallOptions(
        rca=args.rca,
        novel=args.novel,
        no_annotated=args.no_annotated,
        events=events,
        isw=args.isw,
        minintronsize=args.minintronsize,
    )
    for row in call_events(args.GFA, args.GTF, opts, graph=graph):
        print(row)
    return 0


def _cmd_novel_sites(argv):
    ap = argparse.ArgumentParser(
        prog="pantas-tpu-torch novel-sites",
        description="Detect intra-node novel splice sites from soft-clip "
        "pile-ups in a GAF — the signal the reference pipeline structurally "
        "cannot call (no edge can exist mid-node; its IL/OL histograms skip "
        "first/last-node offsets). EXTENSION: no reference counterpart.",
    )
    ap.add_argument("GAF", nargs="?", default=None)
    ap.add_argument("GFA", nargs="?", default=None,
                    help="annotated (optionally augmented) GFA")
    ap.add_argument("-w", dest="w", type=int, default=3, help="min pile-up count (default 3)")
    ap.add_argument("-c", dest="min_clip", type=int, default=5,
                    help="min clipped query bases at the boundary (default 5)")
    ap.add_argument("-q", dest="mapq", type=int, default=20, help="mapq threshold")
    ap.add_argument("--include-boundary", action="store_true",
                    help="also report sites at node boundaries (expressible "
                    "as graph edges, so normally left to the novel-link path)")
    ap.add_argument("--events", dest="gtf", default=None, metavar="GTF",
                    help="classify sites into A3/A5 event rows (gene/strand "
                    "from the node's exon labels + this GTF)")
    ap.add_argument("--quant", action="store_true",
                    help="quantified two-condition mode: merge donor/acceptor "
                    "pile-ups into intron events with a PSI analogue "
                    "(needs --c1/--c2/--gfa and --events GTF)")
    ap.add_argument("--c1", nargs="+", default=None, metavar="GAF",
                    help="condition-1 replicate GAFs (--quant)")
    ap.add_argument("--c2", nargs="+", default=None, metavar="GAF",
                    help="condition-2 replicate GAFs (--quant)")
    ap.add_argument("--gfa", default=None, help="graph for --quant mode")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.events.sites import (
        EVENTS_HEADER,
        QUANT_HEADER,
        classify_sites,
        detect_novel_sites,
        quantify_sites,
        write_novel_sites,
    )

    if args.quant:
        if not (args.c1 and args.c2 and args.gfa and args.gtf):
            ap.error("--quant needs --c1, --c2, --gfa and --events GTF")
        print(QUANT_HEADER)
        for r in quantify_sites(
            args.c1, args.c2, args.gfa, args.gtf,
            w=args.w, min_clip=args.min_clip, mapq_thr=args.mapq,
        ):
            print(r)
        return 0
    if not (args.GAF and args.GFA):
        ap.error("GAF and GFA are required (unless --quant)")

    rows = detect_novel_sites(
        args.GAF, args.GFA, w=args.w, min_clip=args.min_clip,
        mapq_thr=args.mapq, include_boundary=args.include_boundary,
    )
    if args.gtf:
        print(EVENTS_HEADER)
        for r in classify_sites(rows, args.gtf):
            print(r)
    else:
        write_novel_sites(rows)
    return 0


def _cmd_filter_reads(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch filter-reads")
    ap.add_argument("FQ1")
    ap.add_argument("FQ2")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.exps_helpers import filter_reads

    o1, o2 = filter_reads(args.FQ1, args.FQ2, seed=args.seed)
    print(f"[filter-reads] -> {o1} {o2}", file=sys.stderr)
    return 0


def _cmd_fix_vidx(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch fix-vidx")
    ap.add_argument("VCF", nargs="?", default=None, help="VCF (default stdin)")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.exps_helpers import fix_vidx

    fh = open(args.VCF) if args.VCF else sys.stdin
    fix_vidx(fh)
    return 0


def _cmd_clean_gtf(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch clean-gtf")
    ap.add_argument("GTF")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.exps_helpers import clean_gtf

    clean_gtf(args.GTF)
    return 0


def _cmd_prune(argv):
    """Legacy interval pruning utility (the reference's prune_gfa.py)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch prune")
    ap.add_argument("GFA")
    ap.add_argument("-w", dest="w", type=int, default=0,
                    help="extend subgraphs by W nodes")
    ap.add_argument("-t", dest="tprefix", default="ENST",
                    help="transcript prefix (default ENST)")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.build.legacy import prune_gfa

    prune_gfa(args.GFA, sys.stdout, w=args.w, tprefix=args.tprefix)
    return 0


def _cmd_reintroduce(argv):
    """Restore P lines from an unpruned GFA (reintroduce_paths.py)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch reintroduce-paths")
    ap.add_argument("GFA", help="original (unpruned) GFA")
    ap.add_argument("PRUNED_GFA")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.build.legacy import reintroduce_paths

    reintroduce_paths(args.GFA, args.PRUNED_GFA, sys.stdout)
    return 0


def _cmd_add_junctions(argv):
    """Legacy EX/JN annotator from a gffread transcript FASTA
    (add_junctions.py)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch add-junctions")
    ap.add_argument("GFA")
    ap.add_argument("GFFW", help="gffread transcript FASTA with segs: metadata")
    ap.add_argument("--IS", dest="ignore_seq", action="store_true",
                    help="skip the path-sequence == FASTA assertion")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.build.legacy import add_junctions

    add_junctions(args.GFA, args.GFFW, ignore_seq=args.ignore_seq, out=sys.stdout)
    return 0


def _cmd_add_haplotypes(argv):
    """Legacy haplotype path synthesis from phased VCF _alt_ paths
    (add_haplotypes.py)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch add-haplotypes")
    ap.add_argument("GFA")
    ap.add_argument("VCF")
    ap.add_argument("-t", dest="tprefix", default="ENST")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.build.legacy import add_haplotypes

    add_haplotypes(args.GFA, args.VCF, tprefix=args.tprefix, out=sys.stdout)
    return 0


def _cmd_gamp(argv):
    """Legacy GAMP (vg-JSON) augmenter (edge weights only)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch gamp")
    ap.add_argument("JSON", help="vg multipath alignments as line-JSON")
    ap.add_argument("PATHS", help="output path-walks file")
    ap.add_argument("GFA")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.coverage.gamp import augment_gamp

    augment_gamp(args.JSON, args.PATHS, args.GFA, out=sys.stdout)
    return 0


def _cmd_map(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch map")
    ap.add_argument("GFA")
    ap.add_argument("FQ1")
    ap.add_argument("FQ2", nargs="?", default=None)
    ap.add_argument("-k", dest="k", type=int, default=21, help="seed k-mer size")
    ap.add_argument("-t", dest="threads", type=int, default=1, help="alignment threads")
    ap.add_argument("-o", dest="out", default=None,
                    help="output GAF (default stdout; .gz/.zst compresses)")
    ap.add_argument("--index", dest="index", default=None, metavar="DIR",
                    help="persist/reuse the k-mer index (build once, "
                    "mmap-load on later invocations against the same GFA)")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.mapping.mapper import map_reads

    with _stage_out(args.out) as out:
        map_reads(args.GFA, args.FQ1, args.FQ2, k=args.k, out=out,
                  threads=args.threads, index_cache=args.index)
    return 0


def _cmd_prefilter(argv):
    """shark-style gene-panel read prefilter (reference
    exps/3-homo-real/workflow/rules/pantas.smk:57-75 flag mapping:
    -r genes.fa -1/-2 inputs, -o/-p outputs, -q quality, assoc TSV on
    stdout)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch prefilter")
    ap.add_argument("-r", dest="genes_fa", required=True, help="gene panel FASTA")
    ap.add_argument("-1", dest="fq1", required=True)
    ap.add_argument("-2", dest="fq2", default=None)
    ap.add_argument("-o", dest="out1", required=True, help="filtered mate-1 FASTQ")
    ap.add_argument("-p", dest="out2", default=None, help="filtered mate-2 FASTQ")
    ap.add_argument("-q", dest="qthr", type=int, default=10, help="base quality threshold")
    ap.add_argument("-k", dest="k", type=int, default=17)
    ap.add_argument("-c", dest="min_frac", type=float, default=0.6,
                    help="min fraction of k-mer windows confirming a gene")
    ap.add_argument("--threads", dest="threads", type=int, default=1)
    ap.add_argument("--engine", dest="engine", default="auto",
                    choices=["auto", "native", "python"])
    args = ap.parse_args(argv)
    from pantas_tpu_torch.mapping.prefilter import prefilter_reads

    prefilter_reads(
        args.genes_fa, args.fq1, args.fq2, args.out1, args.out2,
        tsv_out=sys.stdout, k=args.k, qthr=args.qthr,
        min_frac=args.min_frac, threads=args.threads, engine=args.engine,
    )
    return 0


def _cmd_map_accuracy(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch map-accuracy")
    ap.add_argument("GFA")
    ap.add_argument("-n", dest="n_reads", type=int, default=2000)
    ap.add_argument("-l", dest="read_len", type=int, default=150)
    ap.add_argument(
        "-d", dest="divergences", default="0,0.01,0.02,0.05",
        help="comma-separated divergence rates",
    )
    ap.add_argument("-e", dest="error_rate", type=float, default=0.001)
    ap.add_argument("-s", dest="seed", type=int, default=11)
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.mapper_accuracy import evaluate, report

    results = evaluate(
        args.GFA,
        divergences=[float(x) for x in args.divergences.split(",")],
        n_reads=args.n_reads,
        read_len=args.read_len,
        error_rate=args.error_rate,
        seed=args.seed,
    )
    report(results)
    return 0


def _cmd_gaf2sam(argv):
    """Project GAF walks to linear SAM (exps/3-homo gaf2sam.py equivalent)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch gaf2sam")
    ap.add_argument("GAF")
    ap.add_argument("GFA")
    ap.add_argument("POSITIONS", nargs="?", default=None,
                    help="path\\tpos,pos,... node-position file (reference-compatible); "
                    "omit to derive positions from the graph's chromosome paths")
    ap.add_argument("--sq", choices=["auto", "hg38"], default="auto",
                    help="@SQ header source: derived from the graph (auto) or the "
                    "reference script's hardcoded hg38 table")
    ap.add_argument("--debug", action="store_true", help="progress/skip log on stderr")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.gaf2sam import gaf_to_sam

    if args.POSITIONS and args.sq == "auto":
        ap.error("positions-file mode needs an explicit --sq (the graph carries no header)")
    gaf_to_sam(
        args.GAF, args.GFA, args.POSITIONS, out=sys.stdout,
        sq="hg38" if args.sq == "hg38" else None,
        log=sys.stderr if args.debug else None,
    )
    return 0


def _cmd_cmp(argv):
    """Multi-tool accuracy comparison vs truth (cmp_pantas.py equivalent)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch cmp")
    ap.add_argument("-t", dest="truth", required=True, help="truth CSV")
    ap.add_argument("-p", dest="pantas", required=True, help="quant-remap CSV")
    ap.add_argument("-r", dest="rmats", default=None, help="rMATS CSV")
    ap.add_argument("-w", dest="whippet", default=None, help="Whippet psi file")
    ap.add_argument("-s", dest="suppa", default=None, help="SUPPA2 CSV")
    ap.add_argument("-c", dest="min_cov", type=int, default=5)
    ap.add_argument("-d", dest="min_dpsi", type=float, default=0.05)
    ap.add_argument("--supp", dest="supp", type=int, default=0)
    ap.add_argument("--events", nargs="+", default=["ES", "A3", "A5", "IR"])
    ap.add_argument("--novel", action="store_true")
    ap.add_argument("--tabs", action="store_true")
    ap.add_argument("--print", dest="print_flag", action="store_true")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.cmp_tools import compare_tools

    compare_tools(
        args.truth, args.pantas, args.rmats, args.whippet, args.suppa,
        events=args.events, min_dpsi=args.min_dpsi, min_cov=args.min_cov,
        novel=args.novel, supp=args.supp, tabs=args.tabs,
        print_flag=args.print_flag,
    )
    return 0


def _cmd_convert_rmats(argv):
    """Convert an rMATS output dir to the comparator CSV (build_rmats.py)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch convert-rmats")
    ap.add_argument("RMATS_DIR", help="directory with {SE,A3SS,A5SS,RI}.MATS.JC.txt")
    ap.add_argument("-o", dest="out", required=True)
    ap.add_argument("-p", dest="pvalue", type=float, default=0.05)
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.converters import rmats_to_csv

    rmats_to_csv(args.RMATS_DIR, args.out, pvalue=args.pvalue)
    return 0


def _cmd_convert_suppa(argv):
    """Convert a SUPPA2 .dpsi file to the comparator CSV (build_suppa.py)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch convert-suppa")
    ap.add_argument("DPSI")
    ap.add_argument("-o", dest="out", required=True)
    ap.add_argument("-p", dest="pvalue", type=float, default=0.05)
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.converters import suppa_to_csv

    suppa_to_csv(args.DPSI, args.out, pvalue=args.pvalue)
    return 0


def _cmd_check_coverage(argv):
    """Count spliced-alignment support for skipped exons (check_coverage.py)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch check-coverage")
    ap.add_argument("EVENTS", help="one skipped-exon region (chrom:start-end) per line")
    ap.add_argument("GTF")
    ap.add_argument("SAM", nargs="+", help="linear alignments (e.g. gaf2sam output)")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.support import check_skipping_support

    check_skipping_support(args.EVENTS, args.GTF, args.SAM, out=sys.stdout)
    return 0


def _cmd_check_novel(argv):
    """Classify skipped exons as novel vs annotated (check_novel.py)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch check-novel")
    ap.add_argument("EVENTS", help="one skipped-exon region (chrom:start-end) per line")
    ap.add_argument("GTF")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.support import classify_novel_skips

    regions = {line.strip("\n") for line in open(args.EVENTS) if line.strip()}
    for region, novel in sorted(classify_novel_skips(regions, args.GTF).items()):
        print(region, novel)
    return 0


def _cmd_introns(argv):
    """Fit the intron length distribution from a GTF (log-normal mixture)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch introns")
    ap.add_argument("-g", "--gtf", required=True)
    ap.add_argument("-o", "--out", required=True, help="where to save the model")
    ap.add_argument("-l", "--label", default="transcript_id")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.introns import estimate

    estimate(args.gtf, args.out, label=args.label)
    return 0


def _cmd_timev(argv):
    """Run a command under rusage timing, writing a ``time -v`` log."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch timev")
    ap.add_argument("-o", dest="time_file", required=True, help="output .time file")
    ap.add_argument("CMD", nargs=argparse.REMAINDER, help="command to run")
    args = ap.parse_args(argv)
    if not args.CMD:
        ap.error("no command given")
    cmd = args.CMD[1:] if args.CMD and args.CMD[0] == "--" else args.CMD
    from pantas_tpu_torch.eval.bench import run_timed

    return run_timed(cmd, args.time_file)


def _cmd_bench_table(argv):
    """Fold a directory of .time logs into one bench CSV (compare_bench.py)."""
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch bench-table")
    ap.add_argument("BENCH_DIR")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.bench import collect

    collect(args.BENCH_DIR, out=sys.stdout)
    return 0


def _cmd_parse_res(argv):
    ap = argparse.ArgumentParser(
        prog="pantas-tpu-torch parse-res",
        description="Aggregate per-tool event CSVs into res/res_mask/venn tables",
    )
    ap.add_argument("-o", dest="outdir", required=True)
    ap.add_argument(
        "--pantas", nargs="+", required=True, metavar="W=CSV",
        help="pantas quant-remap CSVs, one per -w (e.g. 3=quant-remap.w3.csv)",
    )
    ap.add_argument("--rmats", required=True, help="converted rMATS CSV")
    ap.add_argument("--suppa", required=True, help="converted SUPPA2 CSV")
    ap.add_argument("--whippet", required=True, help="Whippet .diff")
    ap.add_argument("--min-dpsi", type=float, default=0.0)
    ap.add_argument("--relax", type=int, default=4)
    ap.add_argument(
        "--figures", action="store_true",
        help="also render the parse_res.py figure suite (corr/venn PNGs)",
    )
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.aggregate import (
        aggregate,
        parse_pantas_csv,
        parse_rmats_csv,
        parse_suppa_csv,
        parse_whippet_diff,
        venn_counts,
        write_res_csvs,
    )

    pantas = {}
    for spec in args.pantas:
        w, eq, path = spec.partition("=")
        if not w or not eq or not path:
            ap.error(f"--pantas expects W=CSV specs, got {spec!r}")
        pantas[w] = parse_pantas_csv(path, args.min_dpsi)
    cols, rows = aggregate(
        pantas,
        parse_rmats_csv(args.rmats, args.min_dpsi),
        parse_suppa_csv(args.suppa, args.min_dpsi),
        parse_whippet_diff(args.whippet, args.min_dpsi),
        relax=args.relax,
    )
    os.makedirs(args.outdir, exist_ok=True)
    write_res_csvs(
        cols, rows,
        os.path.join(args.outdir, "res.csv"),
        os.path.join(args.outdir, "res_mask.csv"),
    )
    with open(os.path.join(args.outdir, "venn_counts.csv"), "w") as out:
        venn_counts(cols, rows, out)
    if args.figures:
        from pantas_tpu_torch.eval.plots import render_res_figures

        written = render_res_figures(
            os.path.join(args.outdir, "res.csv"),
            os.path.join(args.outdir, "res_mask.csv"),
            args.outdir,
            list(pantas.keys()),
        )
        print(f"[parse-res] {len(written)} figures rendered", file=sys.stderr)
    print(f"[parse-res] {len(rows)} events -> {args.outdir}", file=sys.stderr)
    return 0


def _cmd_plot_pr(argv):
    ap = argparse.ArgumentParser(
        prog="pantas-tpu-torch plot-pr",
        description="Truth-support table + 2x2 P/R panel from compare CSVs "
        "(plot_pr.py equivalent)",
    )
    ap.add_argument("csv", nargs="?", default=None,
                    help="concatenated compare CSV (cmp output)")
    ap.add_argument(
        "--scores", nargs="+", metavar="W=CSV", default=None,
        help="build the compare CSV from experiment scores_by_cut CSVs "
        "(one per -w) instead of reading one",
    )
    ap.add_argument("-o", dest="out_png", default=None,
                    help="output PNG (default: <csv>.png)")
    ap.add_argument("--no-figure", action="store_true",
                    help="print the truth table only")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.plots import (
        PR_CSV_HEADER,
        pr_csv_lines_from_scores,
        render_pr,
        truth_support_lines,
    )

    csv_path = args.csv
    if args.scores:
        lines = [PR_CSV_HEADER]
        for spec in args.scores:
            w, eq, path = spec.partition("=")
            if not w or not eq or not path:
                ap.error(f"--scores expects W=CSV specs, got {spec!r} "
                         "(a positional csv must come BEFORE --scores)")
            lines.extend(pr_csv_lines_from_scores(path, w))
        if csv_path is None:
            if args.out_png is None:
                ap.error("--scores needs -o OUT.png or a positional csv "
                         "path to write the converted CSV to")
            import tempfile

            tmp = tempfile.NamedTemporaryFile(
                "w", suffix=".csv", delete=False, prefix="plotpr_"
            )
            tmp.close()
            csv_path = tmp.name
            print(f"[plot-pr] converted CSV: {csv_path}", file=sys.stderr)
        with open(csv_path, "w") as out:
            out.write("\n".join(lines) + "\n")
    elif csv_path is None:
        ap.error("need a compare CSV or --scores")
    for line in truth_support_lines(csv_path):
        print(line)
    if not args.no_figure:
        out = render_pr(csv_path, args.out_png)
        print(f"[plot-pr] wrote {out}", file=sys.stderr)
    return 0


def _cmd_latex_table(argv):
    ap = argparse.ArgumentParser(
        prog="pantas-tpu-torch latex-table",
        description="LaTeX accuracy table from compare CSVs "
        "(format_latex_table.py equivalent, byte-identical stdout)",
    )
    ap.add_argument("csv", help="concatenated compare CSV (cmp output)")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.plots import latex_table_lines

    for line in latex_table_lines(args.csv):
        print(line)
    return 0


def _cmd_compare_rtpcr(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch compare-rtpcr")
    ap.add_argument("TRUTH")
    ap.add_argument("PANTAS")
    ap.add_argument("RMATS")
    ap.add_argument("WHIPPET")
    ap.add_argument("SUPPA")
    ap.add_argument("--strict", action="store_true")
    ap.add_argument("--common", action="store_true")
    ap.add_argument("-d", "--delta", type=float, default=-1)
    ap.add_argument("-v", "--pvalue", type=float, default=-1)
    ap.add_argument("-p", "--prob", type=float, default=-1)
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.rtpcr import RtpcrOptions, run_compare

    run_compare(
        args.TRUTH, args.PANTAS, args.RMATS, args.WHIPPET, args.SUPPA,
        RtpcrOptions(
            strict=args.strict, common=args.common,
            delta=args.delta, pvalue=args.pvalue, prob=args.prob,
        ),
    )
    return 0


def _cmd_exp(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch exp")
    ap.add_argument("CONFIG", help="experiment config (JSON)")
    args = ap.parse_args(argv)
    from pantas_tpu_torch.experiment import run_experiment

    run_experiment(args.CONFIG)
    return 0


def _cmd_sim(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch sim")
    ap.add_argument("FA")
    ap.add_argument("GTF")
    ap.add_argument("-o", dest="prefix", default="sim")
    ap.add_argument("-n", dest="n_events", type=int, default=8)
    ap.add_argument("-r", dest="reads", type=int, default=60)
    ap.add_argument("-l", dest="read_len", type=int, default=150)
    ap.add_argument("-e", dest="error_rate", type=float, default=0.001)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument(
        "--etypes", nargs="+", default=["ES", "IR", "A3", "A5"],
        help="event kinds to inject (ES IR A3 A5 CE)",
    )
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.simulate import simulate

    simulate(
        args.FA,
        args.GTF,
        args.prefix,
        n_events=args.n_events,
        reads_per_isoform=args.reads,
        read_len=args.read_len,
        error_rate=args.error_rate,
        etypes=args.etypes,
        seed=args.seed,
    )
    return 0


def _cmd_eval(argv):
    ap = argparse.ArgumentParser(prog="pantas-tpu-torch eval")
    ap.add_argument("TRUTH")
    ap.add_argument("REMAP_CSV")
    ap.add_argument("--relax", type=int, default=3)
    ap.add_argument("--min-dpsi", dest="min_dpsi", type=float, default=0.0)
    ap.add_argument("--min-w", dest="min_w", type=float, default=0.0)
    args = ap.parse_args(argv)
    from pantas_tpu_torch.eval.compare import (
        parse_quant_remap,
        parse_truth,
        print_scores,
        score,
    )

    results = score(
        parse_truth(args.TRUTH),
        parse_quant_remap(args.REMAP_CSV),
        relax=args.relax,
        min_dpsi=args.min_dpsi,
        min_w=args.min_w,
    )
    print_scores(results)
    return 0


_OWN = {
    "build": _cmd_build,
    "augment": _cmd_augment,
    "augment-dist": _cmd_augment_dist,
    "call": _cmd_call,
    "quant": _cmd_quant,
    "remap": _cmd_remap,
    "replicate": _cmd_replicate,
    "map": _cmd_map,
    "map-accuracy": _cmd_map_accuracy,
    "prefilter": _cmd_prefilter,
    "filter-reads": _cmd_filter_reads,
    "gamp": _cmd_gamp,
    "gaf2sam": _cmd_gaf2sam,
    "reduce": _cmd_reduce,
    "prune": _cmd_prune,
    "reintroduce-paths": _cmd_reintroduce,
    "add-junctions": _cmd_add_junctions,
    "add-haplotypes": _cmd_add_haplotypes,
    "fix-vidx": _cmd_fix_vidx,
    "clean-gtf": _cmd_clean_gtf,
    "introns": _cmd_introns,
    "novel-sites": _cmd_novel_sites,
    "check-coverage": _cmd_check_coverage,
    "check-novel": _cmd_check_novel,
    "sim": _cmd_sim,
    "eval": _cmd_eval,
    "cmp": _cmd_cmp,
    "convert-rmats": _cmd_convert_rmats,
    "convert-suppa": _cmd_convert_suppa,
    "timev": _cmd_timev,
    "bench-table": _cmd_bench_table,
    "exp": _cmd_exp,
    "compare-rtpcr": _cmd_compare_rtpcr,
    "parse-res": _cmd_parse_res,
    "plot-pr": _cmd_plot_pr,
    "latex-table": _cmd_latex_table,
}

_USAGE = """pantas-tpu-torch [build|augment|call|quant|remap|map|version] -h

  pipeline stages:
    build         build and annotate a spliced pangenome
    augment       augment an annotated spliced pangenome using alignments information
                  (--engine device [--mesh N|DxK] runs on the card)
    augment-dist  one process of the multi-process sharded augment
                  (--coordinator HOST:PORT --nprocs N --procid I [--device cpu])
    call          call events from single replicate (--engine device [--mesh N])
    quant         quantify events comparing conditions
    remap         remap events to reference haplotype
    replicate     fused GAF -> events for one replicate (no augmented-GFA round trip)

  mapping / input preparation:
    map           align reads to the spliced pangenome (GAF output)
    map-accuracy  mapper placement accuracy + MAPQ calibration sweep
    prefilter     shark-style gene-panel read prefilter (FASTQ -> FASTQ + TSV)
    filter-reads  keep FASTQ records whose names match a prefilter TSV
    gamp          legacy vg-JSON (GAMP) augmenter (edge weights only)
    gaf2sam       project graph alignments to linear SAM records

  graph tools:
    reduce        reduce a GFA to its transcript id-intervals (gene panels)
    prune         drop uncovered nodes/edges from a GFA (id-interval pruning)
    reintroduce-paths  restore P lines onto a pruned GFA (validated double pass)
    add-junctions   legacy exon/junction tagging from transcript FASTA
    add-haplotypes  legacy haplotype path synthesis from a phased VCF
    fix-vidx      renumber variant indexes in a GFA
    clean-gtf     normalize a GTF for the build layer
    introns       fit the intron length distribution from a GTF

  analysis / extensions:
    novel-sites   detect intra-node novel splice sites from clip pile-ups (GAF)
    check-coverage  count spliced support for skipped exons in SAM files
    check-novel   classify skipped exons as novel vs annotated

  evaluation harness:
    exp           run a full two-condition experiment from a JSON config
    sim           simulate AS-event reads with ground truth
    eval          score called events against simulation truth (P/R/F1)
    cmp           multi-tool accuracy comparison vs truth (pantas/rMATS/Whippet/SUPPA2)
    compare-rtpcr   compare quant output against RT-PCR truth tables
    convert-rmats   rMATS output dir -> comparator CSV
    convert-suppa   SUPPA2 .dpsi -> comparator CSV
    parse-res     fold comparator outputs into result tables (+ --figures suite)
    plot-pr       truth-support table + P/R panel PNG from compare CSVs
    latex-table   LaTeX accuracy table from compare CSVs
    timev         run a command under rusage timing (time -v format log)
    bench-table   fold a directory of .time logs into one CSV

    version       print the version
"""


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_USAGE, file=sys.stdout if argv else sys.stderr)
        return 0 if argv else 1
    mode, rest = argv[0], argv[1:]
    if mode == "version":
        print(f"pantas-tpu-torch, {__version__}")
        return 0
    fn = _OWN.get(mode)
    if fn is None:
        print(_USAGE, file=sys.stderr)
        return 1
    t0 = time.time()
    rc = fn(rest)
    if rc == 0:
        print(f"[pantas-tpu-torch] {mode} completed in {time.time() - t0:.2f}s",
              file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
