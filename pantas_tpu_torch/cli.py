"""Command-line interface of the PyTorch port: ``python -m pantas_tpu_torch``.

The subcommands are ``pantas_tpu``'s (see ``pantas_tpu/cli.py``). This CLI
owns ``augment``: ``--engine device`` (native parse -> device scatter-add)
and ``--engine device-py`` (Python tokenizer -> device) run the port on
``--device`` (``cuda`` by default, ``cpu`` for tests), and the host engines
(``auto``, ``native``, ``host``) run ``pantas_tpu``'s own host code. It owns
``call`` too: ``--engine device [--mesh N]`` runs the port's bitset finders
on ``--device``, and ``--engine host`` the host caller. Device paths that are
not ported yet (``augment --mesh``, ``augment-dist``) exit non-zero and say
so. Every other subcommand is ``pantas_tpu.cli.main`` unchanged: those
stages are host code on either backend.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from pantas_tpu import cli as _tpu_cli

NOT_PORTED = "is not ported to pantas_tpu_torch yet (see ROADMAP.md)"


def _refuse(what: str) -> int:
    print(f"[pantas-tpu-torch] {what} {NOT_PORTED}", file=sys.stderr)
    return 2


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
    ap.add_argument("-t", dest="threads", type=int, default=1, help="native parse threads")
    ap.add_argument("--mesh", default=None, help="multi-device mesh (not ported yet)")
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
    if args.mesh:
        return _refuse("augment --mesh")
    dev = None
    if args.engine in ("device", "device-py"):
        from pantas_tpu_torch import backend

        from pantas_tpu_torch.coverage.device import scatter_choice

        # before the output is opened
        dev = backend.device(args.device)
        scatter_choice(os.environ.get("PANTAS_SCATTER", ""))
    with _tpu_cli._stage_out(args.out) as out:
        return _run_augment(args, dev, out)


def _run_augment(args, dev, out) -> int:
    if dev is None:
        return _tpu_cli._run_augment(args, args.engine, out)
    from pantas_tpu_torch.coverage.device import (
        NativeFeedUnavailable,
        augment_gfa_device,
        augment_gfa_device_native,
    )

    if args.engine == "device":
        try:
            augment_gfa_device_native(
                args.GAF, args.GFA, out=out, mapq_thr=args.thr, device=dev,
                checkpoint_path=args.checkpoint, resume=args.resume,
            )
            return 0
        except NativeFeedUnavailable as e:
            # raised before any output is written; errors of the kernel or
            # the device propagate instead
            _tpu_cli._reset_output_or_raise(out, e)
            print(
                f"[augment] native device feed unavailable ({e}); "
                "python tokenizer fallback",
                file=sys.stderr,
            )
    augment_gfa_device(
        args.GAF, args.GFA, out=out, mapq_thr=args.thr, device=dev,
        checkpoint_path=args.checkpoint, resume=args.resume,
    )
    return 0


def _cmd_augment_dist(argv):
    return _refuse("augment-dist")


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
        help="device engine: shard the candidate axis over N cards (same "
        "rows for any N)",
    )
    ap.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device of the device engine (default cuda; never falls back)",
    )
    ap.add_argument("-o", dest="out", default=None,
                    help="output CSV (default stdout; .gz/.zst compresses)")
    args = ap.parse_args(argv)
    from pantas_tpu.events import CallOptions, call_events

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
        from pantas_tpu_torch.events import call_events_device

        # before the output is opened
        devices = backend.devices(args.device, args.mesh or 1)
        call_fn = functools.partial(call_events_device, devices=devices)
    else:
        call_fn = call_events
    with _tpu_cli._stage_out(args.out) as out:
        for row in call_fn(args.GFA, args.GTF, opts):
            print(row, file=out)
    return 0


_OWN = {
    "augment": _cmd_augment,
    "augment-dist": _cmd_augment_dist,
    "call": _cmd_call,
}
_COMMANDS = {**_tpu_cli._COMMANDS, **_OWN}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    fn = _OWN.get(argv[0]) if argv else None
    if fn is None:
        return _tpu_cli.main(argv)
    t0 = time.time()
    rc = fn(argv[1:])
    if rc == 0:
        print(f"[pantas-tpu-torch] {argv[0]} completed in {time.time() - t0:.2f}s",
              file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
