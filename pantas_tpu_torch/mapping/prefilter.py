"""shark-style gene-panel read prefilter.

The reference's human experiment prefilters FASTQs with the external
``shark`` tool before building/mapping against a reduced gene-panel graph
(``exps/3-homo-real/workflow/rules/pantas.smk:57-75``:
``shark -q 10 -r genes.fa -1 .. -2 .. -o .. -p .. > assoc.tsv``).
This is the native interface-compatible replacement: given a gene FASTA
(one record per gene region, as ``get_genes_fa.sh`` produces) and FASTQ
pair, keep the pairs whose k-mers vote for a panel gene, and emit a
``read<TAB>gene`` association TSV.

Semantics (documented, not a byte-contract — shark is external to the
reference the same way vg is): a mate *confirms* gene g when >= min_frac
of its valid k-mer windows hit g; windows containing a base with
phred < qthr (shark's ``-q``) or a non-ACGT base never vote. A pair is
kept when either mate confirms some gene; the association is the
highest-fraction gene over both mates.
"""

from __future__ import annotations

import io
import sys
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np

from pantas_tpu_torch.io.fasta import iter_fasta
from pantas_tpu_torch.mapping.mapper import PathIndex, PathRecord


def build_gene_index(genes_fa: str, k: int = 17, max_hits: int = 64) -> PathIndex:
    """Both strands are indexed (one record each, same gene name): reverse
    mates carry reverse-complement k-mers, and a mate's windows vote per
    record so strand copies never dilute each other."""
    from pantas_tpu_torch.io.fasta import revcomp

    paths: List[PathRecord] = []
    for name, seq in iter_fasta(genes_fa):
        seq = seq.upper()
        paths.append(PathRecord(name, ["1"], [0], seq))
        paths.append(PathRecord(name, ["1"], [0], revcomp(seq)))
    if not paths:
        raise ValueError(f"no records in {genes_fa}")
    return PathIndex(paths, k=k, max_hits=max_hits)


def _read_votes(
    index: PathIndex, seq: str, qual: Optional[str], qthr: int
) -> Tuple[int, int, int]:
    """(valid_windows, best_gene, best_count) — python engine."""
    k = index.k
    mask = (1 << (2 * k)) - 1
    from pantas_tpu_torch.mapping.mapper import _BASE_CODE

    packed = 0
    run = 0
    valid = 0
    counts: Dict[int, int] = {}
    seen_at: Dict[int, int] = {}
    wc = 0
    for i, ch in enumerate(seq):
        # parity with the native code(): only N breaks the window; other
        # degenerate IUPAC codes pack as 0
        lowq = qual is not None and i < len(qual) and (ord(qual[i]) - 33) < qthr
        if ch in "Nn" or lowq:
            run = 0
            continue
        packed = ((packed << 2) | int(_BASE_CODE[ord(ch)])) & mask
        run += 1
        if run < k:
            continue
        valid += 1
        wc += 1
        for t in index._lookup(packed):
            pid = int(index._pids[t])
            if seen_at.get(pid) == wc:
                continue
            seen_at[pid] = wc
            counts[pid] = counts.get(pid, 0) + 1
    if not counts:
        return valid, -1, 0
    best_gene = max(counts, key=lambda p: (counts[p], -p))
    return valid, best_gene, counts[best_gene]


def _iter_fastq_raw(path: str):
    from pantas_tpu_torch.io.xopen import xopen

    with xopen(path) as fh:
        while True:
            lines = [fh.readline() for _ in range(4)]
            if not lines[0]:
                return
            if lines[-1] and not lines[-1].endswith("\n"):
                lines[-1] += "\n"
            name = lines[0][1:].split()[0]
            yield name, lines[1].rstrip("\n"), lines[3].rstrip("\n"), "".join(lines)


def prefilter_reads(
    genes_fa: str,
    fq1: str,
    fq2: Optional[str],
    out1_path: str,
    out2_path: Optional[str],
    tsv_out: TextIO = sys.stdout,
    k: int = 17,
    qthr: int = 10,
    min_frac: float = 0.6,
    threads: int = 1,
    engine: str = "auto",
    log=sys.stderr,
) -> Tuple[int, int]:
    """Filter FASTQ(s) against a gene panel; returns (kept_pairs, total)."""
    index = build_gene_index(genes_fa, k=k)
    print(
        f"[prefilter] {len(index.paths)} genes, {len(index.kmers)} kmers indexed",
        file=log,
    )

    if engine in ("auto", "native"):
        try:
            kept, total = _prefilter_native(
                index, fq1, fq2, out1_path, out2_path, tsv_out, qthr, min_frac, threads
            )
            print(f"[prefilter] kept {kept}/{total} pairs (native)", file=log)
            return kept, total
        except Exception as e:
            if engine == "native":
                raise
            if isinstance(e, _PartialNativeOutput):
                # association rows already escaped to the caller's real
                # fd — a python re-run would append a duplicate row set
                # on an un-truncatable stream
                raise
            print(f"[prefilter] native unavailable ({e}); python engine", file=log)

    kept = total = 0
    streams = [_iter_fastq_raw(fq1)]
    if fq2:
        streams.append(_iter_fastq_raw(fq2))
    out1 = open(out1_path, "w")
    out2 = open(out2_path, "w") if fq2 and out2_path else None
    try:
        for recs in zip(*streams):
            total += 1
            best_gene = -1
            best_frac = 0.0
            for _name, seq, qual, _raw in recs:
                q = qual if len(qual) == len(seq) else None
                valid, bg, bc = _read_votes(index, seq, q, qthr)
                if valid <= 0 or bg < 0:
                    continue
                frac = bc / valid
                if frac >= min_frac and frac > best_frac:
                    best_frac = frac
                    best_gene = bg
            if best_gene < 0:
                continue
            kept += 1
            out1.write(recs[0][3])
            if out2 is not None:
                out2.write(recs[1][3])
            tsv_out.write(f"{recs[0][0]}\t{index.paths[best_gene].name}\n")
    finally:
        out1.close()
        if out2 is not None:
            out2.close()
    print(f"[prefilter] kept {kept}/{total} pairs (python)", file=log)
    return kept, total


class _PartialNativeOutput(IOError):
    """Native engine failed AFTER streaming association rows to the
    caller's real fd — auto mode must not fall back (duplicate rows)."""


def _prefilter_native(
    index: PathIndex,
    fq1: str,
    fq2: Optional[str],
    out1_path: str,
    out2_path: Optional[str],
    tsv_out: TextIO,
    qthr: int,
    min_frac: float,
    threads: int,
) -> Tuple[int, int]:
    import ctypes

    from pantas_tpu_torch.mapping.mapper import NativePathAligner
    from pantas_tpu_torch.native.gafcov import _ptr

    native = NativePathAligner(index)
    names = "".join(rec.name for rec in index.paths).encode()
    name_off = np.zeros(len(index.paths) + 1, dtype=np.int64)
    off = 0
    for i, rec in enumerate(index.paths):
        off += len(rec.name.encode())
        name_off[i + 1] = off

    stats = np.zeros(2, dtype=np.int64)
    tsv_out.flush()
    tsv_tmp = None
    try:
        tsv_fd = tsv_out.fileno()
    except Exception:
        import tempfile

        tsv_tmp = tempfile.NamedTemporaryFile("w+", delete=False)
        tsv_fd = tsv_tmp.fileno()
    from contextlib import nullcontext

    from pantas_tpu_torch.io.xopen import materialized

    # the C reader fopen()s the paths — compressed FASTQs inflate once
    with materialized(fq1) as f1, (
        materialized(fq2) if fq2 else nullcontext(None)
    ) as f2, open(out1_path, "w") as o1, open(
        out2_path if (fq2 and out2_path) else "/dev/null", "w"
    ) as o2:
        rc = native.lib.shk_filter_file(
            native.handle,
            str(f1).encode(),
            str(f2).encode() if f2 else None,
            o1.fileno(),
            o2.fileno(),
            tsv_fd,
            names,
            _ptr(name_off, ctypes.c_int64),
            qthr,
            min_frac,
            threads,
            _ptr(stats, ctypes.c_int64),
        )
    if rc != 0:
        if tsv_tmp is None:  # rows streamed straight to the caller's fd
            raise _PartialNativeOutput(f"shk_filter_file failed ({rc})")
        import os

        tsv_tmp.close()
        os.unlink(tsv_tmp.name)  # buffered rows are simply discarded
        raise IOError(f"shk_filter_file failed ({rc})")
    if tsv_tmp is not None:
        tsv_tmp.seek(0)
        tsv_out.write(tsv_tmp.read())
        import os

        tsv_tmp.close()
        os.unlink(tsv_tmp.name)
    return int(stats[0]), int(stats[1])
