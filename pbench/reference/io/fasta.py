"""Minimal FASTA reader/writer (build layer only)."""

from __future__ import annotations
from pbench.reference.xopen import xopen

from typing import Dict, Iterator, Tuple


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    name = None
    chunks = []
    with xopen(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def read_fasta(path: str) -> Dict[str, str]:
    return dict(iter_fasta(path))


def read_fasta_record(path: str, name: str) -> str:
    """One record, streaming with early exit — a per-chromosome build
    worker must not load (and scan past) the whole genome to take one
    chromosome (the old pattern cost O(chromosomes x file size) IO and
    held N genome copies in RAM across workers)."""
    for n, seq in iter_fasta(path):
        if n == name:
            return seq
    raise KeyError(f"chromosome {name} missing from {path}")


def write_fasta(out, records, width: int = 80) -> None:
    for name, seq in records:
        print(f">{name}", file=out)
        for i in range(0, len(seq), width):
            print(seq[i : i + width], file=out)


_COMP = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]
