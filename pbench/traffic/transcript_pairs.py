"""Read pairs sampled along the haplotypes' transcript copies: the generator
that every ``transcript_pairs`` traffic mix names.

A mix file gives the shape: abundance skew, fragment length, library
strandedness, the per-base substitution rate, the share of pairs that map
ambiguously (MAPQ under the augment's threshold) and the share of records too
divergent to count; the configuration gives the scale (``reads.pairs``,
``reads.read_len``). The transcripts' abundances are one fixed multiset of
log-normal values, assigned to transcripts in an order drawn from the seed, so
every seed asks for the same spread of expression over different genes.

Each pair picks a transcript by abundance, one of its copies (the reference's
and the haplotypes') uniformly, a fragment length and a start. The mate at the
fragment's left end aligns forward (``>id>id..``), the mate at its right end
reverse (``<id<id..``), as a paired-end library's mates face each other; in an
unstranded library either may be mate 1. Substitutions fall on each base
independently; their count over the read length is the record's ``dv``. The
substituted bases are written as ``*ac``: the augment reads only where a
substitution lies, not its bases.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ABUNDANCE_DRAW_SEED = 0  # the fixed multiset of abundances, the same for every seed
SUBSTITUTIONS = ("*ac", "*ag", "*at", "*ca", "*cg", "*ct", "*ga", "*gc", "*gt", "*ta", "*tc", "*tg")


@dataclass
class Reads:
    """The read table a GAF is rendered from, one entry per record. A record
    covers the steps ``first..last`` of ``tables.steps`` from ``offset`` bp
    into its first step, ``read_len`` bp in all. ``sub_pos[sub_off[i]:sub_off[i + 1]]``
    are record ``i``'s substituted positions along the read as aligned (the
    walk's own orientation), ascending."""

    first: np.ndarray
    last: np.ndarray
    offset: np.ndarray
    reverse: np.ndarray
    mapq: np.ndarray
    sub_off: np.ndarray
    sub_pos: np.ndarray
    read_len: int

    def __len__(self) -> int:
        return len(self.first)

    @property
    def dv(self) -> np.ndarray:
        """The divergence as the GAF prints it, ``dv:f:`` to four places (the
        substitutions over the read length)."""
        return np.round(np.diff(self.sub_off) / self.read_len, 4)


def _step_of(step_start: np.ndarray, at: np.ndarray) -> np.ndarray:
    """The step that holds each bp offset (queries sorted first: the table is
    large, and sorted probes walk it in order)."""
    order = np.argsort(at, kind="stable")
    out = np.empty(len(at), np.int64)
    out[order] = np.searchsorted(step_start, at[order], side="right") - 1
    return out


def _distinct(keys: np.ndarray) -> np.ndarray:
    """``np.unique`` by a sort: some NumPy releases hash instead, several
    times slower on millions of keys."""
    keys = np.sort(keys)
    return keys[np.concatenate(([True], keys[1:] != keys[:-1]))] if len(keys) else keys


def _substitutions(rng, records: int, n: int, rate: float, high_share: float, high: list):
    """Per record, distinct substituted positions: each base at ``rate``, or,
    for a ``high_share`` of records, a count drawn from ``high`` (inclusive)."""
    k = rng.binomial(n, rate, size=records)
    hi = rng.random(records) < high_share
    k[hi] = rng.integers(int(high[0]), int(high[1]) + 1, size=int(hi.sum()))
    rec = np.repeat(np.arange(records, dtype=np.int64), k)
    # k draws a record, and draws again for the repeats until each has k distinct
    pos = rng.integers(0, n, size=len(rec))
    key = _distinct(rec * n + pos)
    while True:
        have = np.bincount(key // n, minlength=records)
        short = k - have
        if not short.any():
            break
        more = np.repeat(np.arange(records, dtype=np.int64), short)
        key = _distinct(np.concatenate([key, more * n + rng.integers(0, n, size=len(more))]))
    off = np.zeros(records + 1, np.int64)
    off[1:] = np.cumsum(k)
    return off, (key % n).astype(np.int32)


def generate(tables, config: dict, mix: dict, seed: int) -> Reads:
    n = int(config["reads"]["read_len"])
    pairs = int(config["reads"]["pairs"])
    if mix["library"] not in ("unstranded", "stranded"):
        raise ValueError(f"unknown library {mix['library']!r}")
    rng = np.random.default_rng(seed)
    path_len = np.diff(tables.path_bp)
    frag = mix["fragment"]
    n_tx = len(tables.tx_names)

    copies = np.flatnonzero(path_len >= int(frag["max"]))
    copies = copies[np.argsort(tables.path_tx[copies], kind="stable")]
    per_tx = np.bincount(tables.path_tx[copies], minlength=n_tx)
    tx_first = np.concatenate(([0], np.cumsum(per_tx)[:-1]))
    values = np.sort(np.random.default_rng(ABUNDANCE_DRAW_SEED).standard_normal(n_tx))
    weight = np.exp(float(mix["abundance"]["lognormal_sigma"]) * values)[rng.permutation(n_tx)]
    weight[per_tx == 0] = 0.0

    tx = rng.choice(n_tx, size=pairs, p=weight / weight.sum())
    path = copies[tx_first[tx] + (rng.random(pairs) * per_tx[tx]).astype(np.int64)]
    flen = np.clip(np.rint(rng.normal(frag["mean"], frag["sd"], pairs)).astype(np.int64),
                   n, int(frag["max"]))
    s1 = (rng.random(pairs) * (path_len[path] - flen + 1)).astype(np.int64)
    s2 = s1 + flen - n
    # mate 1 is the left end's forward record, or, in half the pairs of an
    # unstranded library, the right end's reverse one
    swap = (rng.random(pairs) < 0.5) if mix["library"] == "unstranded" else np.zeros(pairs, bool)
    start = np.stack([np.where(swap, s2, s1), np.where(swap, s1, s2)], axis=1).ravel()
    reverse = np.stack([swap, ~swap], axis=1).ravel()

    low = mix["low_mapq"]
    ambiguous = rng.random(pairs) < float(low["share"])
    mapq = np.where(ambiguous, rng.integers(int(low["range"][0]), int(low["range"][1]) + 1, pairs),
                    int(mix["mapq"]))
    high = mix["high_divergence"]
    sub_off, sub_pos = _substitutions(rng, 2 * pairs, n, float(mix["substitution_rate"]),
                                      float(high["share"]), high["substitutions"])

    lo = tables.path_bp[np.repeat(path, 2)] + start
    first = _step_of(tables.step_start, lo)
    last = _step_of(tables.step_start, lo + n - 1)
    return Reads(first=first, last=last, offset=lo - tables.step_start[first], reverse=reverse,
                 mapq=np.repeat(mapq, 2).astype(np.int32), sub_off=sub_off, sub_pos=sub_pos,
                 read_len=n)


def _cs_pieces(reads: Reads) -> list:
    """Each substitution's piece of ``cs:Z:``: the match run before it, if
    any, and ``*<ref><alt>``."""
    pos = reads.sub_pos.astype(np.int64)
    rec = np.repeat(np.arange(len(reads)), np.diff(reads.sub_off))
    prev = np.empty_like(pos)
    prev[:1] = 0
    prev[1:] = pos[:-1] + 1
    prev[reads.sub_off[:-1][np.diff(reads.sub_off) > 0]] = 0  # a record's first
    run = (pos - prev).tolist()
    sub = ((pos * 7 + rec) % len(SUBSTITUTIONS)).tolist()
    return [f":{r}{SUBSTITUTIONS[b]}" if r else SUBSTITUTIONS[b] for r, b in zip(run, sub)]


def gaf_lines(tables, reads: Reads):
    """The GAF text of ``reads``, in chunks of lines: mates ``p<i>``, the
    walk forward (``>id..``) or reverse (``<id..``, last node first), path
    length over the walk's nodes, start and end on the walk as written."""
    n = reads.read_len
    ss = tables.step_start
    plen = ss[reads.last + 1] - ss[reads.first]
    start = np.where(reads.reverse, plen - reads.offset - n, reads.offset)
    fwd, rev = tables.walk_text, tables.reverse_walk_text
    co, rco = tables.char_off, tables.reverse_char_off
    # a reverse walk is the slice of the reversed text that runs last .. first
    r_first = len(tables.steps) - 1 - reads.last
    r_last = len(tables.steps) - 1 - reads.first
    a = np.where(reads.reverse, rco[r_first], co[reads.first]).tolist()
    b = np.where(reads.reverse, rco[r_last + 1], co[reads.last + 1]).tolist()
    is_rev = reads.reverse.tolist()
    k = np.diff(reads.sub_off)
    last_sub = np.where(k > 0, reads.sub_pos[np.maximum(reads.sub_off[1:] - 1, 0)], -1)
    tail = (n - 1 - last_sub).tolist()
    pieces = _cs_pieces(reads)
    off = reads.sub_off.tolist()
    head = f"\t{n}\t0\t{n}\t+\t"
    fields = zip(range(len(reads)), a, b, is_rev, plen.tolist(), start.tolist(), (n - k).tolist(),
                 reads.mapq.tolist(), reads.dv.tolist(), off, off[1:], tail)
    chunk, lines = 1 << 16, []
    for i, x, y, r, pl, s, m, q, d, o0, o1, t in fields:
        cs = "".join(pieces[o0:o1]) + (f":{t}" if t else "")
        lines.append(f"p{i >> 1}{head}{(rev if r else fwd)[x:y]}\t{pl}\t{s}\t{s + n}\t{m}\t{n}"
                     f"\t{q}\tdv:f:{d:.4f}\tcs:Z:{cs}\n")
        if len(lines) == chunk:
            yield "".join(lines)
            lines = []
    yield "".join(lines)


def write_gaf(tables, reads: Reads, path) -> int:
    """Write the GAF; returns its size in bytes."""
    size = 0
    with open(path, "w") as fh:
        for part in gaf_lines(tables, reads):
            size += fh.write(part)
    return size
