"""The augment reference's novel links in upstream's first-seen order.

Upstream's augmenter counts a record's consecutive node pairs in the order its
walk is written: a reverse walk ``<c<b<a`` crosses ``(b, c)`` before
``(a, b)``, each pair's ends swapped back to the forward link. The first time
a pair with no ``L`` line is crossed fixes where its ``ID:Z:N`` line goes.
:func:`pbench.reference.augment.counts` orders the pairs of a record in the
forward order whatever its orientation, which differs only where one reverse
record is the first to cross two absent links (a read over a short cassette
exon, say); every count is the same. :func:`counts` is that function's result
with the novel links put in upstream's order.

It reads the read table the GAF was rendered from, never the program's output
or state, and imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from pbench.reference import augment
from pbench.reference.augment import MAPQ_THRESHOLD, MAX_DIVERGENCE


def counts(tables, reads) -> augment.Counts:
    c = augment.counts(tables, reads)
    if len(c.novel) < 2:
        return c
    keep = (reads.mapq >= MAPQ_THRESHOLD) & (reads.dv <= MAX_DIVERGENCE)
    first = reads.first[keep]
    pairs = reads.last[keep] - first  # consecutive pairs of each record
    rec_at = np.cumsum(pairs) - pairs
    within = np.arange(int(pairs.sum()), dtype=np.int64) - np.repeat(rec_at, pairs)
    step = np.repeat(first, pairs) + within
    key = (tables.steps[step].astype(np.int64) << 32) | tables.steps[step + 1].astype(np.int64)
    # each pair's place in the stream: its record's, then its place in the walk as written
    written = np.where(np.repeat(reads.reverse[keep], pairs), np.repeat(pairs, pairs) - 1 - within,
                       within)
    order = np.argsort(np.repeat(rec_at, pairs) + written, kind="stable")
    seen, first_at = np.unique(key[order], return_index=True)
    novel_key = np.asarray([(a << 32) | b for a, b, _ in c.novel], np.int64)
    rank = first_at[np.searchsorted(seen, novel_key)]
    return replace(c, novel=[c.novel[i] for i in np.argsort(rank, kind="stable")])
