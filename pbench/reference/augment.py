"""The plain reference of the augment stage, in NumPy.

It computes the augmented GFA that the upstream
``scripts/alignments_augmentation_from_gaf.py`` writes for a read table of
records along walks of the graph, forward (``>``) or reverse (``<``), whose
``cs`` holds matches and substitutions only. A record with MAPQ under 20, or
with ``dv`` over 0.1, adds nothing. For an accepted record the upstream
semantics reduce to this, in the walk's forward order whatever its
orientation: each node gains 1 on ``NC``; each node but the first gains 1 on
its ``IL`` offset 0 and each node but the last 1 on its ``OL`` offset equal to
its length, unless every base of the read on that node is a substitution
(upstream folds a substitution into the match beside it on the node, and a
node with nothing else has no operation left to count); each consecutive pair
of nodes gains 1 on its link's ``RC``. The first ``L`` line of a pair takes
the pair's count (later duplicates print 0), and pairs with no ``L`` line
follow the file as ``L a + b + * RC:i:w ID:Z:N`` in first-seen order. Every
line is printed stripped, with its tags appended.

It reads the read table the GAF was rendered from, never the program's
output or state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAPQ_THRESHOLD = 20
MAX_DIVERGENCE = 0.1


@dataclass
class Counts:
    nc: np.ndarray  # per segment row
    il: np.ndarray  # per segment row, at offset 0
    ol: np.ndarray  # per segment row, at offset = the segment's length
    link_rc: np.ndarray  # per L line, in file order
    novel: list  # [(src row, dst row, count)] in first-seen order


def counts(tables, reads) -> Counts:
    n_seg = len(tables.ids)
    n = reads.read_len
    keep = (reads.mapq >= MAPQ_THRESHOLD) & (reads.dv <= MAX_DIVERGENCE)
    first, last = reads.first[keep], reads.last[keep]
    lo = tables.step_start[first] + reads.offset[keep]
    span = last - first + 1
    total = int(span.sum())
    rec_at = np.cumsum(span) - span
    within = np.arange(total, dtype=np.int64) - np.repeat(rec_at, span)
    step = np.repeat(first, span) + within
    rows = tables.steps[step].astype(np.int64)
    is_last = within == np.repeat(span - 1, span)

    # bases of the read on each (record, node), and the substituted ones
    r_lo = np.repeat(lo, span)
    covered = (np.minimum(r_lo + n, tables.step_start[step + 1])
               - np.maximum(r_lo, tables.step_start[step]))
    k = np.diff(reads.sub_off)
    sub_rec = np.repeat(np.arange(len(reads), dtype=np.int64), k)
    sub_keep = keep[sub_rec]
    kept_at = np.cumsum(keep) - 1  # a kept record's index among the kept
    s_rec = kept_at[sub_rec[sub_keep]]
    s_pos = reads.sub_pos[sub_keep].astype(np.int64)
    s_fwd = np.where(reads.reverse[sub_rec[sub_keep]], n - 1 - s_pos, s_pos)
    s_step = np.searchsorted(tables.step_start, lo[s_rec] + s_fwd, side="right") - 1
    subs = np.bincount(rec_at[s_rec] + s_step - first[s_rec], minlength=total)
    counted = subs < covered

    nc = np.bincount(rows, minlength=n_seg)
    il = np.bincount(rows[(within != 0) & counted], minlength=n_seg)
    ol = np.bincount(rows[~is_last & counted], minlength=n_seg)

    # consecutive pairs inside each record, in stream order
    src = rows[:-1][~is_last[:-1]]
    dst = rows[1:][~is_last[:-1]]
    key = (src << 32) | dst
    uniq, first_at, cnt = np.unique(key, return_index=True, return_counts=True)
    l_key = (tables.l_src.astype(np.int64) << 32) | tables.l_dst.astype(np.int64)
    _, l_first = np.unique(l_key, return_index=True)
    pos = np.minimum(np.searchsorted(uniq, l_key), max(len(uniq) - 1, 0))
    hit = uniq[pos] == l_key if len(uniq) else np.zeros(len(l_key), bool)
    takes = np.zeros(len(l_key), bool)
    takes[l_first] = True  # the first L line of a pair takes its count
    link_rc = np.zeros(len(l_key), np.int64)
    link_rc[takes & hit] = cnt[pos[takes & hit]]
    known = np.isin(uniq, l_key)
    order = np.argsort(first_at[~known], kind="stable")
    nk, nf = uniq[~known][order], cnt[~known][order]
    novel = list(zip((nk >> 32).tolist(), (nk & 0xFFFFFFFF).tolist(), nf.tolist()))
    return Counts(nc=nc, il=il, ol=ol, link_rc=link_rc, novel=novel)


def emit(tables, c: Counts, write, chunk_lines: int = 1 << 15) -> None:
    """Write the augmented GFA through ``write(str)``, in chunks."""
    lens = tables.lens.tolist()
    s_tail = [
        f"\tNC:i:{n}" + (f"\tIL:Z:0.{i}" if i else "") + (f"\tOL:Z:{ln}.{o}" if o else "")
        for n, i, o, ln in zip(c.nc.tolist(), c.il.tolist(), c.ol.tolist(), lens)
    ]
    l_tail = [f"\tRC:i:{w}" for w in c.link_rc.tolist()]
    si = li = 0
    buf = []
    with open(tables.gfa) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("S"):
                buf.append(line + s_tail[si] + "\n")
                si += 1
            elif line.startswith("L"):
                if len(line) == 1:
                    continue
                buf.append(line + l_tail[li] + "\n")
                li += 1
            else:
                buf.append(line + "\n")
            if len(buf) >= chunk_lines:
                write("".join(buf))
                buf = []
    ids = tables.ids.tolist()
    buf.extend(f"L\t{ids[a]}\t+\t{ids[b]}\t+\t*\tRC:i:{w}\tID:Z:N\n" for a, b, w in c.novel)
    write("".join(buf))
