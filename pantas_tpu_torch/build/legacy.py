"""Legacy pre-annotate.cpp build utilities (standalone tools).

Byte-identical reimplementations of the reference's legacy pure-Python
build path helpers (none are wired into the reference CLI or workflows;
kept for component parity):

* ``prune_gfa`` — `scripts/prune_gfa.py` (86 LoC): keep nodes inside the
  [min-w, max+w] id interval of any ``tprefix``/``_alt``-prefixed path.
* ``reintroduce_paths`` — `scripts/reintroduce_paths.py` (37 LoC): restore
  P lines from the unpruned GFA into a pruned one, with a validate-first
  double pass "to print empty GFA in case of failure".
"""

from __future__ import annotations

import sys
from typing import List, Set, Tuple


def prune_gfa(gfa_path: str, out=None, w: int = 0, tprefix: str = "ENST", log=None) -> None:
    """Keep the transcript-interval subgraph; split other paths at gaps.

    Quirks preserved from ``prune_gfa.py``:

    * split sub-paths are named ``{pname}_{i}`` (1-based, underscore — the
      sibling ``reduce.py`` tool uses ``.{i}`` 0-based; both verbatim);
    * a path's FINAL kept segment is dropped — no flush after the node
      loop (``prune_gfa.py:45-53``);
    * lines that are not H/S/L/P vanish (no else branch, ``:25-60``);
    * ``_alt``-prefixed paths pass through verbatim, like transcript paths
      (hardcoded, ``:38-41``).
    """
    out = sys.stdout if out is None else out
    log = sys.stderr if log is None else log
    keep: Set[int] = set()
    nnodes = 0
    for line in open(gfa_path):
        if line.startswith("S"):
            nnodes += 1
        elif line.startswith("P"):
            _, pname, nodes, _ = line.split("\t")
            if not pname.startswith(tprefix):
                continue
            ids = [int(n[:-1]) for n in nodes.split(",")]
            keep |= set(range(min(ids) - w, max(ids) + w + 1))
    print(f"Pruning {len(keep)}/{nnodes} nodes..", file=log)

    wr = out.write
    for line in open(gfa_path):
        if line.startswith("H"):
            wr(line)
        elif line.startswith("S"):
            if int(line.split("\t")[1]) in keep:
                wr(line)
        elif line.startswith("L"):
            t = line.split("\t")
            if int(t[1]) in keep and int(t[3]) in keep:
                wr(line)
        elif line.startswith("P"):
            _, pname, nodes, _ = line.strip("\n").split("\t")
            if pname.startswith(tprefix) or pname.startswith("_alt"):
                wr(line)
            else:
                paths: List[List[int]] = []
                cur: List[int] = []
                for node in (int(n[:-1]) for n in nodes.split(",")):
                    if node in keep:
                        cur.append(node)
                    elif cur:
                        paths.append(cur)
                        cur = []
                # QUIRK: trailing `cur` intentionally not flushed
                for i, path in enumerate(paths, 1):
                    steps = ",".join(f"{x}+" for x in path)
                    wr(f"P\t{pname}_{i}\t{steps}\t*\n")


def reintroduce_paths(gfa_path: str, pruned_gfa_path: str, out=None) -> None:
    """Restore the original P lines into a pruned GFA.

    Double pass as in ``reintroduce_paths.py:8-33``: every consecutive node
    pair of every original path is asserted to exist as an edge in the
    pruned graph BEFORE anything is printed, so a failure emits an empty
    GFA rather than an incomplete one. Reverse-strand paths (last step
    ``-``) are validated in reversed order.
    """
    out = sys.stdout if out is None else out
    edges: Set[Tuple[int, int]] = set()
    for line in open(pruned_gfa_path):
        if line.startswith("L"):
            _, n1, _, n2, _, _ = line.split("\t")
            edges.add((int(n1), int(n2)))

    for line in open(gfa_path):
        if line.startswith("P"):
            nodes = line.split("\t")[2].split(",")
            strand = nodes[-1][-1]
            ids = [int(x[:-1]) for x in nodes]
            if strand == "-":
                ids.reverse()
            for n1, n2 in zip(ids[:-1], ids[1:]):
                assert (n1, n2) in edges

    wr = out.write
    for line in open(pruned_gfa_path):
        wr(line)
    for line in open(gfa_path):
        if line.startswith("P"):
            wr(line)


# ---------------------------------------------------------------------------
# add_junctions / add_haplotypes — the remaining two legacy annotators
# ---------------------------------------------------------------------------


def _fa_complement(fa: str) -> str:
    """gfautils.fa_complement: lowercase walk, unknown bases become N."""
    out = []
    for x in fa.lower():
        out.append(
            "T" if x == "a" else "G" if x == "c" else "C" if x == "g"
            else "A" if x == "t" else "N"
        )
    return "".join(out)


class _MiniGfa:
    """gfautils.GFA parse/print semantics, quirks verbatim:

    * fields split on ANY whitespace (``line.split()``, gfautils.py:103);
    * a path is reverse iff ``"+,"`` does not appear in its steps minus the
      last char — so a SINGLE-NODE forward path parses as reverse
      (gfautils.py:106-112);
    * print always appends ``LN:i:`` to S lines, then EX; JN after L
      fields; P fields re-emitted after the overlap (gfautils.py:172-218).
    """

    def __init__(self, path: str) -> None:
        self.header = ""
        self.nodes: dict = {}  # nid -> [seq, fields, exons]
        self.links: dict = {}  # (a,b) -> [of, ot, overlap, fields, junctions]
        self.paths: dict = {}  # pid -> [nodes, overlap, fields, is_reverse]
        for line in open(path):
            line = line.strip()
            if line.startswith("S"):
                _, nid, seq, *fields = line.split()
                self.nodes[nid] = [seq, fields, []]
            elif line.startswith("P"):
                _, pid, p, overlap, *fields = line.split()
                assert not ("+," in p[:-1] and "-," in p[:-1])
                if "+," in p[:-1]:
                    self.paths[pid] = [p[:-1].split("+,"), overlap, fields, False]
                else:
                    self.paths[pid] = [p[:-1].split("-,"), overlap, fields, True]
            elif line.startswith("L"):
                _, a, of, b, ot, overlap, *fields = line.split()
                self.links[(a, b)] = [of, ot, overlap, fields, []]
            elif line.startswith("H"):
                self.header = line

    def pseq(self, pid: str) -> str:
        nodes, _, _, is_reverse = self.paths[pid]
        if not is_reverse:
            return "".join(self.nodes[n][0] for n in nodes)
        # QUIRK: per-node complement-of-reversed IN PATH ORDER (the node
        # order is not reversed), gfautils.py:54-62
        return "".join(_fa_complement(self.nodes[n][0][::-1]) for n in nodes)

    def print(self, out) -> None:
        if len(self.header) > 0:
            out.write(self.header + "\n")
        for nid, (seq, fields, exons) in self.nodes.items():
            row = ["S", nid, seq, *fields, f"LN:i:{len(seq)}"]
            out.write("\t".join(row))
            if exons:
                out.write(f'\tEX:Z:{",".join(exons)}')
            out.write("\n")
        for (a, b), (of, ot, overlap, fields, junctions) in self.links.items():
            out.write("\t".join(["L", a, of, b, ot, overlap, *fields]))
            if junctions:
                out.write(f'\tJN:Z:{",".join(junctions)}')
            out.write("\n")
        for pid, (nodes, overlap, fields, is_reverse) in self.paths.items():
            joiner = "+," if not is_reverse else "-,"
            steps = joiner.join(nodes) + joiner[0]
            out.write("\t".join(["P", pid, steps, overlap, *fields]))
            out.write("\n")


def add_junctions(
    gfa_path: str, gffw_path: str, ignore_seq: bool = False, out=None, log=None
) -> None:
    """EX/JN tagging from a gffread transcript FASTA with ``segs:`` metadata.

    Byte-identical to ``scripts/add_junctions.py:32-81``: every path node
    gets the CURRENT segment's exon label (label index advances when the
    cumulative node length hits a segment end), the boundary link gets the
    junction label — reversed link key for reverse paths — and the
    transcript path sequence is asserted against the FASTA record unless
    ``ignore_seq`` (the ``--IS`` flag).
    """
    out = sys.stdout if out is None else out
    log = sys.stderr if log is None else log
    gfa = _MiniGfa(gfa_path)

    def records():
        cur = None
        toks: List[str] = []
        seq: List[str] = []
        for line in open(gffw_path):
            if line.startswith(">"):
                if cur is not None:
                    yield cur, toks, "".join(seq)
                toks = line[1:].rstrip("\n").split()
                cur = toks[0]
                seq = []
            else:
                seq.append(line.strip())
        if cur is not None:
            yield cur, toks, "".join(seq)

    for name, desc_tokens, seq in records():
        pid = f"{name}_R1"
        if pid not in gfa.paths:
            print(f"Skipping {name}. Missing from GFA", file=log)
            continue
        if not ignore_seq:
            assert gfa.pseq(pid) == seq

        segs_tok = [l for l in desc_tokens if l.startswith("segs:")][0]
        intsegs = []
        for seg in segs_tok.split(":")[1].split(","):
            s, e = seg.split("-")
            intsegs.append((int(s), int(e)))

        curr_seg = 0
        cum_len = 0
        pnodes, _, _, is_reverse = gfa.paths[pid]
        for ix, nid_curr in enumerate(pnodes):
            cum_len += len(gfa.nodes[nid_curr][0])
            gfa.nodes[nid_curr][2].append(f"{name}.{curr_seg + 1}")
            if cum_len == intsegs[curr_seg][1]:
                curr_seg += 1
                if ix == len(pnodes) - 1:
                    continue
                lkey = (
                    (nid_curr, pnodes[ix + 1])
                    if not is_reverse
                    else (pnodes[ix + 1], nid_curr)
                )
                gfa.links[lkey][4].append(f"{name}.{curr_seg}.{curr_seg + 1}")
        assert curr_seg == len(intsegs)

    gfa.print(out)


def add_haplotypes(
    gfa_path: str, vcf_path: str, tprefix: str = "ENST", out=None, log=None
) -> None:
    """Haplotype path synthesis from phased VCF ``_alt_`` paths.

    Byte-identical to ``scripts/add_haplotypes.py:11-116``: per sample and
    haplotype, substitute every reference node carried by a non-ref allele
    with the allele's ``_alt_`` path nodes (multi-node reference alleles
    de-duplicate on the trailing alt node); identical haplotype paths merge
    under a ``|``-joined name; original lines re-emit verbatim minus the
    ``_alt_`` P lines. Missing genotypes count as reference (pysam
    ``allele_indices`` None -> 0).
    """
    import gzip

    out = sys.stdout if out is None else out
    log = sys.stderr if log is None else log

    ref_paths: dict = {}
    variants: dict = {}
    for line in open(gfa_path):
        if line.startswith("P"):
            _, idx, nodes_s, _ = line.split("\t")
            nodes = [int(x[:-1]) for x in nodes_s.split(",")]
            if idx.startswith("_alt_"):
                vidx = "_".join(idx.split("_")[2:-1])
                a = int(idx.split("_")[-1])
                variants.setdefault(vidx, {})[a] = nodes
            elif idx.startswith(tprefix):
                ref_paths[idx] = nodes

    for idx, alleles in variants.items():
        assert len(alleles) == 2

    op = gzip.open if str(vcf_path).endswith(".gz") else open
    sample_names: List[str] = []
    samples: dict = {}
    with op(vcf_path, "rt") as fh:
        for line in fh:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                sample_names = line.rstrip("\n").split("\t")[9:]
                continue
            cols = line.rstrip("\n").split("\t")
            alts = cols[4].split(",")
            if any(a[0] == "<" for a in alts):
                continue
            rid = cols[2]
            for i, name in enumerate(sample_names):
                if name not in samples:
                    samples[name] = [{}, {}]
                gt = cols[9 + i].split(":")[0].replace("|", "/").split("/")
                h1 = 0 if gt[0] in (".", "") else int(gt[0])
                h2 = 0 if len(gt) < 2 or gt[1] in (".", "") else int(gt[1])
                if h1 != 0 or h2 != 0:
                    assert rid in variants
                if h1 != 0:
                    for ref_a in variants[rid][0]:
                        samples[name][0][ref_a] = variants[rid][h1]
                if h2 != 0:
                    for ref_a in variants[rid][0]:
                        samples[name][1][ref_a] = variants[rid][h2]

    haplotypes: List[Tuple[str, List[int]]] = []
    for sample in samples:
        for hi in (0, 1):
            hap = samples[sample][hi]
            if hap == {}:
                for pname, pnodes in ref_paths.items():
                    haplotypes.append((f"{sample}_{hi + 1}.{pname}", pnodes))
            else:
                for pname, pnodes in ref_paths.items():
                    new_path: List[int] = []
                    for node in pnodes:
                        if node in hap:
                            alt_nodes = hap[node]
                            if new_path != [] and new_path[-1] == alt_nodes[-1]:
                                continue
                            new_path += alt_nodes
                        else:
                            new_path += [node]
                    haplotypes.append((f"{sample}_{hi + 1}.{pname}", new_path))

    print(f"Merging {len(haplotypes)} paths..", file=log)
    inv_haplotypes: dict = {}
    for hname, hpath in haplotypes:
        key = ",".join(f"{x}+" for x in hpath)
        inv_haplotypes.setdefault(key, []).append(hname)
    print(f"Unique paths: {len(inv_haplotypes)}", file=log)

    for line in open(gfa_path):
        if line.startswith("P"):
            _, idx, _, _ = line.split("\t")
            if idx.startswith("_alt_"):
                continue
        out.write(line)
    for hpath, names in inv_haplotypes.items():
        out.write("\t".join(["P", "|".join(names), hpath, "*"]) + "\n")
