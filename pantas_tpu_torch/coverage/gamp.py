"""Legacy GAMP (vg multipath JSON) augmenter — edge weights only.

Byte-identical reimplementation of the reference's legacy tool
``scripts/alignments_augmentation.py`` (165 LoC; not wired to the
reference CLI or any workflow, kept for component parity). Input is
vg-JSON multipath alignments (one JSON object per line, ``subpath`` DAG);
output is (a) a path file listing every source→sink walk per read and
(b) the GFA re-emitted with ``RC:i:`` edge weights on stdout.

Preserved quirks (all cited into the reference file):

* every L line gets ``\\tRC:i:w`` appended even if it already carries tags
  (``alignments_augmentation.py:149-152``);
* non-L lines are re-emitted **stripped** (``:138-140``);
* leftover (novel) edge direction logic is broken verbatim:
  ``revs.get(k[0], k[1])`` looks up a *node string* in a tuple-keyed dict,
  so the default — a non-empty node id, hence truthy — is always returned
  and the first branch always wins, printing the edge **swapped** with no
  ``ID:Z:N`` tag (``:156-160``; the intended-novel second branch with its
  malformed ``RC:i:v,ID:Z:N`` is unreachable);
* leftover order is ``weights`` dict insertion order (``:120-123``);
* reads without a ``subpath`` key are skipped (``:58-59``); a read whose
  subpath DAG has several sources/sinks contributes every full path
  (``:8-40`` recursive enumeration).
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Tuple


def _sources(graph: List[List[int]]) -> List[int]:
    # in-degree count in first-seen order (alignments_augmentation.py:8-19)
    in_nodes: Dict[int, int] = {}
    for n1, adj in enumerate(graph):
        if n1 not in in_nodes:
            in_nodes[n1] = 0
        for n2 in adj:
            in_nodes[n2] = in_nodes.get(n2, 0) + 1
    return [n for n, c in in_nodes.items() if c == 0]


def _full_paths(graph: List[List[int]]) -> List[List[int]]:
    paths: List[List[int]] = []

    def rec(node: int, cur: List[int]) -> None:
        cur.append(node)
        if not graph[node]:
            paths.append(cur[:])
        else:
            for child in graph[node]:
                rec(child, cur)
        cur.pop()

    for s in _sources(graph):
        rec(s, [])
    return paths


def augment_gamp(json_file: str, path_file: str, gfa_file: str, out=None, log=None) -> None:
    out = sys.stdout if out is None else out
    log = sys.stderr if log is None else log
    weights: Dict[Tuple[str, str], int] = {}
    revs: Dict[Tuple[str, str], bool] = {}
    print("Building paths and weights", file=log)
    with open(json_file) as f, open(path_file, "w") as pf:
        for line in f:
            data = json.loads(line)
            read_name = data["name"]
            if "subpath" not in data:
                continue
            subpaths = data["subpath"]
            next_list: List[List[int]] = [[] for _ in subpaths]
            paths_list: List[List[str]] = [[] for _ in subpaths]
            for i, sp in enumerate(subpaths):
                if "next" in sp:
                    next_list[i] = sp["next"]
                nodes = []
                for elem in sp["path"]["mapping"]:
                    pos = elem["position"]
                    d = "-" if pos.get("is_reverse") else "+"
                    nodes.append(f"{pos['node_id']}{d}")
                paths_list[i] = nodes

            paths = [
                [n for idx in full for n in paths_list[idx]]
                for full in _full_paths(next_list)
            ]
            paths_final: List[Tuple[List[str], str]] = []
            for p in paths:
                ids = [x[:-1] for x in p]
                if p[0][-1] == "+":
                    paths_final.append((ids, "+"))
                else:
                    ids.reverse()
                    paths_final.append((ids, "-"))

            for ids, orient in paths_final:
                for s, t in zip(ids, ids[1:]):
                    if orient == "+":
                        key = (s, t)
                        revs[(s, t)] = False
                    else:
                        key = (t, s)
                        revs[(s, t)] = True
                    weights[key] = weights.get(key, 0) + 1

            pf.write(f">{read_name}\n")
            for ids, orient in paths_final:
                d = ">" if orient == "+" else "<"
                pf.write(d.join(ids) + "\n")

    print("Annotating GFA", file=log)
    with open(gfa_file) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("L"):
                print(line, file=out)
            else:
                if len(line) == 1:
                    continue
                tokens = line.split()
                w = weights.pop((tokens[1], tokens[3]), 0)
                print(f"{line}\tRC:i:{w}", file=out)

    for k, v in weights.items():
        # QUIRK: revs.get(k[0], k[1]) — node-string lookup in a tuple-keyed
        # dict: the (truthy) default always wins, the first branch always
        # fires, and the edge prints swapped (alignments_augmentation.py:156-160)
        if revs.get(k[0], k[1]) or not revs.get(k[1], k[0]):
            print(f"L\t{k[1]}\t+\t{k[0]}\t+\t*\tRC:i:{v}", file=out)
        else:
            print(f"L\t{k[0]}\t+\t{k[1]}\t+\t*\tRC:i:{v},ID:Z:N", file=out)
