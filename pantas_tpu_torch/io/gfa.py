"""GFA 1.1 reader/writer with the annotated-spliced-pangenome tag vocabulary.

Tag vocabulary (reference spec: ``docs/README.md:1-41``):

* ``S`` lines: ``EX:Z:`` exon memberships (``Transcript.ExonNumber`` CSV),
  ``LN:i:`` length, ``NC:i:`` node read count, ``IL:Z:``/``OL:Z:`` in/out
  link-offset histograms (``Offset.Count`` CSV).
* ``L`` lines: ``JN:Z:`` junction memberships (``Transcript.From.To`` CSV),
  ``RC:i:`` link read count, ``ID:Z:N`` novel-link marker.

The container keeps records in file order: the event caller's adjacency
iteration order (and therefore some of its tie-breaking choices) follows
link file order, matching the reference parser (``scripts/call.py:145-181``).
"""

from __future__ import annotations
from pantas_tpu_torch.io.xopen import xopen

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple, Union


def parse_tags(fields: List[str]) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Parse trailing ``NAME:TYPE:VALUE`` tag fields into {name: value}.

    Values are kept as raw strings; typed accessors live on the records.
    """
    tags: Dict[str, str] = {}
    types: Dict[str, str] = {}
    for f in fields:
        name, typ, value = f.split(":", 2)
        tags[name] = value
        types[name] = typ
    return tags, types


@dataclass
class Segment:
    sid: str
    seq: str
    tags: Dict[str, str] = field(default_factory=dict)
    tag_types: Dict[str, str] = field(default_factory=dict)

    @property
    def length(self) -> int:
        return len(self.seq)

    def exons(self) -> List[str]:
        """EX tag as a list of ``Transcript.ExonNumber`` labels."""
        ex = self.tags.get("EX")
        return ex.split(",") if ex else []

    def node_count(self) -> int:
        return int(self.tags.get("NC", 0))

    def to_line(self) -> str:
        parts = ["S", self.sid, self.seq]
        parts += [
            f"{k}:{self.tag_types.get(k, _tag_type(k))}:{v}"
            for k, v in self.tags.items()
        ]
        return "\t".join(parts)


@dataclass
class Link:
    from_id: str
    from_orient: str
    to_id: str
    to_orient: str
    overlap: str
    tags: Dict[str, str] = field(default_factory=dict)
    tag_types: Dict[str, str] = field(default_factory=dict)

    def junctions(self) -> List[str]:
        jn = self.tags.get("JN")
        return jn.split(",") if jn else []

    def read_count(self) -> int:
        return int(self.tags.get("RC", 0))

    def is_novel(self) -> bool:
        return "ID" in self.tags

    def to_line(self) -> str:
        parts = [
            "L",
            self.from_id,
            self.from_orient,
            self.to_id,
            self.to_orient,
            self.overlap,
        ]
        parts += [
            f"{k}:{self.tag_types.get(k, _tag_type(k))}:{v}"
            for k, v in self.tags.items()
        ]
        return "\t".join(parts)


@dataclass
class Path:
    name: str
    steps: List[Tuple[str, str]]  # (segment id, orient '+'/'-')
    overlaps: str = "*"

    def to_line(self) -> str:
        steps = ",".join(f"{sid}{o}" for sid, o in self.steps)
        return "\t".join(["P", self.name, steps, self.overlaps])


@dataclass
class Walk:
    """GFA 1.1 W line (kept for pass-through compatibility)."""

    sample: str
    hap_index: str
    seq_id: str
    seq_start: str
    seq_end: str
    steps: List[Tuple[str, str]]  # (segment id, orient '>'/'<')

    def to_line(self) -> str:
        steps = "".join(f"{o}{sid}" for sid, o in self.steps)
        return "\t".join(
            ["W", self.sample, self.hap_index, self.seq_id, self.seq_start, self.seq_end, steps]
        )


_TAG_TYPES = {
    "LN": "i",
    "NC": "i",
    "RC": "i",
    "EX": "Z",
    "IL": "Z",
    "OL": "Z",
    "JN": "Z",
    "ID": "Z",
}


def _tag_type(name: str) -> str:
    return _TAG_TYPES.get(name, "Z")


Record = Union[Segment, Link, Path, Walk, str]


def iter_gfa(path: str) -> Iterator[Record]:
    """Stream a GFA file as typed records (header/comment lines as str)."""
    with xopen(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            rec = parse_gfa_line(line)
            if rec is not None:
                yield rec


def parse_gfa_line(line: str) -> Optional[Record]:
    kind = line[0]
    if kind == "S":
        _, sid, seq, *rest = line.split("\t")
        return Segment(sid, seq, *parse_tags(rest))
    if kind == "L":
        _, a, ao, b, bo, ov, *rest = line.split("\t")
        return Link(a, ao, b, bo, ov, *parse_tags(rest))
    if kind == "P":
        _, name, steps_s, *rest = line.split("\t")
        steps = [(s[:-1], s[-1]) for s in steps_s.split(",")]
        return Path(name, steps, rest[0] if rest else "*")
    if kind == "W":
        _, sample, hap, seqid, s, e, walk_s = line.split("\t")
        steps = []
        i = 0
        while i < len(walk_s):
            orient = walk_s[i]
            j = i + 1
            while j < len(walk_s) and walk_s[j] not in "><":
                j += 1
            steps.append((walk_s[i + 1 : j], orient))
            i = j
        return Walk(sample, hap, seqid, s, e, steps)
    # headers / comments / anything else: raw passthrough
    return line


@dataclass
class Gfa:
    """In-memory GFA with file-order record lists and id-keyed indexes."""

    segments: List[Segment] = field(default_factory=list)
    links: List[Link] = field(default_factory=list)
    paths: List[Path] = field(default_factory=list)
    walks: List[Walk] = field(default_factory=list)
    other: List[str] = field(default_factory=list)

    _seg_by_id: Dict[str, Segment] = field(default_factory=dict, repr=False)
    _link_by_pair: Dict[Tuple[str, str], Link] = field(default_factory=dict, repr=False)

    @classmethod
    def load(cls, path: str) -> "Gfa":
        g = cls()
        for rec in iter_gfa(path):
            g.add(rec)
        return g

    def add(self, rec: Record) -> None:
        if isinstance(rec, Segment):
            self.segments.append(rec)
            self._seg_by_id[rec.sid] = rec
        elif isinstance(rec, Link):
            self.links.append(rec)
            self._link_by_pair[(rec.from_id, rec.to_id)] = rec
        elif isinstance(rec, Path):
            self.paths.append(rec)
        elif isinstance(rec, Walk):
            self.walks.append(rec)
        else:
            self.other.append(rec)

    def segment(self, sid: str) -> Segment:
        return self._seg_by_id[sid]

    def link(self, from_id: str, to_id: str) -> Link:
        return self._link_by_pair[(from_id, to_id)]

    def has_link(self, from_id: str, to_id: str) -> bool:
        return (from_id, to_id) in self._link_by_pair

    def dump(self, out) -> None:
        """Write GFA in canonical section order: header, S, L, P, W."""
        for line in self.other:
            print(line, file=out)
        for s in self.segments:
            print(s.to_line(), file=out)
        for l in self.links:
            print(l.to_line(), file=out)
        for p in self.paths:
            print(p.to_line(), file=out)
        for w in self.walks:
            print(w.to_line(), file=out)
