"""The frozen input generators and the plain reference against the port's
CPU paths on a tiny graph: the frozen build writes the port's graph byte for
byte, and the NumPy augment writes the port's augmented GFA byte for byte on
forward and reverse mates, substitutions, and records the filters reject."""

from __future__ import annotations

import io
import json
from pathlib import Path

import numpy as np
import pytest

from pbench.reference import augment as ref_augment
from pbench.reference import inputs
from pbench.run import load

REPO = Path(__file__).resolve().parents[2]
GEN = load(REPO / "pbench" / "traffic" / "transcript_pairs.py")
CONFIG = json.loads((REPO / "pbench" / "configs" / "dm-real-10mbp.json").read_text())
MIX = json.loads((REPO / "pbench" / "traffic" / "augment-skew.json").read_text())
# the mix with substitutions dense enough that whole nodes are substituted
DENSE = dict(MIX, substitution_rate=0.12, high_divergence={"share": 0.2, "substitutions": [16, 40]})


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    cache = tmp_path_factory.mktemp("cache")
    spec = dict(CONFIG["graph"], mbp=0.05)
    return inputs.GraphTables(inputs.ensure_graph("tiny", spec, cache))


def _config(pairs):
    return dict(CONFIG, reads=dict(CONFIG["reads"], pairs=pairs))


def test_frozen_build_writes_the_ports_graph(graph, tmp_path):
    from pantas_tpu_torch.build.pipeline import build_pangenome
    from pantas_tpu_torch.eval.synth import gen_inputs

    g = CONFIG["graph"]
    gen_inputs(tmp_path, mbp=0.05, n_var=int(0.05 * g["snps_per_mbp"]),
               n_genes=int(0.05 * g["genes_per_mbp"]), n_samples=g["samples"],
               n_chroms=1, n_exons=g["exons"], n_tx=g["isoforms"])
    assert (tmp_path / "g.gtf").read_bytes() == (graph.dir / "g.gtf").read_bytes()
    build_pangenome(str(tmp_path / "g.fa"), str(tmp_path / "g.gtf"), str(tmp_path / "g.vcf"),
                    str(tmp_path / "out"), hp=g["hp"], prune=g["prune"], threads=1,
                    log=io.StringIO())
    port = (tmp_path / "out" / inputs.GFA_NAME).read_bytes()
    assert port == graph.gfa.read_bytes()
    # the reads walk the haplotypes' copies, which the hp=1 graph does not print
    assert b"_H1\t" not in port and len(graph.path_tx) > len(graph.tx_names)


@pytest.mark.parametrize("mix", [MIX, DENSE], ids=["augment-skew", "dense-substitutions"])
def test_reference_augment_is_the_ports(graph, tmp_path, mix):
    from pantas_tpu_torch.coverage.host import augment_gfa
    from pantas_tpu_torch.native import augment_gfa_native

    reads = GEN.generate(graph, _config(3000), mix, seed=2**31 + 7)
    gaf = tmp_path / "r.gaf"
    GEN.write_gaf(graph, reads, gaf)
    want = io.StringIO()
    ref_augment.emit(graph, ref_augment.counts(graph, reads), want.write)
    with open(tmp_path / "native.gfa", "w") as fh:
        augment_gfa_native(str(gaf), str(graph.gfa), out=fh, log=io.StringIO())
    host = io.StringIO()
    augment_gfa(str(gaf), str(graph.gfa), out=host, log=io.StringIO())
    assert (tmp_path / "native.gfa").read_text() == want.getvalue()
    assert host.getvalue() == want.getvalue()


def test_the_mix_reaches_every_branch(graph):
    """Reverse mates, substitutions, both filters, and (in the dense mix)
    nodes whose every base is substituted, which count on NC and not on IL/OL."""
    reads = GEN.generate(graph, _config(3000), MIX, seed=3)
    k = np.diff(reads.sub_off)
    assert reads.reverse.sum() == len(reads) // 2
    assert 0.005 < k.sum() / (len(reads) * reads.read_len) < 0.02
    assert (reads.mapq < ref_augment.MAPQ_THRESHOLD).any()
    assert (reads.dv > ref_augment.MAX_DIVERGENCE).any()
    assert (reads.dv[k == 15] == 0.1).all()

    # the same walks and MAPQs (drawn before the substitutions), with none
    dense = GEN.generate(graph, _config(3000), DENSE, seed=3)
    exact = GEN.generate(graph, _config(3000), dict(DENSE, substitution_rate=0.0,
                                                    high_divergence={"share": 0.0,
                                                                     "substitutions": [0, 0]}), 3)
    assert (exact.first == dense.first).all() and (exact.mapq == dense.mapq).all()
    keep = dense.dv <= ref_augment.MAX_DIVERGENCE
    b = ref_augment.counts(graph, _subset(exact, keep))
    a = ref_augment.counts(graph, _subset(dense, keep))
    assert (a.nc == b.nc).all() and (a.link_rc == b.link_rc).all()
    assert (a.il <= b.il).all() and a.il.sum() < b.il.sum() and a.ol.sum() < b.ol.sum()


def _subset(reads, keep):
    k = np.diff(reads.sub_off)[keep]
    off = np.zeros(len(k) + 1, np.int64)
    off[1:] = np.cumsum(k)
    rec = np.repeat(np.arange(len(reads)), np.diff(reads.sub_off))
    return GEN.Reads(first=reads.first[keep], last=reads.last[keep], offset=reads.offset[keep],
                     reverse=reads.reverse[keep], mapq=reads.mapq[keep], sub_off=off,
                     sub_pos=reads.sub_pos[keep[rec]], read_len=reads.read_len)


def test_generator_is_fixed_by_its_seed(graph):
    cfg = _config(2000)

    def text(seed):
        return "".join(GEN.gaf_lines(graph, GEN.generate(graph, cfg, MIX, seed)))

    a, b, c = text(2**33 + 1), text(2**33 + 1), text(5)
    assert a == b and a != c
    lines = a.splitlines()
    assert len(lines) == 4000 == len(c.splitlines())
    for mate1, mate2 in zip(lines[::2], lines[1::2]):
        f1, f2 = mate1.split("\t"), mate2.split("\t")
        assert f1[0] == f2[0] and {f1[5][0], f2[5][0]} == {">", "<"}
        for f in (f1, f2):
            plen, ps, pe = int(f[6]), int(f[7]), int(f[8])
            assert pe - ps == 150 and 0 <= ps and pe <= plen and f[-1].startswith("cs:Z:")


def test_abundances_are_one_multiset(graph):
    """Seeds permute the same abundance values over the transcripts."""
    cfg = _config(200000)
    counts = []
    for seed in (1, 2):
        reads = GEN.generate(graph, cfg, MIX, seed)
        tx = graph.path_tx[np.searchsorted(graph.path_off, reads.first, side="right") - 1]
        counts.append(np.sort(np.bincount(tx, minlength=len(graph.tx_names))))
    top = np.asarray(counts, float)[:, -10:]
    assert np.allclose(top[0], top[1], rtol=0.1)
