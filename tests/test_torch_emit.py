"""The port's native emitter cuts the GFA into chunks sized from its threads.

``gafcov_emit_mt`` formats a GFA of 8 MiB or more in parallel: about four
line-aligned chunks a thread, each of 1 MiB at the least but the last (under
the test hook ``PANTAS_EMIT_FORCE_MT``, of one line at the least), and it
starts only the threads that have a chunk. The bytes it writes are the JAX
package's host augmenter's, at every thread count.
"""

import io

import numpy as np
import pytest
from fixtures_micro import write_micro

from pantas_tpu.coverage import augment_gfa
from pantas_tpu_torch.graph.compiler import compile_gfa
from pantas_tpu_torch.native import NativeCoverage, native_available

EMIT_FLOOR = 8 << 20  # below it the emission is serial unless the hook is set
CHUNK_FLOOR = 1 << 20  # the least a chunk holds, but the last, with no hook
CHAIN_SEGMENTS = 58_000  # ~10 MiB of GFA: over the serial floor, ~10 chunks
DUP_LINK = "L\t1\t+\t2\t+\t*\n"  # the micro graph's first link, again


@pytest.fixture(scope="module")
def have_native():
    if not native_available():
        pytest.skip("g++ / the port's native build unavailable")


def _write_chain(tmp_path):
    """A chain of canonical-id segments with ``EX`` and ``JN`` tags, and a
    GAF of forward and reverse 3-segment walks naming a share of them,
    some across a link the graph lacks."""
    rng = np.random.default_rng(25)
    seq_len = 24
    seqs = rng.choice(np.frombuffer(b"ACGT", np.uint8), (CHAIN_SEGMENTS, seq_len))
    lines = ["H\tVN:Z:1.1"]
    for i in range(1, CHAIN_SEGMENTS + 1):
        g, e = divmod(i - 1, 8)
        ex = ",".join(f"ENSDMT{g:07d}_R{r}.{e + 1}" for r in range(1, 7))
        lines.append(f"S\t{i}\t{seqs[i - 1].tobytes().decode()}\tEX:Z:{ex}")
    for i in range(1, CHAIN_SEGMENTS):
        g, e = divmod(i - 1, 8)
        jn = f"\tJN:Z:ENSDMT{g:07d}_R1.{e + 1}.{e + 2}" if i % 3 == 0 else ""
        lines.append(f"L\t{i}\t+\t{i + 1}\t+\t*{jn}")
    gfa = tmp_path / "chain.gfa"
    gfa.write_text("\n".join(lines) + "\n")
    span = 3 * seq_len - 4
    recs = []
    for k, a in enumerate(range(1, CHAIN_SEGMENTS - 6, 37)):
        if k % 5 == 4:
            walk = f">{a}>{a + 1}>{a + 5}"  # a novel link a+1 -> a+5
        elif k % 2:
            walk = f"<{a + 2}<{a + 1}<{a}"
        else:
            walk = f">{a}>{a + 1}>{a + 2}"
        recs.append(f"c{k}\t{span}\t0\t{span}\t+\t{walk}\t{3 * seq_len}\t2\t{span + 2}"
                    f"\t{span}\t{span}\t60\tcs:Z::{span}\tdv:f:0.0")
    gaf = tmp_path / "chain.gaf"
    gaf.write_text("\n".join(recs) + "\n")
    return str(gfa), str(gaf)


def _port_emit(gfa, gaf, out_path):
    """The port's native engine over ``gaf``, its emission into a file;
    returns (bytes, the emission's sizes)."""
    eng = NativeCoverage(compile_gfa(gfa))
    eng.process_file(gaf, 20, threads=1)
    with open(out_path, "wb") as out:
        eng.emit(gfa, out.fileno())
    _, sizes = eng.emit_stats()
    return out_path.read_bytes(), sizes


def _reference_bytes(gfa, gaf) -> bytes:
    """The JAX package's host augmenter over the same inputs."""
    buf = io.StringIO()
    augment_gfa(gaf, gfa, out=buf, log=io.StringIO())
    return buf.getvalue().encode()


@pytest.fixture(scope="module")
def chain(have_native, tmp_path_factory):
    gfa, gaf = _write_chain(tmp_path_factory.mktemp("chain"))
    return gfa, gaf, _reference_bytes(gfa, gaf)


@pytest.mark.parametrize("threads", [1, 2, 3, 8])
def test_port_emit_cut_sized_from_threads(chain, tmp_path, monkeypatch, threads):
    """A ~10 MiB GFA crosses the serial floor with no hook: the emitter cuts
    it into about four chunks a thread, of 1 MiB at the least but the last,
    starts only the threads that have a chunk, and writes the JAX host
    augmenter's bytes, those of one thread too."""
    gfa, gaf, reference = chain
    size = len(open(gfa, "rb").read())
    assert size > EMIT_FLOOR
    monkeypatch.delenv("PANTAS_EMIT_FORCE_MT", raising=False)
    monkeypatch.setenv("PANTAS_EMIT_THREADS", "1")
    one, _ = _port_emit(gfa, gaf, tmp_path / "one.gfa")
    monkeypatch.setenv("PANTAS_EMIT_THREADS", str(threads))
    out, sizes = _port_emit(gfa, gaf, tmp_path / "out.gfa")
    assert b"\tID:Z:N\n" in out and b"\tIL:Z:" in out and b"\tOL:Z:" in out
    assert out == reference
    assert out == one
    assert sizes["emit.bytes_out"] == len(out)
    chunks = sizes["emit.chunks"]
    if threads == 1:
        assert (chunks, sizes["emit.threads"]) == (1, 1)
    else:
        most = min(4 * threads, size // CHUNK_FLOOR)
        assert 2 <= most - 1 <= chunks <= most + 1
        assert sizes["emit.threads"] == min(threads, chunks)


@pytest.mark.parametrize("case", ["duplicate-link-later-chunk", "crlf-last-line-unended"])
def test_port_emit_chunk_boundaries(have_native, tmp_path, monkeypatch, case):
    """Under the hook, with more threads than the file has bytes, every line
    is a chunk of its own. A duplicate ``L`` line, a chunk after its first
    occurrence, sends the emission to one ordered pass, where the first
    occurrence prints the weight; CRLF line ends and an unended last line
    keep the JAX host augmenter's bytes."""
    gfa, gaf = write_micro(tmp_path)
    text = open(gfa).read()
    if case == "duplicate-link-later-chunk":
        text += DUP_LINK
    else:
        text = text.rstrip("\n").replace("\n", "\r\n")
    with open(gfa, "w", newline="") as fh:
        fh.write(text)
    data = open(gfa, "rb").read()
    lines = data.splitlines(keepends=True)
    reference = _reference_bytes(gfa, gaf)
    monkeypatch.setenv("PANTAS_EMIT_FORCE_MT", "1")
    monkeypatch.setenv("PANTAS_EMIT_THREADS", str(len(data)))
    out, sizes = _port_emit(gfa, gaf, tmp_path / "out.gfa")
    assert out == reference
    assert sizes["emit.chunks"] == sizes["emit.threads"] == len(lines)
    if case == "duplicate-link-later-chunk":
        assert lines.count(DUP_LINK.encode()) == 2
        head = DUP_LINK.rstrip("\n") + "\tRC:i:"
        first, dup = [x for x in out.decode().split("\n") if x.startswith(head)]
        assert first != head + "0" and dup == head + "0"
    else:
        assert lines[-2].endswith(b"\r\n") and not lines[-1].endswith(b"\n")
        assert lines[-1].rstrip() + b"\n" in out
