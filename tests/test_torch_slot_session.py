"""The port's native slot session in parallel waves, against the one-thread walk.

The port's session (``pantas_tpu_torch/native/gafcov.cpp``) parses a GAF in
waves of line-aligned pieces, one thread a piece, and merges the pieces in
file order. Whatever its thread count, it must deliver the batches, the
first-seen sidecars and the counters of the JAX package's session, which
walks the file on one thread, and the device augment must write the JAX
package's augmented GFA, checkpointed and resumed too.

A piece is never under ``MIN_PIECE`` bytes, so the inputs here are a few
MiB: enough for eight pieces a wave.
"""

import io
import os
import random

import numpy as np
import pytest
from fixtures_micro import MICRO_GAF_LINES, write_micro
from test_augment_fuzz import make_gaf, make_graph

from pantas_tpu.coverage import augment_gfa
from pantas_tpu.coverage import device as jax_device
from pantas_tpu.graph.compiler import compile_gfa as jax_compile_gfa
from pantas_tpu.native.gafcov import NativeCoverage as JaxNativeCoverage
from pantas_tpu_torch import trace
from pantas_tpu_torch.coverage import device as port
from pantas_tpu_torch.graph.compiler import compile_gfa
from pantas_tpu_torch.native import gafcov
from pantas_tpu_torch.parallel.distributed import shard_byte_ranges

THREADS = (1, 2, 3, 8)
MIN_PIECE = 512 << 10  # gafcov.cpp's MIN_PIECE: the least bytes of a piece
SIZE = 9 * MIN_PIECE  # a case's range: eight pieces a wave, and more than one wave
_JAX: dict = {}  # case -> the JAX package's session and augmented GFA of its range


def _copies(text: str, size: int = SIZE) -> str:
    """``text`` repeated to at least ``size`` bytes."""
    return text * -(-size // len(text))


def _big(tmp_path, flush=64, size=SIZE):
    gfa, gaf = write_micro(tmp_path)
    big = tmp_path / "big.gaf"
    big.write_text(_copies(open(gaf).read(), size))
    return gfa, big, flush, None


def _micro(tmp_path):
    return _big(tmp_path, flush=4)


def _batch_sized_waves(tmp_path):
    # a batch spans more bytes than two or three pieces: those waves are
    # sized to a batch, and each yields about one
    return _big(tmp_path, flush=1 << 17)


def _fuzz(tmp_path):
    rng = random.Random(5)
    gfa_text, lens = make_graph(rng)
    gfa, gaf = tmp_path / "g.gfa", tmp_path / "g.gaf"
    gfa.write_text(gfa_text)
    gaf.write_text(_copies(make_gaf(rng, lens, 400)))
    return gfa, gaf, 32, None


def _crlf_blank(tmp_path):
    gfa, _ = write_micro(tmp_path)
    gaf = tmp_path / "crlf.gaf"
    rows = []
    for i, line in enumerate(MICRO_GAF_LINES * 12):
        rows.append(line + ("\r\n" if i % 2 else "\n"))
        if i % 5 == 0:
            rows.append("\n" if i % 3 else "  \r\n")
    gaf.write_bytes(_copies("".join(rows)).encode())
    return gfa, gaf, 16, None


def _dist_range(tmp_path):
    # the middle of three ranks' byte ranges, as augment-dist opens it
    gfa, big, flush, _ = _big(tmp_path, size=3 * SIZE)
    return gfa, big, flush, shard_byte_ranges(str(big), 3)[1]


CASES = {
    "micro-flush4": _micro,
    "big-flush64": _big,
    "batch-sized-waves": _batch_sized_waves,
    "fuzz": _fuzz,
    "crlf-blank": _crlf_blank,
    "dist-range": _dist_range,
}


def _session(eng, gaf, lo, hi, flush, **kw):
    """Every batch of one session, then the engine's sidecars, counters and
    the session's totals."""
    sess = eng.slots_begin(str(gaf), lo, hi, 20, **kw)
    batches = []
    try:
        while True:
            buf = np.empty(flush, dtype=np.int32)
            n = eng.slots_next(sess, buf)
            if n == 0:
                break
            batches.append(buf[:n].copy())
        pos = eng.slots_pos(sess)
        stats = eng.slots_stats(sess) if hasattr(eng, "slots_stats") else {}
    finally:
        eng.slots_end(sess)
    lib, h = eng.lib, eng.handle
    counters = [int(f(h)) for f in (lib.gafcov_rejected, lib.gafcov_skipped,
                                     lib.gafcov_accepted)]
    return batches, eng.seen_sidecar(), eng.novel_sidecar(), counters, pos, stats


def _emitted(eng, batches, gfa, path) -> str:
    """The augmented GFA that the engine writes with the batches' counts."""
    flat = np.zeros(eng.t.total_slots, np.int32)
    for b in batches:
        np.add.at(flat, b, 1)
    eng.set_counts(flat)
    with open(path, "w") as out:
        eng.emit(str(gfa), out.fileno())
    return path.read_text()


def _jax(case, gfa, gaf, lo, hi, flush, tmp_path):
    """The JAX package's one-thread session over the case's range, and its
    device augment's GFA of the same bytes."""
    if case not in _JAX:
        session = _session(JaxNativeCoverage(jax_compile_gfa(str(gfa))), gaf, lo, hi, flush)
        part = tmp_path / "part.gaf"
        with open(gaf, "rb") as fh:
            fh.seek(lo)
            part.write_bytes(fh.read((hi - lo) if hi >= 0 else -1))
        out = io.StringIO()
        jax_device.augment_gfa_device_native(str(part), str(gfa), out=out, log=io.StringIO())
        _JAX[case] = session, out.getvalue()
    return _JAX[case]


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_waves_deliver_the_serial_batches(tmp_path, case, threads):
    gfa, gaf, flush, rng = CASES[case](tmp_path)
    lo, hi = rng or (0, -1)
    eng = gafcov.NativeCoverage(compile_gfa(str(gfa)))
    got = _session(eng, gaf, lo, hi, flush, threads=threads)
    want, want_gfa = _jax(case, gfa, gaf, lo, hi, flush, tmp_path)
    batches, seen, novel, counters, pos, stats = got
    assert len(batches) == len(want[0]) > 1
    for a, b in zip(batches, want[0]):
        assert np.array_equal(a, b)
    for mine, theirs in zip(seen + novel, want[1] + want[2]):
        assert np.array_equal(mine, theirs)
    assert counters == want[3] and pos == want[4]
    size = (hi if hi >= 0 else os.path.getsize(gaf)) - lo
    assert size >= SIZE
    assert stats["slots.threads"] == threads
    assert stats["slots.waves"] > 1
    floor = threads * MIN_PIECE if threads > 1 else 0  # the least span of a wave
    if flush >= 16 and flush * size // stats["slots.delivered"] > floor:
        # waves sized to a batch, which spans more than a record: none
        # yields two
        assert stats["slots.waves"] >= len(batches)
    assert stats["slots.delivered"] == sum(map(len, batches))
    assert stats["slots.bytes"] == size
    assert 0 < stats["slots.merge_ns"] <= stats["slots.parse_ns"]
    # the augmented GFA of the range is the JAX package's device augment's
    # on the same bytes
    assert _emitted(eng, batches, gfa, tmp_path / "out.gfa") == want_gfa


def test_more_threads_than_cores(tmp_path):
    """Twice as many pieces a wave as the process has CPUs: the threads
    share only the master's seen flags, read while none writes them, so the
    batches stay the serial walk's."""
    threads = 2 * len(os.sched_getaffinity(0))
    gfa, big, _, _ = _big(tmp_path, size=(threads + 1) * MIN_PIECE)
    eng = gafcov.NativeCoverage(compile_gfa(str(gfa)))
    got = _session(eng, big, 0, -1, 2048, threads=threads)
    want = _session(JaxNativeCoverage(jax_compile_gfa(str(gfa))), big, 0, -1, 2048)
    assert got[5]["slots.threads"] == threads and got[5]["slots.waves"] > 1
    assert len(got[0]) == len(want[0])
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
    for mine, theirs in zip(got[1] + got[2], want[1] + want[2]):
        assert np.array_equal(mine, theirs)


def test_threads_are_capped_by_the_range(tmp_path):
    """No piece of a wave is under ``MIN_PIECE`` bytes: a wave takes as many
    pieces as the rest of the range holds, up to the threads asked for."""
    gfa, gaf, flush, _ = _big(tmp_path, size=3 * MIN_PIECE + 1000)
    size = os.path.getsize(gaf)
    eng = gafcov.NativeCoverage(compile_gfa(str(gfa)))
    for (lo, hi, threads), want in (((0, -1, 8), 3),
                                    ((0, -1, 2), 2),
                                    ((0, -1, 1), 1),
                                    ((0, 2 * MIN_PIECE - 1, 8), 1),
                                    ((size - MIN_PIECE, -1, 8), 1),
                                    ((100, 100, 8), 1)):
        stats = _session(eng, gaf, lo, hi, flush, threads=threads)[5]
        assert stats["slots.threads"] == want, (lo, hi, threads)
    assert _session(eng, gaf, 100, 100, flush, threads=8)[5]["slots.waves"] == 0
    assert gafcov.host_threads() == len(os.sched_getaffinity(0))
    assert gafcov.host_threads(2) == max(1, len(os.sched_getaffinity(0)) // 2)
    assert gafcov.host_threads(10**6) == 1


@pytest.mark.parametrize("threads", [2, 8])
def test_native_checkpoint_resume_in_waves_byte_identical(tmp_path, threads):
    """Checkpoint, interrupt and resume with several threads a wave: the
    resumed GFA is the one-shot run's and the JAX package's host engine's."""
    # the checkpoint lands after the first wave, and the rest still holds
    # eight pieces
    gfa, big, _, _ = _big(tmp_path, size=3 * SIZE)
    flush = 1 << 14
    host = io.StringIO()
    augment_gfa(str(big), str(gfa), out=host, log=io.StringIO())
    one_shot = io.StringIO()
    port.augment_gfa_device_native(str(big), str(gfa), out=one_shot, device="cpu",
                                   flush_every=flush, threads=threads, log=io.StringIO())
    assert one_shot.getvalue() == host.getvalue()
    ck = str(tmp_path / "ck.pkl")
    r = port.augment_gfa_device_native(
        str(big), str(gfa), out=io.StringIO(), device="cpu", flush_every=flush,
        threads=threads, checkpoint_path=ck, checkpoint_every=2, _stop_after=2,
        log=io.StringIO(),
    )
    assert r is None and os.path.exists(ck)
    resumed, log = io.StringIO(), io.StringIO()
    trace.enable()
    try:
        port.augment_gfa_device_native(str(big), str(gfa), out=resumed, device="cpu",
                                       flush_every=flush, threads=threads, checkpoint_path=ck,
                                       resume=True, log=log)
        counters = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert "Resuming from checkpoint" in log.getvalue()
    assert resumed.getvalue() == one_shot.getvalue()
    assert counters["slots.threads"] == threads and counters["slots.waves"] > 1
