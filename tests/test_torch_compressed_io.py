"""Compressed stage files through the port's CLI, held against the JAX
package's plain outputs: every ``-o *.zst`` / ``-o *.gz`` of ``augment`` (five
engines), ``map``, ``call``, ``quant``, ``remap`` and ``augment-dist``
decompresses to the bytes the JAX package writes to a plain ``-o`` (``call``:
its sorted rows), and ``augment --engine device-py`` reads a ``.zst`` GAF, in
one go and resumed from a checkpoint. Equality is exact everywhere.

``.gz`` is run both through the ``gzip`` binary and with ``shutil.which``
patched to find none, so that the in-process compressor is used; ``.zst``
goes through the port's one route, the system's libzstd
(``io/zstd_ctypes.py``). The native emitters must keep their
file-descriptor path for compressed outputs, and a failing compressor or
stage body must not end in exit 0. Every compressed file is checked by the
``zstandard`` module or ``gzip``, not by the code under test; on a machine
without the module (the ``cuda`` cases on the card) libzstd's one-shot
``ZSTD_decompress`` decodes ``.zst``, not the port's streaming reader.
"""

import ctypes
import ctypes.util
import errno
import gzip
import io
import os
import shutil
import stat
import subprocess
import sys
import threading

import pytest
import torch
from conftest import REPO_ROOT, run_cli
from fixtures_call import write_call_fixtures
from fixtures_micro import write_micro
from fixtures_quant import write_quant_fixtures

from pantas_tpu import cli as tpu_cli
from pantas_tpu_torch import cli
from pantas_tpu_torch.coverage import device as port_device
from pantas_tpu_torch.io import xopen as xopen_mod
from pantas_tpu_torch.io.zstd_ctypes import open_zst

try:
    import zstandard
except ImportError:  # a machine without the module: libzstd's one-shot API decodes
    zstandard = None

MBP = 0.05
READS = 2000
ENGINES = ["native", "auto", "host", "device", "device-py"]
# (suffix, whether the gzip binary is hidden)
SINKS = [("zst", False), ("gz", True), ("gz", False)]
SINK_IDS = ["zst", "gz-in-process", "gz-binary"]
MAGIC = {"zst": b"\x28\xb5\x2f\xfd", "gz": b"\x1f\x8b"}


def _decompressed(path) -> bytes:
    data = open(path, "rb").read()
    suffix = str(path).rsplit(".", 1)[1]
    assert data[:len(MAGIC[suffix])] == MAGIC[suffix], f"{path} is not a {suffix} stream"
    if suffix == "gz":
        return gzip.decompress(data)
    if zstandard is None:
        return _libzstd_one_shot(data)
    with zstandard.ZstdDecompressor().stream_reader(io.BytesIO(data)) as fh:
        return fh.read()


def _libzstd_one_shot(data: bytes, capacity: int = 1 << 20) -> bytes:
    """``data`` decoded by libzstd's one-shot ``ZSTD_decompress`` (every
    frame, into one buffer of ``capacity`` bytes, doubled while it is too
    small): none of the port's streaming reader."""
    lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                                    ctypes.c_size_t]
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    while True:
        dst = ctypes.create_string_buffer(max(capacity, 1))
        n = lib.ZSTD_decompress(dst, capacity, data, len(data))
        if not lib.ZSTD_isError(n):
            return dst.raw[:n]
        error = lib.ZSTD_getErrorName(n).decode()
        assert "too small" in error, f"ZSTD_decompress: {error}"
        capacity = 2 * max(capacity, 1)


def _hide_gzip(hidden, monkeypatch):
    """Hide the ``gzip`` binary from ``shutil.which`` when ``hidden``."""
    if hidden:
        real = shutil.which
        monkeypatch.setattr(shutil, "which",
                            lambda name, *a, **k: None if name == "gzip" else real(name, *a, **k))


@pytest.fixture
def sink(request, monkeypatch):
    """The output suffix, with what the case hides hidden."""
    suffix, hidden = request.param
    _hide_gzip(hidden, monkeypatch)
    return suffix


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    """The port's ``ensure_graph(0.05)`` in a cache of its own, and 2,000
    synthetic reads on it: the augmented GFA is large enough (> 100 kB) to
    fill the pipe many times over."""
    from pantas_tpu_torch.eval import synth

    cache = tmp_path_factory.mktemp("graph_cache")
    saved, synth.CACHE = synth.CACHE, cache
    try:
        wd = synth.ensure_graph(MBP)
    finally:
        synth.CACHE = saved
    gfa = wd / "out" / "pantranscriptome-annotated.gfa"
    gaf = wd / "reads.gaf"
    synth.synth_gaf(gfa, READS, gaf)
    return wd, str(gfa), str(gaf)


_JAX_AUGMENT = {}


def _jax_plain_augment(engine, gaf, gfa, tmp_path) -> bytes:
    """The JAX package's plain ``-o`` output of ``engine`` (JAX on the CPU)."""
    key = (engine, gaf, gfa)
    if key not in _JAX_AUGMENT:
        out = tmp_path / f"jax_{engine}.gfa"
        assert tpu_cli.main(["augment", "--engine", engine, gaf, gfa, "-o", str(out)]) == 0
        _JAX_AUGMENT[key] = out.read_bytes()
    return _JAX_AUGMENT[key]


def _port_augment(engine, gaf, gfa, out, *extra) -> int:
    flags = ["--device", "cpu"] if engine.startswith("device") else []
    return cli.main(["augment", "--engine", engine, *flags, *extra, gaf, gfa, "-o", str(out)])


@pytest.mark.parametrize("sink", SINKS, ids=SINK_IDS, indirect=True)
@pytest.mark.parametrize("engine", ENGINES)
def test_augment_compressed_output(graph, tmp_path, engine, sink):
    """F5: each engine's compressed output decompresses to the JAX package's
    plain bytes, on the 0.05 Mbp graph and on the micro fixture."""
    _, gfa, gaf = graph
    micro_gfa, micro_gaf = write_micro(tmp_path)
    for gfa_in, gaf_in in ((gfa, gaf), (micro_gfa, micro_gaf)):
        out = tmp_path / f"o.gfa.{sink}"
        assert _port_augment(engine, gaf_in, gfa_in, out) == 0
        expected = _jax_plain_augment(engine, gaf_in, gfa_in, tmp_path)
        assert _decompressed(out) == expected
        assert b"RC:i:" in expected and out.stat().st_size < len(expected)


@pytest.mark.parametrize("sink", SINKS[:2], ids=SINK_IDS[:2], indirect=True)
@pytest.mark.parametrize("engine", ["native", "device"])
def test_native_emitter_keeps_its_fd_path(graph, tmp_path, monkeypatch, engine, sink):
    """The native engines emit a compressed GFA through ``NativeCoverage.emit``
    on a pipe, never through the Python ``emit_augmented_gfa``."""
    from pantas_tpu_torch.native import gafcov

    _, gfa, gaf = graph
    fds = []
    real_emit = gafcov.NativeCoverage.emit

    def emit(self, gfa_in, out_fd):
        fds.append(stat.S_ISFIFO(os.fstat(out_fd).st_mode))
        return real_emit(self, gfa_in, out_fd)

    def python_emission(*a, **k):
        raise AssertionError("the Python emitter ran")

    monkeypatch.setattr(gafcov.NativeCoverage, "emit", emit)
    monkeypatch.setattr(gafcov, "emit_augmented_gfa", python_emission)
    monkeypatch.setattr(port_device, "emit_augmented_gfa", python_emission)
    out = tmp_path / f"o.gfa.{sink}"
    assert _port_augment(engine, gaf, gfa, out) == 0
    assert fds == [True]
    assert _decompressed(out) == _jax_plain_augment("native", gaf, gfa, tmp_path)


@pytest.fixture(scope="module")
def reads(graph, tmp_path_factory):
    """Paired reads simulated by the port on the 0.05 Mbp graph's annotation."""
    from pantas_tpu_torch.eval.simulate import simulate

    wd = graph[0]
    prefix = tmp_path_factory.mktemp("reads") / "sim"
    simulate(str(wd / "g.fa"), str(wd / "g.gtf"), str(prefix), n_events=4,
             reads_per_isoform=40, error_rate=0.01, seed=3, log=io.StringIO())
    return [f"{prefix}_c1_1.fq", f"{prefix}_c1_2.fq"]


# the port's CLI in a process of its own, with the ``gzip`` binary hidden
# when the first argument says so
PORT_CLI = """
import shutil, sys
if sys.argv[1] == "True":
    real = shutil.which
    shutil.which = lambda name, *a, **k: None if name == "gzip" else real(name, *a, **k)
from pantas_tpu_torch import cli
sys.exit(cli.main(sys.argv[2:]))
"""


@pytest.mark.parametrize("suffix,hidden", SINKS, ids=SINK_IDS)
def test_map_compressed_output(graph, reads, tmp_path, suffix, hidden):
    """``map`` with the native core, each package in a process of its own:
    the port's compressed GAF decompresses to the JAX package's plain GAF,
    and the port's log shows the native core's fd path."""
    gfa = graph[1]
    plain, out = tmp_path / "jax.gaf", tmp_path / f"port.gaf.{suffix}"
    run_cli([sys.executable, "-m", "pantas_tpu", "map", gfa, *reads, "-o", str(plain)])
    log = run_cli([sys.executable, "-c", PORT_CLI, str(hidden), "map", gfa, *reads,
                   "-o", str(out)]).stderr
    assert "[map] native alignment core" in log and "[map] phases" in log, log[-2000:]
    expected = plain.read_bytes()
    assert expected.count(b"\n") > 100 and _decompressed(out) == expected


@pytest.mark.parametrize("sink", SINKS, ids=SINK_IDS, indirect=True)
@pytest.mark.parametrize("stage", ["call", "quant", "remap"])
def test_other_stage_compressed_output(tmp_path, stage, sink):
    """``call`` (sorted rows), ``quant`` and ``remap`` (bytes) through the
    sink, against the JAX package's plain ``-o``."""
    if stage == "call":
        gfa, gtf = write_call_fixtures(tmp_path)["splice"]
        argv = ["call", "--rca", "0", "--novel", gfa, gtf]
    else:
        c1, c2, gtf = write_quant_fixtures(tmp_path)
        argv = ["quant", "-a", *c1, *c2]
        if stage == "remap":
            quant = tmp_path / "quant.csv"
            assert tpu_cli.main([*argv, "-o", str(quant)]) == 0
            argv = ["remap", str(quant), gtf]
    plain, out = tmp_path / "jax.out", tmp_path / f"port.out.{sink}"
    assert tpu_cli.main([*argv, "-o", str(plain)]) == 0
    assert cli.main([*argv, "-o", str(out)]) == 0
    got, expected = _decompressed(out), plain.read_bytes()
    assert expected.count(b"\n") >= 2
    if stage == "call":
        got, expected = sorted(got.splitlines()), sorted(expected.splitlines())
    assert got == expected


@pytest.mark.parametrize("suffix", ["zst", "gz"])
def test_augment_dist_compressed_output(graph, tmp_path, suffix):
    """F5b: one rank of ``augment-dist`` on the CPU compresses its ``-o``."""
    import socket

    _, gfa, gaf = graph
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = tmp_path / f"dist.gfa.{suffix}"
    proc = subprocess.run(
        [sys.executable, "-m", "pantas_tpu_torch", "augment-dist", gaf, gfa, "-o", str(out),
         "--coordinator", f"127.0.0.1:{port}", "--nprocs", "1", "--procid", "0",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert _decompressed(out) == _jax_plain_augment("native", gaf, gfa, tmp_path)
    assert not list(tmp_path.glob(".augshard.*"))


def _compress(path, suffix):
    data = open(path, "rb").read()
    target = f"{path}.{suffix}"
    if suffix == "zst" and zstandard is None:
        with open_zst(target, "wb") as fh:
            fh.write(data)
        return target
    with open(target, "wb") as fh:
        fh.write(gzip.compress(data) if suffix == "gz" else
                 zstandard.ZstdCompressor().compress(data))
    return target


@pytest.mark.parametrize("suffix", ["zst", "gz"])
def test_device_py_reads_compressed_gaf(graph, tmp_path, suffix):
    """F6: ``device-py`` on a compressed GAF writes the plain run's bytes."""
    _, gfa, gaf = graph
    plain, packed = tmp_path / "plain.gfa", tmp_path / "packed.gfa"
    assert _port_augment("device-py", gaf, gfa, plain) == 0
    assert _port_augment("device-py", _compress(gaf, suffix), gfa, packed) == 0
    assert packed.read_bytes() == plain.read_bytes()
    assert plain.read_bytes() == _jax_plain_augment("device-py", gaf, gfa, tmp_path)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("suffix", ["zst", "gz"])
def test_device_py_resumes_on_compressed_gaf(graph, tmp_path, monkeypatch, capfd, suffix):
    """F6: a ``device-py`` run on a compressed GAF stopped right after its
    first checkpoint, then resumed with ``--resume`` through the CLI, writes
    the one-shot run's bytes; the checkpoint holds a decompressed offset."""
    import pickle

    _, gfa, gaf = graph
    packed = _compress(gaf, suffix)
    ck = tmp_path / "ck.pkl"
    real_save = port_device._save_checkpoint

    def save_then_stop(*args):
        real_save(*args)
        raise _Stop

    monkeypatch.setattr(port_device, "_save_checkpoint", save_then_stop)
    with pytest.raises(_Stop):
        port_device.augment_gfa_device(packed, gfa, out=io.StringIO(), device="cpu",
                                       flush_every=256, checkpoint_path=str(ck),
                                       log=io.StringIO())
    monkeypatch.setattr(port_device, "_save_checkpoint", real_save)
    with open(ck, "rb") as fh:
        offset = pickle.load(fh)["offset"]
    assert 0 < offset < os.path.getsize(gaf)
    capfd.readouterr()
    out = tmp_path / "resumed.gfa.zst"
    assert _port_augment("device-py", packed, gfa, out, "--checkpoint", str(ck), "--resume") == 0
    assert f"Resuming from checkpoint at offset {offset}" in capfd.readouterr().err
    one_shot = tmp_path / "one_shot.gfa"
    assert _port_augment("device-py", packed, gfa, one_shot) == 0
    assert _decompressed(out) == one_shot.read_bytes()


def _drain_threads():
    return [t for t in threading.enumerate() if t.name.startswith("stage-output-drain")]


@pytest.mark.parametrize("sink", SINKS, ids=SINK_IDS, indirect=True)
def test_sink_hands_out_a_pipe(tmp_path, sink):
    """The handle's descriptor is a pipe's, not the compressed file's; what
    the descriptor and the text handle write both arrive, compressed."""
    out = tmp_path / f"o.txt.{sink}"
    with xopen_mod.open_stage_output(out) as fh:
        assert stat.S_ISFIFO(os.fstat(fh.fileno()).st_mode)
        fh.write("text line\n")
        fh.flush()
        os.write(fh.fileno(), b"x" * (3 << 20) + b"\n")
    assert _decompressed(out) == b"text line\n" + b"x" * (3 << 20) + b"\n"
    assert not _drain_threads()


@pytest.mark.parametrize("sink", SINKS, ids=SINK_IDS, indirect=True)
def test_body_error_reraises_and_leaves_no_thread(tmp_path, sink):
    out = tmp_path / f"o.txt.{sink}"
    with pytest.raises(KeyError, match="the body's own"):
        with xopen_mod.open_stage_output(out) as fh:
            fh.write("a" * (1 << 20))
            raise KeyError("the body's own")
    assert not _drain_threads()


class _FailingCompressor:
    """A compressor that fails once more than ``limit`` bytes reached it, or,
    with ``limit`` None, when it writes its last frame on closing."""

    def __init__(self, limit):
        self.limit, self.n = limit, 0

    def write(self, data):
        self.n += len(data)
        if self.limit is not None and self.n > self.limit:
            raise OSError(errno.ENOSPC, "No space left on device")
        return len(data)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.limit is None:
            raise OSError(errno.ENOSPC, "No space left on device")


@pytest.mark.parametrize("limit", [1 << 16, None], ids=["while-writing", "on-close"])
@pytest.mark.parametrize("engine", ["native", "host", "device"])
def test_compressor_failure_is_not_exit_zero(graph, tmp_path, monkeypatch, engine, limit):
    """A compressor that fails while the GFA streams through it, or when it
    writes its last frame, makes the stage raise; no drain thread is left."""
    _, gfa, gaf = graph
    monkeypatch.setattr(xopen_mod, "xopen", lambda path, mode: _FailingCompressor(limit))
    with pytest.raises(OSError):
        _port_augment(engine, gaf, gfa, tmp_path / "o.gfa.zst")
    assert not _drain_threads()


@pytest.mark.parametrize("suffix,hidden", SINKS, ids=SINK_IDS)
@pytest.mark.parametrize("engine", ["native", "host"])
def test_full_disk_exits_non_zero(graph, tmp_path, engine, suffix, hidden):
    """The port's CLI in a process of its own, ``augment -o X`` where X is
    ``/dev/full`` (every write fails with ENOSPC): a non-zero exit, for
    every compressor."""
    if not os.path.exists("/dev/full"):
        pytest.skip("no /dev/full on this system")
    _, gfa, gaf = graph
    out = tmp_path / f"o.gfa.{suffix}"
    out.symlink_to("/dev/full")
    proc = subprocess.run(
        [sys.executable, "-c", PORT_CLI, str(hidden), "augment", "--engine", engine, gaf, gfa,
         "-o", str(out)],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)))
    assert proc.returncode != 0, proc.stderr[-2000:]
    assert "completed" not in proc.stderr


@pytest.mark.parametrize("n", [0, 1, 1000, 3 << 20])
def test_libzstd_streams_agree_with_the_zstandard_module(tmp_path, n):
    """``io/zstd_ctypes.py`` against the ``zstandard`` module both ways, in
    binary and text mode; ``tell()`` is the decompressed position; two
    frames read as one stream; a file cut inside its frame raises. The
    port's stream also decodes by libzstd's one-shot API, the card's
    independent check."""
    if zstandard is None:
        pytest.skip("the zstandard module is not installed")
    data = (b"S\t1\tACGT\tRC:i:7\n" * (n // 16 + 1))[:n]
    ours, theirs = tmp_path / "ours.zst", tmp_path / "theirs.zst"
    with open_zst(str(ours), "wb") as fh:
        for i in range(0, n, 100_003):
            fh.write(data[i:i + 100_003])
    assert _decompressed(ours) == data
    assert _libzstd_one_shot(ours.read_bytes(), n) == data
    frame = zstandard.ZstdCompressor().compress(data)
    theirs.write_bytes(frame)
    with open_zst(str(theirs), "rb") as fh:
        assert fh.read() == data and fh.tell() == n
    theirs.write_bytes(frame + zstandard.ZstdCompressor().compress(b"tail\n"))
    with open_zst(str(theirs), "rt") as fh:
        assert fh.read() == data.decode() + "tail\n"
    if n:
        theirs.write_bytes(frame[:-3])
        with pytest.raises(OSError, match="ends inside a frame"):
            open_zst(str(theirs), "rb").read()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["device", "device-py"])
@pytest.mark.parametrize("suffix", ["zst", "gz"])
def test_cuda_device_engine_compressed_output(graph, tmp_path, cuda, engine, suffix):
    """On the card: the device engines' compressed output equals the native
    engine's plain bytes."""
    _, gfa, gaf = graph
    plain, out = tmp_path / "native.gfa", tmp_path / f"dev.gfa.{suffix}"
    assert cli.main(["augment", "--engine", "native", gaf, gfa, "-o", str(plain)]) == 0
    assert cli.main(["augment", "--engine", engine, gaf, gfa, "-o", str(out)]) == 0
    assert _decompressed(out) == plain.read_bytes()
