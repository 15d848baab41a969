"""The host side of the port's PUT and GET (minio_tpu_torch, device="cpu")
held to the JAX package and to its own oracles.  Tolerance: byte-exact.

- utils/streams: PipelinedMD5 against hashlib; the pooled ingest ring and
  the bytearray chunker (MTPU_ZEROCOPY=0) against the JAX package's
  batched_chunks on the same seeded streams, with and without readinto;
  a PUT whose reader scribbles over the ring's buffers stores the body.
- storage: write_file_batches against the append_file loop and the JAX
  drive, in every MTPU_ODIRECT mode, with O_DIRECT's EINVAL redone
  buffered; rename_data fsyncs the staging directory under
  MTPU_OSYNC=on before the rename.
- engine: concurrent streamed PUTs and multipart parts digest their MD5
  in parallel (one worker per stream); part files equal with zero-copy
  on and off and equal to the JAX set's; the FileInfo cache's hits and
  its invalidation; get_object's prefetched segments.
"""

import hashlib
import os
import threading

import numpy as np
import pytest

import minio_tpu.utils.streams as jax_streams
import minio_tpu_torch.engine.erasure_set as es_mod
from minio_tpu.engine.erasure_set import ErasureSet as JaxErasureSet
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.engine import multipart as mp
from minio_tpu_torch.engine import quorum as Q
from minio_tpu_torch.engine.erasure_set import ErasureSet
from minio_tpu_torch.ops import coalesce
from minio_tpu_torch.storage import diskio
from minio_tpu_torch.storage import drive as drive_mod
from minio_tpu_torch.storage.drive import SYS_VOL, LocalDrive
from minio_tpu_torch.storage.errors import (ErrErasureReadQuorum,
                                             ErrObjectNotFound)
from minio_tpu_torch.utils import streams

MIB = 1 << 20


def body_of(size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


class ReadStream:
    """A body that answers read(n) with seeded short pieces."""

    def __init__(self, data: bytes, seed: int):
        self._mv = memoryview(data)
        self._pos = 0
        self._rng = np.random.default_rng(seed)

    def _take(self, n: int) -> memoryview:
        n = min(n, int(self._rng.integers(1, 3 * MIB)),
                len(self._mv) - self._pos)
        out = self._mv[self._pos:self._pos + n]
        self._pos += n
        return out

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = len(self._mv)
        return bytes(self._take(n))


class ReadIntoStream(ReadStream):
    """The same, with a readinto that first scribbles over the whole
    buffer it is given (its bytes past the count returned are the
    reader's to clobber)."""

    def readinto(self, b) -> int:
        mv = b if isinstance(b, memoryview) else memoryview(b)
        mv[:] = b"\xee" * len(mv)
        piece = self._take(len(mv))
        mv[:len(piece)] = piece
        return len(piece)


STREAMS = {"read": ReadStream, "readinto": ReadIntoStream}


@pytest.fixture(autouse=True)
def no_executor_threads_left():
    """No executor or MRF thread a test starts outlives it (the MD5
    workers, "mtpu-md5", are process-wide by design)."""
    def executors():
        return {t for t in threading.enumerate()
                if t.name.startswith("ThreadPoolExecutor")}
    before = executors()
    yield
    assert not executors() - before


@pytest.fixture(autouse=True)
def cold_lanes():
    coalesce.reset()
    yield
    coalesce.reset()


@pytest.fixture
def make_set(tmp_path):
    made = []

    def make(n=4, parity=2, root="d"):
        es = ErasureSet([LocalDrive(str(tmp_path / root / f"d{i}"))
                         for i in range(n)], default_parity=parity,
                        device="cpu")
        es.make_bucket("bkt")
        made.append(es)
        return es
    yield make
    for es in made:
        es.close()


# -- PipelinedMD5 --------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1, 1000, 3 * MIB + 17])
def test_pipelined_md5_equals_hashlib(size):
    body = body_of(size, seed=size)
    fed = streams.PipelinedMD5()
    fed.feed(body, chunk_len=MIB // 3)
    assert fed.hexdigest() == hashlib.md5(body).hexdigest()
    # Writable views are copied on update: scribbling over the buffer
    # after update must not change the digest.
    piecewise = streams.PipelinedMD5()
    buf = bytearray(MIB)
    for off in range(0, size, MIB):
        n = min(MIB, size - off)
        buf[:n] = body[off:off + n]
        piecewise.update(memoryview(buf)[:n])
        buf[:] = b"\x00" * len(buf)
    assert piecewise.hexdigest() == hashlib.md5(body).hexdigest()


def test_pipelined_md5_close_releases_worker(monkeypatch):
    """close() drops what a stream has queued: the workers go on to
    other streams instead of digesting an abandoned body."""
    gate, started = threading.Event(), threading.Event()
    real_md5 = hashlib.md5

    class Gated:
        def __init__(self):
            self._h = real_md5()

        def update(self, piece):
            started.set()
            assert gate.wait(10)
            self._h.update(piece)

        def hexdigest(self):
            return self._h.hexdigest()
    monkeypatch.setattr(streams, "hashlib",
                        type("hashlib", (), {"md5": Gated}))
    md5 = streams.PipelinedMD5()
    md5.feed(b"abcdef" * 100, chunk_len=6)
    assert started.wait(5)
    md5.close()
    gate.set()
    assert md5.hexdigest() == real_md5(b"abcdef").hexdigest()
    assert not md5._pieces


def test_pipelined_md5_error_reaches_hexdigest(monkeypatch):
    """A digest step that fails drops the stream's queue and raises
    at hexdigest(), as the JAX worker's future does."""
    class Failing:
        def update(self, piece):
            raise ValueError("digest failed")
    monkeypatch.setattr(streams, "hashlib",
                        type("hashlib", (), {"md5": Failing}))
    md5 = streams.PipelinedMD5()
    md5.feed(b"x" * 100, chunk_len=10)
    with pytest.raises(ValueError, match="digest failed"):
        md5.hexdigest()
    assert not md5._pieces


def test_pipelined_md5_streams_share_the_pool(monkeypatch):
    """More streams than the pool's 4 workers interleave piece by
    piece: eight open streams, each with a piece in flight, hold no
    worker between pieces, so a ninth is digested at once.  update()
    waits for the stream's previous piece (one in flight), so a body
    cannot pile up ahead of its digest."""
    bodies = [body_of(3 * 4096, seed=s) for s in range(9)]
    open_streams = [streams.PipelinedMD5() for _ in range(8)]
    for md5, body in zip(open_streams, bodies):
        md5.update(memoryview(bytearray(body[:4096])))
    ninth = streams.PipelinedMD5()
    ninth.feed(bodies[8], chunk_len=4096)
    done = threading.Event()
    threading.Thread(target=lambda: (ninth.hexdigest(), done.set()),
                     daemon=True).start()
    assert done.wait(10)
    assert ninth.hexdigest() == hashlib.md5(bodies[8]).hexdigest()
    for md5, body in zip(open_streams, bodies):
        md5.update(body[4096:8192])
        md5.update(memoryview(bytearray(body[8192:])))
        assert md5.hexdigest() == hashlib.md5(body).hexdigest()

    # One piece in flight: a second update waits for the first's digest.
    gate, real_md5 = threading.Event(), hashlib.md5

    class Gated:
        def __init__(self):
            self._h = real_md5()

        def update(self, piece):
            assert gate.wait(10)
            self._h.update(piece)

        def hexdigest(self):
            return self._h.hexdigest()
    monkeypatch.setattr(streams, "hashlib",
                        type("hashlib", (), {"md5": Gated}))
    md5 = streams.PipelinedMD5()
    md5.update(b"one")
    second = threading.Thread(target=md5.update, args=(b"two",),
                              daemon=True)
    second.start()
    second.join(0.3)
    assert second.is_alive() and not md5._pieces
    gate.set()
    second.join(10)
    assert md5.hexdigest() == real_md5(b"onetwo").hexdigest()


# -- the ingest ring -----------------------------------------------------------

def _chunks(mod, head, stream, chunk_len):
    # Each view is copied on receipt: the ring recycles its buffers.
    return [(bytes(c), last) for c, last in
            mod.batched_chunks(head, stream, chunk_len)]


@pytest.mark.parametrize("zerocopy", ["1", "0"], ids=["ring", "bytearray"])
@pytest.mark.parametrize("kind", sorted(STREAMS))
@pytest.mark.parametrize("size,head", [(0, 0), (5, 5), (4 * MIB, 1000),
                                       (9 * MIB + 7, 0),
                                       (10 * MIB, 2 * MIB + 3)])
def test_batched_chunks_match_jax(monkeypatch, zerocopy, kind, size, head):
    monkeypatch.setenv("MTPU_ZEROCOPY", zerocopy)
    body = body_of(size, seed=size + head)
    got = _chunks(streams, body[:head],
                  STREAMS[kind](body[head:], seed=7), 2 * MIB)
    want = _chunks(jax_streams, body[:head],
                   STREAMS[kind](body[head:], seed=7), 2 * MIB)
    assert got == want
    assert b"".join(c for c, _ in got) == body
    assert [last for _, last in got] == [False] * (len(got) - 1) + [True]


@pytest.mark.parametrize("coalesced", ["1", "0"], ids=["lane", "direct"])
def test_put_through_recycled_ring(make_set, monkeypatch, coalesced):
    """A streamed PUT of more batches than the ring has slots, from a
    reader that scribbles over every buffer it fills, through a lane
    forced to dispatch on its own thread: the stored bytes and every
    part file equal the copying oracle's."""
    monkeypatch.setenv("MTPU_COALESCE", coalesced)
    monkeypatch.setattr(es_mod, "BATCH_BLOCKS", 2)
    monkeypatch.setattr(streams, "_RING_DEPTH", 2)
    body = body_of(11 * MIB + 12345, seed=3)
    parts = {}
    for zerocopy in ("1", "0"):
        monkeypatch.setenv("MTPU_ZEROCOPY", zerocopy)
        coalesce.reset()
        if coalesced == "1":
            coalesce.get().lane(torch_cpu())._ema = 2.0
        es = make_set(root=f"z{zerocopy}")
        fi = es.put_object("bkt", "o", ReadIntoStream(body, seed=5))
        assert fi.etag == hashlib.md5(body).hexdigest()
        _, got = es.get_object("bkt", "o")
        assert bytes(got) == body
        parts[zerocopy] = _part_files(es, fi)
    assert parts["1"] == parts["0"]


@pytest.mark.parametrize("zerocopy", ["1", "0"], ids=["ring", "bytearray"])
def test_concurrent_streamed_puts_through_queued_lane(make_set, monkeypatch,
                                                      zerocopy):
    """Concurrent streamed PUTs whose batches queue on the lane thread:
    a PUT's last ring buffer is released when its body ends, and another
    PUT leases it at once, so the batch must be resolved before that.
    Every object reads back as written."""
    monkeypatch.setenv("MTPU_ZEROCOPY", zerocopy)
    es = make_set(n=6, parity=2)
    bodies = {f"c{i}": body_of(2 * MIB + 4099 * i, seed=70 + i)
              for i in range(12)}

    def put(key):
        coalesce.get().lane(torch_cpu())._ema = 2.0    # queue, not inline
        return es.put_object("bkt", key, ReadIntoStream(bodies[key],
                                                        seed=9))
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(4) as ex:
        fis = list(ex.map(put, bodies))
    for fi in fis:
        assert fi.etag == hashlib.md5(bodies[fi.name]).hexdigest()
        assert bytes(es.get_object("bkt", fi.name)[1]) == bodies[fi.name]


def torch_cpu():
    import torch
    return torch.device("cpu")


def _part_files(es, fi, part="part.1"):
    """Part file bytes keyed by shard index."""
    out = {}
    for pos, d in enumerate(es.drives):
        p = os.path.join(d.root, fi.volume, fi.name, fi.data_dir, part)
        with open(p, "rb") as f:
            out[fi.erasure.distribution[pos]] = f.read()
    return out


# -- vectored writes -----------------------------------------------------------

BATCH_SETS = {
    "aligned": [4 * diskio.ALIGN, 64 * diskio.ALIGN, 32 * diskio.ALIGN],
    "ragged": [1000, 200 * 1024 + 3, 0, 17],
}


@pytest.mark.parametrize("mode", ["off", "fadvise", "direct"])
@pytest.mark.parametrize("shape", sorted(BATCH_SETS))
def test_write_file_batches_equals_append_and_jax(tmp_path, monkeypatch,
                                                  mode, shape):
    monkeypatch.setenv("MTPU_ODIRECT", mode)
    rng = np.random.default_rng(len(shape))
    batches = [rng.integers(0, 256, n, dtype=np.uint8)
               for n in BATCH_SETS[shape]]
    port, loop = LocalDrive(str(tmp_path / "p")), \
        LocalDrive(str(tmp_path / "l"))
    jax = JaxLocalDrive(str(tmp_path / "j"))
    before = drive_mod.stats()["vectored_writes"]
    for _ in range(2):                       # a second call appends
        port.write_file_batches(SYS_VOL, "tmp/x/part.1", batches)
        jax.write_file_batches(SYS_VOL, "tmp/x/part.1", batches)
        for b in batches:
            loop.append_file(SYS_VOL, "tmp/x/part.1", b)
    assert drive_mod.stats()["vectored_writes"] == before + 2
    got = [open(os.path.join(d.root, SYS_VOL, "tmp/x/part.1"), "rb").read()
           for d in (port, loop, jax)]
    assert got[0] == got[1] == got[2] == b"".join(
        b.tobytes() for b in batches) * 2


def test_direct_write_einval_redone_buffered(tmp_path, monkeypatch):
    """tmpfs refuses O_DIRECT writes with EINVAL: the vectored write is
    redone through the buffered descriptor, byte for byte."""
    monkeypatch.setenv("MTPU_ODIRECT", "direct")
    direct_fds, refused = set(), []
    real_open, real_pwritev = os.open, os.pwritev

    def fake_open(path, flags, *a, **kw):
        if flags & os.O_DIRECT:
            fd = real_open(path, flags & ~os.O_DIRECT, *a, **kw)
            direct_fds.add(fd)
            return fd
        return real_open(path, flags, *a, **kw)

    def fake_pwritev(fd, bufs, off):
        if fd in direct_fds:
            refused.append(fd)
            raise OSError(22, "Invalid argument")
        return real_pwritev(fd, bufs, off)

    monkeypatch.setattr(os, "open", fake_open)
    monkeypatch.setattr(os, "pwritev", fake_pwritev)
    batches = [body_of(16 * diskio.ALIGN, seed=i) for i in range(3)]
    d = LocalDrive(str(tmp_path / "d"))
    d.write_file_batches(SYS_VOL, "tmp/y/part.1", batches)
    monkeypatch.undo()
    assert refused and direct_fds
    with open(os.path.join(d.root, SYS_VOL, "tmp/y/part.1"), "rb") as f:
        assert f.read() == b"".join(batches)


def test_rename_data_fsyncs_staging_dir_under_osync(make_set, monkeypatch):
    """MTPU_OSYNC=on: the staged part files and then the staging
    directory itself are fsynced before the rename publishes them."""
    monkeypatch.setenv("MTPU_OSYNC", "on")
    events = []
    real_fsync, real_replace = os.fsync, os.replace

    def fsync(fd):
        events.append(("fsync", os.readlink(f"/proc/self/fd/{fd}")))
        return real_fsync(fd)

    def replace(src, dst, *a, **kw):
        events.append(("replace", os.fspath(src)))
        return real_replace(src, dst, *a, **kw)

    es = make_set()
    monkeypatch.setattr(os, "fsync", fsync)
    monkeypatch.setattr(os, "replace", replace)
    es.put_object("bkt", "o", body_of(MIB + 5, seed=9))
    monkeypatch.undo()
    staging = [src for kind, src in events if kind == "replace"
               and f"{SYS_VOL}/tmp/put-" in src]
    assert len(staging) == len(es.drives)
    for src in staging:
        renamed = events.index(("replace", src))
        synced = [i for i, e in enumerate(events) if e == ("fsync", src)]
        assert synced and synced[0] < renamed, src
        assert ("fsync", os.path.join(src, "part.1")) in events[:renamed]


# -- per-stream MD5 --------------------------------------------------------------

class _GatedMD5:
    """hashlib.md5 whose first bulk update waits at a barrier: two
    streams pass it only if their digests run at the same time."""

    real = hashlib.md5

    def __init__(self, barrier, *a, **kw):
        self._h = self.real(*a, **kw)
        self._barrier = barrier
        self._waited = False

    def update(self, data):
        if not self._waited and len(data) >= 256 * 1024:
            self._waited = True
            self._barrier.wait()
        self._h.update(data)

    def hexdigest(self):
        return self._h.hexdigest()

    def digest(self):
        return self._h.digest()


def _gate_md5(monkeypatch):
    barrier = threading.Barrier(2, timeout=20)
    monkeypatch.setattr(hashlib, "md5",
                        lambda *a, **kw: _GatedMD5(barrier, *a, **kw))
    return barrier


def _run_two(fn, args):
    out, errs = [None, None], []

    def run(i):
        try:
            out[i] = fn(*args[i])
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)
    ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs
    return out


def test_concurrent_streamed_puts_digest_in_parallel(make_set, monkeypatch):
    es = make_set()
    bodies = [body_of(3 * MIB + i, seed=40 + i) for i in range(2)]
    barrier = _gate_md5(monkeypatch)
    fis = _run_two(lambda key, body: es.put_object(
        "bkt", key, ReadStream(body, seed=1)),
        [("a", bodies[0]), ("b", bodies[1])])
    monkeypatch.undo()
    assert not barrier.broken
    for fi, body in zip(fis, bodies):
        assert fi.etag == hashlib.md5(body).hexdigest()
        assert bytes(es.get_object("bkt", fi.name)[1]) == body


def test_concurrent_multipart_parts_digest_in_parallel(make_set,
                                                       monkeypatch):
    es = make_set()
    up = mp.new_multipart_upload(es, "bkt", "big")
    bodies = [body_of(5 * MIB + i, seed=50 + i) for i in range(2)]
    barrier = _gate_md5(monkeypatch)
    parts = _run_two(lambda n, body: mp.put_object_part(
        es, "bkt", "big", up, n, ReadStream(body, seed=2)),
        [(1, bodies[0]), (2, bodies[1])])
    monkeypatch.undo()
    assert not barrier.broken
    for part, body in zip(parts, bodies):
        assert part.etag == hashlib.md5(body).hexdigest()


# -- staging: zero-copy on and off, and the JAX set ------------------------------

@pytest.mark.parametrize("size", [3 * MIB + 1234, 70 * MIB + 5])
@pytest.mark.parametrize("reader", [False, True], ids=["bytes", "stream"])
def test_part_files_equal_across_modes_and_jax(tmp_path, monkeypatch,
                                               make_set, size, reader):
    body = body_of(size, seed=size % 97)
    parts, fis = {}, {}
    for zerocopy in ("1", "0"):
        monkeypatch.setenv("MTPU_ZEROCOPY", zerocopy)
        es = make_set(n=6, parity=2, root=f"z{zerocopy}")
        data = ReadIntoStream(body, seed=3) if reader else body
        fis[zerocopy] = fi = es.put_object("bkt", "o", data)
        parts[zerocopy] = _part_files(es, fi)
    monkeypatch.delenv("MTPU_ZEROCOPY")
    jes = JaxErasureSet([JaxLocalDrive(str(tmp_path / "jax" / f"d{i}"))
                         for i in range(6)], default_parity=2)
    try:
        jes.make_bucket("bkt")
        jfi = jes.put_object("bkt", "o", body)
        jparts = {}
        for pos, d in enumerate(jes.drives):
            with open(os.path.join(d.root, "bkt", "o", jfi.data_dir,
                                   "part.1"), "rb") as f:
                jparts[jfi.erasure.distribution[pos]] = f.read()
    finally:
        jes.pool.shutdown(wait=True)
        jes._iter_pool.shutdown(wait=True)
    assert parts["1"] == parts["0"] == jparts
    assert fis["1"].etag == fis["0"].etag == jfi.etag == \
        hashlib.md5(body).hexdigest()


# -- the FileInfo cache ----------------------------------------------------------

def _elections(fn):
    before = es_mod.stats()["meta_read_requests"]
    out = fn()
    return es_mod.stats()["meta_read_requests"] - before, out


def test_fileinfo_cache_hits_and_invalidation(make_set):
    es = make_set()
    a, b = body_of(MIB + 3, seed=1), body_of(200 * 1024, seed=2)
    es.put_object("bkt", "o", a)
    # HEAD elects and writes through; the GET that follows elects 0.
    n, _ = _elections(lambda: es.head_object("bkt", "o"))
    assert n == 1
    n, (_, got) = _elections(lambda: es.get_object("bkt", "o"))
    assert n == 0 and bytes(got) == a
    n, _ = _elections(lambda: es.get_object("bkt", "o", 5, 100))
    assert n == 0
    # A PUT invalidates: the next GET elects and sees the new bytes.
    es.put_object("bkt", "o", b)
    n, (_, got) = _elections(lambda: es.get_object("bkt", "o"))
    assert n == 1 and bytes(got) == b
    # A metadata update invalidates.
    fi = es.head_object("bkt", "o")
    fi.metadata = dict(fi.metadata, **{"x-amz-meta-k": "v"})
    es.update_object_metadata("bkt", "o", fi)
    n, (fi2, _) = _elections(lambda: es.get_object("bkt", "o"))
    assert n == 1 and fi2.metadata["x-amz-meta-k"] == "v"
    # A DELETE invalidates.
    es.delete_object("bkt", "o")
    with pytest.raises(ErrObjectNotFound):
        es.get_object("bkt", "o")
    # The TTL bounds an entry's life.
    es.put_object("bkt", "p", a)
    es.head_object("bkt", "p")
    es._FI_CACHE_TTL = 0.0
    n, _ = _elections(lambda: es.get_object("bkt", "p"))
    assert n == 1


@pytest.mark.parametrize("size", [200, MIB + 5], ids=["inline", "parts"])
@pytest.mark.parametrize("write", ["put", "delete"])
@pytest.mark.parametrize("reader", ["get", "head"])
def test_fileinfo_cache_write_racing_an_election(make_set, monkeypatch,
                                                 reader, write, size):
    """A write that publishes while a GET or HEAD elects the old
    metadata leaves no entry behind: the next GET sees the write
    (S3 read-after-write).  The election is patched to run the write
    after it has read the drives and before it returns."""
    es = make_set()
    old, new = body_of(size, seed=11), body_of(size, seed=12)
    es.put_object("bkt", "o", old)
    real = es._read_metadata
    raced = []

    def racing(bucket, obj, version_id=""):
        entry = real(bucket, obj, version_id)
        if not raced:
            raced.append(write)
            if write == "put":
                es.put_object("bkt", "o", new)
            else:
                es.delete_object("bkt", "o")
        return entry
    monkeypatch.setattr(es, "_read_metadata", racing)
    if reader == "get":
        # The racing GET itself reads lock-free: it returns the old
        # bytes, or, where the write renamed the old data_dir away,
        # fails on read quorum.
        try:
            _, got = es.get_object("bkt", "o")
            assert bytes(got) == old
        except ErrErasureReadQuorum:
            assert size > MIB
    else:
        assert es.head_object("bkt", "o").size == size
    assert raced
    if write == "put":
        fi, got = es.get_object("bkt", "o")
        assert bytes(got) == new
        assert fi.etag == hashlib.md5(new).hexdigest()
        assert es.head_object("bkt", "o").etag == fi.etag
    else:
        with pytest.raises(ErrObjectNotFound):
            es.get_object("bkt", "o")
        with pytest.raises(ErrObjectNotFound):
            es.head_object("bkt", "o")


def test_fileinfo_cache_is_bounded_lru(make_set):
    es = make_set()
    es._FI_CACHE_MAX = 3
    for i in range(5):
        es.put_object("bkt", f"k{i}", body_of(1000, seed=i))
        es.head_object("bkt", f"k{i}")
    assert [k[1] for k in es._fi_cache] == ["k2", "k3", "k4"]
    es.get_object("bkt", "k2")               # a hit moves to the MRU end
    assert [k[1] for k in es._fi_cache] == ["k3", "k4", "k2"]


# -- get_object's prefetch -------------------------------------------------------

@pytest.mark.parametrize("away", [(), (0,)], ids=["healthy", "degraded"])
def test_get_object_prefetch_same_bytes(make_set, monkeypatch, away):
    """Segments read one ahead (the one-core gate lifted) give the
    bytes of get_object_iter, of serial segments, and of the body."""
    monkeypatch.setattr(es_mod, "BATCH_BLOCKS", 2)
    es = make_set(n=6, parity=2)
    body = body_of(9 * MIB + 77, seed=8)
    fi = es.put_object("bkt", "o", body)
    order = Q.shuffle_by_distribution(list(range(6)),
                                      fi.erasure.distribution)
    for s in away:
        es.drives[order[s]] = None
    for serial in (False, True):
        monkeypatch.setattr(es_mod, "SERIAL_FANOUT", serial)
        for off, ln in [(0, -1), (MIB + 3, 5 * MIB), (len(body) - 9, 9)]:
            want = body[off:] if ln < 0 else body[off:off + ln]
            _, got = es.get_object("bkt", "o", off, ln)
            assert bytes(got) == want
            _, it = es.get_object_iter("bkt", "o", off, ln)
            assert b"".join(bytes(c) for c in it) == want
