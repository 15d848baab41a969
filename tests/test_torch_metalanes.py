"""The metadata plane of the port (ops/metalanes.py, the drive's group
commit, journal and batched reads, the engine's laned publishes and the
K+1 read trim) held to the JAX package's on the same seeded inputs, and
the repairs the port makes: a group commit acknowledges only once its
blobs are durable, a journal replay never puts an older blob over a
newer xl.meta nor brings back a deleted key, replays in commit order, a
respawned worker retires its predecessor's segments, a write round too
small to journal is handed back, a request's read note counts once, and
the breaker counts a batched call's failed items and judges its whole
time."""

import os
import shutil
import threading
import time
import zlib

import numpy as np
import pytest

from minio_tpu.engine.erasure_set import ErasureSet as JaxErasureSet
from minio_tpu.ops import metalanes as jax_metalanes
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu.storage.xlmeta import FileInfo as JaxFileInfo
from minio_tpu_torch.engine import erasure_set as es_mod
from minio_tpu_torch.engine.erasure_set import ErasureSet, Metas
from minio_tpu_torch.ops import coalesce, metalanes
from minio_tpu_torch.storage import drive as drive_mod
from minio_tpu_torch.storage.drive import (META_JOURNAL_DIR, SYS_VOL,
                                           XL_META_FILE, LocalDrive)
from minio_tpu_torch.storage.errors import (ErrDiskNotFound,
                                            ErrFileNotFound,
                                            ErrObjectNotFound,
                                            ErrVolumeNotFound)
from minio_tpu_torch.storage.health_wrap import HealthWrappedDrive
from minio_tpu_torch.storage.naughty import NaughtyDrive
from minio_tpu_torch.storage.xlmeta import FileInfo, XLMeta
from minio_tpu_torch.utils import msgpackx

KIB = 1024
STAMP = 1_700_000_000_123_456_789


@pytest.fixture(autouse=True)
def cold_planes():
    coalesce.reset()
    metalanes.reset()
    jax_metalanes.reset()
    yield
    metalanes.reset()
    jax_metalanes.reset()
    coalesce.reset()


def body(size, seed):
    return np.random.default_rng(seed).bytes(size)


def fi_for(cls, obj, data, vid="", mod=1):
    return cls(volume="v", name=obj, version_id=vid, mod_time_ns=mod,
               size=len(data), inline_data=data)


def xlmeta(root, obj, vol="v"):
    with open(os.path.join(root, vol, obj, XL_META_FILE), "rb") as f:
        return f.read()


def segments(root):
    return sorted(os.listdir(os.path.join(root, SYS_VOL, META_JOURNAL_DIR)))


def _items(cls, same_key: bool, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(8):
        obj = "k" if same_key else f"o{i}"
        vid = f"{i:02d}" + "0" * 30 if same_key else ""
        data = rng.bytes(int(rng.integers(64, 4096)))
        out.append(("v", obj, fi_for(cls, obj, data, vid=vid, mod=i + 1)))
    return out


# -- the drive's group commit ---------------------------------------------------

@pytest.mark.parametrize("same_key", [False, True], ids=["keys", "one-key"])
def test_batch_bytes_equal_a_solo_sequence_in_both_packages(tmp_path,
                                                            same_key):
    """A group-committed batch leaves the xl.meta bytes of a sequence of
    solo write_metadata calls; items of one key chain onto each other
    (every version lands); the JAX package's batch and solo writes give
    the same bytes."""
    runs = {}
    for pkg, drive_cls, fi_cls in (("torch", LocalDrive, FileInfo),
                                   ("jax", JaxLocalDrive, JaxFileInfo)):
        for how in ("batch", "solo"):
            d = drive_cls(str(tmp_path / f"{pkg}-{how}"))
            d.make_volume("v")
            items = _items(fi_cls, same_key, seed=5)
            if how == "batch":
                assert d.write_metadata_many(items) == [None] * len(items)
            else:
                for vol, obj, fi in items:
                    d.write_metadata(vol, obj, fi)
            runs[(pkg, how)] = {o: xlmeta(d.root, o) for o in
                                sorted({obj for _, obj, _ in items})}
            assert segments(d.root) == []           # no journal residue
    first = runs[("torch", "batch")]
    assert all(r == first for r in runs.values())
    if same_key:
        assert len(XLMeta.from_bytes(first["k"]).versions) == 8


def test_per_item_fault_isolation_matches_jax(tmp_path):
    """A poisoned item (a missing volume) fails alone in both packages;
    its batch-mates publish the same bytes."""
    got = {}
    for pkg, drive_cls, fi_cls in (("torch", LocalDrive, FileInfo),
                                   ("jax", JaxLocalDrive, JaxFileInfo)):
        d = drive_cls(str(tmp_path / pkg))
        d.make_volume("v")
        good = fi_for(fi_cls, "good1", b"a")
        bad = fi_cls(volume="novol", name="bad", size=1, inline_data=b"b",
                     mod_time_ns=1)
        errs = d.write_metadata_many([("v", "good1", good),
                                      ("novol", "bad", bad),
                                      ("v", "good2",
                                       fi_for(fi_cls, "good2", b"c"))])
        assert errs[0] is None and errs[2] is None
        assert type(errs[1]).__name__ == "ErrVolumeNotFound"
        got[pkg] = (xlmeta(d.root, "good1"), xlmeta(d.root, "good2"))
        assert segments(d.root) == []
    assert got["torch"] == got["jax"]
    assert isinstance(
        LocalDrive(str(tmp_path / "torch")).write_metadata_many(
            [("novol", "x", fi_for(FileInfo, "x", b"x"))])[0],
        ErrVolumeNotFound)


class _Killed(BaseException):
    """Stands for a kill between the segment's fsync and the publish."""


def _leave_segment(monkeypatch, drive_cls, root, items):
    """Run write_metadata_many until its segment is fsynced, then stop
    it as a kill would: the segment stays, nothing is published."""
    d = drive_cls(str(root))
    d.make_volume("v")
    # The volume predates the segment by more than a timestamp tick (a
    # directory changed in the segment's tick is not replayed into).
    time.sleep(0.02)

    def killed(self, *a, **kw):
        raise _Killed()
    monkeypatch.setattr(drive_cls, "_publish_meta_blob", killed)
    with pytest.raises(_Killed):
        d.write_metadata_many(items)
    monkeypatch.undo()
    assert len(segments(d.root)) == 1
    return d


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_segment_either_package_left_replays_in_the_other(
        tmp_path, monkeypatch, writer):
    """A segment a kill left after its fsync is replayed by the other
    package's boot sweep into the xl.meta the batch would have
    published (and the segment is gone)."""
    pkgs = {"torch": (LocalDrive, FileInfo), "jax": (JaxLocalDrive,
                                                     JaxFileInfo)}
    reader = "torch" if writer == "jax" else "jax"
    w_drive, w_fi = pkgs[writer]
    items = _items(w_fi, False, seed=9) + _items(w_fi, True, seed=10)
    root = tmp_path / "replay"
    _leave_segment(monkeypatch, w_drive, root, items)
    counts = pkgs[reader][0](str(root)).sweep_stale()
    # The port counts the keys it republished, the JAX package every
    # entry (one key's chained entries included).
    assert counts["meta_journal"] == (
        len({obj for _, obj, _ in items}) if reader == "torch"
        else len(items))
    assert segments(str(root)) == []
    ref = LocalDrive(str(tmp_path / "ref"))
    ref.make_volume("v")
    for vol, obj, fi in _items(FileInfo, False, 9) + _items(FileInfo, True,
                                                            10):
        ref.write_metadata(vol, obj, fi)
    for obj in sorted({obj for _, obj, _ in items}):
        assert xlmeta(str(root), obj) == xlmeta(ref.root, obj), obj


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_a_torn_segment_is_discarded(tmp_path, pkg):
    drive_cls = LocalDrive if pkg == "torch" else JaxLocalDrive
    d = drive_cls(str(tmp_path / "d"))
    d.make_volume("v")
    seg = os.path.join(d.root, SYS_VOL, META_JOURNAL_DIR,
                       "seg-000000000001-1-torn")
    pay = msgpackx.packb({"v": 1, "entries": [
        {"vol": "v", "obj": "lost", "blob": b"never"}]})
    with open(seg, "wb") as f:          # the CRC of a shorter payload
        f.write(b"MJ01" + zlib.crc32(pay[:-3]).to_bytes(4, "big") + pay)
    assert d.sweep_stale()["meta_journal"] == 0
    assert not os.path.exists(seg)
    assert not os.path.exists(os.path.join(d.root, "v", "lost"))


def test_read_version_many_on_mixed_items_matches_jax(tmp_path):
    out = {}
    for pkg, drive_cls, fi_cls in (("torch", LocalDrive, FileInfo),
                                   ("jax", JaxLocalDrive, JaxFileInfo)):
        d = drive_cls(str(tmp_path / pkg))
        d.make_volume("v")
        d.write_metadata("v", "have", fi_for(fi_cls, "have", b"yes"))
        res = d.read_version_many([("v", "have", ""), ("v", "missing", ""),
                                   ("novol", "x", ""),
                                   ("v", "have", "0" * 32)])
        out[pkg] = [(fi.inline_data if fi is not None else None,
                     type(e).__name__ if e is not None else None)
                    for fi, e in res]
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == (b"yes", None)
    assert all(fi is None and e for fi, e in out["torch"][1:])


# -- the replay's repairs -------------------------------------------------------

def _stale_segment_sequence(tmp_path, drive_cls, fi_cls, then="write"):
    """Worker A group-commits version 1 of K and publishes, worker B
    (another process's drive object over the same root) writes version
    2 and acknowledges it (or, `then="delete"`, deletes K, its last
    version), then A dies before its unlink; a later boot sweeps.
    Returns K's version after the sweep (None when K is gone)."""
    root = str(tmp_path / "shared")
    a, b = drive_cls(root), drive_cls(root)
    a.make_volume("v")
    jdir = os.path.join(root, SYS_VOL, META_JOURNAL_DIR)
    kept = str(tmp_path / "kept")
    os.mkdir(kept)
    publish = drive_cls._publish_meta_blob

    def publish_and_keep(self, vol, obj, blob):
        for name in os.listdir(jdir):         # the segment A will unlink
            shutil.copy2(os.path.join(jdir, name), kept)
        publish(self, vol, obj, blob)
    a._publish_meta_blob = publish_and_keep.__get__(a)
    assert a.write_metadata_many(
        [("v", "K", fi_for(fi_cls, "K", b"version 1", mod=1))]) == [None]
    time.sleep(0.02)
    if then == "delete":
        b.delete_version("v", "K", "")
    else:
        b.write_metadata("v", "K", fi_for(fi_cls, "K", b"version 2",
                                          mod=2))
    for name in os.listdir(kept):             # A died before its unlink
        shutil.copy2(os.path.join(kept, name), jdir)
    drive_cls(root).sweep_stale()
    assert os.listdir(jdir) == []
    try:
        return drive_cls(root).read_version("v", "K").inline_data
    except Exception as e:  # noqa: BLE001 — either package's not-found
        assert type(e).__name__ == "ErrFileNotFound", e
        return None


@pytest.mark.parametrize("then,kept", [("write", b"version 2"),
                                       ("delete", None)])
def test_replay_never_puts_an_older_blob_over_an_acknowledged_write(
        tmp_path, then, kept):
    """The port keeps B's acknowledged version 2, and keeps K deleted
    after B's acknowledged DELETE; the JAX rule (replace with every
    surviving blob) puts A's version 1 back either way."""
    assert _stale_segment_sequence(tmp_path / "torch", LocalDrive,
                                   FileInfo, then) == kept
    assert _stale_segment_sequence(tmp_path / "jax", JaxLocalDrive,
                                   JaxFileInfo, then) == b"version 1"


def test_replay_repairs_a_corrupt_xlmeta_but_not_a_missing_one(tmp_path):
    """A blob renamed over an xl.meta whose data a power loss lost reads
    corrupt: the segment's blob replaces it.  A segment of a key whose
    xl.meta is missing under a directory changed since is not
    replayed."""
    d = LocalDrive(str(tmp_path / "d"))
    d.make_volume("v")
    jdir = os.path.join(d.root, SYS_VOL, META_JOURNAL_DIR)
    d.write_metadata("v", "torn", fi_for(FileInfo, "torn", b"old"))
    os.makedirs(os.path.join(d.root, "v", "gone"))
    time.sleep(0.02)
    blobs = {}
    for obj, text in (("torn", b"new"), ("gone", b"deleted since")):
        meta = XLMeta()
        meta.add_version(fi_for(FileInfo, obj, text))
        blobs[obj] = meta.to_bytes()
    _segment(os.path.join(jdir, "seg-00000000000000000001-1-aa"),
             [{"vol": "v", "obj": o, "blob": b} for o, b in blobs.items()],
             time.time_ns())
    time.sleep(0.02)
    with open(xlmeta_path(d.root, "torn"), "wb"):
        pass                                  # zero length, as torn
    shutil.rmtree(os.path.join(d.root, "v", "gone"))
    assert d.sweep_stale()["meta_journal"] == 1
    assert d.read_version("v", "torn").inline_data == b"new"
    with pytest.raises(ErrFileNotFound):
        d.read_version("v", "gone")


def xlmeta_path(root, obj, vol="v"):
    return os.path.join(root, vol, obj, XL_META_FILE)


def test_a_group_commit_acks_after_its_blobs_are_durable(tmp_path,
                                                         monkeypatch):
    """Each journaled publish, in order: the segment's fsync, the blob's
    rename, a sync that makes the renamed blob durable (the drive's
    sync), the segment's unlink, and only then the caller's ack.  With
    no sync between the rename and the unlink, nothing synced would
    cover an acknowledged blob after a power loss."""
    monkeypatch.setenv("MTPU_METABATCH_SOLO", "1")
    d = LocalDrive(str(tmp_path / "d"))
    d.make_volume("v")
    jdir = os.path.join(d.root, SYS_VOL, META_JOURNAL_DIR)
    events = []
    real_fsync, real_replace, real_unlink = os.fsync, os.replace, os.unlink
    real_sync = drive_mod.diskio.sync_fs

    def fsync(fd):
        path = os.readlink(f"/proc/self/fd/{fd}")
        events.append("fsync-segment" if path.startswith(jdir) else
                      "sync" if path.endswith(XL_META_FILE) else "fsync")
        real_fsync(fd)

    def replace(src, dst):
        if str(dst).endswith(XL_META_FILE):
            events.append("rename")
        real_replace(src, dst)

    def unlink(path):
        if str(path).startswith(jdir):
            events.append("unlink-segment")
        real_unlink(path)

    def sync_fs(path):
        events.append("sync")
        real_sync(path)
    monkeypatch.setattr(os, "fsync", fsync)
    monkeypatch.setattr(os, "replace", replace)
    monkeypatch.setattr(os, "unlink", unlink)
    monkeypatch.setattr(drive_mod.diskio, "sync_fs", sync_fs)
    mb = metalanes.get()
    for i, obj in enumerate(("a", "K", "K")):
        mb.submit_write(d, "v", obj, fi_for(FileInfo, obj, bytes([i]),
                                            vid=f"{i:032x}")).result()
        events.append("ack")
    monkeypatch.undo()
    assert [e for e in events if e != "fsync"] == [
        "fsync-segment", "rename", "sync", "unlink-segment", "ack"] * 3
    assert segments(d.root) == []


def _segment(path, entries, mtime_ns):
    pay = msgpackx.packb({"v": 1, "entries": entries})
    with open(path, "wb") as f:
        f.write(b"MJ01" + zlib.crc32(pay).to_bytes(4, "big") + pay)
    os.utime(path, ns=(mtime_ns, mtime_ns))


def test_replay_follows_commit_order_not_names(tmp_path):
    """Two processes' segments of one key: the one committed later (its
    modification time) wins, whatever the names' order; the JAX replay
    goes by name."""
    won = {}
    for pkg, drive_cls in (("torch", LocalDrive), ("jax", JaxLocalDrive)):
        d = drive_cls(str(tmp_path / pkg))
        d.make_volume("v")
        jdir = os.path.join(d.root, SYS_VOL, META_JOURNAL_DIR)
        now = time.time_ns()
        # The volume was made before both commits.
        os.utime(os.path.join(d.root, "v"), ns=(now - 3_000_000_000,) * 2)
        for text, name, age in ((b"committed first", "seg-000000000002-7-a",
                                 2_000_000_000),
                                (b"committed last", "seg-000000000001-8-b",
                                 1_000_000_000)):
            meta = XLMeta()
            meta.add_version(fi_for(FileInfo, "K", text))
            _segment(os.path.join(jdir, name), [
                {"vol": "v", "obj": "K", "blob": meta.to_bytes()}],
                now - age)
        assert d.sweep_stale()["meta_journal"] >= 1
        won[pkg] = d.read_version("v", "K").inline_data
    assert won == {"torch": b"committed last", "jax": b"committed first"}


def test_retire_drops_only_the_dead_processes_segments(tmp_path):
    d = LocalDrive(str(tmp_path / "d"))
    d.make_volume("v")
    jdir = os.path.join(d.root, SYS_VOL, META_JOURNAL_DIR)
    for name in ("seg-00000000000000000001-4242-aa",
                 "seg-000000000003-4242-bb", "seg-00000000000000000002-77-cc"):
        _segment(os.path.join(jdir, name), [], time.time_ns())
    assert d.retire_meta_segments(4242) == 2
    assert segments(d.root) == ["seg-00000000000000000002-77-cc"]
    assert d.retire_meta_segments(0) == 0


# -- the breaker and the naughty drive see the batched calls ----------------------

def test_breaker_counts_each_failed_item_of_a_batch(tmp_path, monkeypatch):
    """A drive that fails every laned publish trips its breaker: each
    failed item of write_metadata_many counts as a failed call (the JAX
    wrap saw one clean call per batch and kept the drive healthy)."""
    monkeypatch.setenv("MTPU_BREAKER_ERRS", "2")
    monkeypatch.setenv("MTPU_BREAKER_OFFLINE_ERRS", "4")
    monkeypatch.setenv("MTPU_BREAKER_PROBE_S", "30")
    nd = NaughtyDrive(str(tmp_path / "d"))
    nd.make_volume("v")
    nd.fail_always("write_metadata")
    wd = HealthWrappedDrive(nd)
    try:
        errs = wd.write_metadata_many(
            [("v", f"o{i}", fi_for(FileInfo, f"o{i}", b"x"))
             for i in range(4)])
        assert all(isinstance(e, ErrDiskNotFound) for e in errs)
        assert wd.health_state() == "offline"
        assert wd.api_stats()["write_metadata_many"]["errors"] == 4
    finally:
        wd.close()


def test_breaker_judges_a_batched_call_on_its_whole_time(tmp_path,
                                                        monkeypatch):
    """A stalled drive under batched publishes reaches SUSPECT: every
    item waited the call's whole time, so a slow breach is judged on
    it, not on a per-item share (3 items in 150 ms are no 50 ms
    publishes)."""
    monkeypatch.setenv("MTPU_BREAKER_SLOW_MS", "100")
    monkeypatch.setenv("MTPU_BREAKER_SLOW_CALLS", "2")
    nd = NaughtyDrive(str(tmp_path / "d"))
    nd.make_volume("v")
    nd.slow("write_metadata_many", 0.15)
    wd = HealthWrappedDrive(nd)
    try:
        for call in range(2):
            assert wd.health_state() == "ok"
            assert wd.write_metadata_many(
                [("v", f"o{call}-{i}", fi_for(FileInfo, "o", b"x"))
                 for i in range(3)]) == [None] * 3
        assert wd.health_state() == "suspect"
    finally:
        wd.close()


def test_breaker_counts_failed_reads_but_not_benign_misses(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("MTPU_BREAKER_ERRS", "2")
    nd = NaughtyDrive(str(tmp_path / "d"))
    nd.make_volume("v")
    wd = HealthWrappedDrive(nd)
    try:
        res = wd.read_version_many([("v", f"missing{i}", "")
                                    for i in range(5)])
        assert all(e is not None for _, e in res)
        assert wd.health_state() == "ok"          # not-found is benign
        nd.fail_always("read_version")
        wd.read_version_many([("v", "a", ""), ("v", "b", "")])
        assert wd.health_state() == "suspect"
    finally:
        wd.close()


def test_naughty_program_hits_the_matching_item_of_a_batch(tmp_path):
    nd = NaughtyDrive(str(tmp_path / "d"))
    nd.make_volume("v")
    nd.fail("write_metadata", on_call=2)
    errs = nd.write_metadata_many([("v", f"o{i}", fi_for(FileInfo, f"o{i}",
                                                         bytes([i])))
                                   for i in range(3)])
    assert errs[0] is None and errs[2] is None
    assert isinstance(errs[1], ErrDiskNotFound)
    assert nd.calls["write_metadata"] == 3
    assert nd.calls["write_metadata_many"] == 1
    assert not os.path.exists(os.path.join(nd.root, "v", "o1"))
    nd.fail("read_version", on_call=1)
    res = nd.read_version_many([("v", "o0", ""), ("v", "o2", "")])
    assert res[0][0] is None and isinstance(res[0][1], ErrDiskNotFound)
    assert res[1][0].inline_data == bytes([2])
    assert nd.calls["read_version"] == 2          # each item once


# -- the write round's gate and the read note -------------------------------------

@pytest.mark.parametrize("n,solo", [(1, ""), (2, ""), (3, ""), (1, "1")])
def test_a_write_round_too_small_to_journal_is_handed_back(monkeypatch, n,
                                                           solo):
    """A round of fewer than JOURNAL_MIN_ITEMS publishes is no batch:
    each caller runs its solo call on its own thread.  From three items
    up (or under MTPU_METABATCH_SOLO) the round is one batched call."""
    monkeypatch.setenv("MTPU_METABATCH_SOLO", solo)
    calls = []

    def solo_fn(item):
        calls.append(("solo", item, threading.get_ident()))
        return item

    def batch_fn(items):
        calls.append(("batch", tuple(items), threading.get_ident()))
        return [(it, None) for it in items]
    lane = metalanes.MetaLane("t", solo_fn, batch_fn,
                              metalanes.JOURNAL_MIN_ITEMS)
    handles = [metalanes.MetaHandle() for _ in range(n)]
    got = {}

    def caller(i):
        got[i] = (handles[i].result(), threading.get_ident())
    ts = [threading.Thread(target=caller, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    lane._dispatch(list(zip(range(n), handles)))
    for t in ts:
        t.join()
    assert {i: r for i, (r, _) in got.items()} == {i: i for i in range(n)}
    if n >= metalanes.JOURNAL_MIN_ITEMS or solo:
        assert [c[:2] for c in calls] == [("batch", tuple(range(n)))]
        assert lane.stats()["handed_back"] == 0
    else:
        assert sorted(c[:2] for c in calls) == [("solo", i)
                                                for i in range(n)]
        assert {c[1]: c[2] for c in calls} == {i: tid for i, (_, tid)
                                               in got.items()}
        st = lane.stats()
        assert (st["handed_back"], st["inline_ops"]) == (n, n)
        assert not lane.busy() or lane._ema > 1.05


def test_a_request_counts_once_on_the_read_plane(tmp_path, monkeypatch):
    """A lone HEAD through the S3 handler notes one read in flight (the
    handler's note and the engine's are one), so the idle plane takes
    the full fan-out; the handler sets the sets' trim parity from the
    STANDARD storage class."""
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.server.handlers import S3Handlers
    monkeypatch.setenv("MTPU_STORAGE_CLASS_STANDARD", "EC:1")
    pools = ServerPools([ErasureSets(
        [LocalDrive(str(tmp_path / f"d{i}")) for i in range(6)],
        set_drive_count=6, device="cpu")])
    try:
        h = S3Handlers(pools)
        es = pools.pools[0].sets[0]
        assert (es.default_parity, es.trim_parity) == (3, 1)
        pools.make_bucket("b")
        pools.put_object("b", "k", body(3000, 8))
        mb = metalanes.get()
        seen = []
        real = es._read_version_fanout

        def fanout(*a):
            seen.append((mb._inflight_reads, mb.read_hot()))
            return real(*a)
        monkeypatch.setattr(es, "_read_version_fanout", fanout)
        resp = h.get_object("b", "k", {}, {}, head=True)
        assert resp.status == 200
        assert seen and all(x == (1, False) for x in seen)
        assert mb._inflight_reads == 0
        with mb.reading():
            with mb.reading():
                assert mb._inflight_reads == 1
        assert mb._inflight_reads == 0
    finally:
        pools.close()


# -- the engine: laned publishes and elections ------------------------------------

def _pin_time(monkeypatch):
    import minio_tpu.engine.erasure_set as jax_es_mod
    monkeypatch.setattr(es_mod, "_now_ns", lambda: STAMP)
    monkeypatch.setattr(jax_es_mod, "_now_ns", lambda: STAMP, raising=False)


def _burst(es, clients=6, per=5, seed=11):
    """Concurrent inline PUTs of 4-64 KiB bodies; returns the bodies."""
    rng = np.random.default_rng(seed)
    plan = [[(f"c{c}/o{i}", body(int(rng.integers(4 * KIB, 64 * KIB)),
                                 seed * 1000 + c * 100 + i))
             for i in range(per)] for c in range(clients)]
    errors = []

    def run(objs):
        try:
            for key, data in objs:
                es.put_object("b", key, data, version_id="",
                              mod_time_ns=STAMP)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
    ts = [threading.Thread(target=run, args=(objs,)) for objs in plan]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors, errors
    return {k: v for objs in plan for k, v in objs}


def _disk_state(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        if SYS_VOL in dirpath:
            continue
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _responses(es, bodies, concurrent: bool):
    """HEAD and GET of every key (from threads when `concurrent`):
    (etag, size, body) per key."""
    out = {}

    def one(key):
        fi = es.head_object("b", key)
        _, got = es.get_object("b", key)
        out[key] = (fi.metadata.get("etag"), fi.size, bytes(got))
    keys = sorted(bodies)
    if concurrent:
        ts = [threading.Thread(target=lambda ks=keys[i::4]: [one(k)
                                                           for k in ks])
              for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    else:
        for key in keys:
            one(key)
    return out


def test_burst_gives_the_same_disk_and_responses_lanes_on_off_and_jax(
        tmp_path, monkeypatch):
    """A concurrent burst of inline PUTs, then concurrent HEAD + GET:
    the same xl.meta bytes on every drive and the same responses with
    the lanes on (engaged by the burst's concurrency, and forced with
    MTPU_METABATCH_SOLO=1: every publish group-committed), with
    MTPU_METABATCH=0 (no group commit), and in the JAX package."""
    _pin_time(monkeypatch)
    states, answers = {}, {}
    for mode, env in (("1", {}), ("solo", {"MTPU_METABATCH_SOLO": "1"}),
                      ("0", {"MTPU_METABATCH": "0"})):
        for name in ("MTPU_METABATCH", "MTPU_METABATCH_SOLO"):
            monkeypatch.delenv(name, raising=False)
        for name, v in env.items():
            monkeypatch.setenv(name, v)
        metalanes.reset()
        st0 = drive_mod.stats()
        root = tmp_path / f"torch-{mode}"
        with ErasureSet([LocalDrive(str(root / f"d{i}")) for i in range(6)],
                        default_parity=2, device="cpu") as es:
            es._FI_CACHE_TTL = 0.0
            es.make_bucket("b")
            bodies = _burst(es)
            st1 = drive_mod.stats()
            commits = st1["meta_group_commits"] - st0["meta_group_commits"]
            if mode != "1":
                assert (commits > 0) == (mode == "solo")
            answers[mode] = _responses(es, bodies, concurrent=True)
        states[mode] = _disk_state(root)
    for name in ("MTPU_METABATCH", "MTPU_METABATCH_SOLO"):
        monkeypatch.delenv(name, raising=False)
    jroot = tmp_path / "jax"
    jes = JaxErasureSet([JaxLocalDrive(str(jroot / f"d{i}"))
                         for i in range(6)], default_parity=2)
    try:
        jes.make_bucket("b")
        jbodies = _burst(jes)
        answers["jax"] = _responses(jes, jbodies, concurrent=False)
    finally:
        jes.pool.shutdown(wait=True)
        jes._iter_pool.shutdown(wait=True)
    states["jax"] = _disk_state(jroot)
    assert states["1"] == states["solo"] == states["0"] == states["jax"]
    assert answers["1"] == answers["solo"] == answers["0"] == answers["jax"]
    assert all(a[2] == bodies[k] for k, a in answers["1"].items())


def test_queued_publishes_share_one_journal_fsync(tmp_path, monkeypatch):
    """Publishes queued behind a busy write lane go to the drive in one
    write_metadata_many call: one journal fsync for all of them."""
    monkeypatch.setenv("MTPU_METABATCH_SOLO", "1")
    release = threading.Event()
    batches = []
    with ErasureSet([LocalDrive(str(tmp_path / f"d{i}")) for i in range(4)],
                    default_parity=2, device="cpu") as es:
        es.make_bucket("b")
        d0 = es.drives[0]
        real = d0.write_metadata_many

        def gated(items):
            batches.append(len(items))
            if len(batches) == 1:
                release.wait(30)
            return real(items)
        d0.write_metadata_many = gated
        bodies = {f"k{i}": body(5000 + i, 30 + i) for i in range(5)}
        ts = [threading.Thread(target=es.put_object, args=("b", k, v))
              for k, v in bodies.items()]
        ts[0].start()
        while not batches:
            time.sleep(0.005)
        for t in ts[1:]:
            t.start()
        lane = metalanes.get().write_lane(d0)
        deadline = time.monotonic() + 30
        while lane.stats()["pending"] < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        release.set()
        for t in ts:
            t.join()
        assert batches == [1, 4]
        assert lane.stats()["max_items"] == 4
        for k, v in bodies.items():
            assert bytes(es.get_object("b", k)[1]) == v


def test_solo_forced_lone_put_goes_through_the_journal(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("MTPU_METABATCH_SOLO", "1")
    st0 = drive_mod.stats()
    with ErasureSet([LocalDrive(str(tmp_path / f"d{i}")) for i in range(4)],
                    default_parity=2, device="cpu") as es:
        es.make_bucket("b")
        data = body(3000, 4)
        es.put_object("b", "k", data)
        st1 = drive_mod.stats()
        assert st1["meta_group_commits"] - st0["meta_group_commits"] == 4
        assert bytes(es.get_object("b", "k")[1]) == data
        assert all(segments(d.root) == [] for d in es.drives)


@pytest.fixture
def primed(tmp_path):
    made = []

    def make(root="s"):
        es = ErasureSet([LocalDrive(str(tmp_path / root / f"d{i}"))
                         for i in range(6)], default_parity=2, device="cpu")
        made.append(es)
        es._FI_CACHE_TTL = 0.0
        es.make_bucket("b")
        es.put_object("b", "small", body(4096, 5))
        es.put_object("b", "big", body(300 * KIB + 3, 6))
        return es
    yield make
    for es in made:
        es.close()


def _hot(fn):
    """Run `fn` with concurrent readers noted in flight: the trim
    engages only on a hot read plane."""
    mb = metalanes.get()
    mb.note_read(2)
    try:
        return fn()
    finally:
        mb.note_read(-2)


@pytest.mark.parametrize("key", ["small", "big"])
def test_trim_against_the_all_n_fan_out(primed, monkeypatch, key):
    """The trimmed election equals the all-N one (and the JAX package's
    on the same drives); an inline object's trimmed read reads K+1
    drives, those holding its shards 0..K, lists the rest as unread
    and is no degraded read; a streaming object widens to every
    drive."""
    es = primed()
    got = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("MTPU_META_TRIM", flag)
        c0 = metalanes.counters()
        fi, metas = _hot(lambda: es._read_metadata("b", key))
        c1 = metalanes.counters()
        got[flag] = (fi.to_obj(), _hot(lambda: bytes(
            es.get_object("b", key)[1])))
        assert isinstance(metas, Metas)
        assert not es._degraded(metas)
        read = [pos for pos, m in enumerate(metas) if m is not None]
        if flag == "1" and key == "small":
            k = es.n - es.default_parity
            assert len(read) == k + 1 and len(metas.unread) == es.n - k - 1
            assert sorted(fi.erasure.distribution[p] for p in read) == \
                list(range(1, k + 2))
            assert c1["trim_hits"] - c0["trim_hits"] == 1
        else:
            assert len(read) == es.n and not metas.unread
        if flag == "1" and key == "big":
            assert c1["trim_fallbacks"] - c0["trim_fallbacks"] == 1
    assert got["1"] == got["0"]
    jes = JaxErasureSet([JaxLocalDrive(d.root) for d in es.drives],
                        default_parity=2)
    try:
        jfi, _, _ = jes._read_metadata("b", key)
        assert jfi.to_obj() == got["1"][0]
    finally:
        jes.pool.shutdown(wait=True)
        jes._iter_pool.shutdown(wait=True)


def test_trim_with_a_failed_drive_falls_back_and_reads(primed, monkeypatch):
    monkeypatch.setenv("MTPU_META_TRIM", "1")
    es = primed()
    want = bytes(es.get_object("b", "small")[1])
    fi0, _ = es._read_metadata("b", "small")
    data_pos = fi0.erasure.distribution.index(1)     # holds shard 0
    es.drives[data_pos] = None
    c0 = metalanes.counters()
    fi, metas = _hot(lambda: es._read_metadata("b", "small"))
    assert metalanes.counters()["trim_fallbacks"] - c0["trim_fallbacks"] == 1
    assert not metas.unread and es._degraded(metas)
    assert fi.to_obj() == fi0.to_obj()
    assert _hot(lambda: bytes(es.get_object("b", "small")[1])) == want
    with pytest.raises(ErrObjectNotFound):
        _hot(lambda: es._read_metadata("b", "missing"))


def test_idle_plane_takes_the_full_fan_out(primed, monkeypatch):
    monkeypatch.setenv("MTPU_META_TRIM", "1")
    es = primed()
    fi, metas = es._read_metadata("b", "small")
    assert all(m is not None for m in metas) and not metas.unread


def test_trimmed_election_in_the_fileinfo_cache_is_no_missing_drive(
        primed, monkeypatch):
    """A trimmed election stored in the FileInfo cache serves the next
    GET of the inline object with the device work of an all-N election:
    the data shards it reads are the ones the trim read."""
    from minio_tpu_torch.ops import fused
    es = primed()
    es._FI_CACHE_TTL = 30.0
    want = body(4096, 5)
    items = []
    for flag in ("1", "0"):
        monkeypatch.setenv("MTPU_META_TRIM", flag)
        es._fi_cache.clear()
        _hot(lambda: es.head_object("b", "small"))
        i0 = dict(fused.ITEMS)
        assert bytes(es.get_object("b", "small")[1]) == want
        items.append({k: v - i0[k] for k, v in fused.ITEMS.items()})
    assert items[0] == items[1] and items[0]["gf_matmul"] == 0
