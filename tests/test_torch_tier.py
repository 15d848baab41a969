"""The tier of the port (minio_tpu_torch/bucket/tier.py, its server and
scanner hooks; device="cpu") held to the JAX package's.  Tolerance:
exact (equal bytes, stub metadata, tier objects and journal records).

- One seeded script on both packages, each over its own copy of the same
  drives: transitions, full and ranged read-through, a temporary and a
  permanent restore, the scanner's re-expiry, deletes freed through the
  journal; `uuid` and `time` pinned in both tier modules.
- State across packages: a stub, a tier config and a journal one
  package wrote are served and replayed by the other, both ways.
- The journal: a torn last line, equal folds in both packages, records
  of another process kept by a compaction, and the four `ilm.*` crash
  points in subprocesses (`MTPU_CRASH`), each resolved by the next boot.
- The backends: S3TierBackend against an in-process port server over
  loopback, PoolTierBackend over a second object layer, ChaosTierBackend.
- Lifecycle expiry freeing a tier copy, the scanner's transitions,
  re-expiry and journal drain, and MTPU_ILM=0 moving nothing.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time as real_time
import uuid as real_uuid
from types import SimpleNamespace

import numpy as np
import pytest

import minio_tpu.bucket.lifecycle as jax_lc
import minio_tpu.bucket.tier as jax_tier
import minio_tpu_torch.bucket.lifecycle as port_lc
import minio_tpu_torch.bucket.tier as port_tier
from minio_tpu.engine.pools import ServerPools as JaxServerPools
from minio_tpu.engine.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.background.scanner import DataScanner
from minio_tpu_torch.background.usage import DirtyTracker
from minio_tpu_torch.bucket.metadata import BucketMetadataSys
from minio_tpu_torch.engine.pools import ServerPools
from minio_tpu_torch.engine.sets import ErasureSets
from minio_tpu_torch.storage.drive import LocalDrive
from test_torch_server import close_pools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT, SECRET = "tieradmin", "tieradmin-secret"
NOW = 1_800_000_000.0
DAY = 86400.0


def _jax_pools(root):
    drives = [JaxLocalDrive(str(root / f"d{i}")) for i in range(4)]
    return JaxServerPools([JaxErasureSets(drives, set_drive_count=4)])


def _port_pools(root):
    drives = [LocalDrive(str(root / f"d{i}")) for i in range(4)]
    return ServerPools([ErasureSets(drives, set_drive_count=4,
                                    device="cpu")])


JAX = SimpleNamespace(name="jax", tier=jax_tier, lc=jax_lc,
                      pools=_jax_pools)
PORT = SimpleNamespace(name="port", tier=port_tier, lc=port_lc,
                       pools=_port_pools)


class _Clock:
    """A `time` module stand-in whose time() the test moves."""

    def __init__(self, now: float):
        self.now = now
        self.sleep = real_time.sleep
        self.monotonic = real_time.monotonic
        self.perf_counter = real_time.perf_counter
        self.time_ns = real_time.time_ns

    def time(self) -> float:
        return self.now


class _UUIDs:
    """Sequential uuid4s: both packages draw the same tier keys."""

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        return real_uuid.UUID(int=self.n)


@pytest.fixture()
def pinned(monkeypatch):
    clock = _Clock(NOW)
    for mod in (jax_tier, port_tier):
        monkeypatch.setattr(mod, "time", clock)
        monkeypatch.setattr(mod, "uuid", _UUIDs())
    return clock


@pytest.fixture(autouse=True)
def _no_bound_tracker():
    yield
    DirtyTracker.shared().bind(None)


def _payload(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).bytes(n)


def _strip_owner(recs):
    """Journal records without the port's `owner` (the JAX intent has
    none; the fold ignores it)."""
    return [{k: v for k, v in r.items() if k != "owner"} for r in recs]


def _journal_lines(path):
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _tier_files(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


# -- one script, both packages ---------------------------------------------------

_OBJECTS = (("cold/a", 300_000), ("cold/b", 1_000_003), ("cold/c", 1),
            ("hot/d", 200_000), ("cold/v", 250_000))


def _seed_drives(root):
    """The shared starting drives, written by the JAX package: a
    versioned and an unversioned bucket."""
    pools = _jax_pools(root)
    try:
        pools.make_bucket("tb")
        pools.make_bucket("vb")
        for i, (key, n) in enumerate(_OBJECTS):
            if key == "cold/v":
                pools.put_object("vb", key, _payload(i, n), versioned=True)
                pools.put_object("vb", key, _payload(50 + i, n // 2),
                                 versioned=True)
            else:
                pools.put_object("tb", key, _payload(i, n))
    finally:
        close_pools(pools)


def _script(pkg, root):
    """What one package does and reads; returns every observation."""
    out = []
    pools = pkg.pools(root)
    warm = str(root / "warm")
    try:
        tm = pkg.tier.TierManager(pools)
        tm.add_tier("warm", pkg.tier.DirTierBackend(warm),
                    config={"type": "fs", "path": warm})
        lc = pkg.lc.Lifecycle.parse(
            b"<LifecycleConfiguration><Rule><Status>Enabled</Status>"
            b"<Filter><Prefix>cold/</Prefix></Filter><Transition><Days>10"
            b"</Days><StorageClass>WARM</StorageClass></Transition></Rule>"
            b"</LifecycleConfiguration>")
        out.append(pkg.tier.run_transitions(pools, "tb", lc, tm,
                                            now=NOW + 11 * DAY,
                                            workers=1))
        out.append(pkg.tier.run_transitions(pools, "vb", lc, tm,
                                            now=NOW + 11 * DAY,
                                            workers=1))
        versions = pools.list_object_versions("vb", "cold/v")
        old_vid = versions[-1].version_id
        out.append(tm.transition_object("vb", "cold/v", "WARM", old_vid))
        for bucket, key, vid in (("tb", "cold/a", ""), ("tb", "cold/b", ""),
                                 ("tb", "cold/c", ""), ("tb", "hot/d", ""),
                                 ("vb", "cold/v", ""),
                                 ("vb", "cold/v", old_vid)):
            fi, body = pools.get_object(bucket, key, version_id=vid)
            meta = dict(fi.metadata)
            out.append((bucket, key, fi.size, bytes(body), meta))
            if tm.is_transitioned(fi):
                out.append(tm.read_through(fi))
                size = int(meta[pkg.tier.TIER_SIZE_KEY])
                for off, ln in ((0, 1), (size // 3, size // 2),
                                (size - 1, 1)):
                    out.append(b"".join(tm.read_through_iter(fi, off, ln)))
        out.append(_tier_files(warm))
        # A temporary restore, then the window passes.
        out.append(tm.restore_object("tb", "cold/a", days=2))
        fi, body = pools.get_object("tb", "cold/a")
        out.append((fi.size, bytes(body) == _payload(0, 300_000),
                    tm.restore_fresh(fi), dict(fi.metadata)))
        out.append(tm.expire_restores("tb", now=NOW + DAY))
        out.append(tm.expire_restores("tb", now=NOW + 3 * DAY))
        fi, body = pools.get_object("tb", "cold/a")
        out.append((fi.size, bytes(body), dict(fi.metadata)))
        # A permanent restore frees the tier copy.
        out.append(tm.restore_object("tb", "cold/b"))
        fi, body = pools.get_object("tb", "cold/b")
        out.append((bytes(body) == _payload(1, 1_000_003),
                    dict(fi.metadata)))
        out.append(tm.restore_object("tb", "hot/d"))
        # A hard delete of a stub, through the hook the server calls.
        fi = pools.head_object("vb", "cold/v", old_vid)
        pools.delete_object("vb", "cold/v", old_vid, True)
        tm.on_version_deleted(fi)
        out.append(_tier_files(warm))
        st = tm.stats()
        out.append({k: st[k] for k in (
            "transitioned", "transition_bytes", "restored", "restore_bytes",
            "restore_expired", "read_through", "read_through_bytes",
            "freed", "journal_pending", "tiers", "names")})
        out.append(_strip_owner(_journal_lines(
            pkg.tier.default_journal_path(pools))))
    finally:
        close_pools(pools)
    return out


def test_tier_script_matches_jax(tmp_path, pinned):
    _seed_drives(tmp_path / "seed")
    got = {}
    for pkg in (JAX, PORT):
        shutil.copytree(tmp_path / "seed", tmp_path / pkg.name)
        pinned.now = NOW
        for mod in (jax_tier, port_tier):
            mod.uuid.n = 0
        got[pkg.name] = _script(pkg, tmp_path / pkg.name)
    jax_out, port_out = got["jax"], got["port"]
    assert len(port_out) == len(jax_out)
    for i, (j, p) in enumerate(zip(jax_out, port_out)):
        assert p == j, i
    # What the script saw, spelled out for the port.
    assert port_out[:3] == [3, 1, True]
    stats = port_out[-2]
    assert (stats["transitioned"], stats["restored"], stats["freed"],
            stats["restore_expired"], stats["journal_pending"]) == \
        (5, 2, 2, 1, 0)


# -- state across packages --------------------------------------------------------

def _leave_crash_state(pkg, root, warm):
    """A transitioned object, an orphan tier copy with its intent, and a
    pending free: what a crash leaves for the next boot."""
    pools = pkg.pools(root)
    try:
        tm = pkg.tier.TierManager(pools)
        tm.add_tier("WARM", pkg.tier.DirTierBackend(warm),
                    config={"type": "fs", "path": warm})
        pools.make_bucket("xb")
        pools.put_object("xb", "stub", _payload(7, 400_000))
        pools.put_object("xb", "hot", _payload(8, 150_000))
        assert tm.transition_object("xb", "stub", "WARM")
        backend = tm.get_tier("WARM")
        backend.put("xb/orphan", b"dead bytes")
        tm.journal.record({"op": "intent", "tkey": "xb/orphan",
                           "tier": "WARM", "bucket": "xb", "key": "hot",
                           "vid": "", "size": 150_000})
        backend.put("xb/freed-late", b"garbage")
        tm.enqueue_delete("WARM", "xb/freed-late", 7)
    finally:
        close_pools(pools)


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_stub_config_and_journal_cross_packages(tmp_path, writer, reader):
    warm = str(tmp_path / "warm")
    _leave_crash_state(writer, tmp_path, warm)
    left = sorted(os.listdir(warm))
    assert len(left) == 3 and {"xb_freed-late", "xb_orphan"} < set(left)
    pools = reader.pools(tmp_path)
    try:
        tm = reader.tier.TierManager(pools)      # the recovery boot
        assert tm.list_tiers() == ["WARM"]
        st = tm.stats()
        assert (st["orphans_reaped"], st["freed"], st["journal_pending"]) \
            == (1, 1, 0)
        left = os.listdir(warm)
        assert len(left) == 1 and left[0].startswith("xb_")
        fi, body = pools.get_object("xb", "stub")
        assert tm.is_transitioned(fi) and bytes(body) == b""
        assert tm.read_through(fi) == _payload(7, 400_000)
        assert bytes(pools.get_object("xb", "hot")[1]) == \
            _payload(8, 150_000)
        assert tm.restore_object("xb", "stub")
        assert os.listdir(warm) == []
        assert bytes(pools.get_object("xb", "stub")[1]) == \
            _payload(7, 400_000)
    finally:
        close_pools(pools)


# -- the journal ------------------------------------------------------------------

def test_torn_tail_folds_alike(tmp_path):
    path = str(tmp_path / "j" / "tier-journal.jsonl")
    os.makedirs(os.path.dirname(path))
    recs = [{"op": "intent", "tkey": "b/1", "tier": "W", "bucket": "b",
             "key": "k", "vid": "", "size": 3},
            {"op": "free", "tier": "W", "tkey": "b/2", "size": 4},
            {"op": "intent", "tkey": "b/3", "tier": "W", "bucket": "b",
             "key": "k3", "vid": "", "size": 5},
            {"op": "done", "tkey": "b/1"}]
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
        f.write('{"op":"freed","tk')
    folds = []
    for mod in (jax_tier, port_tier):
        j = mod.TierJournal(path, fsync=False)
        folds.append((j.torn_lines, j.intents, j.frees, j.pending()))
    assert folds[0] == folds[1]
    assert folds[1][0] == 1 and folds[1][3] == 2


def test_a_compaction_keeps_another_process_records(tmp_path):
    """Two journals over one file (two workers): each compaction folds
    the file, so neither drops the other's pending records; an append
    after the other's compaction lands in the new file.  A JAX journal
    compacts its own fold and drops them."""
    path = str(tmp_path / "tier-journal.jsonl")
    a = port_tier.TierJournal(path, fsync=False)
    b = port_tier.TierJournal(path, fsync=False)
    a.record({"op": "free", "tier": "W", "tkey": "b/from-a"})
    b.record({"op": "free", "tier": "W", "tkey": "b/from-b"})
    a.checkpoint()
    b.record({"op": "free", "tier": "W", "tkey": "b/after"})
    b.checkpoint()
    a.record({"op": "freed", "tkey": "b/from-b"})
    fresh = port_tier.TierJournal(path, fsync=False)
    assert sorted(fresh.frees) == ["b/after", "b/from-a"]
    # The JAX journals over a copy of the same history lose a record.
    jpath = str(tmp_path / "jax.jsonl")
    ja = jax_tier.TierJournal(jpath, fsync=False)
    jb = jax_tier.TierJournal(jpath, fsync=False)
    ja.record({"op": "free", "tier": "W", "tkey": "b/from-a"})
    jb.record({"op": "free", "tier": "W", "tkey": "b/from-b"})
    ja.checkpoint()
    assert sorted(jax_tier.TierJournal(jpath).frees) == ["b/from-a"]


def test_the_journal_lives_on_a_local_drive(tmp_path):
    """A cluster node's first drives are its peers': the journal goes on
    its first local drive, never under a path named after a peer."""
    def drive(root):
        return SimpleNamespace(root=root)
    local = tmp_path / "n2" / "d1"
    local.mkdir(parents=True)
    pools = SimpleNamespace(pools=[SimpleNamespace(sets=[SimpleNamespace(
        drives=[None, drive("http://127.0.0.1:9/tmp/n1/d1"),
                drive("127.0.0.1:9/drive1"), drive(str(local))])])])
    assert port_tier.default_journal_path(pools) == os.path.join(
        str(local), ".mtpu.sys", "tier-journal.jsonl")
    pools.pools[0].sets[0].drives.pop()
    assert port_tier.default_journal_path(pools) is None


def test_concurrent_journals_lose_no_record(tmp_path):
    """More writers than cores, each its own journal over one file (as
    the pool's workers have), compacting every 5 appends, with a short
    switch interval: every record of every writer is in the final fold
    (a compaction of one writer's fold would drop the others')."""
    import threading
    path = str(tmp_path / "tier-journal.jsonl")
    writers, per = 2 * (os.cpu_count() or 4), 30
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def write(w):
            j = port_tier.TierJournal(path, fsync=False, ckpt_every=5)
            for i in range(per):
                j.record({"op": "free", "tier": "W", "tkey": f"b/{w}-{i}"})
            j.close()
        threads = [threading.Thread(target=write, args=(w,))
                   for w in range(writers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(port_tier.TierJournal(path).frees) == writers * per


def test_an_intent_of_a_live_process_is_not_reaped(tmp_path):
    """A transition another live process runs (its intent names that
    process) survives a drain here; once that process is gone the
    intent is an orphan and is reaped."""
    pools = _port_pools(tmp_path)
    warm = str(tmp_path / "warm")
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    try:
        tm = port_tier.TierManager(pools)
        tm.add_tier("WARM", port_tier.DirTierBackend(warm))
        tm.get_tier("WARM").put("b/live", b"copy in flight")
        start = port_tier._proc_start(child.pid)
        tm.journal.record({"op": "intent", "tkey": "b/live", "tier": "WARM",
                           "bucket": "b", "key": "k", "vid": "",
                           "size": 14, "owner": f"{child.pid}:{start}"})
        tm.drain_journal()
        assert os.listdir(warm) == ["b_live"]
        assert tm.journal.pending() == 1
        child.kill()
        child.wait(timeout=30)
        tm.drain_journal()
        assert os.listdir(warm) == [] and tm.journal.pending() == 0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
        close_pools(pools)


_CRASH_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    from minio_tpu_torch.bucket import tier
    from minio_tpu_torch.engine.pools import ServerPools
    from minio_tpu_torch.engine.sets import ErasureSets
    from minio_tpu_torch.storage.drive import LocalDrive
    root, warm, point = sys.argv[1], sys.argv[2], sys.argv[3]
    drives = [LocalDrive(f"{{root}}/d{{i}}") for i in range(4)]
    pools = ServerPools([ErasureSets(drives, set_drive_count=4,
                                     device="cpu")])
    tm = tier.TierManager(pools)
    tm.add_tier("WARM", tier.DirTierBackend(warm),
                config={{"type": "fs", "path": warm}}, replace=True)
    if point == "ilm.pre_delete":
        fi = pools.head_object("cb", "obj")
        pools.delete_object("cb", "obj")
        tm.on_version_deleted(fi)
    else:
        tm.transition_object("cb", "obj", "WARM")
    print("survived", flush=True)
""")


def test_the_four_crash_points_resolve_on_the_next_boot(tmp_path):
    """A process dies (137) at each ilm.* point; the next TierManager
    over its drives leaves the whole hot version (pre_stub, post_copy)
    or the stub it published (checkpoint), reaps the orphan copy, and
    retries the free a death before the delete left (pre_delete)."""
    data = _payload(3, 300_000)
    runs = {}
    for point in ("ilm.pre_stub", "ilm.post_copy", "ilm.checkpoint",
                  "ilm.pre_delete"):
        root = tmp_path / point
        pools = _port_pools(root)
        try:
            pools.make_bucket("cb")
            pools.put_object("cb", "obj", data)
            if point == "ilm.pre_delete":
                tm = port_tier.TierManager(pools)
                tm.add_tier("WARM", port_tier.DirTierBackend(
                    str(root / "warm")),
                    config={"type": "fs", "path": str(root / "warm")})
                assert tm.transition_object("cb", "obj", "WARM")
        finally:
            close_pools(pools)
        script = root / "crash.py"
        script.write_text(_CRASH_SCRIPT.format(repo=REPO))
        env = dict(os.environ, MTPU_CRASH=point, CUDA_VISIBLE_DEVICES="")
        runs[point] = subprocess.Popen(
            [sys.executable, str(script), str(root), str(root / "warm"),
             point], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
    for point, proc in runs.items():
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 137, (point, err[-2000:])
        assert b"survived" not in out
        assert f"dying at {point}".encode() in err
        root = tmp_path / point
        warm = str(root / "warm")
        pools = _port_pools(root)
        try:
            tm = port_tier.TierManager(pools)
            st = tm.stats()
            assert st["journal_pending"] == 0, point
            if point == "ilm.pre_delete":
                assert st["freed"] == 1 and os.listdir(warm) == []
                with pytest.raises(Exception):
                    pools.head_object("cb", "obj")
                continue
            fi, body = pools.get_object("cb", "obj")
            if point == "ilm.checkpoint":
                assert tm.is_transitioned(fi) and bytes(body) == b""
                assert tm.read_through(fi) == data
                assert len(os.listdir(warm)) == 1
            else:
                assert not tm.is_transitioned(fi) and bytes(body) == data
                assert os.listdir(warm) == []
                assert st["orphans_reaped"] == 1       # the intent
        finally:
            close_pools(pools)


# -- the backends -----------------------------------------------------------------

def test_s3_and_pool_backends_over_the_port(tmp_path):
    """S3TierBackend against an in-process port server over loopback,
    PoolTierBackend over a second object layer: a transition through
    each, read back full and ranged, freed by a restore."""
    from minio_tpu_torch.server.client import S3Client
    from minio_tpu_torch.server.server import S3Server
    from minio_tpu_torch.server.sigv4 import Credentials
    remote = _port_pools(tmp_path / "remote")
    cold = _port_pools(tmp_path / "cold")
    hot = _port_pools(tmp_path / "hot")
    srv = S3Server(remote, Credentials(ROOT, SECRET)).start()
    try:
        S3Client(srv.endpoint, ROOT, SECRET, timeout=30).make_bucket("warm")
        s3b = port_tier.S3TierBackend(srv.endpoint, ROOT, SECRET, "warm")
        s3b.put("k1", b"tiered bytes")
        assert s3b.get("k1") == b"tiered bytes" and s3b.size("k1") == 12
        assert b"".join(s3b.get_stream("k1", 3, 5)) == b"red b"
        s3b.delete("k1")
        s3b.delete("k1")                         # absent: no error
        with pytest.raises(port_tier.ErrObjectNotFound):
            s3b.get("k1")
        tm = port_tier.TierManager(hot)
        tm.add_tier("S3", s3b)
        tm.add_tier("POOL", port_tier.PoolTierBackend(cold))
        hot.make_bucket("hb")
        for i, name in enumerate(("S3", "POOL")):
            data = _payload(20 + i, 700_001)
            hot.put_object("hb", name, data)
            assert tm.transition_object("hb", name, name)
            fi = hot.head_object("hb", name)
            assert tm.read_through(fi) == data
            assert b"".join(tm.read_through_iter(fi, 1000, 4096)) == \
                data[1000:5096]
            assert tm.restore_object("hb", name)
            assert bytes(hot.get_object("hb", name)[1]) == data
        assert remote.list_objects("warm") == []
        assert cold.list_objects(port_tier.PoolTierBackend.TIER_BUCKET) \
            == []
    finally:
        srv.shutdown()
        for p in (remote, cold, hot):
            close_pools(p)


def test_a_failing_tier_leaves_the_hot_version_and_drains_later(tmp_path):
    """ChaosTierBackend failing every call: the transition raises
    ErrTierUnavailable and the hot version stays; once the tier is back
    the drain reaps the partial copy and a retry moves the object."""
    pools = _port_pools(tmp_path)
    try:
        tm = port_tier.TierManager(pools)
        chaos = port_tier.ChaosTierBackend(
            port_tier.DirTierBackend(str(tmp_path / "warm")), seed=1,
            error_rate=1.0)
        tm.add_tier("WARM", chaos)
        pools.make_bucket("fb")
        data = _payload(5, 200_000)
        pools.put_object("fb", "o", data)
        with pytest.raises(port_tier.ErrTierUnavailable):
            tm.transition_object("fb", "o", "WARM")
        assert bytes(pools.get_object("fb", "o")[1]) == data
        assert tm.journal.pending() == 1 and chaos.injected["errors"] >= 1
        chaos.chaos_off()
        tm.drain_journal()
        assert tm.journal.pending() == 0
        assert tm.transition_object("fb", "o", "WARM")
        assert tm.read_through(pools.head_object("fb", "o")) == data
    finally:
        close_pools(pools)


# -- lifecycle and the scanner ------------------------------------------------------

def test_lifecycle_expiry_frees_the_tier_copy_as_jax_does(tmp_path):
    out = {}
    for pkg in (JAX, PORT):
        root = tmp_path / pkg.name
        pools = pkg.pools(root)
        warm = str(root / "warm")
        try:
            tm = pkg.tier.TierManager(pools)
            tm.add_tier("WARM", pkg.tier.DirTierBackend(warm))
            pools.make_bucket("eb")
            pools.put_object("eb", "gone/x", _payload(9, 220_000))
            pools.put_object("eb", "keep/y", _payload(10, 220_000))
            assert tm.transition_object("eb", "gone/x", "WARM")
            assert tm.transition_object("eb", "keep/y", "WARM")
            lc = pkg.lc.Lifecycle.parse(
                b"<LifecycleConfiguration><Rule><Status>Enabled</Status>"
                b"<Filter><Prefix>gone/</Prefix></Filter><Expiration>"
                b"<Days>1</Days></Expiration></Rule>"
                b"</LifecycleConfiguration>")
            stats = pkg.lc.apply_lifecycle(pools, "eb", lc,
                                           now=real_time.time() + 2 * DAY,
                                           tier_mgr=tm)
            out[pkg.name] = (stats, len(os.listdir(warm)),
                             sorted(fi.name for fi in
                                    pools.list_objects("eb")),
                             tm.stats()["freed"])
        finally:
            close_pools(pools)
    assert out["port"] == out["jax"]
    assert out["port"][1:] == (1, ["keep/y"], 1)


def test_scanner_transitions_reexpires_and_drains(tmp_path, monkeypatch):
    """One scanner cycle with the clock past the rule's days tiers every
    matching object; a temporary restore is re-expired by a cycle with
    the clock past its window; a free that failed while the tier was
    down is retried by the next cycle."""
    clock = _Clock(real_time.time())
    monkeypatch.setattr(port_lc, "time", clock)
    monkeypatch.setattr(port_tier, "time", clock)
    pools = _port_pools(tmp_path)
    sc = None
    try:
        meta = BucketMetadataSys(pools)
        tm = port_tier.TierManager(pools)
        chaos = port_tier.ChaosTierBackend(
            port_tier.DirTierBackend(str(tmp_path / "warm")))
        tm.add_tier("WARM", chaos)
        pools.make_bucket("sb")
        datas = {f"o{i}": _payload(30 + i, 150_000 + i) for i in range(4)}
        for k, v in datas.items():
            pools.put_object("sb", k, v)
        meta.put("sb", "lifecycle", (
            b"<LifecycleConfiguration><Rule><Status>Enabled</Status>"
            b"<Filter/><Transition><Days>5</Days><StorageClass>WARM"
            b"</StorageClass></Transition></Rule>"
            b"</LifecycleConfiguration>"))
        sc = DataScanner(pools).attach_config(meta, tm)
        sc.scan_cycle()
        assert tm.stats()["transitioned"] == 0   # too young
        clock.now += 6 * DAY
        sc.scan_cycle()
        assert tm.stats()["transitioned"] == 4
        for k, v in datas.items():
            fi = pools.head_object("sb", k)
            assert fi.size == 0 and tm.read_through(fi) == v
        assert tm.restore_object("sb", "o0", days=1)
        sc.scan_cycle()
        assert pools.head_object("sb", "o0").size == len(datas["o0"])
        clock.now += 2 * DAY
        sc.scan_cycle()
        assert pools.head_object("sb", "o0").size == 0
        assert tm.stats()["restore_expired"] == 1
        # A free while the tier is down stays queued, then drains.
        chaos.error_rate = 1.0
        fi = pools.head_object("sb", "o1")
        pools.delete_object("sb", "o1")
        tm.on_version_deleted(fi)
        assert tm.journal.pending() == 1
        chaos.chaos_off()
        sc.scan_cycle()
        assert tm.journal.pending() == 0
        assert len(os.listdir(tmp_path / "warm")) == 3
    finally:
        if sc is not None:
            sc.stop()
        close_pools(pools)


def test_ilm_off_tiers_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("MTPU_ILM", "0")
    pools = _port_pools(tmp_path)
    try:
        tm = port_tier.TierManager(pools)
        tm.add_tier("WARM", port_tier.DirTierBackend(str(tmp_path / "w")))
        pools.make_bucket("ob")
        pools.put_object("ob", "x", _payload(1, 140_000))
        lc = port_lc.Lifecycle.parse(
            b"<LifecycleConfiguration><Rule><Status>Enabled</Status>"
            b"<Filter/><Transition><Days>1</Days><StorageClass>WARM"
            b"</StorageClass></Transition></Rule>"
            b"</LifecycleConfiguration>")
        assert port_tier.run_transitions(pools, "ob", lc, tm,
                                         now=real_time.time() + 9 * DAY) == 0
        assert jax_tier.ilm_enabled() is port_tier.ilm_enabled() is False
        assert not tm.is_transitioned(pools.head_object("ob", "x"))
        assert os.listdir(tmp_path / "w") == []
    finally:
        close_pools(pools)


def test_tier_configs_seal_and_cross_packages(tmp_path, monkeypatch):
    """Credentials persist only sealed with the KMS; either package
    unseals the other's sealed config under the same master key."""
    from minio_tpu.crypto.kms import StaticKMS as JaxKMS
    from minio_tpu_torch.crypto.kms import StaticKMS as PortKMS
    monkeypatch.delenv("MTPU_KMS_SECRET_KEY", raising=False)
    cfg = {"type": "s3", "endpoint": "http://127.0.0.1:1",
           "accessKey": "AKSECRETID", "secretKey": "sswordpa",
           "bucket": "warm"}
    pools = _port_pools(tmp_path)
    try:
        tm = port_tier.TierManager(pools, kms=None)
        with pytest.raises(port_tier.StorageError):
            tm.add_tier("remote", object(), config=cfg)
        assert tm.list_tiers() == []
        tm = port_tier.TierManager(pools, kms=PortKMS(b"\x11" * 32))
        tm.add_tier("remote", object(), config=cfg)
        raw = pools.pools[0].sets[0].drives[0].read_all(
            ".mtpu.sys", port_tier.TierManager.TIER_CONFIG_PATH)
        assert b"AKSECRETID" not in raw and b"sswordpa" not in raw
    finally:
        close_pools(pools)
    jpools = _jax_pools(tmp_path)
    try:
        jtm = jax_tier.TierManager(jpools, kms=JaxKMS(b"\x11" * 32))
        assert jtm.list_tiers() == ["REMOTE"]
        assert jtm._load_configs()["REMOTE"] == cfg
        jtm.add_tier("fs2", object(), config={"type": "fs",
                                               "path": str(tmp_path / "f")})
    finally:
        close_pools(jpools)
    pools = _port_pools(tmp_path)
    try:
        tm = port_tier.TierManager(pools, kms=PortKMS(b"\x11" * 32))
        assert tm.list_tiers() == ["FS2", "REMOTE"]
        assert tm._load_configs()["FS2"]["type"] == "fs"
    finally:
        close_pools(pools)
