"""The port's namespace lock (minio_tpu_torch.cluster.nslock) and where
the object layer takes it, heal's `remove_dangling`, and the thread
safety of the kernel wrappers' launch counts and table cache
(device="cpu")."""

import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from minio_tpu.engine import heal as jax_heal
from minio_tpu.engine.erasure_set import ErasureSet as JaxErasureSet
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu.storage.errors import \
    ErrErasureReadQuorum as JaxErrErasureReadQuorum
from minio_tpu_torch.cluster.dynamic_timeout import DynamicTimeout
from minio_tpu_torch.cluster.nslock import LockLost, NSLockMap
from minio_tpu_torch.engine import heal
from minio_tpu_torch.engine import multipart as mp
from minio_tpu_torch.engine.erasure_set import ErasureSet
from minio_tpu_torch.ops import erasure_cuda, erasure_torch, highwayhash_cuda
from minio_tpu_torch.storage.drive import LocalDrive
from minio_tpu_torch.storage.errors import (ErrErasureReadQuorum,
                                            StorageError)


def payload(size, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def make_set(tmp_path, n=4):
    return ErasureSet([LocalDrive(str(tmp_path / f"d{i}")) for i in range(n)],
                      device="cpu")


def _in_thread(fn):
    """Run fn in a thread; returns (thread, box) with box["err"] set if
    it raised."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — the test reads it
            box["err"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


class TestRWLock:
    def test_writers_exclude_each_other_and_readers(self):
        locks = NSLockMap()
        inside = {"w": 0, "r": 0, "bad": 0}
        mu = threading.Lock()

        def writer():
            for _ in range(50):
                with locks.write_locked("b", "o", timeout=10):
                    with mu:
                        inside["w"] += 1
                        if inside["w"] > 1 or inside["r"]:
                            inside["bad"] += 1
                    time.sleep(0.0002)
                    with mu:
                        inside["w"] -= 1

        def reader():
            for _ in range(50):
                with locks.read_locked("b", "o", timeout=10):
                    with mu:
                        inside["r"] += 1
                        if inside["w"]:
                            inside["bad"] += 1
                    time.sleep(0.0002)
                    with mu:
                        inside["r"] -= 1
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=f) for f in
                       (writer, writer, writer, reader, reader, reader)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert inside == {"w": 0, "r": 0, "bad": 0}
        assert locks._local == {}          # entries go at refcount 0

    def test_readers_share_and_other_keys_are_free(self):
        locks = NSLockMap()
        with locks.read_locked("b", "o", timeout=1):
            with locks.read_locked("b", "o", timeout=1):
                pass
            with locks.write_locked("b", "other", timeout=1):
                pass
            with pytest.raises(LockLost):
                with locks.write_locked("b", "o", timeout=0.05):
                    pass

    def test_timeout_raises_lock_lost(self):
        locks = NSLockMap()
        assert issubclass(LockLost, StorageError)
        with locks.write_locked("b", "o", timeout=1):
            t0 = time.monotonic()
            with pytest.raises(LockLost, match="b/o"):
                with locks.write_locked("b", "o", timeout=0.1):
                    pass
            assert time.monotonic() - t0 >= 0.09
            with pytest.raises(LockLost):
                with locks.read_locked("b", "o", timeout=0.05):
                    pass
        with locks.write_locked("b", "o", timeout=0.1):  # free again
            pass

    def test_adaptive_deadline(self):
        locks = NSLockMap()
        locks.acquire_timeout = DynamicTimeout(default_s=0.05,
                                               minimum_s=0.01)
        with locks.write_locked("b", "o"):
            with pytest.raises(LockLost):
                with locks.write_locked("b", "o"):
                    pass
        dt = DynamicTimeout(default_s=1.0, minimum_s=0.1, maximum_s=2.0)
        for _ in range(DynamicTimeout.WINDOW):
            dt.log_timeout()
        assert dt.timeout() == pytest.approx(1.25)
        for _ in range(DynamicTimeout.WINDOW):
            dt.log_success(0.01)
        assert dt.timeout() == pytest.approx(1.0)


def _waits_for_lock(es, bucket, obj, fn):
    """fn() does not finish while bucket/obj's write lock is held, and
    finishes once it is released."""
    with es.nslock.write_locked(bucket, obj, timeout=1):
        t, box = _in_thread(fn)
        t.join(timeout=0.3)
        assert t.is_alive(), "ran while the write lock was held"
    t.join(timeout=60)
    assert not t.is_alive()
    if "err" in box:
        raise box["err"]
    return box.get("out")


def test_mutations_take_the_write_lock(tmp_path):
    with make_set(tmp_path) as es:
        es.make_bucket("b")
        data = payload(3000)
        _waits_for_lock(es, "b", "o", lambda: es.put_object("b", "o", data))
        assert bytes(es.get_object("b", "o")[1]) == data
        shutil.rmtree(os.path.join(es.drives[0].root, "b", "o"))
        r = _waits_for_lock(es, "b", "o",
                            lambda: heal.heal_object(es, "b", "o"))
        assert r[0].healed_drives == [0]
        _waits_for_lock(es, "b", "o", lambda: es.delete_object("b", "o"))
        uid = mp.new_multipart_upload(es, "b", "m")
        info = mp.put_object_part(es, "b", "m", uid, 1, data)
        _waits_for_lock(es, "b", "m", lambda: mp.complete_multipart_upload(
            es, "b", "m", uid, [(1, info.etag)]))
        assert bytes(es.get_object("b", "m")[1]) == data


def test_sets_sharing_a_lock_map_exclude_each_other(tmp_path):
    """Two ErasureSets over the same drives given one NSLockMap: a PUT
    through one waits for the other's lock."""
    locks = NSLockMap()
    paths = [str(tmp_path / f"d{i}") for i in range(4)]
    with ErasureSet([LocalDrive(p) for p in paths], device="cpu",
                    nslock=locks) as one, \
            ErasureSet([LocalDrive(p) for p in paths], device="cpu",
                       nslock=locks) as two:
        one.make_bucket("b")
        data = payload(5000, seed=3)
        _waits_for_lock(one, "b", "o", lambda: two.put_object("b", "o",
                                                               data))
        assert bytes(one.get_object("b", "o")[1]) == data


def test_put_racing_heal_keeps_the_put(tmp_path, monkeypatch):
    """A heal that elected the old version and a PUT of a new one on the
    same key: the PUT waits for the heal's lock, so every drive ends
    with the PUT's version and the GET returns its bytes.  Without the
    lock the heal would publish the old version on the drive it
    rebuilds, after the PUT."""
    with make_set(tmp_path) as es:
        es.make_bucket("b")
        es.put_object("b", "o", payload(2 * 1024 * 1024 + 5, seed=1))
        shutil.rmtree(os.path.join(es.drives[2].root, "b", "o"))
        new = payload(1024 * 1024 + 9, seed=2)
        in_heal, put_done = threading.Event(), threading.Event()
        real = heal._heal_data

        def slow_heal_data(*a, **kw):
            in_heal.set()
            put_done.wait(timeout=0.5)    # a PUT that skips the lock lands
            return real(*a, **kw)
        monkeypatch.setattr(heal, "_heal_data", slow_heal_data)
        t_heal, heal_box = _in_thread(lambda: heal.heal_object(es, "b", "o"))
        assert in_heal.wait(timeout=30)

        def put():
            fi = es.put_object("b", "o", new)
            put_done.set()
            return fi
        t_put, put_box = _in_thread(put)
        t_heal.join(timeout=60)
        t_put.join(timeout=60)
        assert not t_heal.is_alive() and not t_put.is_alive()
        assert "err" not in heal_box and "err" not in put_box
        fi = put_box["out"]
        for d in es.drives:
            got = d.read_version("b", "o")
            assert (got.data_dir, got.mod_time_ns, got.size) == \
                (fi.data_dir, fi.mod_time_ns, fi.size), d
        assert bytes(es.get_object("b", "o")[1]) == new
        es.drives[0] = es.drives[1] = None
        assert bytes(es.get_object("b", "o")[1]) == new


@pytest.mark.parametrize("remove_dangling", [True, False])
def test_remove_dangling_matches_the_jax_heal(tmp_path, remove_dangling):
    """One copy of a version left of four (below read quorum, every drive
    answering): purged by default, left in place with
    remove_dangling=False, by both packages alike."""
    trees = {}
    for name in ("jax", "torch"):
        paths = [str(tmp_path / name / f"d{i}") for i in range(4)]
        jes = JaxErasureSet([JaxLocalDrive(p) for p in paths])
        jes.make_bucket("b")
        jes.put_object("b", "o", payload(200_000))
        for p in paths[:3]:
            shutil.rmtree(os.path.join(p, "b", "o"))
        trees[name] = paths
    jes = JaxErasureSet([JaxLocalDrive(p) for p in trees["jax"]])
    with ErasureSet([LocalDrive(p) for p in trees["torch"]],
                    device="cpu") as es:
        if remove_dangling:
            jr = jax_heal.heal_object(jes, "b", "o")[0]
            r = heal.heal_object(es, "b", "o")[0]
            assert r.purged and jr.purged
            assert (r.before, r.after) == (jr.before, jr.after)
        else:
            with pytest.raises(JaxErrErasureReadQuorum):
                jax_heal.heal_object(jes, "b", "o", remove_dangling=False)
            with pytest.raises(ErrErasureReadQuorum):
                heal.heal_object(es, "b", "o", remove_dangling=False)
    for name, paths in trees.items():
        assert os.path.exists(os.path.join(paths[3], "b", "o", "xl.meta")) \
            is not remove_dangling, name


@pytest.mark.parametrize("mod", [erasure_cuda, highwayhash_cuda],
                         ids=["gf_matmul", "hh256"])
def test_launch_counts_are_atomic(mod, monkeypatch):
    """Every launch a wrapper counts from any thread is counted: the
    read-modify-write is under a lock (heal workers launch
    concurrently)."""
    monkeypatch.setattr(mod, "LAUNCHES", 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [mod._count_launch() for _ in range(20_000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert mod.LAUNCHES == 16 * 20_000


def test_table_cache_under_threads(monkeypatch):
    """Threads that share the GF table cache, clearing it all the time,
    each get the tables of their own matrix."""
    monkeypatch.setattr(erasure_cuda, "_TABLES", {})
    monkeypatch.setattr(erasure_cuda, "_TABLES_MAX", 2)
    mats = [erasure_torch._transform_matrix_bits(8, 4, tuple(range(k, k + 8)),
                                                 (k,))
            for k in range(1, 5)] + [erasure_torch._encode_matrix_bits(8, 4)]
    want = [erasure_cuda.nibble_tables(m).view(np.uint8) for m in mats]
    bad = []

    def worker(i):
        for j in range(200):
            m = (i + j) % len(mats)
            t = erasure_cuda._device_tables(mats[m], torch.device("cpu"))
            if not np.array_equal(t.numpy().reshape(want[m].shape),
                                  want[m]):
                bad.append(m)
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert bad == [] and len(erasure_cuda._TABLES) <= 2


# -- the namespace lock across processes --------------------------------------

_TWO_WRITERS = r"""
import json, os, signal, sys, time
signal.alarm(90)
from minio_tpu_torch.cluster import nslock
from minio_tpu_torch.engine.erasure_set import ErasureSet
from minio_tpu_torch.storage.drive import LocalDrive

root, n_puts = sys.argv[1], int(sys.argv[2])
nslock.shared_stripes()          # made before the fork, as the pool does
go_r, go_w = os.pipe()
acks_r, acks_w = os.pipe()


def child(c):
    real = LocalDrive._read_xlmeta

    def slow(self, vol, obj):
        # Widen the read-modify-write of xl.meta: two writers that are
        # not excluded overlap here.
        meta = real(self, vol, obj)
        time.sleep(0.03)
        return meta
    LocalDrive._read_xlmeta = slow
    es = ErasureSet([LocalDrive(os.path.join(root, f"d{i}"))
                     for i in range(4)], device="cpu")
    if c == 0:
        es.make_bucket("vb")
        os.write(go_w, b"gg")
    os.read(go_r, 1)
    for i in range(n_puts):
        fi = es.put_object("vb", "key", b"v%d-%d" % (c, i) * 100,
                           versioned=True)
        os.write(acks_w, (fi.version_id + "\n").encode())
    es.close()


pids = []
for c in range(2):
    pid = os.fork()
    if pid == 0:
        try:
            child(c)
            os._exit(0)
        except BaseException:
            import traceback
            traceback.print_exc()
            os._exit(1)
    pids.append(pid)
os.close(acks_w)
rcs = [os.waitstatus_to_exitcode(os.waitpid(p, 0)[1]) for p in pids]
acked = set()
with os.fdopen(acks_r) as f:
    acked = {line.strip() for line in f if line.strip()}
es = ErasureSet([LocalDrive(os.path.join(root, f"d{i}")) for i in range(4)],
                device="cpu")
history = {fi.version_id for fi in es.list_object_versions("vb", "key")}
es.close()
print(json.dumps({"rcs": rcs, "acked": sorted(acked),
                  "history": sorted(history)}))
"""


_WRITER_AND_STAMPER = r"""
import json, os, select, signal, sys, time
signal.alarm(90)
from minio_tpu_torch.cluster import nslock
from minio_tpu_torch.engine.erasure_set import ErasureSet
from minio_tpu_torch.storage.drive import LocalDrive

root, n_puts = sys.argv[1], int(sys.argv[2])
nslock.shared_stripes()          # made before the fork, as the pool does
go_r, go_w = os.pipe()
acks_r, acks_w = os.pipe()
done_r, done_w = os.pipe()


def child(c):
    real = LocalDrive._read_xlmeta

    def slow(self, vol, obj):
        meta = real(self, vol, obj)
        time.sleep(0.03)
        return meta
    LocalDrive._read_xlmeta = slow
    es = ErasureSet([LocalDrive(os.path.join(root, f"d{i}"))
                     for i in range(4)], device="cpu")
    if c == 0:
        es.make_bucket("vb")
        first = es.put_object("vb", "key", os.urandom(200_000),
                              versioned=True)
        os.write(go_w, first.version_id.encode())
        for i in range(n_puts):
            fi = es.put_object("vb", "key", os.urandom(200_000),
                               versioned=True)
            os.write(acks_w, (fi.version_id + "\n").encode())
        os.write(done_w, b"d")
    else:
        first = os.read(go_r, 64).decode()
        i = 0
        while not select.select([done_r], [], [], 0)[0]:
            fi = es.head_object("vb", "key", first)
            fi.metadata["x-amz-replication-status"] = f"stamp{i}"
            es.update_object_metadata("vb", "key", fi)
            i += 1
    es.close()


pids = []
for c in range(2):
    pid = os.fork()
    if pid == 0:
        try:
            child(c)
            os._exit(0)
        except BaseException:
            import traceback
            traceback.print_exc()
            os._exit(1)
    pids.append(pid)
os.close(acks_w)
rcs = [os.waitstatus_to_exitcode(os.waitpid(p, 0)[1]) for p in pids]
with os.fdopen(acks_r) as f:
    acked = {line.strip() for line in f if line.strip()}
es = ErasureSet([LocalDrive(os.path.join(root, f"d{i}")) for i in range(4)],
                device="cpu")
history = {fi.version_id for fi in es.list_object_versions("vb", "key")}
es.close()
print(json.dumps({"rcs": rcs, "acked": sorted(acked),
                  "history": sorted(history)}))
"""


def test_a_metadata_stamp_keeps_another_process_version(tmp_path):
    """One process PUTs versions of a key while another keeps stamping
    the metadata of its first version (replication's status, a tag or a
    retention), each read-modify-write of xl.meta slowed to overlap:
    every acknowledged version stays in the history.  A stamp outside
    the key's write lock writes back an xl.meta without the version the
    other process added."""
    import json
    import subprocess
    root = str(tmp_path / "root")
    os.makedirs(root)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", _WRITER_AND_STAMPER, root,
                          "6"], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rcs"] == [0, 0], out.stderr[-3000:]
    assert len(res["acked"]) == 6
    lost = set(res["acked"]) - set(res["history"])
    assert not lost, f"{len(lost)} acknowledged versions lost"


def test_two_processes_keep_every_acknowledged_version(tmp_path):
    """Two forked processes, each with its own LocalDrives over one
    root, write versions of one key at once (each read-modify-write of
    xl.meta slowed to overlap): every acknowledged version is in the
    key's history.  With a per-process lock alone the writes interleave
    and versions are lost."""
    import json
    import subprocess
    root = str(tmp_path / "root")
    os.makedirs(root)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", _TWO_WRITERS, root, "6"],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rcs"] == [0, 0], out.stderr[-3000:]
    assert len(res["acked"]) == 12
    lost = set(res["acked"]) - set(res["history"])
    assert not lost, f"{len(lost)} acknowledged versions lost"


def _holder(table, resource):
    """(pid, holds) of the resource's stripe; (0, 0) when free."""
    pid, _, holds = (int(v) for v in table._rows[table.stripe(resource)])
    return pid, holds


class TestStripes:
    def test_one_thread_takes_two_keys_of_one_stripe(self):
        """Copy and multipart complete take two keys: two keys of one
        stripe in one thread do not wait on each other."""
        from minio_tpu_torch.cluster.nslock import StripeTable
        locks = NSLockMap(StripeTable(nstripes=1))
        t0 = time.monotonic()
        with locks.write_locked("b", "src", timeout=2):
            with locks.write_locked("b", "dst", timeout=2):
                assert _holder(locks.stripes, "b/dst") == (os.getpid(), 2)
        assert time.monotonic() - t0 < 1.0
        assert _holder(locks.stripes, "b/dst") == (0, 0)

    def test_threads_of_one_process_share_a_stripe(self):
        """Two threads writing two keys of one stripe both go on; a
        write of the same key still waits for the first."""
        from minio_tpu_torch.cluster.nslock import StripeTable
        locks = NSLockMap(StripeTable(nstripes=1))
        inside = threading.Event()
        leave = threading.Event()

        def hold():
            with locks.write_locked("b", "x", timeout=5):
                inside.set()
                leave.wait(5)
        t = threading.Thread(target=hold, daemon=True)
        t.start()
        assert inside.wait(5)
        try:
            with locks.write_locked("b", "y", timeout=1):
                pass
            with pytest.raises(LockLost):
                with locks.write_locked("b", "x", timeout=0.2):
                    pass
        finally:
            leave.set()
            t.join(5)
        assert not t.is_alive()

    def test_a_dead_holders_stripe_is_taken(self):
        """A process that died holding a stripe (its row names a gone
        pid) does not stall the next writer until its deadline."""
        import subprocess
        from minio_tpu_torch.cluster.nslock import StripeTable, _start_ticks
        table = StripeTable(nstripes=4)
        p = subprocess.Popen([sys.executable, "-c", "pass"])
        ticks = _start_ticks(p.pid)
        p.wait(timeout=30)
        s = table.stripe("b/k")
        table._rows[s] = (p.pid, ticks or 1, 1)
        t0 = time.monotonic()
        assert table.acquire("b/k", timeout=5)
        assert time.monotonic() - t0 < 1.0
        assert _holder(table, "b/k") == (os.getpid(), 1)
        table.release("b/k")
        assert _holder(table, "b/k") == (0, 0)

    def test_a_live_holder_in_another_process_excludes(self):
        """A stripe held by a live other process (its row names it)
        keeps this process out until the deadline."""
        import subprocess
        from minio_tpu_torch.cluster.nslock import StripeTable, _start_ticks
        table = StripeTable(nstripes=4)
        p = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(30)"])
        try:
            deadline = time.monotonic() + 10
            while _start_ticks(p.pid) is None:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            s = table.stripe("b/k")
            table._rows[s] = (p.pid, _start_ticks(p.pid), 1)
            assert not table.acquire("b/k", timeout=0.3)
            p.kill()
            p.wait(timeout=30)
            assert table.acquire("b/k", timeout=5)
            table.release("b/k")
        finally:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)

    def test_uncontended_cost_per_mutation(self, capsys):
        """What a single process (MTPU_WORKERS=0) pays for the stripe: one
        uncontended lock more per mutation, printed in ms."""
        class _NoStripes:
            def acquire(self, resource, timeout):
                return True

            def release(self, resource):
                pass

        def per_mutation_ms(locks, n=3000):
            t0 = time.perf_counter()
            for i in range(n):
                with locks.write_locked("b", f"k{i % 64}", timeout=5):
                    pass
            return (time.perf_counter() - t0) * 1e3 / n

        from minio_tpu_torch.cluster.nslock import StripeTable
        with_stripes = NSLockMap(StripeTable())
        without = NSLockMap(_NoStripes())
        got = {"with": [], "without": []}
        for _ in range(3):            # in turns
            got["without"].append(per_mutation_ms(without))
            got["with"].append(per_mutation_ms(with_stripes))
        extra = min(got["with"]) - min(got["without"])
        with capsys.disabled():
            print(f"\n[nslock] uncontended write lock: "
                  f"{min(got['without']):.4f} ms in-process only, "
                  f"{min(got['with']):.4f} ms with the stripe "
                  f"(+{extra:.4f} ms a mutation; CPU)")
        assert extra < 1.0
