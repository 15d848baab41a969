"""The port's object layer (minio_tpu_torch: utils/siphash, engine/sets,
engine/pools, the heal sweep over sets and background/heal_ops;
device="cpu") held to the JAX package.  Tolerance: byte-exact.  Both
packages place every name on the same set, a deployment one package
wrote is listed, version-listed, read and healed by the other with equal
results in both directions, the two-pool placement and pool-sticky
multipart cases of tests/test_pools.py run against both packages, the
sweep's grouping, stop and error cases run on fake sets, and a heal
sequence after a wiped drive in every set leaves the same drives as the
JAX package's."""

import functools
import os
import shutil
import threading
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import minio_tpu.engine.erasure_set as jax_es_mod
import minio_tpu.storage.errors as jax_errors
import minio_tpu_torch.engine.erasure_set as port_es_mod
import minio_tpu_torch.storage.errors as port_errors
from minio_tpu.background.heal_ops import HealState as JaxHealState
from minio_tpu.engine.pools import ServerPools as JaxServerPools
from minio_tpu.engine.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu.utils import siphash as jax_siphash
from minio_tpu_torch.background.heal_ops import HealSequence, HealState
from minio_tpu_torch.engine import heal
from minio_tpu_torch.engine.pools import ServerPools
from minio_tpu_torch.engine.sets import ErasureSets
from minio_tpu_torch.storage.drive import SYS_VOL, LocalDrive
from minio_tpu_torch.utils import siphash

JAX = SimpleNamespace(
    name="jax", LocalDrive=JaxLocalDrive, ErasureSets=JaxErasureSets,
    ServerPools=JaxServerPools, HealState=JaxHealState, errors=jax_errors)
PORT = SimpleNamespace(
    name="port", LocalDrive=LocalDrive,
    ErasureSets=functools.partial(ErasureSets, device="cpu"),
    ServerPools=ServerPools,
    HealState=HealState, errors=port_errors)
IMPLS = [JAX, PORT]
MIB = 1 << 20


def close(obj):
    """Stop the executors of a ServerPools or ErasureSets of either
    package (the JAX package's sets have no close())."""
    for p in getattr(obj, "pools", [obj]):
        for es in p.sets:
            if isinstance(es, port_es_mod.ErasureSet):
                es.close()
            else:
                es.pool.shutdown(wait=True)
                es._iter_pool.shutdown(wait=True)


@pytest.fixture(autouse=True)
def no_executor_threads_left():
    """No executor thread a test starts outlives it."""
    def executors():
        return {t for t in threading.enumerate()
                if t.name.startswith("ThreadPoolExecutor")}
    before = executors()
    yield
    assert not executors() - before


@pytest.fixture
def closing():
    made = []
    yield made.append
    for obj in made:
        close(obj)


@pytest.fixture(params=IMPLS, ids=lambda i: i.name)
def impl(request):
    return request.param


def body_of(size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


def pool_on(impl, root, n_drives=8, set_drive_count=4, deployment_id=None):
    return impl.ErasureSets(
        [impl.LocalDrive(str(root / f"d{i}")) for i in range(n_drives)],
        set_drive_count=set_drive_count, deployment_id=deployment_id)


def tree(root):
    """(relpath -> bytes) of every file under a deployment but the
    staging area and the metacache."""
    out = {}
    for dirpath, _, files in os.walk(root):
        rel_dir = os.path.relpath(dirpath, root)
        parts = rel_dir.split(os.sep)
        if SYS_VOL in parts and parts[parts.index(SYS_VOL) + 1:][:1] in (
                ["tmp"], ["metacache"]):
            continue
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.normpath(os.path.join(rel_dir, f))] = fh.read()
    return out


def row(fi):
    return (fi.name, fi.version_id, fi.size, fi.mod_time_ns, fi.deleted,
            fi.metadata.get("etag", ""))


# -- placement -------------------------------------------------------------------

@pytest.mark.parametrize("length", [0, 1, 7, 8, 9, 15, 16, 17, 63, 200])
def test_siphash_equal(length):
    rng = np.random.default_rng(length)
    for _ in range(20):
        key = rng.bytes(16)
        data = rng.bytes(length)
        assert siphash.siphash24(key, data) == \
            jax_siphash.siphash24(key, data)


def test_sip_hash_mod_equal_for_1000_names():
    key = uuid.UUID("6a6e6f2c-8a1c-4b3f-9a3e-0b5f0a4d2c11").bytes
    names = [f"obj/{i:04d}-{'x' * (i % 23)}" for i in range(1000)]
    for card in (1, 2, 3, 4, 16):
        assert [siphash.sip_hash_mod(n, card, key) for n in names] == \
            [jax_siphash.sip_hash_mod(n, card, key) for n in names]
    assert siphash.sip_hash_mod("x", 0, key) == -1


@pytest.mark.parametrize("formatter", IMPLS, ids=["jax-formats",
                                                  "port-formats"])
def test_set_for_same_set_for_1000_names(formatter, tmp_path, closing):
    """One package formats 4 sets x 4 drives, the other adopts the
    format: the same deployment id, and the same set for every name."""
    first = pool_on(formatter, tmp_path, 16, 4)
    closing(first)
    other = pool_on(JAX if formatter is PORT else PORT, tmp_path, 16, 4)
    closing(other)
    assert first.deployment_id == other.deployment_id
    names = [f"k{i:04d}/{i * 7919 % 1000}" for i in range(1000)]
    got = [first.sets.index(first.set_for(n)) for n in names]
    assert got == [other.sets.index(other.set_for(n)) for n in names]
    assert set(got) == {0, 1, 2, 3}
    assert [es.set_index for es in other.sets] == [0, 1, 2, 3]


# -- two pools: the cases of tests/test_pools.py, both packages ------------------

def two_pools(impl, root):
    p0 = pool_on(impl, root / "p0", 4, 4)
    p1 = pool_on(impl, root / "p1", 4, 4, deployment_id=p0.deployment_id)
    return impl.ServerPools([p0, p1])


def force_free(pools, frees):
    """Pin each pool's reported free space (placement is by most-free)."""
    for p, free in zip(pools.pools, frees):
        p.disk_usage = (lambda f: lambda: {"total": 1 << 40, "free": f})(
            free)


@pytest.fixture
def pools2(impl, tmp_path, closing):
    p = two_pools(impl, tmp_path)
    closing(p)
    return p


class TestTwoPoolsBothPackages:
    def test_new_object_lands_on_most_free_pool(self, impl, pools2):
        pools2.make_bucket("b")
        force_free(pools2, [10, 1000])
        pools2.put_object("b", "x", b"hello world" * 1000)
        pools2.pools[1].head_object("b", "x")
        with pytest.raises(impl.errors.ErrObjectNotFound):
            pools2.pools[0].head_object("b", "x")
        force_free(pools2, [5000, 1000])
        pools2.put_object("b", "y", b"data")
        pools2.pools[0].head_object("b", "y")
        with pytest.raises(impl.errors.ErrObjectNotFound):
            pools2.pools[1].head_object("b", "y")

    def test_overwrite_finds_existing_pool(self, impl, pools2):
        pools2.make_bucket("b")
        force_free(pools2, [1000, 10])
        pools2.put_object("b", "x", b"v1")
        force_free(pools2, [10, 1000])
        pools2.put_object("b", "x", b"v2-new-content")
        assert bytes(pools2.get_object("b", "x")[1]) == b"v2-new-content"
        with pytest.raises(impl.errors.ErrObjectNotFound):
            pools2.pools[1].head_object("b", "x")

    def test_delete_routes_to_owning_pool(self, impl, pools2):
        pools2.make_bucket("b")
        force_free(pools2, [10, 1000])
        pools2.put_object("b", "gone", b"bye")
        pools2.delete_object("b", "gone")
        with pytest.raises(impl.errors.ErrObjectNotFound):
            pools2.get_object("b", "gone")

    def test_multipart_is_pool_sticky(self, impl, pools2):
        pools2.make_bucket("b")
        force_free(pools2, [10, 1000])
        uid = pools2.new_multipart_upload("b", "mp")
        assert uid.startswith("1.")
        part = body_of(MIB + 17, seed=5)
        pools2.put_object_part("b", "mp", uid, 1, part)
        force_free(pools2, [1000, 10])       # placement flips: id sticks
        etags = {p.number: p.etag
                 for p in pools2.list_parts("b", "mp", uid)}
        pools2.complete_multipart_upload("b", "mp", uid, [(1, etags[1])])
        pools2.pools[1].head_object("b", "mp")
        assert bytes(pools2.get_object("b", "mp")[1]) == part
        with pytest.raises(Exception) as err:
            pools2.put_object_part("b", "mp", "9.nope", 1, b"x")
        assert type(err.value).__name__ == "ErrUploadNotFound"

    def test_tie_break_is_lowest_index(self, impl, pools2):
        pools2.make_bucket("b")
        force_free(pools2, [500, 500])
        for i in range(16):
            assert pools2.get_pool_idx("b", f"k{i}") == 0

    def test_placement_stable_across_instances(self, impl, pools2):
        pools2.make_bucket("b")
        force_free(pools2, [500, 500])
        keys = [f"obj-{i:02d}" for i in range(12)]
        first = {k: pools2.get_pool_idx("b", k) for k in keys}
        rebuilt = impl.ServerPools(pools2.pools)
        assert {k: rebuilt.get_pool_idx("b", k) for k in keys} == first

    def test_probe_beats_skew(self, impl, pools2):
        pools2.make_bucket("b")
        force_free(pools2, [1000, 10])
        pools2.put_object("b", "sticky", b"v1")
        force_free(pools2, [1, 10 ** 9])
        assert pools2.get_pool_idx("b", "sticky") == 0
        pools2.put_object("b", "sticky", b"v2")
        with pytest.raises(impl.errors.ErrObjectNotFound):
            pools2.pools[1].head_object("b", "sticky")

    def test_listing_merges_across_pools(self, impl, pools2):
        pools2.make_bucket("b")
        force_free(pools2, [1000, 10])
        pools2.put_object("b", "a-on-p0", b"0")
        force_free(pools2, [10, 1000])
        pools2.put_object("b", "b-on-p1", b"1")
        assert [fi.name for fi in pools2.list_objects("b")] == \
            ["a-on-p0", "b-on-p1"]
        assert pools2.list_object_names("b") == ["a-on-p0", "b-on-p1"]

    def test_bucket_ops_fan_out(self, impl, pools2):
        pools2.make_bucket("everywhere")
        assert all(p.bucket_exists("everywhere") for p in pools2.pools)
        assert "everywhere" in pools2.list_buckets()
        with pytest.raises(impl.errors.ErrBucketExists):
            pools2.make_bucket("everywhere")
        pools2.delete_bucket("everywhere")
        assert not pools2.bucket_exists("everywhere")

    def test_listing_pagination_resumes_across_pools(self, impl, pools2):
        pools2.make_bucket("b")
        want = []
        for i in range(10):
            force_free(pools2, [1000, 10] if i % 2 == 0 else [10, 1000])
            pools2.put_object("b", f"o{i:02d}", b"x")
            want.append(f"o{i:02d}")
        got, marker = [], ""
        while True:
            page = pools2.list_objects("b", marker=marker, max_keys=3)
            if not page:
                break
            assert len(page) <= 3
            got += [fi.name for fi in page]
            marker = page[-1].name
        assert got == sorted(want)

    def test_list_multipart_uploads_merges_pools(self, impl, pools2):
        pools2.make_bucket("b")
        force_free(pools2, [1000, 10])
        u0 = pools2.new_multipart_upload("b", "mp-a")
        force_free(pools2, [10, 1000])
        u1 = pools2.new_multipart_upload("b", "mp-b")
        assert u0.startswith("0.") and u1.startswith("1.")
        rows = pools2.list_multipart_uploads("b")
        assert [(r["object"], r["upload_id"]) for r in rows] == \
            [("mp-a", u0), ("mp-b", u1)]
        pools2.abort_multipart_upload("b", "mp-a", u0)
        assert [r["upload_id"] for r in
                pools2.list_multipart_uploads("b")] == [u1]

    def test_usage_sums_pools(self, impl, pools2):
        force_free(pools2, [100, 250])
        du = pools2.disk_usage()
        assert du["total"] == 2 << 40 and du["free"] == 350
        assert [{k: r[k] for k in ("pool", "total", "free")}
                for r in pools2.pool_status()] == \
            [{"pool": 0, "total": 1 << 40, "free": 100},
             {"pool": 1, "total": 1 << 40, "free": 250}]

    def test_heal_bucket_aggregates_pools(self, impl, pools2, tmp_path):
        pools2.make_bucket("hb")
        os.rmdir(str(tmp_path / "p0" / "d1" / "hb"))
        os.rmdir(str(tmp_path / "p1" / "d2" / "hb"))
        assert pools2.heal_bucket("hb") == {0: {0: [1]}, 1: {0: [2]}}
        assert os.path.isdir(str(tmp_path / "p0" / "d1" / "hb"))
        assert os.path.isdir(str(tmp_path / "p1" / "d2" / "hb"))

    def test_heal_walks_both_pools(self, impl, pools2, tmp_path):
        pools2.make_bucket("b")
        blobs = {}
        for i in range(4):
            force_free(pools2, [1000, 10] if i % 2 == 0 else [10, 1000])
            blobs[f"o{i}"] = body_of(200_000 + i, seed=i)
            pools2.put_object("b", f"o{i}", blobs[f"o{i}"])
        for tag in ("p0/d1", "p1/d2"):
            shutil.rmtree(str(tmp_path / tag / "b"))
        assert all(pools2.heal_object("b", n) for n in blobs)
        for name, data in blobs.items():
            assert bytes(pools2.get_object("b", name)[1]) == data
        assert os.path.isdir(str(tmp_path / "p0/d1/b"))


def test_two_pool_placement_equal_across_packages(tmp_path, closing):
    """The same writes under the same free-space readings put every
    name on the same pool and set, with equal object files."""
    placed = {}
    for impl in IMPLS:
        pools = two_pools(impl, tmp_path / impl.name)
        closing(pools)
        pools.make_bucket("b")
        where = []
        for i in range(24):
            force_free(pools, [(i * 37) % 5, (i * 11) % 5])
            name = f"n{i:02d}"
            pools.put_object("b", name, body_of(100 + i, seed=i))
            idx = pools.get_pool_idx("b", name)
            where.append((idx, pools.pools[idx].sets.index(
                pools.pools[idx].set_for(name))))
        placed[impl.name] = where
    assert placed["port"] == placed["jax"]
    assert len(set(placed["port"])) == 2


# -- a deployment written by one package, served by the other --------------------

def write_deployment(pools):
    """Versioned and unversioned objects over the pool's sets: inline,
    multi-block with a ragged tail, a second version, a delete marker,
    a multipart object.  Returns {name: live body}."""
    pools.make_bucket("v")
    live = {}
    for i in range(12):
        size = 2 * MIB + 11 if i % 4 == 0 else 700 * (i + 1)
        live[f"o{i:02d}"] = body_of(size, seed=i)
        pools.put_object("v", f"o{i:02d}", live[f"o{i:02d}"], versioned=True)
    live["o01"] = body_of(333, seed=99)
    pools.put_object("v", "o01", live["o01"], versioned=True)
    pools.delete_object("v", "o02", versioned=True)
    del live["o02"]
    uid = pools.new_multipart_upload("v", "mp")
    parts = [body_of(5 * MIB + 5, seed=50), body_of(1000, seed=51)]
    etags = [pools.put_object_part("v", "mp", uid, i + 1, p).etag
             for i, p in enumerate(parts)]
    pools.complete_multipart_upload("v", "mp", uid,
                                    [(i + 1, e) for i, e in enumerate(etags)])
    live["mp"] = b"".join(parts)
    return live


def wipe_one_per_set(root, n_sets=2, set_drive_count=4, pos=1):
    """Wipe drive `pos` of every set whole."""
    for s in range(n_sets):
        shutil.rmtree(root / f"d{s * set_drive_count + pos}")


@pytest.mark.parametrize("writer", IMPLS, ids=["jax-writes", "port-writes"])
def test_deployment_served_across_packages(writer, tmp_path, closing):
    """A 2-set deployment one package wrote is listed, version-listed and
    read by the other package with the writer's own results; then a
    drive of every set is wiped, and a heal sequence of each package on
    its own copy leaves the same drives, equal to those before the
    wipe."""
    reader = PORT if writer is JAX else JAX
    wp = writer.ServerPools([pool_on(writer, tmp_path / "w")])
    closing(wp)
    live = write_deployment(wp)
    rp = reader.ServerPools([pool_on(reader, tmp_path / "w")])
    closing(rp)
    for p in (wp, rp):
        assert [row(fi) for fi in p.list_objects("v")] == \
            [row(fi) for fi in wp.list_objects("v")]
        assert sorted(fi.name for fi in p.list_objects("v")) == sorted(live)
        for name in sorted(live) + ["o02"]:
            assert [row(fi) for fi in p.list_object_versions("v", name)] == \
                [row(fi) for fi in wp.list_object_versions("v", name)]
    for name, body in live.items():
        assert bytes(rp.get_object("v", name)[1]) == body
    close(wp)
    close(rp)

    before = tree(tmp_path / "w")
    wipe_one_per_set(tmp_path / "w")
    for side in ("jax", "port"):
        shutil.copytree(tmp_path / "w", tmp_path / side)
    status = {}
    for impl in IMPLS:
        p = impl.ServerPools([pool_on(impl, tmp_path / impl.name)])
        closing(p)
        seq = impl.HealState(p).launch()
        deadline = time.monotonic() + 60
        while seq.state in ("pending", "running") and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        st = seq.status()
        status[impl.name] = (st["state"], st["scanned"], st["healed"],
                             st["failures"])
        for name, body in live.items():
            assert bytes(p.get_object("v", name)[1]) == body
    assert status["port"] == status["jax"] == ("done", 13, 13, [])
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    healed = tree(tmp_path / "port")
    for k in before:
        if "healing.bin" not in k:
            assert healed.get(k) == before[k], k


# -- the sweep over sets ---------------------------------------------------------

class _FakeSet:
    def __init__(self, i, card):
        self.set_index = i
        self.device = torch.device("cuda", card)


class TestSweepSets:
    """The cases of tests/test_device_lanes.py:343-416 on the port."""

    def test_groups_overlap_across_cards(self, monkeypatch):
        monkeypatch.setenv("MTPU_HEAL_DEVICE_PARALLEL", "1")
        sets = [_FakeSet(i, i % 4) for i in range(8)]
        mu = threading.Lock()
        state = {"active": 0, "peak": 0}
        both = threading.Event()

        def job(es):
            with mu:
                state["active"] += 1
                state["peak"] = max(state["peak"], state["active"])
                if state["active"] >= 2:
                    both.set()
            both.wait(10.0)
            with mu:
                state["active"] -= 1
            return es.set_index

        assert heal.sweep_sets_device_parallel(sets, job) == \
            {i: i for i in range(8)}
        assert state["peak"] >= 2

    def test_same_card_sets_stay_serial_within_group(self, monkeypatch):
        monkeypatch.setenv("MTPU_HEAL_DEVICE_PARALLEL", "1")
        sets = [_FakeSet(i, 0) for i in range(4)]
        order = []

        def job(es):
            order.append((es.set_index, threading.current_thread().name))
            return es.set_index

        heal.sweep_sets_device_parallel(sets, job)
        assert [s for s, _ in order] == [0, 1, 2, 3]
        assert {t for _, t in order} == {threading.current_thread().name}

    def test_serial_oracle_runs_on_caller_thread_in_order(self,
                                                          monkeypatch):
        monkeypatch.setenv("MTPU_HEAL_DEVICE_PARALLEL", "0")
        sets = [_FakeSet(i, i % 4) for i in range(8)]
        seen = []

        def job(es):
            seen.append((es.set_index, threading.current_thread().name))
            return es.set_index

        assert heal.sweep_sets_device_parallel(sets, job) == \
            {i: i for i in range(8)}
        assert [s for s, _ in seen] == list(range(8))
        assert len({t for _, t in seen}) == 1

    def test_group_exception_propagates_after_join(self, monkeypatch):
        monkeypatch.setenv("MTPU_HEAL_DEVICE_PARALLEL", "1")
        sets = [_FakeSet(i, i % 2) for i in range(4)]
        done = []

        def job(es):
            if es.device.index == 1:
                raise RuntimeError("group 1 died")
            done.append(es.set_index)
            return es.set_index

        with pytest.raises(RuntimeError, match="group 1 died"):
            heal.sweep_sets_device_parallel(sets, job)
        assert done == [0, 2]          # the healthy group still finished

    @pytest.mark.parametrize("parallel", ["0", "1"])
    def test_stop_ends_every_group(self, monkeypatch, parallel):
        monkeypatch.setenv("MTPU_HEAL_DEVICE_PARALLEL", parallel)
        sets = [_FakeSet(i, i % 2) for i in range(6)]
        stop = threading.Event()
        ran = []

        def job(es):
            ran.append(es.set_index)
            stop.set()
            return es.set_index

        res = heal.sweep_sets_device_parallel(sets, job, stop=stop)
        assert len(ran) <= 2 and set(res) == set(ran)
        assert heal.sweep_sets_device_parallel(sets, job, stop=stop) == {}

    def test_cpu_sets_are_one_group(self, tmp_path, closing, monkeypatch):
        monkeypatch.setenv("MTPU_HEAL_DEVICE_PARALLEL", "1")
        pool = pool_on(PORT, tmp_path, 12, 4)
        closing(pool)
        names = []
        heal.sweep_sets_device_parallel(
            pool.sets, lambda es: names.append(
                threading.current_thread().name))
        assert names == [threading.current_thread().name] * 3


# -- heal sequences --------------------------------------------------------------

def wait_done(seq, timeout=60):
    seq.wait(timeout)
    return seq.status()


def test_heal_sequence_scopes_status_and_stop(tmp_path, closing):
    """A sequence on one bucket heals only it; one running sequence per
    scope; a stopped sequence reports it; statuses are kept."""
    pools = PORT.ServerPools([pool_on(PORT, tmp_path)])
    closing(pools)
    for b in ("hs", "other"):
        pools.make_bucket(b)
        for i in range(3):
            pools.put_object(b, f"o{i}", body_of(150_000, seed=i))
    es = pools.pools[0].sets[0]
    for b in ("hs", "other"):
        shutil.rmtree(os.path.join(es.drives[1].root, b))
    hs = HealState(pools)
    seq = hs.launch(bucket="hs")
    st = wait_done(seq)
    assert st["state"] == "done" and st["bucket"] == "hs"
    on_set0 = sum(pools.pools[0].set_for(f"o{i}") is es for i in range(3))
    assert st["scanned"] == 3 and st["healed"] == on_set0
    assert not os.path.isdir(os.path.join(es.drives[1].root, "other"))
    assert hs.get(seq.id) is seq and len(hs.statuses()) == 1

    stopped = HealSequence(pools)
    stopped.stop()
    assert stopped.run().state == "stopped"
    assert stopped.status()["scanned"] == 0


def test_heal_sequence_failure_is_reported(tmp_path, closing, monkeypatch):
    pools = PORT.ServerPools([pool_on(PORT, tmp_path)])
    closing(pools)
    pools.make_bucket("b")

    def boom():
        raise RuntimeError("no buckets today")
    monkeypatch.setattr(pools, "list_buckets", boom)
    st = wait_done(HealState(pools).launch())
    assert st["state"] == "failed" and st["failures"] == ["no buckets today"]


# -- the device ------------------------------------------------------------------

def test_server_pools_device(tmp_path, monkeypatch, closing):
    """No device means the CUDA card: without CUDA the sets raise; sets
    made with device="cpu" make a layer on the host; pools whose sets
    run on different kinds of device are refused."""
    pool = pool_on(PORT, tmp_path, 8, 4)
    closing(pool)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErasureSets([LocalDrive(str(tmp_path / f"x{i}")) for i in range(4)],
                    set_drive_count=4)
    pools = ServerPools([pool])
    assert {es.device for es in pools.pools[0].sets} == \
        {torch.device("cpu")}
    pools.make_bucket("b")
    pools.put_object("b", "o", b"on the host")
    assert bytes(pools.get_object("b", "o")[1]) == b"on the host"
    monkeypatch.setattr(pool.sets[1], "device", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="runs on cuda:0"):
        ServerPools([pool])
    with pytest.raises(ValueError):
        ServerPools([])
