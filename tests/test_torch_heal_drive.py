"""The port's drive heal (minio_tpu_torch.engine.heal, device="cpu"): the
drive-level scenarios of tests/test_heal.py, the pipelined heal against
its serial oracle, a wiped drive healed by both packages, which must
leave the same files, equal to the tree before the wipe, and the
HealingTracker, format.json, listing and walk that either package reads
from the other."""

import os
import shutil
import threading

import numpy as np
import pytest

from minio_tpu.engine import heal as jax_heal
from minio_tpu.engine import multipart as jax_mp
from minio_tpu.engine.erasure_set import ErasureSet as JaxErasureSet
from minio_tpu.storage import format as jax_format
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.engine import heal
from minio_tpu_torch.engine.erasure_set import BLOCK_SIZE, ErasureSet
from minio_tpu_torch.parallel import pipeline as pl
from minio_tpu_torch.storage import format as fmt
from minio_tpu_torch.storage.drive import SYS_VOL, LocalDrive

HH = "highwayhash256S"


def make_set(tmp_path, n=6, parity=None, name="hs"):
    drives = [LocalDrive(str(tmp_path / name / f"d{i}")) for i in range(n)]
    return ErasureSet(drives, default_parity=parity, device="cpu")


def payload(size, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def drive_files(root, bucket):
    """(relpath -> bytes) of a bucket dir on one drive."""
    base = os.path.join(root, bucket)
    out = {}
    for dirpath, _, files in os.walk(base):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, base)] = fh.read()
    return out


def drive_tree(root):
    """(relpath -> bytes) of every bucket file on a drive, and its
    format.json: what a heal must restore."""
    out = {}
    for vol in sorted(os.listdir(root)):
        if vol.startswith("."):
            continue
        for rel, blob in drive_files(root, vol).items():
            out[f"{vol}/{rel}"] = blob
    p = os.path.join(root, SYS_VOL, "format.json")
    if os.path.exists(p):
        with open(p, "rb") as f:
            out[f"{SYS_VOL}/format.json"] = f.read()
    return out


def wipe(es, pos):
    """A replaced drive: its whole directory gone, reopened empty."""
    root = es.drives[pos].root
    shutil.rmtree(root)
    es.drives[pos] = LocalDrive(root)


class TestHealDrive:
    def test_full_drive_heal(self, tmp_path):
        with make_set(tmp_path, n=4) as es:
            es.make_bucket("b1")
            es.make_bucket("b2")
            blobs = {}
            for i in range(5):
                data = payload(200_000 + i * 37, seed=i)
                es.put_object("b1", f"obj{i}", data)
                blobs["b1", f"obj{i}"] = data
            small = payload(500, seed=99)
            es.put_object("b2", "tiny", small)
            blobs["b2", "tiny"] = small
            wipe(es, 1)

            tracker = heal.heal_drive(es, 1)
            assert tracker.finished
            assert tracker.objects_healed == 6
            assert tracker.objects_failed == 0
            assert tracker.bytes_healed == sum(len(b) for b in blobs.values())
            es.drives[0] = None        # reads must use the healed drive
            for (b, o), data in blobs.items():
                assert bytes(es.get_object(b, o)[1]) == data

    def test_tracker_resume(self, tmp_path):
        with make_set(tmp_path, n=4) as es:
            es.make_bucket("b")
            for i in range(4):
                es.put_object("b", f"o{i}", payload(1000, seed=i))
            wipe(es, 0)
            # An interrupted heal that already covered o0 and o1.
            heal.HealingTracker(heal_id="x", started_ns=1,
                                resume_bucket="b", resume_object="o1",
                                objects_healed=2).save(es.drives[0])
            tracker = heal.heal_drive(es, 0)
            assert tracker.finished and tracker.heal_id == "x"
            assert tracker.objects_healed == 4    # 2 carried + 2 new
            assert not os.path.exists(
                os.path.join(es.drives[0].root, "b", "o0", "xl.meta"))
            heal.heal_object(es, "b", "o0")       # what resume skipped
            assert os.path.exists(
                os.path.join(es.drives[0].root, "b", "o0", "xl.meta"))
            assert heal.HealingTracker.load(es.drives[0]).finished


class TestPipelineEquivalence:
    """The pipelined heal (MTPU_HEAL_PIPELINE=1, the default) gives
    byte-identical repaired shards and identical HealResults to the
    serial oracle over a randomized corruption matrix."""

    @pytest.mark.parametrize("seed", range(6))
    def test_serial_vs_pipelined_byte_identity(self, tmp_path, seed,
                                               monkeypatch):
        rng = np.random.default_rng(seed + 1000)
        n = int(rng.choice([4, 6]))
        par = n // 2
        size = int(rng.choice([3 * BLOCK_SIZE + 777, 5 * BLOCK_SIZE,
                               2 * BLOCK_SIZE + 1,
                               6 * BLOCK_SIZE + 12345]))
        # Small batches: several pipelined batches on a few MiB.
        monkeypatch.setattr(heal, "HEAL_BATCH_BLOCKS", 4)
        n_bad = int(rng.integers(1, par + 1))
        bad = sorted(rng.choice(n, size=n_bad, replace=False).tolist())
        modes = [str(rng.choice(["wipe", "flip", "truncate"]))
                 for _ in bad]
        flip_frac = [float(rng.random()) for _ in bad]

        outcomes = {}
        for env, name in (("0", "serial"), ("1", "pipelined")):
            monkeypatch.setenv("MTPU_HEAL_PIPELINE", env)
            with make_set(tmp_path, n=n, name=f"eq-{name}") as es:
                es.make_bucket("b")
                data = payload(size, seed=seed)
                fi = es.put_object("b", "o", data)
                golden = [drive_files(d.root, "b") for d in es.drives]
                for pos, cmode, frac in zip(bad, modes, flip_frac):
                    part = os.path.join(es.drives[pos].root, "b", "o",
                                        fi.data_dir, "part.1")
                    if cmode == "wipe":
                        shutil.rmtree(os.path.join(es.drives[pos].root,
                                                   "b", "o"))
                    elif cmode == "flip":
                        raw = bytearray(open(part, "rb").read())
                        raw[int(frac * len(raw))] ^= 0x5A
                        open(part, "wb").write(bytes(raw))
                    else:
                        raw = open(part, "rb").read()
                        open(part, "wb").write(raw[:len(raw) // 2])
                heal.STAGES.reset()
                r = heal.heal_object(es, "b", "o", deep=True)[0]
                batches = heal.STAGES.read()["batches"]
                want = -(-(size // BLOCK_SIZE) // 4) + (
                    1 if size % BLOCK_SIZE else 0)
                assert batches == (0 if name == "serial" else want), name
                outcomes[name] = (r.before, r.after,
                                  sorted(r.healed_drives), r.purged)
                assert sorted(r.healed_drives) == bad, (name, r.before)
                for pos in bad:
                    assert drive_files(es.drives[pos].root, "b") == \
                        golden[pos], (name, pos)
                assert bytes(es.get_object("b", "o")[1]) == data
        assert outcomes["serial"] == outcomes["pipelined"]


class TestConcurrentHealDrive:
    @staticmethod
    def _seed_objects(es, count):
        es.make_bucket("b")
        blobs = {}
        for i in range(count):
            data = payload(20_000 + i * 13, seed=i)
            es.put_object("b", f"o{i:02d}", data)
            blobs[f"o{i:02d}"] = data
        return blobs

    def test_interrupted_concurrent_heal_resumes(self, tmp_path,
                                                 monkeypatch):
        with make_set(tmp_path, n=4, name="ci") as es:
            blobs = self._seed_objects(es, 12)
            wipe(es, 1)
            stop = threading.Event()
            calls = {"n": 0}
            mu = threading.Lock()
            real = heal.heal_object

            def stopping(*a, **kw):
                with mu:
                    calls["n"] += 1
                    if calls["n"] == 5:
                        stop.set()
                return real(*a, **kw)
            monkeypatch.setattr(heal, "heal_object", stopping)
            t1 = heal.heal_drive(es, 1, workers=4, checkpoint_every=2,
                                 stop=stop)
            assert not t1.finished
            saved = heal.HealingTracker.load(es.drives[1])
            assert saved is not None and not saved.finished
            # The saved resume point is a CONTIGUOUS prefix: every object
            # at or before it is on the healed drive.
            if saved.resume_object:
                for name in sorted(blobs):
                    if name <= saved.resume_object:
                        assert os.path.exists(os.path.join(
                            es.drives[1].root, "b", name, "xl.meta")), name

            monkeypatch.setattr(heal, "heal_object", real)
            t2 = heal.heal_drive(es, 1, workers=4)
            assert t2.finished
            # Objects past the frontier healed before the interrupt heal
            # again as no-ops: the count lands exactly on the total.
            assert t2.objects_healed == len(blobs)
            assert t2.objects_failed == 0
            es.drives[0] = None        # reads must use the healed drive
            for name, data in blobs.items():
                assert os.path.exists(os.path.join(
                    es.drives[1].root, "b", name, "xl.meta")), name
                assert bytes(es.get_object("b", name)[1]) == data

    def test_concurrency_is_bounded(self, tmp_path, monkeypatch):
        with make_set(tmp_path, n=4, name="bc") as es:
            self._seed_objects(es, 10)
            wipe(es, 2)
            gauge = {"cur": 0, "max": 0}
            mu = threading.Lock()
            real = heal.heal_object

            def tracking(*a, **kw):
                with mu:
                    gauge["cur"] += 1
                    gauge["max"] = max(gauge["max"], gauge["cur"])
                try:
                    return real(*a, **kw)
                finally:
                    with mu:
                        gauge["cur"] -= 1
            monkeypatch.setattr(heal, "heal_object", tracking)
            t = heal.heal_drive(es, 2, workers=3)
            assert t.finished and t.objects_healed == 10
            assert 0 < gauge["max"] <= 3


def _jax_tree(root, algo, n, parity, monkeypatch):
    """A formatted EC set the JAX package wrote: two objects of `algo`,
    an inline object, an mxh256 multipart object of two parts, and a
    versioned object with two versions and a delete marker."""
    paths = [str(root / f"d{i}") for i in range(n)]
    drives = [JaxLocalDrive(p) for p in paths]
    jax_format.init_format_sets([drives])
    jes = JaxErasureSet(drives, default_parity=parity)
    jes.make_bucket("a")
    jes.make_bucket("b")
    big = 2 * BLOCK_SIZE + 4321 if algo == "mxh256" else 200 * 1024
    monkeypatch.setenv("MTPU_BITROT_ALGO", algo)
    jes.put_object("a", "x/one", payload(big, seed=1))
    jes.put_object("a", "x/two", payload(big + 1000, seed=2))
    jes.put_object("b", "inline", payload(3000, seed=3))
    monkeypatch.setenv("MTPU_BITROT_ALGO", "mxh256")
    uid = jax_mp.new_multipart_upload(jes, "b", "mp")
    listed = []
    for i, size in enumerate((5 * BLOCK_SIZE, 70_000)):
        info = jax_mp.put_object_part(jes, "b", "mp", uid, i + 1,
                                      payload(size, seed=10 + i))
        listed.append((i + 1, info.etag))
    jax_mp.complete_multipart_upload(jes, "b", "mp", uid, listed)
    jes.put_object("b", "v", payload(150_000, seed=4), versioned=True)
    jes.put_object("b", "v", payload(2000, seed=5), versioned=True)
    jes.delete_object("b", "v", versioned=True)
    monkeypatch.delenv("MTPU_BITROT_ALGO")
    return paths


@pytest.mark.parametrize("algo", ["mxh256", HH])
def test_same_drive_as_the_jax_heal(tmp_path, algo, monkeypatch):
    """A tree the JAX package wrote, with one drive wiped whole, copied
    twice: the JAX package's heal_format + heal_drive heal one copy and
    the port's the other.  Both end file for file equal to each other
    and to the tree before the wipe, format.json and xl.meta included."""
    n, parity, pos = 4, 2, 1
    src = tmp_path / "src"
    paths = _jax_tree(src, algo, n, parity, monkeypatch)
    before = [drive_tree(p) for p in paths]
    shutil.rmtree(paths[pos])
    copies = {}
    for name in ("jax", "torch"):
        shutil.copytree(src, tmp_path / name)
        copies[name] = [str(tmp_path / name / f"d{i}") for i in range(n)]

    jes = JaxErasureSet([JaxLocalDrive(p) for p in copies["jax"]],
                        default_parity=parity)
    assert jax_heal.heal_format(jes) == [pos]
    jt = jax_heal.heal_drive(jes, pos)
    with ErasureSet([LocalDrive(p) for p in copies["torch"]],
                    default_parity=parity, device="cpu") as es:
        assert heal.heal_format(es) == [pos]
        assert heal.heal_format(es) == []
        t = heal.heal_drive(es, pos, workers=2)
        got = {b: bytes(es.get_object("b", b)[1]) for b in ("inline", "mp")}
    assert (t.finished, t.objects_healed, t.objects_failed,
            t.bytes_healed, t.resume_bucket, t.resume_object) == \
        (jt.finished, jt.objects_healed, jt.objects_failed,
         jt.bytes_healed, jt.resume_bucket, jt.resume_object)
    assert t.objects_healed == 7 and t.objects_failed == 0
    assert got["inline"] == payload(3000, seed=3)
    assert got["mp"] == payload(5 * BLOCK_SIZE, seed=10) + \
        payload(70_000, seed=11)
    for i in range(n):
        theirs = drive_tree(copies["jax"][i])
        ours = drive_tree(copies["torch"][i])
        assert ours == theirs == before[i], i


def test_heal_format_writes_the_layout_slot(tmp_path):
    drives = [LocalDrive(str(tmp_path / f"d{i}")) for i in range(4)]
    ref = fmt.init_format_sets([drives])
    formats = [fmt.load_format(d) for d in drives]
    assert fmt.quorum_formatted(formats)
    assert [f["xl"]["this"] for f in formats] == ref["xl"]["sets"][0]
    golden = open(os.path.join(drives[2].root, SYS_VOL, "format.json"),
                  "rb").read()
    with ErasureSet(drives, device="cpu") as es:
        assert heal.heal_format(es) == []
        wipe(es, 2)
        assert fmt.load_format(es.drives[2]) is None
        assert not fmt.quorum_formatted([None, None, None, formats[3]])
        assert heal.heal_format(es) == [2]
        assert es.drives[2].disk_id == ref["xl"]["sets"][0][2]
    assert open(os.path.join(drives[2].root, SYS_VOL, "format.json"),
                "rb").read() == golden
    # The JAX package reads the port's format and verifies every slot.
    jdrives = [JaxLocalDrive(d.root) for d in drives]
    assert jax_format.init_format_sets([jdrives])["id"] == ref["id"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tracker_across_packages(tmp_path, writer):
    """A HealingTracker saved by one package loads in the other, with
    the same bytes on disk."""
    fields = dict(heal_id="h-1", started_ns=123456789,
                  resume_bucket="bkt", resume_object="dir/obj",
                  objects_healed=7, objects_failed=1,
                  bytes_healed=1 << 33, finished=False)
    root = str(tmp_path / "d")
    ours, theirs = LocalDrive(root), JaxLocalDrive(root)
    if writer == "jax":
        jax_heal.HealingTracker(**fields).save(theirs)
        loaded = heal.HealingTracker.load(ours)
    else:
        heal.HealingTracker(**fields).save(ours)
        loaded = jax_heal.HealingTracker.load(theirs)
    assert vars(loaded) == fields
    blob = ours.read_all(SYS_VOL, heal.HEALING_FILE)
    jax_heal.HealingTracker(**fields).save(theirs)
    assert ours.read_all(SYS_VOL, heal.HEALING_FILE) == blob
    assert heal.HealingTracker.load(LocalDrive(str(tmp_path / "e"))) is None


def test_heal_bucket_objects_prefix_and_callback(tmp_path):
    with make_set(tmp_path, n=4) as es:
        es.make_bucket("b")
        names = ["logs/1", "logs/2", "logs/3", "other"]
        for i, name in enumerate(names):
            es.put_object("b", name, payload(3000 + i, seed=i))
        for name in names:
            shutil.rmtree(os.path.join(es.drives[3].root, "b", name))
        seen = {}
        mu = threading.Lock()

        def on_object(name, results, err):
            with mu:
                seen[name] = (err, [r.healed_drives for r in results])
        results = heal.heal_bucket_objects(es, "b", prefix="logs/",
                                           workers=2, on_object=on_object)
        assert sorted(r.object for r in results) == names[:3]
        assert seen == {n: (None, [[3]]) for n in names[:3]}
        assert not os.path.exists(os.path.join(es.drives[3].root, "b",
                                               "other"))
        assert heal.heal_bucket_objects(es, "b", prefix="logs/") and all(
            not r.healed for r in heal.heal_bucket_objects(es, "b",
                                                           prefix="logs/"))
        stop = threading.Event()
        stop.set()
        assert heal.heal_bucket_objects(es, "b", stop=stop) == []


def test_listing_matches_the_jax_drive(tmp_path):
    """list_buckets, list_volumes and walk_dir see what the JAX package's
    drive sees on the same directories."""
    with make_set(tmp_path, n=4) as es:
        for b in ("zeta", "alpha"):
            es.make_bucket(b)
        for name in ("a/b/c", "a/b!x", "a/bc", "top"):
            es.put_object("alpha", name, payload(100))
        os.makedirs(os.path.join(es.drives[0].root, ".hidden"))
        assert es.list_buckets() == ["alpha", "zeta"]
        for d in es.drives:
            jd = JaxLocalDrive(d.root)
            assert d.list_volumes() == jd.list_volumes()
            for prefix in ("", "a/", "a/b", "t"):
                assert list(d.walk_dir("alpha", prefix)) == \
                    list(jd.walk_dir("alpha", prefix)), prefix
        shutil.rmtree(os.path.join(es.drives[1].root, "zeta"))
        shutil.rmtree(os.path.join(es.drives[2].root, "zeta"))
        shutil.rmtree(os.path.join(es.drives[3].root, "zeta"))
        assert es.list_buckets() == ["alpha"]     # 1 of 4 < quorum 2


class TestPipelinePrimitives:
    def test_prefetch_map_keeps_order_and_bounds_readahead(self):
        from concurrent.futures import ThreadPoolExecutor
        started = []
        mu = threading.Lock()

        def fn(i):
            with mu:
                started.append(i)
            return i * i
        with ThreadPoolExecutor(4) as pool:
            out = []
            for i, v in enumerate(pl.prefetch_map(fn, range(20), pool,
                                                  depth=2)):
                with mu:
                    assert len(started) <= i + 3     # depth + 1 ahead
                out.append(v)
        assert out == [i * i for i in range(20)]
        assert list(pl.prefetch_map(fn, range(3), None)) == [0, 1, 4]

    def test_stage_pipeline_orders_writes(self):
        from concurrent.futures import ThreadPoolExecutor
        writes, stages = [], []
        with ThreadPoolExecutor(2) as pool:
            n = pl.StagePipeline(pool).run(
                pl.prefetch_map(lambda i: i, range(10), pool),
                lambda i: i + 100, writes.append,
                on_batch=lambda *t: stages.append(t))
        assert n == 10 and writes == list(range(100, 110))
        assert len(stages) == 10 and all(min(t) >= 0 for t in stages)

    def test_stage_pipeline_waits_for_the_write_in_flight(self):
        from concurrent.futures import ThreadPoolExecutor
        done = []

        def compute(i):
            if i == 3:
                raise ValueError("boom")
            return i

        def write(i):
            threading.Event().wait(0.02)
            done.append(i)
        with ThreadPoolExecutor(2) as pool:
            with pytest.raises(ValueError):
                pl.StagePipeline(pool).run(range(6), compute, write)
            assert done == [0, 1, 2]

    def test_frontier_is_contiguous(self):
        f = pl.Frontier()
        assert [f.mark(i) for i in (2, 0, 3, 1, 5)] == [0, 1, 1, 4, 4]
        assert f.position == 4

    def test_run_window_bounds_and_stops(self):
        from concurrent.futures import ThreadPoolExecutor
        gauge = {"cur": 0, "max": 0}
        mu = threading.Lock()
        stop = threading.Event()

        def fn(i):
            with mu:
                gauge["cur"] += 1
                gauge["max"] = max(gauge["max"], gauge["cur"])
            threading.Event().wait(0.005)
            with mu:
                gauge["cur"] -= 1
            if i == 7:
                raise KeyError(i)
            return i
        with ThreadPoolExecutor(8) as pool:
            got = {idx: (r, e) for idx, _, r, e in
                   pl.run_window(fn, iter(range(30)), pool, window=3)}
            assert sorted(got) == list(range(30))
            assert isinstance(got[7][1], KeyError)
            assert all(got[i] == (i, None) for i in range(30) if i != 7)
            assert 0 < gauge["max"] <= 3
            stop.set()
            assert list(pl.run_window(fn, range(5), pool, 3,
                                      stop=stop)) == []
