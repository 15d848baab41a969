"""The seeded chaos matrix of the JAX package (tests/test_chaos.py: its
smoke and torn-rename cases, with the JAX tests' seeds) on the port's
ChaosDrive and erasure set, once more with the metadata lanes forced on
(MTPU_METABATCH_SOLO=1), and the naughty drive's program reaching a
laned publish.

Invariants: every acknowledged write reads back byte-exact (a read under
the storm may fail with a clean StorageError, never return wrong bytes);
rejected writes stay invisible; once the weather stops, heal converges
to full width."""

import os
import random

import numpy as np
import pytest

from minio_tpu_torch.engine import heal as heal_mod
from minio_tpu_torch.engine.erasure_set import BLOCK_SIZE, ErasureSet
from minio_tpu_torch.ops import coalesce, metalanes
from minio_tpu_torch.storage import drive as drive_mod
from minio_tpu_torch.storage.chaos import ChaosDrive, ErrChaosInjected
from minio_tpu_torch.storage.errors import ErrDiskNotFound, StorageError
from minio_tpu_torch.storage.naughty import NaughtyDrive

pytestmark = pytest.mark.chaos

SIZES = [700, 64_000, 300_000, BLOCK_SIZE + 77]


@pytest.fixture(autouse=True)
def cold_planes():
    coalesce.reset()
    metalanes.reset()
    yield
    metalanes.reset()
    coalesce.reset()


@pytest.fixture
def sets():
    made = []
    yield made.append
    for es in made:
        es.close()


def payload(size, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def build_set(tmp, seed, track, n=4, m=2, tag=""):
    """Chaos drives start calm (rates 0) so the bucket's setup is
    deterministic; storm() turns the weather on."""
    drives = [ChaosDrive(f"{tmp}/{tag}s{seed}d{i}", seed=seed * 101 + i)
              for i in range(n)]
    es = ErasureSet(drives, default_parity=m, device="cpu")
    track(es)
    es.make_bucket("cb")
    return es, drives


def storm(drives, error_rate=0.05, slow_rate=0.05, torn_rate=0.04,
          slow_s=0.002):
    for d in drives:
        d.error_rate = error_rate
        d.slow_rate = slow_rate
        d.torn_rate = torn_rate
        d.slow_s = slow_s


def run_scenario(tmp_path, seed, track, n=4, m=2, sizes=SIZES, rounds=1,
                 with_tier=False):
    es, drives = build_set(str(tmp_path), seed, track, n=n, m=m)
    if with_tier:
        from minio_tpu_torch.engine.hotcache import (HotObjectCache,
                                                     attach_sets)
        attach_sets(es, HotObjectCache(total_bytes=32 << 20))
    rng = np.random.default_rng(seed)
    storm(drives)

    acknowledged: dict[str, bytes] = {}
    rejected: list[str] = []
    for i, size in enumerate(sizes):
        name = f"o{i}"
        data = payload(size, seed * 1000 + i)
        try:
            es.put_object("cb", name, data)
        except StorageError:
            rejected.append(name)
        else:
            acknowledged[name] = data

    # Reads under the storm: exact bytes or a clean error.
    for _ in range(rounds):
        for name, data in acknowledged.items():
            try:
                _, got = es.get_object("cb", name)
            except StorageError:
                continue
            assert bytes(got) == data, (seed, name, "full GET corrupt")
            if len(data) > 10:
                off = int(rng.integers(0, len(data) - 2))
                ln = int(rng.integers(1, len(data) - off))
                try:
                    _, part = es.get_object("cb", name, offset=off,
                                            length=ln)
                except StorageError:
                    continue
                assert bytes(part) == data[off:off + ln], \
                    (seed, name, off, ln, "ranged GET corrupt")

    # The weather stops: heal converges.
    for d in drives:
        d.chaos_off()
    for name in acknowledged:
        for _ in range(2 * n):
            rs = heal_mod.heal_object(es, "cb", name, deep=True)
            if all(not r.healed for r in rs):
                break
        rs = heal_mod.heal_object(es, "cb", name, deep=True)
        assert all(not r.healed for r in rs), \
            (seed, name, "heal did not converge")
        for r in rs:
            assert r.after == [heal_mod.DRIVE_OK] * n, (seed, name)

    # No acknowledged write lost, full width back.
    for name, data in acknowledged.items():
        _, got = es.get_object("cb", name)
        assert bytes(got) == data, (seed, name, "data loss after heal")
    for name in rejected:
        with pytest.raises(StorageError):
            es.get_object("cb", name)
    return es, drives, acknowledged


class TestChaosSmoke:
    @pytest.mark.parametrize("lanes", ["default", "solo"])
    def test_one_seed_matrix(self, tmp_path, sets, monkeypatch, lanes):
        """One seed through the whole scenario; with
        MTPU_METABATCH_SOLO=1 every inline publish (the 700 B and 64 kB
        objects) goes through the write lanes' journaled batches."""
        if lanes == "solo":
            monkeypatch.setenv("MTPU_METABATCH_SOLO", "1")
        st0 = drive_mod.stats()
        es, drives, acked = run_scenario(tmp_path, seed=7, track=sets)
        assert sum(sum(d.injected.values()) for d in drives) > 0
        commits = (drive_mod.stats()["meta_group_commits"]
                   - st0["meta_group_commits"])
        assert (commits > 0) == (lanes == "solo")

    def test_one_seed_matrix_hotcache(self, tmp_path, sets, monkeypatch):
        """The same with the hot tier attached: a tainted read under the
        storm must bypass the fill, calm verified reads fill then hit,
        and an overwrite is read back new at once."""
        monkeypatch.setenv("MTPU_HOTCACHE", "1")
        es, drives, acked = run_scenario(tmp_path, seed=7, track=sets,
                                         rounds=3, with_tier=True)
        assert es.hot_tier.stats()["bypassed"] > 0
        big = max(acked, key=lambda k: len(acked[k]))
        for _ in range(3):
            _, got = es.get_object("cb", big)
            assert bytes(got) == acked[big]
        assert es.hot_tier.stats()["hits"] > 0
        for j, name in enumerate(sorted(acked)[:2]):
            new = payload(len(acked[name]) + 17, seed=7000 + j)
            es.put_object("cb", name, new)
            _, got = es.get_object("cb", name)
            assert bytes(got) == new

    def test_determinism_same_seed_same_faults(self, tmp_path):
        """Identical call sequences on identical seeds inject identical
        fault sequences."""
        logs = []
        for run in ("a", "b"):
            d = ChaosDrive(f"{tmp_path}/det{run}", seed=42)
            d.make_volume("v")
            d.error_rate, d.slow_rate, d.torn_rate = 0.3, 0.2, 0.2
            d.slow_s = 0.0
            outcomes = []
            for i in range(60):
                try:
                    d.write_all("v", f"f{i}", b"x" * 64)
                    outcomes.append("ok")
                except StorageError as e:
                    outcomes.append(type(e).__name__)
            logs.append((outcomes, dict(d.injected)))
        assert logs[0] == logs[1]

    def test_batched_calls_draw_once_per_call(self, tmp_path):
        """A batched metadata call is one intercepted call: three draws,
        whatever its length, so the schedule stays a function of (seed,
        call order).  (The drive's internal read_all calls are
        intercepted calls too; the weather here is on the batched call
        alone.)"""
        from minio_tpu_torch.storage.xlmeta import FileInfo
        seed, rate = 42, 0.3
        d = ChaosDrive(f"{tmp_path}/batched", seed=seed, error_rate=rate,
                       methods=("write_metadata_many",))
        d.make_volume("v")
        got = []
        for i in range(40):
            items = [("v", f"o{i}-{j}", FileInfo(
                volume="v", name=f"o{i}-{j}", size=1, inline_data=b"x",
                mod_time_ns=1)) for j in range(i % 3 + 1)]
            try:
                errs = d.write_metadata_many(items)
                got.append("ok" if errs == [None] * len(items) else "item")
            except ErrDiskNotFound:
                got.append("err")
        oracle = random.Random(seed)
        want = []
        for _ in range(40):
            oracle.random()
            oracle.random()
            want.append("err" if oracle.random() < rate else "ok")
        assert got == want and "err" in got

    def test_torn_write_never_becomes_data(self, tmp_path, sets):
        """One drive tearing every write: the stripe still reaches
        quorum, the readback is exact, and heal repairs the drive once
        the weather stops."""
        es, drives = build_set(str(tmp_path), seed=3, track=sets,
                               tag="torn")
        drives[0].torn_rate = 1.0
        data = payload(300_000, seed=31)
        es.put_object("cb", "t", data)
        _, got = es.get_object("cb", "t")
        assert bytes(got) == data
        assert drives[0].injected["torn"] > 0
        drives[0].chaos_off()
        r = heal_mod.heal_object(es, "cb", "t", deep=True)[0]
        assert 0 in r.healed_drives or r.before[0] == heal_mod.DRIVE_OK
        r2 = heal_mod.heal_object(es, "cb", "t", deep=True)[0]
        assert not r2.healed and r2.after == [heal_mod.DRIVE_OK] * 4

    def test_quorum_edge_stays_clean(self, tmp_path, sets):
        """m dead drives: exact bytes.  m + 1: a clean StorageError."""
        es, drives = build_set(str(tmp_path), seed=5, track=sets,
                               tag="edge")
        data = payload(200_000, seed=51)
        es.put_object("cb", "q", data)
        for d in drives[:2]:
            d.error_rate = 1.0
        _, got = es.get_object("cb", "q")
        assert bytes(got) == data
        drives[2].error_rate = 1.0
        with pytest.raises(StorageError):
            es.get_object("cb", "q")


class TestTornRename:
    """Torn rename_data: the data dir moved into place, xl.meta never
    updated, the state a kill between the two halves of a publish
    leaves."""

    def _set_with_torn_rename(self, tmp, track, seed=13):
        drives = [ChaosDrive(f"{tmp}/trd{i}", seed=seed * 101 + i,
                             **({"methods": ("rename_data",),
                                 "torn_rate": 1.0} if i == 0 else {}))
                  for i in range(4)]
        es = ErasureSet(drives, default_parity=2, device="cpu")
        track(es)
        es.make_bucket("cb")
        return es, drives

    def test_orphan_data_dir_stays_invisible(self, tmp_path, sets):
        es, drives = self._set_with_torn_rename(str(tmp_path), sets)
        data = payload(300_000, seed=131)
        es.put_object("cb", "t", data)
        assert drives[0].injected["torn"] == 1
        obj_dir = os.path.join(drives[0].root, "cb", "t")
        entries = os.listdir(obj_dir)
        assert "xl.meta" not in entries and entries, entries
        _, got = es.get_object("cb", "t")
        assert bytes(got) == data
        drives[0].chaos_off()
        for _ in range(4):
            rs = heal_mod.heal_object(es, "cb", "t", deep=True)
            if all(not r.healed for r in rs):
                break
        r = heal_mod.heal_object(es, "cb", "t", deep=True)[0]
        assert not r.healed and r.after == [heal_mod.DRIVE_OK] * 4
        assert "xl.meta" in os.listdir(obj_dir)
        _, got = es.get_object("cb", "t")
        assert bytes(got) == data

    def test_draw_sequence_is_seed_oracle(self, tmp_path):
        """The fault schedule is the one a bare random.Random(seed)
        predicts: three draws (slow, torn, err) per intercepted call."""
        seed, rate = 77, 0.25
        d = ChaosDrive(f"{tmp_path}/oracle", seed=seed,
                       error_rate=rate, torn_rate=rate,
                       methods=("write_all",))
        d.make_volume("v")
        got = []
        for i in range(50):
            try:
                d.write_all("v", f"f{i}", b"y" * 32)
                got.append("ok")
            except ErrChaosInjected as e:
                got.append("torn" if "torn" in str(e) else "err")
            except StorageError:
                got.append("err")
        oracle_rng = random.Random(seed)
        want = []
        for _ in range(50):
            oracle_rng.random()
            r_torn = oracle_rng.random()
            r_err = oracle_rng.random()
            want.append("torn" if r_torn < rate
                        else ("err" if r_err < rate else "ok"))
        assert got == want
        assert "torn" in got and "err" in got

    def test_torn_rename_with_scripted_overwrite(self, tmp_path, sets):
        """The torn publish of an overwrite: the new version still wins
        at quorum and heal keeps it."""
        es, drives = self._set_with_torn_rename(str(tmp_path), sets,
                                                seed=17)
        drives[0].chaos_off()
        v1 = payload(200_000, seed=171)
        es.put_object("cb", "ow", v1)
        drives[0].torn_rate = 1.0
        v2 = payload(200_000, seed=172)
        es.put_object("cb", "ow", v2)
        _, got = es.get_object("cb", "ow")
        assert bytes(got) == v2
        drives[0].chaos_off()
        for _ in range(4):
            rs = heal_mod.heal_object(es, "cb", "ow", deep=True)
            if all(not r.healed for r in rs):
                break
        _, got = es.get_object("cb", "ow")
        assert bytes(got) == v2


def test_scripted_write_metadata_fault_hits_a_laned_publish(tmp_path, sets,
                                                            monkeypatch):
    """With the lanes on, a fault programmed on one drive's
    write_metadata fails that drive's item of the batched publish:
    the PUT still reaches quorum, the drive holds no xl.meta of the key,
    and heal restores it."""
    monkeypatch.setenv("MTPU_METABATCH_SOLO", "1")
    drives = [NaughtyDrive(str(tmp_path / f"n{i}")) for i in range(4)]
    es = ErasureSet(drives, default_parity=2, device="cpu")
    sets(es)
    es.make_bucket("b")
    drives[1].fail("write_metadata", on_call=1)
    data = payload(3000, seed=61)
    es.put_object("b", "k", data)
    assert drives[1].calls["write_metadata_many"] >= 1
    assert not os.path.exists(os.path.join(drives[1].root, "b", "k"))
    assert os.path.exists(os.path.join(drives[0].root, "b", "k", "xl.meta"))
    assert bytes(es.get_object("b", "k")[1]) == data
    r = heal_mod.heal_object(es, "b", "k")[0]
    assert r.healed_drives == [1]
    assert drives[1].read_version("b", "k").inline_data is not None
