"""The port's device shard cache and host-to-device ledger
(minio_tpu_torch/ops/devcache.py) on the CPU, on the fill discipline of
tests/test_devcache.py: a corrupt or degraded read never fills, an
overwrite or a delete invalidates, a mutation made with the cache off
still invalidates, a recovery boot starts cold, LRU eviction under a
small cap and an oversized fill refused; a hit places 0 bytes by the
ledger and a first touch about one per byte served; heal rebuilds from
resident rows to the same end state; and MTPU_DEVCACHE=0 and
MTPU_H2D_PIPELINE=0 give the same bytes."""

import os
import shutil
import threading

import numpy as np
import pytest

from minio_tpu_torch.engine import heal
from minio_tpu_torch.engine.erasure_set import (BATCH_BLOCKS, BLOCK_SIZE,
                                                ErasureSet)
from minio_tpu_torch.ops import coalesce, devcache, fused
from minio_tpu_torch.storage.drive import LocalDrive
from minio_tpu_torch.storage.errors import ErrObjectNotFound

CPU = "cpu"


@pytest.fixture(autouse=True)
def fresh_plane():
    coalesce.reset()
    devcache.reset()
    yield
    coalesce.reset()
    devcache.reset()


@pytest.fixture(params=["1", "0"], ids=["devcache", "nocache"])
def cache_mode(request, monkeypatch):
    monkeypatch.setenv("MTPU_DEVCACHE", request.param)
    return request.param


def make_set(tmp_path, n=4, parity=None, name="dc"):
    return ErasureSet([LocalDrive(str(tmp_path / name / f"d{i}"))
                       for i in range(n)], default_parity=parity, device=CPU)


def payload(size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


def corrupt_part(es, pos, bucket, obj, fi, at=100):
    p = os.path.join(es.drives[pos].root, bucket, obj, fi.data_dir, "part.1")
    with open(p, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))


def drive_files(drive, bucket):
    base = os.path.join(drive.root, bucket)
    out = {}
    for dirpath, _, files in os.walk(base):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, base)] = fh.read()
    return out


def data_drive(es, fi, s=0):
    from minio_tpu_torch.engine import quorum as Q
    order = Q.shuffle_by_distribution(list(range(es.n)),
                                      fi.erasure.distribution)
    return order[s]


class TestOracleEquivalence:
    def test_randomized_ranges(self, tmp_path, cache_mode):
        """Ranged GETs, each twice (the second may hit), give the bytes
        of the object with the cache on and off."""
        es = make_set(tmp_path)
        es.make_bucket("b")
        data = payload(3 * BLOCK_SIZE + 12345, seed=9)
        es.put_object("b", "o", data)
        assert es.get_object("b", "o")[1] == data
        rng = np.random.default_rng(17)
        for _ in range(10):
            off = int(rng.integers(0, len(data)))
            ln = int(rng.integers(1, len(data) - off + 1))
            for _rep in range(2):
                assert es.get_object("b", "o", off, ln)[1] == \
                    data[off:off + ln], (off, ln)
        if cache_mode == "1":
            assert devcache.get().stats()["hits"] > 0
        else:
            assert devcache.stats() is None or \
                devcache.get().stats()["fills"] == 0
        es.close()

    @pytest.mark.parametrize("h2d", ["1", "0"], ids=["pipelined", "serial"])
    def test_h2d_pipeline_oracle(self, tmp_path, monkeypatch, h2d):
        """Concurrent PUTs and GETs through the lane: the pipelined
        staging writes and reads the bytes of the serial copies."""
        monkeypatch.setenv("MTPU_H2D_PIPELINE", h2d)
        monkeypatch.setenv("MTPU_DEVCACHE", "0")
        es = make_set(tmp_path, n=6, parity=2, name=f"h2d{h2d}")
        es.make_bucket("b")
        bodies = {f"o{i}": payload((i % 3) * BLOCK_SIZE + 777 * i + 1,
                                   seed=21 + i) for i in range(6)}
        lane = coalesce.get().lane(CPU)
        lane._ema = 2.0               # queue: the lane thread dispatches
        threads = [threading.Thread(target=es.put_object,
                                    args=("b", nm, data))
                   for nm, data in bodies.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
            assert not t.is_alive()
        for nm, data in bodies.items():
            assert es.get_object("b", nm)[1] == data
        files = {d: drive_files(es.drives[d], "b") for d in range(6)}
        st = lane.stats()
        queued = st["dispatches"] - st["inline_dispatches"]
        assert queued >= 1
        if h2d == "1":
            assert st["pipeline_dispatches"] == queued
        else:
            assert st["pipeline_dispatches"] == 0
        es.close()
        # The same objects through the other copy path: the same frames.
        monkeypatch.setenv("MTPU_H2D_PIPELINE", "0" if h2d == "1" else "1")
        coalesce.reset()
        other = make_set(tmp_path, n=6, parity=2, name=f"o{h2d}")
        other.make_bucket("b")
        for nm, data in bodies.items():
            other.put_object("b", nm, data)
        for d in range(6):
            a = {k.split("/")[0] + k[-7:]: v
                 for k, v in files[d].items() if k.endswith("part.1")}
            b = {k.split("/")[0] + k[-7:]: v
                 for k, v in drive_files(other.drives[d], "b").items()
                 if k.endswith("part.1")}
            assert a == b
        other.close()

    def test_heal_end_state(self, tmp_path, cache_mode):
        """Heal after a drive is wiped restores the same shard files
        whether its batches come from resident rows or from the disks."""
        es = make_set(tmp_path, n=4)
        es.make_bucket("b")
        data = payload(2 * BLOCK_SIZE + 100, seed=5)
        fi = es.put_object("b", "o", data,
                           mod_time_ns=1_700_000_000_000_000_000,
                           version_id="")
        golden = [drive_files(d, "b") for d in es.drives]
        assert es.get_object("b", "o")[1] == data      # fills when on
        pos = data_drive(es, fi, 1)
        root = es.drives[pos].root
        shutil.rmtree(root)
        es.drives[pos] = LocalDrive(root)
        hits = devcache.get().stats()["hits"]
        heal.heal_bucket(es, "b")
        r = heal.heal_object(es, "b", "o")[0]
        assert r.healed_drives == [pos]
        assert drive_files(es.drives[pos], "b") == golden[pos]
        if cache_mode == "1":
            assert devcache.get().stats()["hits"] > hits
        assert es.get_object("b", "o")[1] == data
        es.close()


class TestBoundaryAccounting:
    SIZE = BATCH_BLOCKS * BLOCK_SIZE // 8    # 4 full blocks, no tail

    def test_hit_places_zero_bytes(self, tmp_path, monkeypatch):
        monkeypatch.setenv("MTPU_DEVCACHE", "1")
        es = make_set(tmp_path, name="zerohit")
        es.make_bucket("b")
        data = payload(self.SIZE, seed=3)
        es.put_object("b", "o", data)
        assert es.get_object("b", "o")[1] == data   # first touch + fill
        st0 = devcache.h2d_stats()
        assert st0["h2d_dispatches"] > 0
        assert devcache.get().stats()["fills"] == 1
        items = dict(fused.ITEMS)
        assert es.get_object("b", "o")[1] == data   # resident
        st1 = devcache.h2d_stats()
        assert (st1["h2d_bytes"], st1["h2d_dispatches"]) == \
            (st0["h2d_bytes"], st0["h2d_dispatches"])
        assert fused.ITEMS == items                 # no device work
        assert devcache.get().stats()["hits"] == 1
        es.close()

    def test_first_touch_bytes_per_byte(self, tmp_path, monkeypatch):
        """A first-touch GET places each byte it serves once, through
        the direct call and through the lane's staging alike."""
        monkeypatch.setenv("MTPU_DEVCACHE", "1")
        es = make_set(tmp_path, name="ratio")
        es.make_bucket("b")
        data = payload(self.SIZE, seed=4)
        es.put_object("b", "o", data)
        es.put_object("b", "p", data)
        devcache.reset_h2d()                        # drop the PUTs'
        assert es.get_object("b", "o")[1] == data
        assert devcache.h2d_stats()["h2d_bytes"] == self.SIZE
        lane = coalesce.get().lane(CPU)
        lane._ema = 2.0               # hot: the verify rides the lane
        devcache.reset_h2d()
        assert es.get_object("b", "p")[1] == data
        assert devcache.h2d_stats()["h2d_bytes"] == self.SIZE
        assert lane.stats()["h2d_bytes"] == self.SIZE
        es.close()


class TestFillDiscipline:
    def test_corrupt_read_never_fills(self, tmp_path, monkeypatch):
        monkeypatch.setenv("MTPU_DEVCACHE", "1")
        es = make_set(tmp_path)
        es.make_bucket("b")
        data = payload(2 * BLOCK_SIZE + 50, seed=7)
        fi = es.put_object("b", "o", data)
        corrupt_part(es, data_drive(es, fi), "b", "o", fi)
        assert es.get_object("b", "o")[1] == data   # rebuilt from parity
        st = devcache.get().stats()
        assert st["fills"] == 0 and st["entries"] == 0
        es.close()

    def test_degraded_read_never_fills(self, tmp_path, monkeypatch):
        monkeypatch.setenv("MTPU_DEVCACHE", "1")
        es = make_set(tmp_path)
        es.make_bucket("b")
        data = payload(2 * BLOCK_SIZE, seed=8)
        fi = es.put_object("b", "o", data)
        es.drives[data_drive(es, fi)] = None
        assert es.get_object("b", "o")[1] == data
        st = devcache.get().stats()
        assert st["fills"] == 0 and st["entries"] == 0
        es.close()

    def test_overwrite_invalidates(self, tmp_path, cache_mode):
        es = make_set(tmp_path)
        es.make_bucket("b")
        old = payload(2 * BLOCK_SIZE + 9, seed=10)
        new = payload(2 * BLOCK_SIZE + 9, seed=11)
        es.put_object("b", "o", old)
        assert es.get_object("b", "o")[1] == old
        es.put_object("b", "o", new)
        assert es.get_object("b", "o")[1] == new
        if cache_mode == "1":
            assert devcache.get().stats()["invalidations"] > 0
        es.close()

    def test_delete_invalidates(self, tmp_path, cache_mode):
        es = make_set(tmp_path)
        es.make_bucket("b")
        es.put_object("b", "o", payload(BLOCK_SIZE + 3, seed=12))
        es.get_object("b", "o")
        es.delete_object("b", "o")
        with pytest.raises(ErrObjectNotFound):
            es.get_object("b", "o")
        es.close()

    def test_fill_taken_before_a_mutation_is_refused(self):
        c = devcache.get()
        gen0 = c.current_gen(7, "b")
        c.note_mutation(7, "b")
        rows = np.zeros((1, 2, 8), dtype=np.uint8)
        assert not c.fill((7, "b", "o", 1, "dd", 0, 1, "mxh256"), gen0, rows)
        assert c.stats()["stale_drops"] == 1 and c.stats()["entries"] == 0

    def test_lookup_drops_stale_entries(self):
        c = devcache.get()
        key = (7, "b", "o", 1, "dd", 0, 1, "mxh256")
        assert c.fill(key, c.current_gen(7, "b"),
                      np.zeros((1, 2, 8), dtype=np.uint8))
        assert c.lookup(key).key == key
        c.note_mutation(7, "b")
        assert c.lookup(key) is None
        st = c.stats()
        assert (st["hits"], st["misses"], st["stale_drops"]) == (1, 1, 1)
        assert st["entries"] == 0 and st["resident_bytes"] == 0

    def test_mutation_while_off_invalidates_on_reenable(self, tmp_path,
                                                        monkeypatch):
        monkeypatch.setenv("MTPU_DEVCACHE", "1")
        es = make_set(tmp_path, name="flip")
        es.make_bucket("b")
        old = payload(BLOCK_SIZE + 40, seed=13)
        es.put_object("b", "o", old)
        assert es.get_object("b", "o")[1] == old    # filled
        monkeypatch.setenv("MTPU_DEVCACHE", "0")
        new = payload(BLOCK_SIZE + 40, seed=14)
        es.put_object("b", "o", new, version_id="")
        monkeypatch.setenv("MTPU_DEVCACHE", "1")
        assert es.get_object("b", "o")[1] == new
        es.close()

    def test_recovery_boot_starts_cold(self, tmp_path, cache_mode):
        es = make_set(tmp_path, name="boot")
        es.make_bucket("b")
        data = payload(2 * BLOCK_SIZE + 64, seed=15)
        es.put_object("b", "o", data)
        assert es.get_object("b", "o")[1] == data   # fills under owner A
        es2 = ErasureSet(list(es.drives), device=CPU)
        assert es2._devcache_owner != es._devcache_owner
        hits = devcache.get().stats()["hits"]
        assert es2.get_object("b", "o")[1] == data
        st = devcache.get().stats()
        assert st["hits"] == hits
        if cache_mode == "1":
            assert st["misses"] > 0
        es.close()
        es2.close()


class TestCapacityAndEviction:
    def test_lru_eviction_under_small_cap(self, tmp_path, monkeypatch):
        monkeypatch.setenv("MTPU_DEVCACHE", "1")
        monkeypatch.setenv("MTPU_DEVCACHE_MB", "4")
        es = make_set(tmp_path, name="cap")
        es.make_bucket("b")
        blobs = {i: payload(2 * BLOCK_SIZE, seed=20 + i) for i in range(4)}
        for i, blob in blobs.items():
            es.put_object("b", f"o{i}", blob)
        for i, blob in blobs.items():             # 4 x 2 MiB > 4 MiB
            assert es.get_object("b", f"o{i}")[1] == blob
        st = devcache.get().stats()
        assert st["evictions"] > 0 and st["resident_bytes"] <= 4 << 20
        for i, blob in blobs.items():             # evicted ones re-read
            assert es.get_object("b", f"o{i}")[1] == blob
        es.close()

    def test_oversize_fill_refused(self, monkeypatch):
        monkeypatch.setenv("MTPU_DEVCACHE_MB", "1")
        c = devcache.get()
        big = np.zeros((2, 2, 1 << 20), dtype=np.uint8)   # 4 MiB > 1 MiB
        assert not c.fill((1, "b", "o", 1, "dd", 0, 2, "mxh256"), 0, big)
        assert c.stats()["rejects"] == 1

    def test_device_array_places_once(self):
        c = devcache.get()
        rows = np.arange(2 * 2 * 8, dtype=np.uint8).reshape(2, 2, 8)
        key = (1, "b", "o", 1, "dd", 0, 2, "mxh256")
        assert c.fill(key, 0, rows, device=CPU)
        e, boff = c.lookup_range(1, "b", "o", 1, "dd", "mxh256", 1, 2)
        assert boff == 1
        devcache.reset_h2d()
        t = c.device_array(e)
        assert c.device_array(e) is t
        assert devcache.h2d_stats()["h2d_bytes"] == rows.nbytes
        assert np.array_equal(t.numpy(), rows)
        with pytest.raises(ValueError):
            e.host[0, 0, 0] = 1                   # hits hand out views
