"""The port's heal (minio_tpu_torch.engine.heal, device="cpu"): the
scenarios of tests/test_heal.py for mxh256 and HighwayHash objects, and a
damaged tree healed by both packages, which must leave the same files,
equal to the tree before the damage."""

import os
import shutil

import numpy as np
import pytest

from minio_tpu.engine import heal as jax_heal
from minio_tpu.engine.erasure_set import ErasureSet as JaxErasureSet
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.engine import heal
from minio_tpu_torch.engine.erasure_set import BLOCK_SIZE, ErasureSet
from minio_tpu_torch.storage.drive import LocalDrive
from minio_tpu_torch.storage.errors import (ErrErasureReadQuorum,
                                            ErrObjectNotFound)

HH = "highwayhash256S"
ALGOS = ["mxh256", HH]
# Sizes with a tail fragment.  The plain HighwayHash version runs one
# chain of torch ops per 32-byte packet of a shard, so HighwayHash objects
# here stay below one block (the tail is the whole shard); the
# cross-package test below takes them through full blocks too.
DATA_SIZE = {"mxh256": 3 * BLOCK_SIZE + 777, HH: 200 * 1024 + 777}


@pytest.fixture(params=ALGOS)
def algo(request, monkeypatch):
    monkeypatch.setenv("MTPU_BITROT_ALGO", request.param)
    return request.param


def make_set(root, n=6, parity=None):
    return ErasureSet([LocalDrive(str(root / f"d{i}")) for i in range(n)],
                      default_parity=parity, device="cpu")


def payload(size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


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


def test_noop_when_healthy(tmp_path, algo):
    with make_set(tmp_path) as es:
        es.make_bucket("b")
        es.put_object("b", "o", payload(DATA_SIZE[algo]))
        results = heal.heal_object(es, "b", "o")
        assert len(results) == 1
        assert not results[0].healed
        assert results[0].after == [heal.DRIVE_OK] * es.n


@pytest.mark.parametrize("wipe_count", [1, 3])       # 1 and `parity`
def test_heal_wiped_drives(tmp_path, algo, wipe_count):
    with make_set(tmp_path) as es:                   # EC 3+3
        es.make_bucket("b")
        data = payload(DATA_SIZE[algo], seed=3)
        es.put_object("b", "o", data)
        golden = [drive_files(d.root, "b") for d in es.drives]
        for i in range(wipe_count):
            shutil.rmtree(os.path.join(es.drives[i].root, "b", "o"))
        r = heal.heal_object(es, "b", "o")[0]
        assert r.healed_drives == list(range(wipe_count))
        assert r.before[:wipe_count] == [heal.DRIVE_MISSING] * wipe_count
        for i in range(wipe_count):
            assert drive_files(es.drives[i].root, "b") == golden[i]
        assert bytes(es.get_object("b", "o")[1]) == data


def test_heal_corrupt_shard_found_by_deep_scan(tmp_path, algo):
    with make_set(tmp_path) as es:
        es.make_bucket("b")
        data = payload(DATA_SIZE[algo], seed=5)
        fi = es.put_object("b", "o", data)
        p = os.path.join(es.drives[2].root, "b", "o", fi.data_dir, "part.1")
        golden = open(p, "rb").read()
        raw = bytearray(golden)
        raw[100] ^= 0xFF
        open(p, "wb").write(bytes(raw))
        assert heal.heal_object(es, "b", "o")[0].before[2] == heal.DRIVE_OK
        r = heal.heal_object(es, "b", "o", deep=True)[0]
        assert r.before[2] == heal.DRIVE_CORRUPT and r.healed_drives == [2]
        assert open(p, "rb").read() == golden
        r2 = heal.heal_object(es, "b", "o", deep=True)[0]
        assert r2.after == [heal.DRIVE_OK] * es.n and not r2.healed


def test_heal_inline_object(tmp_path, algo):
    with make_set(tmp_path, n=4) as es:
        es.make_bucket("b")
        data = payload(8 * 1024, seed=7)
        es.put_object("b", "o", data)
        golden = drive_files(es.drives[1].root, "b")
        shutil.rmtree(os.path.join(es.drives[1].root, "b", "o"))
        r = heal.heal_object(es, "b", "o")[0]
        assert r.healed_drives == [1]
        assert es.drives[1].read_version("b", "o").inline_data is not None
        assert drive_files(es.drives[1].root, "b") == golden
        es.drives[0] = None                   # the healed shard serves
        assert bytes(es.get_object("b", "o")[1]) == data


def test_heal_corrupt_inline_shard(tmp_path, algo):
    """A deep scan finds a flipped byte inside an inline shard's frame."""
    with make_set(tmp_path, n=4) as es:
        es.make_bucket("b")
        data = payload(9 * 1024, seed=8)
        es.put_object("b", "o", data)
        fi = es.drives[3].read_version("b", "o")
        golden = drive_files(es.drives[3].root, "b")
        bad = bytearray(fi.inline_data)
        bad[40] ^= 0x01
        fi.inline_data = bytes(bad)
        es.drives[3].write_metadata("b", "o", fi)
        r = heal.heal_object(es, "b", "o", deep=True)[0]
        assert r.before[3] == heal.DRIVE_CORRUPT and r.healed_drives == [3]
        assert drive_files(es.drives[3].root, "b") == golden


def test_heal_delete_marker(tmp_path, algo):
    """Delete markers come from the JAX package (the port's slim set has
    no versioned delete); the port heals them."""
    paths = [str(tmp_path / f"d{i}") for i in range(4)]
    jes = JaxErasureSet([JaxLocalDrive(p) for p in paths])
    jes.make_bucket("b")
    jes.put_object("b", "o", payload(1000), versioned=True)
    dm = jes.delete_object("b", "o", versioned=True)
    shutil.rmtree(os.path.join(paths[0], "b", "o"))
    with ErasureSet([LocalDrive(p) for p in paths], device="cpu") as es:
        by_vid = {r.version_id: r for r in heal.heal_object(es, "b", "o")}
        assert 0 in by_vid[dm.version_id].healed_drives
        assert es.drives[0].read_version("b", "o", dm.version_id).deleted
        assert len(by_vid) == 2 and all(0 in r.healed_drives
                                        for r in by_vid.values())


def test_heal_outdated_drive(tmp_path, algo):
    """A drive that missed an overwrite is outdated until healed."""
    with make_set(tmp_path) as es:
        es.make_bucket("b")
        es.put_object("b", "o", payload(DATA_SIZE[algo], seed=1))
        d3, es.drives[3] = es.drives[3], None
        data2 = payload(DATA_SIZE[algo] + 5, seed=2)
        es.put_object("b", "o", data2)
        es.drives[3] = d3
        r = heal.heal_object(es, "b", "o")[0]
        assert r.before[3] == heal.DRIVE_OUTDATED and r.healed_drives == [3]
        for pos in (0, 1, 2):                 # read through drive 3
            es.drives[pos] = None
        assert bytes(es.get_object("b", "o")[1]) == data2


def test_dangling_purged(tmp_path, algo):
    with make_set(tmp_path, n=4) as es:       # K=2: 2 metas needed
        es.make_bucket("b")
        es.put_object("b", "o", payload(DATA_SIZE[algo]))
        for i in range(3):                    # 1 of 4 copies left
            shutil.rmtree(os.path.join(es.drives[i].root, "b", "o"))
        r = heal.heal_object(es, "b", "o")[0]
        assert r.purged
        with pytest.raises(ErrObjectNotFound):
            es.get_object("b", "o")


def test_unhealable_with_offline_not_purged(tmp_path, algo):
    with make_set(tmp_path, n=4) as es:
        es.make_bucket("b")
        es.put_object("b", "o", payload(DATA_SIZE[algo]))
        for i in range(3):
            shutil.rmtree(os.path.join(es.drives[i].root, "b", "o"))
        es.drives[0] = es.drives[1] = None
        with pytest.raises(ErrErasureReadQuorum):
            heal.heal_object(es, "b", "o")
        assert os.path.exists(
            os.path.join(es.drives[3].root, "b", "o", "xl.meta"))


def test_dry_run_changes_nothing(tmp_path, algo):
    with make_set(tmp_path, n=4) as es:
        es.make_bucket("b")
        es.put_object("b", "o", payload(DATA_SIZE[algo]))
        shutil.rmtree(os.path.join(es.drives[0].root, "b", "o"))
        r = heal.heal_object(es, "b", "o", dry_run=True)[0]
        assert r.healed_drives == [0]
        assert not os.path.exists(os.path.join(es.drives[0].root, "b", "o"))


def test_heal_bucket_recreates_volume(tmp_path):
    with make_set(tmp_path, n=4) as es:
        es.make_bucket("b")
        os.rmdir(os.path.join(es.drives[2].root, "b"))
        assert heal.heal_bucket(es, "b") == [2]
        assert os.path.isdir(os.path.join(es.drives[2].root, "b"))
        assert heal.heal_bucket(es, "b") == []


@pytest.mark.parametrize("size", [BLOCK_SIZE + 777, 100 * 1024])
def test_same_tree_as_the_jax_heal(tmp_path, algo, size):
    """One damaged tree, copied twice: the JAX package heals one copy and
    the port the other.  Both end file for file equal to each other and
    to the tree before the damage (part files and xl.meta)."""
    n, parity = 6, 2
    src = tmp_path / "src"
    paths = [str(src / f"d{i}") for i in range(n)]
    jes = JaxErasureSet([JaxLocalDrive(p) for p in paths],
                        default_parity=parity)
    jes.make_bucket("b")
    jfi = jes.put_object("b", "o", payload(size, seed=11))
    assert jfi.erasure.bitrot_algo() == algo
    before = [drive_files(p, "b") for p in paths]
    order = jax_heal.Q.shuffle_by_distribution(list(range(n)),
                                               jfi.erasure.distribution)
    data_pos, parity_pos = order[0], order[n - 1]
    shutil.rmtree(paths[data_pos])            # a replaced data drive
    shutil.rmtree(os.path.join(paths[parity_pos], "b", "o"))
    copies = {}
    for name in ("jax", "torch"):
        shutil.copytree(src, tmp_path / name)
        copies[name] = [str(tmp_path / name / f"d{i}") for i in range(n)]

    jes = JaxErasureSet([JaxLocalDrive(p) for p in copies["jax"]],
                        default_parity=parity)
    assert jax_heal.heal_bucket(jes, "b") == [data_pos]
    jr = jax_heal.heal_object(jes, "b", "o")[0]
    with ErasureSet([LocalDrive(p) for p in copies["torch"]],
                    default_parity=parity, device="cpu") as es:
        assert heal.heal_bucket(es, "b") == [data_pos]
        r = heal.heal_object(es, "b", "o")[0]
    assert (r.before, r.after, r.healed_drives) == \
        (jr.before, jr.after, jr.healed_drives)
    assert sorted(r.healed_drives) == sorted([data_pos, parity_pos])
    for i in range(n):
        theirs = drive_files(copies["jax"][i], "b")
        ours = drive_files(copies["torch"][i], "b")
        assert ours == theirs == before[i], i
