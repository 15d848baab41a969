"""The port's slice as a whole (minio_tpu_torch.engine.erasure_set on
local drives, device="cpu") and its on-disk state against the JAX
package's ErasureSet, in both directions, byte-exact."""

import hashlib
import io
import os

import numpy as np
import pytest

from minio_tpu.engine.erasure_set import ErasureSet as JaxErasureSet
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.engine import quorum as Q
from minio_tpu_torch.engine.erasure_set import BLOCK_SIZE, ErasureSet
from minio_tpu_torch.storage.drive import LocalDrive
from minio_tpu_torch.storage.errors import (ErrBucketExists,
                                            ErrBucketNotFound,
                                            ErrErasureReadQuorum,
                                            ErrObjectNotFound)

MIB = 1 << 20
SIZES = [100 * 1024, 3 * MIB + 1234]      # inline; full blocks + a tail
GEOMETRIES = [(4, 2), (6, 2)]             # EC:2+2, EC:4+2


def body_of(size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


def drive_paths(root, n):
    return [str(root / f"d{i}") for i in range(n)]


@pytest.fixture(params=GEOMETRIES, ids=["ec2+2", "ec4+2"])
def geom(request):
    return request.param


@pytest.fixture
def port_set(tmp_path, geom):
    n, parity = geom
    es = ErasureSet([LocalDrive(p) for p in drive_paths(tmp_path, n)],
                    default_parity=parity, device="cpu")
    es.make_bucket("bkt")
    yield es
    es.close()


def data_shard_positions(fi, count):
    order = Q.shuffle_by_distribution(list(range(len(fi.erasure.distribution))),
                                      fi.erasure.distribution)
    return [order[s] for s in range(count)]


@pytest.mark.parametrize("size", SIZES)
def test_put_get_head_delete(port_set, size):
    es = port_set
    body = body_of(size, seed=size)
    fi = es.put_object("bkt", "obj", body)
    assert fi.etag == hashlib.md5(body).hexdigest()
    got_fi, got = es.get_object("bkt", "obj")
    assert bytes(got) == body and got_fi.etag == fi.etag
    ranges = [(0, 1), (size - 1, 1), (size // 3, size // 3), (7, size - 7)]
    if size > BLOCK_SIZE:
        ranges.append((BLOCK_SIZE - 10, 20))           # crosses a block
        ranges.append((size - 1500, 1500))             # inside the tail
    for off, ln in ranges:
        assert bytes(es.get_object("bkt", "obj", off, ln)[1]) == \
            body[off:off + ln], (off, ln)
    head = es.head_object("bkt", "obj")
    assert head.size == size and head.etag == fi.etag
    es.delete_object("bkt", "obj")
    with pytest.raises(ErrObjectNotFound):
        es.head_object("bkt", "obj")
    with pytest.raises(ErrObjectNotFound):
        es.get_object("bkt", "obj")
    with pytest.raises(ErrObjectNotFound):
        es.delete_object("bkt", "obj")


def test_put_from_reader(port_set):
    body = body_of(2 * MIB + 77, seed=5)
    fi = port_set.put_object("bkt", "streamed", io.BytesIO(body))
    assert fi.size == len(body)
    assert fi.etag == hashlib.md5(body).hexdigest()
    assert bytes(port_set.get_object("bkt", "streamed")[1]) == body


@pytest.mark.parametrize("size", SIZES)
def test_degraded_get_with_parity_data_drives_removed(port_set, geom, size):
    n, parity = geom
    body = body_of(size, seed=11)
    fi = port_set.put_object("bkt", "obj", body)
    for pos in data_shard_positions(fi, parity):
        port_set.drives[pos] = None
    assert bytes(port_set.get_object("bkt", "obj")[1]) == body
    off = size // 2
    assert bytes(port_set.get_object("bkt", "obj", off, 4096)[1]) == \
        body[off:off + 4096]


def test_too_many_drives_lost(port_set, geom):
    n, parity = geom
    body = body_of(3 * MIB, seed=2)
    fi = port_set.put_object("bkt", "obj", body)
    for pos in data_shard_positions(fi, parity + 1):
        port_set.drives[pos] = None
    with pytest.raises(ErrErasureReadQuorum):
        port_set.get_object("bkt", "obj")


@pytest.mark.parametrize("where", ["block", "tail"])
def test_corrupted_frame_served_from_spare(port_set, where):
    es = port_set
    body = body_of(3 * MIB + 1234, seed=3)
    fi = es.put_object("bkt", "obj", body)
    pos = data_shard_positions(fi, 1)[0]
    part = os.path.join(es.drives[pos].root, "bkt", "obj", fi.data_dir,
                        "part.1")
    frame = 32 + fi.erasure.shard_size
    at = frame + 100 if where == "block" else 3 * frame + 40
    with open(part, "r+b") as f:
        f.seek(at)
        old = f.read(8)
        f.seek(at)
        f.write(bytes(b ^ 0xFF for b in old))
    assert bytes(es.get_object("bkt", "obj")[1]) == body


def test_bucket_errors(port_set):
    with pytest.raises(ErrBucketExists):
        port_set.make_bucket("bkt")
    with pytest.raises(ErrBucketNotFound):
        port_set.put_object("nope", "obj", b"x")
    with pytest.raises(ErrObjectNotFound):
        port_set.get_object("bkt", "missing")


@pytest.mark.parametrize("size", SIZES)
def test_jax_writes_port_reads(tmp_path, geom, size):
    n, parity = geom
    paths = drive_paths(tmp_path, n)
    jes = JaxErasureSet([JaxLocalDrive(p) for p in paths],
                        default_parity=parity)
    jes.make_bucket("bkt")
    body = body_of(size, seed=21)
    jfi = jes.put_object("bkt", "obj", body)
    with ErasureSet([LocalDrive(p) for p in paths], default_parity=parity,
                    device="cpu") as es:
        fi, got = es.get_object("bkt", "obj")
        assert bytes(got) == body and fi.etag == jfi.etag
        assert bytes(es.get_object("bkt", "obj", 5, size - 10)[1]) == \
            body[5:size - 5]


@pytest.mark.parametrize("size", SIZES)
def test_port_writes_jax_reads(tmp_path, geom, size):
    n, parity = geom
    paths = drive_paths(tmp_path, n)
    body = body_of(size, seed=22)
    with ErasureSet([LocalDrive(p) for p in paths], default_parity=parity,
                    device="cpu") as es:
        es.make_bucket("bkt")
        fi = es.put_object("bkt", "obj", body)
    jes = JaxErasureSet([JaxLocalDrive(p) for p in paths],
                        default_parity=parity)
    jfi, got = jes.get_object("bkt", "obj")
    assert bytes(got) == body and jfi.etag == fi.etag
    for pos in data_shard_positions(fi, parity):
        jes.drives[pos] = None                       # degraded, JAX side
    assert bytes(jes.get_object("bkt", "obj")[1]) == body


@pytest.mark.parametrize("size", SIZES)
def test_same_bytes_on_disk(tmp_path, geom, size):
    """Same body, same explicit identity: every drive position holds the
    same part file (streaming objects) or the same xl.meta (inline
    objects, whose framed shards live in it) in both packages."""
    n, parity = geom
    body = body_of(size, seed=23)
    ident = dict(version_id="", mod_time_ns=1_700_000_000_123_456_789)
    jpaths = drive_paths(tmp_path / "jax", n)
    jes = JaxErasureSet([JaxLocalDrive(p) for p in jpaths],
                        default_parity=parity)
    jes.make_bucket("bkt")
    jfi = jes.put_object("bkt", "obj", body, **ident)
    tpaths = drive_paths(tmp_path / "torch", n)
    with ErasureSet([LocalDrive(p) for p in tpaths], default_parity=parity,
                    device="cpu") as es:
        es.make_bucket("bkt")
        fi = es.put_object("bkt", "obj", body, **ident)
    assert bool(fi.data_dir) == bool(jfi.data_dir) == (size > 128 * 1024)
    for jp, tp in zip(jpaths, tpaths):
        if fi.data_dir:
            a = open(os.path.join(jp, "bkt", "obj", jfi.data_dir, "part.1"),
                     "rb").read()
            b = open(os.path.join(tp, "bkt", "obj", fi.data_dir, "part.1"),
                     "rb").read()
        else:
            a = open(os.path.join(jp, "bkt", "obj", "xl.meta"), "rb").read()
            b = open(os.path.join(tp, "bkt", "obj", "xl.meta"), "rb").read()
        assert a == b, jp


def _flip(path, at):
    with open(path, "r+b") as f:
        f.seek(at)
        old = f.read(8)
        f.seek(at)
        f.write(bytes(b ^ 0xFF for b in old))


@pytest.mark.parametrize("size", SIZES)
def test_highwayhash_jax_writes_port_reads(tmp_path, geom, size,
                                           monkeypatch):
    """An object MinIO's default algorithm framed, written by the JAX
    package, reads byte-exact through the port: healthy, degraded, and
    with a corrupted frame served from a spare."""
    n, parity = geom
    monkeypatch.setenv("MTPU_BITROT_ALGO", "highwayhash256S")
    paths = drive_paths(tmp_path, n)
    jes = JaxErasureSet([JaxLocalDrive(p) for p in paths],
                        default_parity=parity)
    jes.make_bucket("bkt")
    body = body_of(size, seed=31)
    jfi = jes.put_object("bkt", "hh", body)
    assert jfi.erasure.bitrot_algo() == "highwayhash256S"
    with ErasureSet([LocalDrive(p) for p in paths], default_parity=parity,
                    device="cpu") as es:
        fi, got = es.get_object("bkt", "hh")
        assert bytes(got) == body and fi.etag == jfi.etag
        drives = list(es.drives)
        for pos in data_shard_positions(fi, parity):
            es.drives[pos] = None
        assert bytes(es.get_object("bkt", "hh")[1]) == body
        es.drives = drives
        if fi.data_dir:
            pos = data_shard_positions(fi, 1)[0]
            _flip(os.path.join(paths[pos], "bkt", "hh", fi.data_dir,
                               "part.1"), 32 + fi.erasure.shard_size + 100)
            assert bytes(es.get_object("bkt", "hh")[1]) == body


@pytest.mark.parametrize("size", SIZES)
def test_highwayhash_port_writes_jax_reads_same_bytes(tmp_path, geom, size,
                                                      monkeypatch):
    """The port writes under MTPU_BITROT_ALGO=highwayhash256S; the JAX
    package reads it, healthy and degraded, and wrote the same bytes at
    every drive position for the same identity."""
    n, parity = geom
    monkeypatch.setenv("MTPU_BITROT_ALGO", "highwayhash256S")
    body = body_of(size, seed=32)
    ident = dict(version_id="", mod_time_ns=1_700_000_000_987_654_321)
    tpaths = drive_paths(tmp_path / "torch", n)
    with ErasureSet([LocalDrive(p) for p in tpaths], default_parity=parity,
                    device="cpu") as es:
        es.make_bucket("bkt")
        fi = es.put_object("bkt", "hh", body, **ident)
    assert fi.erasure.bitrot_algo() == "highwayhash256S"
    jes = JaxErasureSet([JaxLocalDrive(p) for p in tpaths],
                        default_parity=parity)
    jfi, got = jes.get_object("bkt", "hh")
    assert bytes(got) == body and jfi.etag == fi.etag
    for pos in data_shard_positions(fi, parity):
        jes.drives[pos] = None
    assert bytes(jes.get_object("bkt", "hh")[1]) == body

    jpaths = drive_paths(tmp_path / "jax", n)
    jes = JaxErasureSet([JaxLocalDrive(p) for p in jpaths],
                        default_parity=parity)
    jes.make_bucket("bkt")
    jfi = jes.put_object("bkt", "hh", body, **ident)
    name = f"{fi.data_dir}/part.1" if fi.data_dir else "xl.meta"
    for jp, tp in zip(jpaths, tpaths):
        jname = f"{jfi.data_dir}/part.1" if jfi.data_dir else "xl.meta"
        with open(os.path.join(jp, "bkt", "hh", jname), "rb") as a, \
                open(os.path.join(tp, "bkt", "hh", name), "rb") as b:
            assert a.read() == b.read(), jp


def test_sha256_still_has_no_device_program(tmp_path, monkeypatch):
    """sha256 has no device program (the gate raises), so its objects
    take the host route: the port reads the JAX package's and writes its
    own with no device digest item, the GF work still on the device."""
    from minio_tpu_torch.ops import fused
    paths = drive_paths(tmp_path, 4)
    monkeypatch.setenv("MTPU_BITROT_ALGO", "sha256")
    jes = JaxErasureSet([JaxLocalDrive(p) for p in paths])
    jes.make_bucket("bkt")
    body = body_of(5000)
    jes.put_object("bkt", "sha", body)
    with pytest.raises(NotImplementedError, match="no device program"):
        fused.check_algo("sha256")
    fused.reset_items()
    with ErasureSet([LocalDrive(p) for p in paths], device="cpu") as es:
        assert es.get_object("bkt", "sha")[1] == body
        fi = es.put_object("bkt", "new", b"abc" * 50_000)
        assert fi.erasure.bitrot_algo() == "sha256"
        assert es.get_object("bkt", "new")[1] == b"abc" * 50_000
    assert fused.ITEMS["hh256"] == fused.ITEMS["mxh256"] == 0
    assert fused.ITEMS["gf_matmul"] == 1     # the PUT's one encode
    assert jes.get_object("bkt", "new")[1] == b"abc" * 50_000
