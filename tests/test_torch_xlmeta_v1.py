"""Legacy xl.json (format v1) objects on the port: the cases of the JAX
package's tests/test_xlmeta_v1.py on objects that the JAX make_xl_json
wrote (unframed shards, whole-file HighwayHash per drive, 10 MiB blocks
or smaller ones for several blocks), read, HEADed, listed and
reconstructed by the port; and make_xl_json bytes equal across the
packages.  Inputs from a numpy seed; tolerance: exact bytes."""

import json

import numpy as np
import pytest

from minio_tpu.engine.erasure_set import ErasureSet as JaxErasureSet
from minio_tpu.ops.erasure_cpu import ReedSolomonCPU
from minio_tpu.storage import bitrot_io as jax_bitrot
from minio_tpu.storage import xlmeta_v1 as jax_v1
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu.storage.xlmeta import ErasureInfo as JaxErasureInfo
from minio_tpu.storage.xlmeta import FileInfo as JaxFileInfo
from minio_tpu.storage.xlmeta import ObjectPartInfo as JaxObjectPartInfo
from minio_tpu_torch.engine.erasure_set import ErasureSet
from minio_tpu_torch.engine.hotcache import HotObjectCache, attach_sets
from minio_tpu_torch.ops import fused
from minio_tpu_torch.storage import xlmeta_v1
from minio_tpu_torch.storage.drive import LocalDrive
from minio_tpu_torch.storage.errors import ErrErasureReadQuorum
from minio_tpu_torch.storage.xlmeta import (ErasureInfo, FileInfo,
                                            ObjectPartInfo)

V1_BLOCK = 10 * 1024 * 1024


def body_of(size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


def v1_shards(data: bytes, k: int, m: int, bs: int) -> list[bytes]:
    """The k+m shard files of a v1 part: each block of `bs` bytes split
    into k chunks of ceil(block / k) and encoded, chunks back to back."""
    cpu = ReedSolomonCPU(k, m)
    out = [bytearray() for _ in range(k + m)]
    for lo in range(0, len(data), bs):
        for s, chunk in enumerate(cpu.encode_data(data[lo:lo + bs])):
            out[s] += chunk.tobytes()
    return [bytes(s) for s in out]


def write_v1_object(drives, bucket, obj, data, k=2, m=2, bs=V1_BLOCK):
    """The on-disk layout an old deployment leaves, written with the JAX
    package's make_xl_json and whole_file_digest."""
    shards = v1_shards(data, k, m, bs)
    dist = list(range(1, k + m + 1))
    for pos, d in enumerate(drives):
        shard = shards[dist[pos] - 1]
        d.create_file(bucket, f"{obj}/part.1", shard)
        fi = JaxFileInfo(
            volume=bucket, name=obj, version_id="", data_dir="legacy",
            mod_time_ns=1_700_000_000_000_000_000, size=len(data),
            metadata={"content-type": "text/plain"},
            parts=[JaxObjectPartInfo(1, len(data), len(data))],
            erasure=JaxErasureInfo(
                data_blocks=k, parity_blocks=m, block_size=bs,
                index=pos + 1, distribution=dist,
                checksums=[{"part": 1, "name": "part.1",
                            "algo": "highwayhash256",
                            "hash": jax_bitrot.whole_file_digest(
                                shard, "highwayhash256")}]))
        d.write_all(bucket, f"{obj}/{jax_v1.XL_JSON}",
                    jax_v1.make_xl_json(fi))


@pytest.fixture
def sets(tmp_path):
    """The same four drives seen by a JAX writer and the port's set."""
    jd = [JaxLocalDrive(str(tmp_path / f"v1d{i}")) for i in range(4)]
    for d in jd:
        d.make_volume("legacy")
    es = ErasureSet([LocalDrive(str(tmp_path / f"v1d{i}"))
                     for i in range(4)], device="cpu")
    fused.reset_items()
    yield jd, es
    es.close()


def test_v1_object_readable(sets):
    jd, es = sets
    data = b"written by a v1 deployment" * 1000
    write_v1_object(jd, "legacy", "old-obj", data)
    fi, got = es.get_object("legacy", "old-obj")
    assert got == data
    assert fi.metadata["content-type"] == "text/plain"
    assert xlmeta_v1.is_v1(fi)
    # One whole-file hh256 item for the part's four equal-length shards,
    # no rebuild of a healthy object.
    assert fused.ITEMS["hh256"] == 1 and fused.ITEMS["gf_matmul"] == 0
    fi2, it = es.get_object_iter("legacy", "old-obj", 7, 300)
    assert b"".join(it) == data[7:307]


def test_v1_head_and_versions(sets):
    jd, es = sets
    data = b"v1 head" * 100
    write_v1_object(jd, "legacy", "h", data)
    fi = es.head_object("legacy", "h")
    assert fi.size == len(data)
    versions = es.list_object_versions("legacy", "h")
    assert len(versions) == 1 and versions[0].size == len(data)
    assert versions[0].is_latest and xlmeta_v1.is_v1(versions[0])


@pytest.mark.parametrize("bs", [V1_BLOCK, 4096])
def test_v1_corrupt_shard_reconstructs(sets, bs):
    """A corrupted data shard fails its drive's whole-file digest and the
    data rows are rebuilt on the device: one GF call per chunk size (one
    for a single block; full blocks and the ragged last block at 4 KiB
    blocks).  The JAX package reads the same object alike."""
    jd, es = sets
    data = body_of(3 * 4096 + 1000, seed=bs) if bs == 4096 else \
        b"corruption-tolerant v1" * 500
    write_v1_object(jd, "legacy", "c", data, bs=bs)
    p = es.drives[0]._file_path("legacy", "c/part.1")
    raw = bytearray(open(p, "rb").read())
    raw[10] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    _, got = es.get_object("legacy", "c")
    assert got == data
    assert fused.ITEMS["hh256"] == 1
    assert fused.ITEMS["gf_matmul"] == (2 if bs == 4096 else 1)
    assert JaxErasureSet(jd).get_object("legacy", "c")[1] == data


def test_v1_missing_checksum_shard_not_trusted(sets):
    jd, es = sets
    data = b"stripped checksums" * 500
    write_v1_object(jd, "legacy", "nc", data)
    mp = es.drives[0]._file_path("legacy", f"nc/{xlmeta_v1.XL_JSON}")
    doc = json.loads(open(mp, "rb").read())
    for c in doc["erasure"]["checksum"]:
        c["hash"] = ""
    open(mp, "w").write(json.dumps(doc))
    p = es.drives[0]._file_path("legacy", "nc/part.1")
    raw = bytearray(open(p, "rb").read())
    raw[3] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    _, got = es.get_object("legacy", "nc")
    assert got == data


def test_v1_below_quorum_errors(sets):
    jd, es = sets
    write_v1_object(jd, "legacy", "q", b"x" * 4000)
    es.drives[0] = es.drives[1] = es.drives[2] = None
    with pytest.raises(ErrErasureReadQuorum):
        es.get_object("legacy", "q")


def test_v1_never_enters_the_hot_tier_or_a_sendfile_plan(sets):
    jd, es = sets
    write_v1_object(jd, "legacy", "t", body_of(5000, seed=3), k=1, m=3)
    tier = HotObjectCache(total_bytes=1 << 20)
    attach_sets(es, tier)
    for _ in range(3):
        assert es.get_object("legacy", "t")[1] == body_of(5000, seed=3)
    assert tier.stats()["fills"] == 0
    assert es.sendfile_plan("legacy", "t") is None


def test_make_parse_roundtrip_and_bytes_equal_the_jax_packages():
    kw = dict(volume="b", name="o", version_id="", data_dir="legacy",
              mod_time_ns=1_700_000_000_000_000_000, size=7,
              metadata={"k": "v"})
    ec = dict(data_blocks=2, parity_blocks=2, block_size=10 << 20, index=1,
              distribution=[1, 2, 3, 4],
              checksums=[{"part": 1, "name": "part.1",
                          "algo": "highwayhash256", "hash": b"\x01" * 32}])
    fi = FileInfo(**kw, parts=[ObjectPartInfo(1, 7, 7)],
                  erasure=ErasureInfo(**ec))
    jfi = JaxFileInfo(**kw, parts=[JaxObjectPartInfo(1, 7, 7)],
                      erasure=JaxErasureInfo(**ec))
    raw = xlmeta_v1.make_xl_json(fi)
    assert raw == jax_v1.make_xl_json(jfi)
    out = xlmeta_v1.parse_xl_json(raw, "b", "o")
    assert out.size == 7 and out.erasure.data_blocks == 2
    assert out.erasure.checksums[0]["hash"] == b"\x01" * 32
    assert out.metadata["k"] == "v" and xlmeta_v1.is_v1(out)
    assert out.to_obj() == jax_v1.parse_xl_json(raw, "b", "o").to_obj()


def test_read_version_many_takes_the_xl_json_fallback(sets):
    jd, es = sets
    write_v1_object(jd, "legacy", "m", b"m" * 300)
    got = es.drives[1].read_version_many([("legacy", "m", ""),
                                          ("legacy", "absent", "")])
    assert got[0][1] is None and xlmeta_v1.is_v1(got[0][0])
    assert got[0][0].to_obj() == es.drives[1].read_version(
        "legacy", "m").to_obj()
    assert got[1][0] is None and got[1][1] is not None
