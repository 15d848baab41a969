"""The other bitrot forms on the port against the JAX package: the
host-route digests (sha256, blake2b512), sha256 objects written, read,
degraded-read and healed by either package, and the whole-file digest
of legacy objects.  Inputs from a numpy seed; tolerance: exact bytes."""

import os
import shutil

import numpy as np
import pytest

from minio_tpu.engine import erasure_set as jax_es_mod
from minio_tpu.engine import heal as jax_heal
from minio_tpu.engine.erasure_set import ErasureSet as JaxErasureSet
from minio_tpu.storage import bitrot_io as jax_bitrot
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.engine import erasure_set as port_es_mod
from minio_tpu_torch.engine import heal
from minio_tpu_torch.engine import quorum as Q
from minio_tpu_torch.engine.erasure_set import BLOCK_SIZE, ErasureSet
from minio_tpu_torch.ops import fused
from minio_tpu_torch.storage import bitrot_io
from minio_tpu_torch.storage.drive import LocalDrive
from minio_tpu_torch.storage.errors import ErrFileCorrupt

N, PARITY = 6, 2
# Streaming bodies: full blocks and a ragged tail (sha256 is cheap on the
# host, so these run whole blocks).
SIZES = [2 * BLOCK_SIZE + 777, 300 * 1024 + 5]


def body_of(size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


def tree(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != ".mtpu.sys"]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture
def sha256_env(monkeypatch):
    monkeypatch.setenv("MTPU_BITROT_ALGO", "sha256")
    fused.reset_items()


def pin_identity(monkeypatch):
    for mod in (jax_es_mod, port_es_mod):
        monkeypatch.setattr(mod, "new_uuid",
                            lambda: "00000002-aaaa-4bbb-8ccc-000000000002")
        monkeypatch.setattr(mod, "_now_ns", lambda: 1_700_000_000_987_654_321)


@pytest.mark.parametrize("algo", ["sha256", "blake2b512"])
@pytest.mark.parametrize("length", [1, 31, 32, 4096, 131072 + 3])
def test_host_frames_equal_the_jax_hash_batch(algo, length):
    rows = np.random.default_rng(length).integers(0, 256, (5, length),
                                                  dtype=np.uint8)
    want = jax_bitrot._hash_batch(rows, algo)
    assert np.array_equal(bitrot_io.host_hash_batch(rows, algo), want)
    assert np.array_equal(
        fused.hash_rows(rows, algo, device="cpu").numpy(), want)
    # The fused PUT program: parity on the (plain) device path, the
    # digests of data and parity rows by hashlib.
    x = rows[:4].reshape(2, 2, length)
    parity, digests = fused.encode_and_hash(x, 2, 2, algo=algo,
                                            device="cpu")
    assert digests.shape == (4, 2, bitrot_io.digest_size(algo))
    shards = np.concatenate([x, parity.numpy()], axis=1)   # (B, K+M, S)
    for s in range(4):
        assert np.array_equal(digests[s].numpy(),
                              jax_bitrot._hash_batch(
                                  np.ascontiguousarray(shards[:, s]), algo))


@pytest.mark.parametrize("size", SIZES)
def test_sha256_tree_equals_the_jax_packages(tmp_path, monkeypatch,
                                             sha256_env, size):
    pin_identity(monkeypatch)
    body = body_of(size, seed=size)
    jroots = [str(tmp_path / "jax" / f"d{i}") for i in range(N)]
    proots = [str(tmp_path / "port" / f"d{i}") for i in range(N)]
    jes = JaxErasureSet([JaxLocalDrive(p) for p in jroots],
                        default_parity=PARITY)
    jes.make_bucket("b")
    jfi = jes.put_object("b", "o", body)
    with ErasureSet([LocalDrive(p) for p in proots], default_parity=PARITY,
                    device="cpu") as es:
        es.make_bucket("b")
        fi = es.put_object("b", "o", body)
    assert fi.erasure.bitrot_algo() == jfi.erasure.bitrot_algo() == "sha256"
    for jr, pr in zip(jroots, proots):
        assert tree(pr) == tree(jr), pr
    assert fused.ITEMS["hh256"] == fused.ITEMS["mxh256"] == 0


def _data_positions(fi, count):
    order = Q.shuffle_by_distribution(list(range(N)),
                                      fi.erasure.distribution)
    return [order[s] for s in range(count)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_reads_degrades_and_heals_the_others(tmp_path, sha256_env,
                                                  writer):
    """One package writes sha256 objects; the other reads them healthy,
    reads them with two data drives gone (rows rebuilt, survivors
    verified by hashlib), and heals a wiped drive back to the bytes the
    writer left."""
    roots = [str(tmp_path / f"d{i}") for i in range(N)]
    bodies = {f"o{s}": body_of(s, seed=s) for s in SIZES}
    if writer == "jax":
        w = JaxErasureSet([JaxLocalDrive(p) for p in roots],
                          default_parity=PARITY)
        w.make_bucket("b")
        fis = {k: w.put_object("b", k, v) for k, v in bodies.items()}
    else:
        with ErasureSet([LocalDrive(p) for p in roots],
                        default_parity=PARITY, device="cpu") as w:
            w.make_bucket("b")
            fis = {k: w.put_object("b", k, v) for k, v in bodies.items()}
    before = [tree(r) for r in roots]
    port = ErasureSet([LocalDrive(p) for p in roots], default_parity=PARITY,
                      device="cpu")
    jax = JaxErasureSet([JaxLocalDrive(p) for p in roots],
                        default_parity=PARITY)
    reader = jax if writer == "port" else port
    try:
        for k, v in bodies.items():
            assert reader.get_object("b", k)[1] == v
        gone = _data_positions(fis["o" + str(SIZES[0])], 2)
        saved = [reader.drives[p] for p in gone]
        for p in gone:
            reader.drives[p] = None
        for k, v in bodies.items():
            assert reader.get_object("b", k, 1000, 200_000)[1] == \
                v[1000:201_000]
        for p, d in zip(gone, saved):
            reader.drives[p] = d
        victim = gone[0]
        shutil.rmtree(roots[victim])
        if reader is port:
            port.drives[victim] = LocalDrive(roots[victim])
            assert heal.heal_bucket(port, "b") == [victim]
            for k in bodies:
                assert heal.heal_object(port, "b", k)[0].healed_drives == \
                    [victim]
        else:
            jax.drives[victim] = JaxLocalDrive(roots[victim])
            assert jax_heal.heal_bucket(jax, "b") == [victim]
            for k in bodies:
                jax_heal.heal_object(jax, "b", k)
        assert tree(roots[victim]) == before[victim]
    finally:
        port.close()
    assert fused.ITEMS["hh256"] == fused.ITEMS["mxh256"] == 0


@pytest.mark.parametrize("algo", ["highwayhash256", "sha256", "blake2b512"])
@pytest.mark.parametrize("length", [0, 1, 33, 1000, 4099])
def test_whole_file_digest_equals_the_jax_packages(algo, length):
    data = body_of(length, seed=length + 7)
    want = jax_bitrot.whole_file_digest(data, algo)
    assert bitrot_io.whole_file_digest(data, algo, device="cpu") == want
    bitrot_io.verify_whole_file(data, want, algo, device="cpu")
    if length:
        flipped = bytearray(data)
        flipped[length // 2] ^= 0x10
        with pytest.raises(ErrFileCorrupt):
            bitrot_io.verify_whole_file(bytes(flipped), want, algo,
                                        device="cpu")


def test_whole_file_digests_batch_one_call_per_length():
    files = [body_of(n, seed=n) for n in (64, 64, 65, 64)]
    fused.reset_items()
    got = bitrot_io.whole_file_digests(files, "highwayhash256",
                                       device="cpu")
    assert got == [jax_bitrot.whole_file_digest(f, "highwayhash256")
                   for f in files]
    assert fused.ITEMS["hh256"] == 2          # lengths 64 and 65


def test_unknown_algorithm_still_raises(monkeypatch):
    monkeypatch.setenv("MTPU_BITROT_ALGO", "blake2b512")   # read only
    with pytest.raises(ValueError, match="not one of"):
        bitrot_io.write_algo()
    monkeypatch.setenv("MTPU_BITROT_ALGO", "crc32")
    with pytest.raises(ValueError, match="not one of"):
        bitrot_io.write_algo()
    monkeypatch.setenv("MTPU_BITROT_ALGO", "sha256")
    assert bitrot_io.write_algo() == "sha256"
    with pytest.raises(ErrFileCorrupt):
        bitrot_io.digest_size("crc32")
    with pytest.raises(ErrFileCorrupt):
        bitrot_io.whole_file_digest(b"abc", "crc32", device="cpu")
    with pytest.raises(ValueError, match="no host route"):
        bitrot_io.host_hash_batch(np.zeros((1, 4), np.uint8), "mxh256")
