"""The port's multipart uploads (minio_tpu_torch.engine.multipart,
device="cpu"): S3 semantics and errors, an object whose parts carry
different bitrot algorithms, heal of a multi-part object, and uploads
carried across the two packages, byte-exact on disk."""

import hashlib
import os
import shutil

import numpy as np
import pytest

from minio_tpu.engine import multipart as jax_mp
from minio_tpu.engine.erasure_set import ErasureSet as JaxErasureSet
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.engine import heal
from minio_tpu_torch.engine import multipart as mp
from minio_tpu_torch.engine.erasure_set import ErasureSet
from minio_tpu_torch.storage.drive import LocalDrive

MIB = 1 << 20
PART = 5 * MIB                     # MIN_PART_SIZE
HH = "highwayhash256S"
N, PARITY = 8, 2                   # EC:6+2: short HighwayHash chains on CPU
# (size, bitrot algorithm) of the mixed object's parts.
MIXED = [(PART, "mxh256"), (PART, HH), (100 * 1024 + 9, "mxh256")]


def payload(size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


def make_set(root, n=4, parity=None):
    return ErasureSet([LocalDrive(str(root / f"d{i}")) for i in range(n)],
                      default_parity=parity, device="cpu")


@pytest.fixture
def es(tmp_path):
    s = make_set(tmp_path)
    s.make_bucket("b")
    yield s
    s.close()


def upload_parts(mod, es, obj, parts, monkeypatch, uid=None):
    """Upload (size, algo) parts with package `mod`; returns the upload id,
    the bodies and the (number, etag) list."""
    uid = uid or mod.new_multipart_upload(es, "b", obj)
    bodies, listed = [], []
    for i, (size, algo) in enumerate(parts):
        monkeypatch.setenv("MTPU_BITROT_ALGO", algo)
        body = payload(size, seed=100 + i)
        info = mod.put_object_part(es, "b", obj, uid, i + 1, body)
        assert info.etag == hashlib.md5(body).hexdigest()
        bodies.append(body)
        listed.append((i + 1, info.etag))
    return uid, bodies, listed


class TestSemantics:
    def test_upload_list_complete(self, es):
        uid = mp.new_multipart_upload(es, "b", "o", metadata={"k": "v"})
        assert [u["upload_id"] for u in mp.list_multipart_uploads(es, "b")] \
            == [uid]
        p1, p2 = payload(PART, 1), payload(77, 2)
        i2 = mp.put_object_part(es, "b", "o", uid, 2, p2)   # out of order
        i1 = mp.put_object_part(es, "b", "o", uid, 1, p1)
        assert [p.number for p in mp.list_parts(es, "b", "o", uid)] == [1, 2]
        fi = mp.complete_multipart_upload(es, "b", "o", uid,
                                          [(1, i1.etag), (2, i2.etag)])
        want = hashlib.md5(bytes.fromhex(i1.etag)
                           + bytes.fromhex(i2.etag)).hexdigest() + "-2"
        assert fi.etag == want and fi.size == PART + 77
        assert fi.metadata["k"] == "v"
        got_fi, got = es.get_object("b", "o")
        assert bytes(got) == p1 + p2 and got_fi.etag == want
        assert mp.list_multipart_uploads(es, "b") == []

    def test_overwrite_and_sparse_numbers(self, es):
        uid = mp.new_multipart_upload(es, "b", "o")
        mp.put_object_part(es, "b", "o", uid, 3, payload(PART, 1))
        a = payload(PART, 11)
        ia = mp.put_object_part(es, "b", "o", uid, 3, a)    # re-upload wins
        b = payload(100, 5)
        ib = mp.put_object_part(es, "b", "o", uid, 7, b)
        fi = mp.complete_multipart_upload(es, "b", "o", uid,
                                          [(3, ia.etag), (7, ib.etag)])
        assert [p.number for p in fi.parts] == [1, 2]
        assert bytes(es.get_object("b", "o")[1]) == a + b

    def test_errors(self, es):
        with pytest.raises(mp.ErrUploadNotFound):
            mp.put_object_part(es, "b", "o", "nope", 1, b"x")
        uid = mp.new_multipart_upload(es, "b", "o")
        with pytest.raises(mp.ErrInvalidPart):
            mp.put_object_part(es, "b", "o", uid, 0, b"x")
        i1 = mp.put_object_part(es, "b", "o", uid, 1, payload(1000, 1))
        i2 = mp.put_object_part(es, "b", "o", uid, 2, payload(1000, 2))
        with pytest.raises(mp.ErrPartTooSmall):
            mp.complete_multipart_upload(es, "b", "o", uid,
                                         [(1, i1.etag), (2, i2.etag)])
        with pytest.raises(mp.ErrInvalidPartOrder):
            mp.complete_multipart_upload(es, "b", "o", uid,
                                         [(2, i2.etag), (1, i1.etag)])
        with pytest.raises(mp.ErrInvalidPart):
            mp.complete_multipart_upload(es, "b", "o", uid,
                                         [(1, "deadbeef" * 4)])

    def test_abort_cleans_up(self, es):
        uid = mp.new_multipart_upload(es, "b", "o")
        mp.put_object_part(es, "b", "o", uid, 1, payload(1000))
        mp.abort_multipart_upload(es, "b", "o", uid)
        assert mp.list_multipart_uploads(es, "b") == []
        with pytest.raises(mp.ErrUploadNotFound):
            mp.list_parts(es, "b", "o", uid)
        with pytest.raises(mp.ErrUploadNotFound):
            mp.abort_multipart_upload(es, "b", "o", uid)

    def test_list_uploads_by_prefix(self, es):
        u1 = mp.new_multipart_upload(es, "b", "photos/a")
        u2 = mp.new_multipart_upload(es, "b", "videos/a")
        assert [u["upload_id"] for u in
                mp.list_multipart_uploads(es, "b", prefix="photos/")] == [u1]
        assert {u["upload_id"] for u in
                mp.list_multipart_uploads(es, "b")} == {u1, u2}

    def test_stale_same_size_part_excluded(self, es):
        """A drive that missed a same-size re-upload must not publish its
        stale part (ETag check in complete's per-drive publish)."""
        uid = mp.new_multipart_upload(es, "b", "o")
        mp.put_object_part(es, "b", "o", uid, 1, payload(PART, 1))
        new = payload(PART, 2)
        d3, es.drives[3] = es.drives[3], None
        info = mp.put_object_part(es, "b", "o", uid, 1, new)
        es.drives[3] = d3
        mp.complete_multipart_upload(es, "b", "o", uid, [(1, info.etag)])
        assert bytes(es.get_object("b", "o")[1]) == new


def test_mixed_algorithms_read_and_heal(tmp_path, monkeypatch):
    """Parts written under different MTPU_BITROT_ALGO values read back
    byte-exact: whole, a range across the part 1/2 boundary, degraded;
    then heal restores a wiped drive's copy of every part."""
    with make_set(tmp_path, N, PARITY) as es:
        es.make_bucket("b")
        uid, bodies, listed = upload_parts(mp, es, "o", MIXED, monkeypatch)
        fi = mp.complete_multipart_upload(es, "b", "o", uid, listed)
        assert [c["algo"] for c in fi.erasure.checksums] == \
            [a for _, a in MIXED]
        whole = b"".join(bodies)
        assert bytes(es.get_object("b", "o")[1]) == whole
        off = PART - 1000
        assert bytes(es.get_object("b", "o", off, 5000)[1]) == \
            whole[off:off + 5000]
        golden = {}
        for root in (d.root for d in es.drives):
            golden[root] = {f: open(os.path.join(root, "b", "o", fi.data_dir,
                                                 f), "rb").read()
                            for f in ("part.1", "part.2", "part.3")}
        saved = list(es.drives)
        es.drives[0] = es.drives[5] = None
        assert bytes(es.get_object("b", "o")[1]) == whole
        es.drives = saved
        shutil.rmtree(os.path.join(es.drives[4].root, "b", "o"))
        r = heal.heal_object(es, "b", "o")[0]
        assert r.healed_drives == [4]
        for root, files in golden.items():
            for f, blob in files.items():
                assert open(os.path.join(root, "b", "o", fi.data_dir, f),
                            "rb").read() == blob, (root, f)
        es.drives[0] = es.drives[1] = None    # the healed drive serves
        assert bytes(es.get_object("b", "o")[1]) == whole


def test_heal_restores_an_empty_last_part(tmp_path, monkeypatch):
    """A completed upload whose last part is 0 bytes: heal stages that
    empty part file too, so the wiped drive's copy equals the others' and
    a second heal finds nothing to do."""
    with make_set(tmp_path, N, PARITY) as es:
        es.make_bucket("b")
        uid, bodies, listed = upload_parts(
            mp, es, "o", [(PART, "mxh256"), (0, HH)], monkeypatch)
        fi = mp.complete_multipart_upload(es, "b", "o", uid, listed)
        assert [p.size for p in fi.parts] == [PART, 0]

        def files(root):
            return {f: open(os.path.join(root, "b", "o", fi.data_dir, f),
                            "rb").read() for f in ("part.1", "part.2")}
        golden = files(es.drives[4].root)
        assert golden["part.2"] == b""
        shutil.rmtree(os.path.join(es.drives[4].root, "b", "o"))
        assert heal.heal_object(es, "b", "o")[0].healed_drives == [4]
        assert files(es.drives[4].root) == golden
        assert heal.heal_object(es, "b", "o")[0].healed_drives == []
        es.drives[0] = es.drives[1] = None    # the healed drive serves
        assert bytes(es.get_object("b", "o")[1]) == bodies[0]


class _Clock:
    """A fixed clock for both packages' multipart modules, so that two
    runs mint the same upload id, part metas and xl.meta."""
    @staticmethod
    def time_ns():
        return 1_700_000_000_111_222_333

    @staticmethod
    def perf_counter():
        return 0.0


def _fix_identity(monkeypatch):
    for mod in (mp, jax_mp):
        monkeypatch.setattr(mod, "time", _Clock)
        monkeypatch.setattr(mod, "new_uuid",
                            lambda: "00000000-0000-4000-8000-000000000042")


def test_uploads_across_packages(tmp_path, monkeypatch):
    """The port writes the parts and the JAX package completes and reads
    the object; the JAX package writes the same parts and the port
    completes and reads it.  Both trees end equal file for file."""
    _fix_identity(monkeypatch)
    parts = [(PART, HH), (300 * 1024 + 3, "mxh256")]
    roots = {name: [str(tmp_path / name / f"d{i}") for i in range(N)]
             for name in ("a", "b")}

    es = ErasureSet([LocalDrive(p) for p in roots["a"]],
                    default_parity=PARITY, device="cpu")
    es.make_bucket("b")
    uid, bodies, listed = upload_parts(mp, es, "o", parts, monkeypatch)
    es.close()
    jes = JaxErasureSet([JaxLocalDrive(p) for p in roots["a"]],
                        default_parity=PARITY)
    assert [p.number for p in jax_mp.list_parts(jes, "b", "o", uid)] == \
        [1, 2]
    jfi = jax_mp.complete_multipart_upload(jes, "b", "o", uid, listed)
    assert bytes(jes.get_object("b", "o")[1]) == b"".join(bodies)

    jes = JaxErasureSet([JaxLocalDrive(p) for p in roots["b"]],
                        default_parity=PARITY)
    jes.make_bucket("b")
    juid, jbodies, jlisted = upload_parts(jax_mp, jes, "o", parts,
                                          monkeypatch)
    assert (juid, jbodies, jlisted) == (uid, bodies, listed)
    with ErasureSet([LocalDrive(p) for p in roots["b"]],
                    default_parity=PARITY, device="cpu") as es:
        fi = mp.complete_multipart_upload(es, "b", "o", juid, jlisted)
        assert fi.etag == jfi.etag
        assert bytes(es.get_object("b", "o")[1]) == b"".join(bodies)

    for a, b in zip(roots["a"], roots["b"]):
        for name in ("xl.meta", f"{fi.data_dir}/part.1",
                     f"{fi.data_dir}/part.2"):
            with open(os.path.join(a, "b", "o", name), "rb") as fa, \
                    open(os.path.join(b, "b", "o", name), "rb") as fb:
                assert fa.read() == fb.read(), (a, name)
