"""The object transforms of the port, held to the JAX package on the CPU.

- Sealing: each package's `seal` unseals in the other, at sizes around
  the 64 KiB packet; a flipped byte, two swapped packets and a dropped
  final packet are each detected by both.
- Byte-identical stores: with `secrets.token_bytes`, `new_uuid` and the
  clock pinned in both packages, an SSE-S3, an SSE-C and a
  compressed-then-sealed object give the same part files and xl.meta.
- The KMS: default and named keys unwrap each other's data keys; the KES
  client against an in-process fake KES (tests/test_sts_ldap_kes.py's).
- Cross-package reads: what the JAX server writes (SSE-S3, SSE-C,
  compressed) a port server on the same drives reads back exactly, and
  the other way round.
- Over HTTP on the port: copies across SSE-C, SSE-S3 and plain,
  UploadPartCopy from a sealed source, HEAD with and without the key, a
  wrong key, the refused multipart SSE, the KMS admin API, a tiered
  sealed object read through its tier, the replication proxy's reversal.
Bytes are exact everywhere.
"""

from __future__ import annotations

import base64
import hashlib
import os
import secrets

import numpy as np
import pytest

import minio_tpu.crypto.kms as jax_kms
import minio_tpu.crypto.sse as jax_sse
import minio_tpu.engine.erasure_set as jax_es_mod
import minio_tpu.server.handlers as jax_handlers
import minio_tpu_torch.crypto.kms as port_kms
import minio_tpu_torch.crypto.sse as port_sse
import minio_tpu_torch.engine.erasure_set as port_es_mod
import minio_tpu_torch.server.handlers as port_handlers
from test_torch_server import (JAX, PORT, TIMEOUT, _jax_pools, _port_pools,
                               close_pools)

ACCESS, SECRET = "sseadmin", "sseadmin-secret"
MASTER = b"\x42" * 32
KIB = 1024


def payload(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def csv_text(rows: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    lines = [b"id,name,dept,salary"]
    for i in range(rows):
        lines.append(b"%d,user%d,%s,%d" % (
            i, int(rng.integers(0, 1000)),
            (b"eng", b"sales", b"ops")[int(rng.integers(0, 3))],
            int(rng.integers(50, 200))))
    return b"\n".join(lines) + b"\n"


def ssec(key: bytes, prefix: str = "x-amz-") -> dict:
    return {
        f"{prefix}server-side-encryption-customer-algorithm": "AES256",
        f"{prefix}server-side-encryption-customer-key":
            base64.b64encode(key).decode(),
        f"{prefix}server-side-encryption-customer-key-md5":
            base64.b64encode(hashlib.md5(key).digest()).decode(),
    }


def pin_random(monkeypatch) -> dict:
    """Deterministic `secrets.token_bytes` (the one module both
    packages' sse and kms modules draw from); reset `n` to replay."""
    state = {"n": 0}

    def token_bytes(n: int = 32) -> bytes:
        state["n"] += 1
        out = b""
        while len(out) < n:
            out += hashlib.sha256(b"pin-%d-%d" % (state["n"],
                                                  len(out))).digest()
        return out[:n]
    monkeypatch.setattr(jax_sse.secrets, "token_bytes", token_bytes)
    assert port_sse.secrets is secrets
    return state


# -- sealing ----------------------------------------------------------------------

SIZES = [0, 1, 64 * KIB - 1, 64 * KIB, 64 * KIB + 1, 1024 * KIB + 7]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sealer,opener", [(jax_sse, port_sse),
                                           (port_sse, jax_sse)],
                         ids=["jax-to-port", "port-to-jax"])
def test_seal_unseals_across_packages(size, sealer, opener):
    key = hashlib.sha256(b"k%d" % size).digest()
    data = payload(size, size)
    blob = sealer.seal(data, key)
    n_packets = max(1, -(-size // port_sse.PACKET_SIZE))
    assert len(blob) == 8 + size + n_packets * (4 + 16)
    assert opener.unseal(blob, key) == data


def _packets(blob: bytes) -> list[bytes]:
    out, pos = [], 8
    while pos < len(blob):
        n = int.from_bytes(blob[pos:pos + 4], "big")
        out.append(blob[pos:pos + 4 + n])
        pos += 4 + n
    return out


@pytest.mark.parametrize("mode", ["tamper", "reorder", "truncate"])
@pytest.mark.parametrize("sealer", [jax_sse, port_sse], ids=["jax", "port"])
def test_tampering_is_detected_by_both(mode, sealer):
    key = b"\x07" * 32
    blob = sealer.seal(payload(3 * 64 * KIB + 5, 3), key)
    head, packets = blob[:8], _packets(blob)
    if mode == "tamper":
        bad = bytearray(blob)
        bad[8 + 4 + 100] ^= 1
        bad = bytes(bad)
    elif mode == "reorder":
        bad = head + packets[1] + packets[0] + b"".join(packets[2:])
    else:
        bad = head + b"".join(packets[:-1])
    for mod in (jax_sse, port_sse):
        with pytest.raises(mod.SSEError):
            mod.unseal(bad, key)


# -- byte-identical stores --------------------------------------------------------

def tree(root) -> dict:
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != ".mtpu.sys"]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


KINDS = {
    "sse-s3": ("obj.bin", lambda: payload(300 * KIB + 3, 11),
               {"x-amz-server-side-encryption": "AES256"}),
    "sse-c": ("obj.bin", lambda: payload(200 * KIB + 1, 12),
              ssec(b"\x33" * 32)),
    "compressed-sse-s3": ("table.csv", lambda: csv_text(30_000, 13),
                          {"x-amz-server-side-encryption": "AES256",
                           "Content-Type": "text/csv"}),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_both_packages_store_the_same_bytes(kind, tmp_path, monkeypatch):
    state = pin_random(monkeypatch)
    for mod in (jax_es_mod, port_es_mod):
        monkeypatch.setattr(mod, "new_uuid",
                            lambda: "00000003-aaaa-4bbb-8ccc-000000000003")
        monkeypatch.setattr(mod, "_now_ns", lambda: 1_700_000_000_555_000_001)
    key, make, headers = KINDS[kind]
    data = make()
    trees, metas = {}, {}
    for pkg, make_pools, hmod, kms_mod in (
            (JAX, _jax_pools, jax_handlers, jax_kms),
            (PORT, _port_pools, port_handlers, port_kms)):
        state["n"] = 0
        pools = make_pools(tmp_path / pkg.name, "d")
        try:
            h = hmod.S3Handlers(pools, kms=kms_mod.StaticKMS(MASTER),
                                compress_enabled=True)
            pools.make_bucket("tbk")
            h.put_object("tbk", key, data, dict(headers))
            fi = pools.head_object("tbk", key)
            metas[pkg.name] = dict(fi.metadata)
            got = h._read_plaintext("tbk", key, "", dict(headers))[1]
            assert bytes(got) == data
        finally:
            close_pools(pools)
        trees[pkg.name] = tree(tmp_path / pkg.name)
    assert metas["port"] == metas["jax"]
    assert metas["port"]["x-mtpu-internal-client-size"] == str(len(data))
    if kind.startswith("compressed"):
        assert metas["port"]["x-mtpu-internal-compression"] == "deflate"
    assert sorted(trees["port"]) == sorted(trees["jax"])
    assert trees["port"] == trees["jax"]


# -- the KMS and KES --------------------------------------------------------------

@pytest.mark.parametrize("key_id", [None, "tenant-a"])
@pytest.mark.parametrize("maker,opener", [(jax_kms, port_kms),
                                          (port_kms, jax_kms)],
                         ids=["jax-to-port", "port-to-jax"])
def test_kms_data_keys_unwrap_across_packages(key_id, maker, opener):
    a, b = maker.StaticKMS(MASTER), opener.StaticKMS(MASTER)
    if key_id:
        a.create_key(key_id)
        b.create_key(key_id)
    kid, plain, sealed = a.generate_data_key(b"ctx", key_id=key_id)
    assert kid == (key_id or "mtpu-default-key")
    assert b.decrypt_data_key(kid, sealed, b"ctx") == plain
    with pytest.raises(opener.KMSError):
        b.decrypt_data_key(kid, sealed, b"other")
    assert a.list_keys() == b.list_keys()
    assert b.key_status(kid) == a.key_status(kid) == {
        "keyId": kid, "encryptionErr": "", "decryptionErr": ""}
    doc = maker.seal_with_kms(a, b"tier secret", b"tier-config")
    assert opener.unseal_with_kms(b, doc, b"tier-config") == b"tier secret"


def test_kms_refuses_what_the_jax_kms_refuses(monkeypatch):
    monkeypatch.delenv("MTPU_KMS_SECRET_KEY", raising=False)
    assert port_kms.kms_from_env() is None
    for bad in (b"\x00" * 32, b"short"):
        with pytest.raises(port_kms.KMSError):
            port_kms.StaticKMS(bad)
    k = port_kms.StaticKMS(MASTER)
    for bad_id in ("", "a/b"):
        with pytest.raises(port_kms.KMSError):
            k.create_key(bad_id)
    assert k.key_status("ghost")["encryptionErr"] == \
        jax_kms.StaticKMS(MASTER).key_status("ghost")["encryptionErr"]
    monkeypatch.setenv("MTPU_KMS_SECRET_KEY", MASTER.hex())
    assert port_kms.kms_from_env().key_id == "mtpu-default-key"


def test_kes_client_against_a_fake_kes():
    from minio_tpu.crypto.kes import KESKMS as JaxKES
    from minio_tpu_torch.crypto.kes import KESKMS
    from test_sts_ldap_kes import FakeKES
    fake = FakeKES()
    try:
        kms, jkms = KESKMS("127.0.0.1", fake.port), \
            JaxKES("127.0.0.1", fake.port)
        assert kms.status() == {"version": "fake-kes"}
        kid, pk, sealed = kms.generate_data_key(b"ctx")
        assert kid == "minio-key" and len(pk) == 32
        assert kms.decrypt_data_key(kid, sealed, b"ctx") == pk
        assert jkms.decrypt_data_key(kid, sealed, b"ctx") == pk
        with pytest.raises(port_kms.KMSError):
            kms.decrypt_data_key(kid, sealed, b"other")
        with pytest.raises(port_kms.KMSError):
            kms.generate_data_key(b"", key_id="ghost")
        kms.create_key("tenant-b")
        assert kms.list_keys() == jkms.list_keys() == ["minio-key",
                                                      "tenant-b"]
        assert kms.key_status("tenant-b") == jkms.key_status("tenant-b")
        # SSE-S3 through the KES: each package unseals the other's.
        stored, meta = port_sse.encrypt_for_put(
            b"kes sealed", {"x-amz-server-side-encryption": "aws:kms"}, kms)
        assert jax_sse.decrypt_for_get(stored, meta, {}, jkms) == \
            b"kes sealed"
    finally:
        fake.stop()
    down = KESKMS("127.0.0.1", fake.port, timeout=1.0)
    with pytest.raises(port_kms.KMSError):
        down.generate_data_key(b"")


# -- over HTTP -----------------------------------------------------------------

def _server(pkg, pools, **kw):
    from minio_tpu.crypto.kms import StaticKMS as JaxKMS
    kms = (JaxKMS if pkg is JAX else port_kms.StaticKMS)(MASTER)
    return pkg.S3Server(pools, pkg.sigv4.Credentials(ACCESS, SECRET),
                        kms=kms, compress_enabled=True, **kw).start()


CROSS = {
    "s3.bin": (payload(700 * KIB + 9, 21),
               {"x-amz-server-side-encryption": "AES256"}),
    "c.bin": (payload(150 * KIB + 2, 22), ssec(b"\x51" * 32)),
    "t.csv": (csv_text(20_000, 23), {"Content-Type": "text/csv"}),
    "ct.csv": (csv_text(9_000, 24), ssec(b"\x52" * 32)),
}


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-writes", "port-writes"])
def test_transformed_objects_read_across_packages(writer, reader, tmp_path):
    pools = writer.pools(tmp_path, "d")
    srv = _server(writer, pools)
    try:
        cli = writer.S3Client(srv.endpoint, ACCESS, SECRET,
                              **writer.client_kw)
        cli.make_bucket("xbk")
        for key, (data, headers) in CROSS.items():
            st, _, body = cli.request("PUT", f"/xbk/{key}", body=data,
                                      headers=dict(headers))
            assert st == 200, body
    finally:
        srv.shutdown()
        close_pools(pools)
    pools = reader.pools(tmp_path, "d")
    srv = _server(reader, pools)
    try:
        cli = reader.S3Client(srv.endpoint, ACCESS, SECRET,
                              **reader.client_kw)
        for key, (data, headers) in CROSS.items():
            keyh = {k: v for k, v in headers.items()
                    if "customer" in k}
            st, h, body = cli.request("GET", f"/xbk/{key}", headers=keyh)
            assert st == 200 and body == data, key
            assert int(h["Content-Length"]) == len(data)
            st, _, body = cli.request(
                "GET", f"/xbk/{key}",
                headers=dict(keyh, Range="bytes=70000-140000"))
            assert st == 206 and body == data[70000:140001], key
            st, h, _ = cli.request("HEAD", f"/xbk/{key}", headers=keyh)
            assert st == 200 and int(h["Content-Length"]) == len(data)
        fi = pools.head_object("xbk", "t.csv")
        assert fi.metadata["x-mtpu-internal-compression"] == "deflate"
        assert fi.size < len(CROSS["t.csv"][0]) // 2
    finally:
        srv.shutdown()
        close_pools(pools)


@pytest.fixture()
def port_cli(tmp_path):
    pools = _port_pools(tmp_path, "h")
    srv = _server(PORT, pools)
    cli = PORT.S3Client(srv.endpoint, ACCESS, SECRET, timeout=TIMEOUT)
    cli.make_bucket("hbk")
    yield srv, pools, cli
    srv.shutdown()
    close_pools(pools)


def test_head_and_get_check_the_ssec_key(port_cli):
    srv, pools, cli = port_cli
    key, wrong = b"\x61" * 32, b"\x62" * 32
    data = payload(90 * KIB, 31)
    assert cli.request("PUT", "/hbk/o", body=data, headers=ssec(key))[0] \
        == 200
    st, h, _ = cli.request("HEAD", "/hbk/o", headers=ssec(key))
    assert st == 200
    assert h["x-amz-server-side-encryption-customer-algorithm"] == "AES256"
    assert h["x-amz-server-side-encryption-customer-key-md5"] == \
        ssec(key)["x-amz-server-side-encryption-customer-key-md5"]
    for headers in ({}, ssec(wrong)):
        for method in ("HEAD", "GET"):
            st, _, body = cli.request(method, "/hbk/o", headers=headers)
            assert st == 403, (method, headers)
    bad = dict(ssec(key))
    bad["x-amz-server-side-encryption-customer-key-md5"] = \
        ssec(wrong)["x-amz-server-side-encryption-customer-key-md5"]
    assert cli.request("PUT", "/hbk/p", body=b"x", headers=bad)[0] == 400
    assert cli.request("GET", "/hbk/o", headers=ssec(key))[2] == data
    # SSE-S3 announces itself, a plain object does not.
    cli.request("PUT", "/hbk/s", body=b"s3",
                headers={"x-amz-server-side-encryption": "AES256"})
    assert cli.request("HEAD", "/hbk/s")[1][
        "x-amz-server-side-encryption"] == "AES256"
    cli.request("PUT", "/hbk/plain", body=b"p")
    assert "x-amz-server-side-encryption" not in \
        cli.request("HEAD", "/hbk/plain")[1]


def test_copies_reseal_across_modes(port_cli):
    srv, pools, cli = port_cli
    key, key2 = b"\x71" * 32, b"\x72" * 32
    data = payload(120 * KIB + 5, 41)
    cli.request("PUT", "/hbk/src-c", body=data, headers=ssec(key))
    cli.request("PUT", "/hbk/src-s3", body=data,
                headers={"x-amz-server-side-encryption": "AES256"})
    cli.request("PUT", "/hbk/src-plain", body=data)
    src_key = ssec(key, "x-amz-copy-source-")

    def copy(dst, src, headers):
        st, _, body = cli.request(
            "PUT", f"/hbk/{dst}",
            headers=dict(headers, **{"x-amz-copy-source": f"/hbk/{src}"}))
        return st, body

    def algo(k):
        return pools.head_object("hbk", k).metadata.get(
            "x-mtpu-internal-sse-algo", "")
    # SSE-C -> SSE-S3, SSE-C -> SSE-C under another key, SSE-C -> plain
    assert copy("c2s3", "src-c", dict(
        src_key, **{"x-amz-server-side-encryption": "AES256"}))[0] == 200
    assert algo("c2s3") == "SSE-S3"
    assert copy("c2c", "src-c", dict(src_key, **ssec(key2)))[0] == 200
    assert copy("c2p", "src-c", src_key)[0] == 200
    assert algo("c2p") == ""
    # SSE-S3 stays SSE-S3 by default; plain -> SSE-C
    assert copy("s32s3", "src-s3", {})[0] == 200
    assert algo("s32s3") == "SSE-S3"
    assert copy("p2c", "src-plain", ssec(key2))[0] == 200
    # A sealed SSE-C source without its key is refused.
    assert copy("nokey", "src-c", {})[0] == 403
    for dst, h in (("c2s3", {}), ("c2c", ssec(key2)), ("c2p", {}),
                   ("s32s3", {}), ("p2c", ssec(key2))):
        st, hd, body = cli.request("GET", f"/hbk/{dst}", headers=h)
        assert st == 200 and body == data, dst
        assert int(hd["Content-Length"]) == len(data)
    # UploadPartCopy from a sealed source: the part is the plaintext.
    st, _, body = cli.request("POST", "/hbk/mp", query={"uploads": ""})
    upload = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
    st, _, body = cli.request(
        "PUT", "/hbk/mp", query={"partNumber": "1", "uploadId": upload},
        headers=dict(src_key, **{"x-amz-copy-source": "/hbk/src-c",
                                 "x-amz-copy-source-range":
                                     "bytes=1000-60999"}))
    assert st == 200, body
    etag = body.split(b"<ETag>")[1].split(b"</ETag>")[0].decode()
    done = (f"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
            f"<ETag>{etag}</ETag></Part></CompleteMultipartUpload>")
    assert cli.request("POST", "/hbk/mp", query={"uploadId": upload},
                       body=done.encode())[0] == 200
    assert cli.get_object("hbk", "mp") == data[1000:61000]
    # A multipart upload asking for SSE is refused (the JAX package
    # stores its parts plain).
    st, _, body = cli.request("POST", "/hbk/mp2", query={"uploads": ""},
                              headers={"x-amz-server-side-encryption":
                                       "AES256"})
    assert st == 501 and b"multipart" in body


def test_kms_admin_api_matches_jax(tmp_path):
    out = {}
    for pkg in (JAX, PORT):
        pools = pkg.pools(tmp_path / pkg.name, "k")
        srv = _server(pkg, pools)
        try:
            cli = PORT.S3Client(srv.endpoint, ACCESS, SECRET,
                                timeout=TIMEOUT)
            out[pkg.name] = [
                cli.admin("GET", "kms/status"),
                cli.admin("GET", "kms/key/list"),
                cli.admin("POST", "kms/key/create", {"key-id": "app-1"}),
                cli.admin("POST", "kms/key/create", {"key-id": ""})[0],
                cli.admin("GET", "kms/key/list"),
                cli.admin("GET", "kms/key/status", {"key-id": "app-1"}),
                cli.admin("GET", "kms/key/status", {"key-id": "ghost"}),
                cli.admin("DELETE", "kms/key/list")[0]]
        finally:
            srv.shutdown()
            close_pools(pools)
    assert out["port"] == out["jax"]
    assert out["port"][2] == (200, {"created": "app-1"})


def test_encryption_config_is_stored_not_applied(port_cli):
    srv, pools, cli = port_cli
    cfg = (b"<ServerSideEncryptionConfiguration><Rule>"
           b"<ApplyServerSideEncryptionByDefault><SSEAlgorithm>AES256"
           b"</SSEAlgorithm></ApplyServerSideEncryptionByDefault></Rule>"
           b"</ServerSideEncryptionConfiguration>")
    assert cli.request("PUT", "/hbk", query={"encryption": ""},
                       body=cfg)[0] == 200
    st, _, got = cli.request("GET", "/hbk", query={"encryption": ""})
    assert (st, got) == (200, cfg)
    cli.request("PUT", "/hbk/nohdr", body=b"plain")
    assert "x-mtpu-internal-sse-algo" not in \
        pools.head_object("hbk", "nohdr").metadata
    assert cli.request("DELETE", "/hbk", query={"encryption": ""})[0] == 204
    assert cli.request("GET", "/hbk", query={"encryption": ""})[0] == 404


def test_a_sealed_compressed_object_reads_through_its_tier(tmp_path):
    from minio_tpu_torch.bucket.tier import DirTierBackend, TierManager
    pools = _port_pools(tmp_path, "t")
    tm = TierManager(pools, kms=port_kms.StaticKMS(MASTER))
    tm.add_tier("WARM", DirTierBackend(str(tmp_path / "warm")))
    srv = _server(PORT, pools, tier_mgr=tm)
    try:
        cli = PORT.S3Client(srv.endpoint, ACCESS, SECRET, timeout=TIMEOUT)
        cli.make_bucket("tbk")
        data = csv_text(25_000, 51)
        for key, h in (("s.csv", {"x-amz-server-side-encryption":
                                  "AES256"}),
                       ("c.csv", ssec(b"\x81" * 32))):
            cli.request("PUT", f"/tbk/{key}", body=data, headers=h)
            stored = pools.head_object("tbk", key).size
            assert stored < len(data) // 2           # compressed, sealed
            assert tm.transition_object("tbk", key, "WARM")
            fi = pools.head_object("tbk", key)
            assert fi.size == 0 and tm.is_transitioned(fi)
            keyh = {k: v for k, v in h.items() if "customer" in k}
            st, hd, body = cli.request("GET", f"/tbk/{key}", headers=keyh)
            assert st == 200 and body == data, key
            assert hd["x-amz-storage-class"] == "WARM"
            st, _, body = cli.request("GET", f"/tbk/{key}", headers=dict(
                keyh, Range="bytes=5000-9999"))
            assert st == 206 and body == data[5000:10000]
        assert cli.request("GET", "/tbk/c.csv")[0] == 403   # no key
    finally:
        srv.shutdown()
        close_pools(pools)


def test_the_replication_proxy_reverses_the_transforms(tmp_path):
    """A GET the bucket's resync proxies to an in-process target, which
    answers with its stored bytes and metadata, serves the plaintext of
    the sealed, compressed copy."""
    data = csv_text(5_000, 61)
    kms = port_kms.StaticKMS(MASTER)
    from minio_tpu_torch.utils import compress as cz
    comp, cmeta = cz.compress(data)
    sealed, smeta = port_sse.encrypt_for_put(
        comp, {"x-amz-server-side-encryption": "AES256"}, kms)
    meta = dict(cmeta, **smeta, etag="e" * 32)

    class Proxy:
        def resync_status(self, bucket):
            return {"status": "running"}

        def proxy_get(self, bucket, key, headers=None):
            return dict(meta), sealed
    pools = _port_pools(tmp_path, "r")
    try:
        h = port_handlers.S3Handlers(pools, replication=Proxy(), kms=kms)
        pools.make_bucket("rb")
        resp = h.get_object("rb", "gone.csv", {}, {})
        assert resp.status == 200 and bytes(resp.body) == data
        assert resp.headers["Content-Length"] == str(len(data))
        resp = h.get_object("rb", "gone.csv", {}, {"Range": "bytes=10-19"})
        assert resp.status == 206 and bytes(resp.body) == data[10:20]
    finally:
        close_pools(pools)


REPL_XML = ("<ReplicationConfiguration><Rule><ID>r1</ID>"
            "<Status>Enabled</Status><Priority>1</Priority>"
            "<Filter><Prefix></Prefix></Filter><Destination>"
            "<Bucket>arn:aws:s3:::{dst}</Bucket></Destination>"
            "</Rule></ReplicationConfiguration>")


def test_replicas_carry_the_plaintext_and_the_target_seals_again(
        tmp_path, monkeypatch):
    """Replication between two port servers with their own KMS master
    keys: an SSE-S3 version lands sealed again under the target's key,
    a compressed one compressed by the target, each reading back its
    plaintext; an SSE-C version (its key is the client's) is stamped
    FAILED and counted unreplicable, not copied as ciphertext.  While
    the bucket resyncs, a GET of a key only the target holds proxies
    to it and serves the plaintext; an SSE-C one with the client's key,
    and AccessDenied without it."""
    from minio_tpu_torch.bucket import replication as port_repl
    from minio_tpu_torch.utils import compress as cz
    import json
    monkeypatch.setenv("MTPU_SCANNER", "0")
    monkeypatch.delenv("MTPU_WORKER_ID", raising=False)
    kms_b = port_kms.StaticKMS(b"\x43" * 32)
    pools_a = _port_pools(tmp_path, "ra")
    pools_b = _port_pools(tmp_path, "rb")
    rp = port_repl.ReplicationPool(pools_a)
    creds = PORT.sigv4.Credentials(ACCESS, SECRET)
    srv_a = _server(PORT, pools_a, replication=rp)
    srv_b = PORT.S3Server(pools_b, creds, kms=kms_b,
                          compress_enabled=True).start()
    try:
        a = PORT.S3Client(srv_a.endpoint, ACCESS, SECRET, timeout=TIMEOUT)
        b = PORT.S3Client(srv_b.endpoint, ACCESS, SECRET, timeout=TIMEOUT)
        a.make_bucket("src")
        b.make_bucket("dst")
        st, _, body = a.request(
            "POST", "/minio/admin/v3/bucket-remote",
            query={"bucket": "src"},
            body=json.dumps({"endpoint": srv_b.endpoint,
                             "accessKey": ACCESS, "secretKey": SECRET,
                             "targetBucket": "dst"}).encode())
        assert st == 200, body
        st, _, body = a.request("PUT", "/src", query={"replication": ""},
                                body=REPL_XML.format(dst="dst").encode())
        assert st == 200, body
        ckey = b"\x71" * 32
        objs = dict(CROSS, **{"c.bin": (payload(150 * KIB + 2, 22),
                                        ssec(ckey))})
        objs.pop("ct.csv")
        objs["st.csv"] = (csv_text(9_000, 62),
                          {"x-amz-server-side-encryption": "AES256",
                           "Content-Type": "text/csv"})
        for key, (data, headers) in objs.items():
            st, _, body = a.request("PUT", f"/src/{key}", body=data,
                                    headers=dict(headers))
            assert st == 200, body
        assert rp.wait_idle(30)
        for key in ("s3.bin", "t.csv", "st.csv"):
            data = objs[key][0]
            assert b.get_object("dst", key) == data, key
            fi, stored = pools_b.get_object("dst", key)
            assert bytes(stored) != data, key
            assert fi.metadata[port_repl.STATUS_KEY] == "REPLICA"
            assert a.head_object("src", key)[
                "x-amz-replication-status"] == "COMPLETED"
        for key in ("s3.bin", "st.csv"):
            fi = pools_b.head_object("dst", key)
            assert fi.metadata[port_sse.META_ALGO] == "SSE-S3"
            sealed_key = base64.b64decode(
                fi.metadata[port_sse.META_SEALED_KEY])
            kid = fi.metadata[port_sse.META_KMS_KEY_ID]
            kms_b.decrypt_data_key(kid, sealed_key)
            with pytest.raises(port_kms.KMSError):
                port_kms.StaticKMS(MASTER).decrypt_data_key(kid,
                                                            sealed_key)
        for key in ("t.csv", "st.csv"):
            assert pools_b.head_object("dst", key).metadata[
                cz.META_COMPRESSION] == "deflate"
        st, _, _ = b.request("HEAD", "/dst/c.bin", headers=ssec(ckey))
        assert st == 404
        assert a.request("HEAD", "/src/c.bin", headers=ssec(ckey))[1][
            "x-amz-replication-status"] == "FAILED"
        assert rp.stats()["unreplicable"] == 1

        only = {"only-s3.bin": objs["s3.bin"], "only.csv": objs["t.csv"],
                "only-c.bin": objs["c.bin"]}
        for key, (data, headers) in only.items():
            st, _, body = b.request("PUT", f"/dst/{key}", body=data,
                                    headers=dict(headers))
            assert st == 200, body
        rp._save_resync("src", {"bucket": "src", "status": "running",
                                "started": 0, "last_key": "",
                                "queued": 0})
        for key, (data, headers) in only.items():
            keyh = {k: v for k, v in headers.items() if "customer" in k}
            st, h, body = a.request("GET", f"/src/{key}", headers=keyh)
            assert (st, body) == (200, data), key
            assert h["x-amz-replication-status"] == "REPLICA"
            st, _, body = a.request(
                "GET", f"/src/{key}",
                headers=dict(keyh, Range="bytes=70000-140000"))
            assert (st, body) == (206, data[70000:140001]), key
        st, _, body = a.request("GET", "/src/only-c.bin")
        assert st == 403 and b"AccessDenied" in body
    finally:
        rp.stop()
        srv_a.shutdown()
        srv_b.shutdown()
        close_pools(pools_a)
        close_pools(pools_b)
