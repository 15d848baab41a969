"""The S3 front door of the port (minio_tpu_torch/server; device="cpu"):
the 28 HTTP probes of tests/test_server.py, each run against the JAX
package's server and client and against the port's.  Every request goes
over a real TCP socket with a real SigV4 signature and comes back as
real S3 XML: buckets, objects, ranges, metadata, copy, the conditional
matrix, multi-delete, Content-MD5, listing v1 and v2, versioning,
multipart, the auth forms (header, bad secret, unknown key, anonymous,
presigned, tampered presigned, aws-chunked streaming, the chunk-size
cap), key encoding and TLS."""

import datetime
import hashlib
import http.client
import io
import socket
from types import SimpleNamespace

import numpy as np
import pytest

import minio_tpu.server.api_errors as jax_api_errors
import minio_tpu.server.client as jax_client
import minio_tpu.server.server as jax_server
import minio_tpu.server.sigv4 as jax_sigv4
import minio_tpu_torch.engine.erasure_set as port_es_mod
import minio_tpu_torch.server.api_errors as port_api_errors
import minio_tpu_torch.server.client as port_client
import minio_tpu_torch.server.server as port_server
import minio_tpu_torch.server.sigv4 as port_sigv4
from minio_tpu.engine.pools import ServerPools as JaxServerPools
from minio_tpu.engine.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.engine.pools import ServerPools
from minio_tpu_torch.engine.sets import ErasureSets
from minio_tpu_torch.storage.drive import LocalDrive

ACCESS, SECRET = "testadmin", "testadmin-secret-key"
#: Client socket timeout of the port's client (the JAX client's is 60 s).
TIMEOUT = 30


def _jax_pools(root, prefix):
    drives = [JaxLocalDrive(str(root / f"{prefix}{i}")) for i in range(4)]
    return JaxServerPools([JaxErasureSets(drives, set_drive_count=4)])


def _port_pools(root, prefix):
    drives = [LocalDrive(str(root / f"{prefix}{i}")) for i in range(4)]
    return ServerPools([ErasureSets(drives, set_drive_count=4,
                                    device="cpu")])


JAX = SimpleNamespace(
    name="jax", pools=_jax_pools, S3Server=jax_server.S3Server,
    S3Client=jax_client.S3Client, S3ClientError=jax_client.S3ClientError,
    sigv4=jax_sigv4, S3Error=jax_api_errors.S3Error, client_kw={})
PORT = SimpleNamespace(
    name="port", pools=_port_pools, S3Server=port_server.S3Server,
    S3Client=port_client.S3Client, S3ClientError=port_client.S3ClientError,
    sigv4=port_sigv4, S3Error=port_api_errors.S3Error,
    client_kw={"timeout": TIMEOUT})


def close_pools(pools):
    """Stop the executors of either package's sets (the JAX package's
    sets have no close())."""
    for p in pools.pools:
        for es in p.sets:
            if isinstance(es, port_es_mod.ErasureSet):
                es.close()
            else:
                es.pool.shutdown(wait=True)
                es._iter_pool.shutdown(wait=True)


@pytest.fixture(params=[JAX, PORT], ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.fixture()
def srv(pkg, tmp_path):
    pools = pkg.pools(tmp_path, "d")
    server = pkg.S3Server(pools, pkg.sigv4.Credentials(ACCESS,
                                                      SECRET)).start()
    yield server
    server.shutdown()
    close_pools(pools)


@pytest.fixture()
def cli(pkg, srv):
    return pkg.S3Client(srv.endpoint, ACCESS, SECRET, **pkg.client_kw)


def payload(size, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


class TestBuckets:
    def test_bucket_lifecycle(self, cli):
        cli.make_bucket("alpha")
        assert cli.bucket_exists("alpha")
        assert "alpha" in cli.list_buckets()
        cli.delete_bucket("alpha")
        assert not cli.bucket_exists("alpha")

    def test_invalid_bucket_name(self, pkg, cli):
        with pytest.raises(pkg.S3ClientError) as ei:
            cli.make_bucket("AB")
        assert ei.value.code == "InvalidBucketName"

    def test_meta_bucket_hidden(self, cli):
        assert ".mtpu.sys" not in cli.list_buckets()

    def test_delete_nonempty_bucket(self, pkg, cli):
        cli.make_bucket("bkt1")
        cli.put_object("bkt1", "x", b"data")
        with pytest.raises(pkg.S3ClientError) as ei:
            cli.delete_bucket("bkt1")
        assert ei.value.code == "BucketNotEmpty"


class TestObjects:
    def test_put_get_head_delete(self, pkg, cli):
        cli.make_bucket("bkt")
        data = payload(1000)
        h = cli.put_object("bkt", "obj1", data)
        assert h["ETag"].strip('"')
        assert cli.get_object("bkt", "obj1") == data
        head = cli.head_object("bkt", "obj1")
        assert int(head["Content-Length"]) == 1000
        cli.delete_object("bkt", "obj1")
        with pytest.raises(pkg.S3ClientError) as ei:
            cli.get_object("bkt", "obj1")
        assert ei.value.code == "NoSuchKey"

    def test_large_object_roundtrip(self, cli):
        cli.make_bucket("bkt")
        data = payload(3 * (1 << 20) + 12345, seed=3)
        cli.put_object("bkt", "big", data)
        assert cli.get_object("bkt", "big") == data

    def test_range_read(self, cli):
        cli.make_bucket("bkt")
        data = payload(300000, seed=1)
        cli.put_object("bkt", "r", data)
        assert cli.get_object("bkt", "r", range_=(100, 999)) == data[100:1000]
        # suffix range
        status, _, got = cli._check(*cli.request(
            "GET", "/bkt/r", headers={"Range": "bytes=-500"}))
        assert got == data[-500:]
        assert status == 206

    def test_user_metadata(self, cli):
        cli.make_bucket("bkt")
        cli.put_object("bkt", "m", b"x",
                       headers={"x-amz-meta-color": "blue",
                                "Content-Type": "text/plain"})
        h = cli.head_object("bkt", "m")
        assert h.get("x-amz-meta-color") == "blue"
        assert h.get("Content-Type") == "text/plain"

    def test_copy_object(self, cli):
        cli.make_bucket("bkt")
        data = payload(500, seed=2)
        cli.put_object("bkt", "src", data)
        cli.copy_object("bkt", "src", "bkt", "dst")
        assert cli.get_object("bkt", "dst") == data

    def test_conditional_get(self, cli):
        cli.make_bucket("bkt")
        h = cli.put_object("bkt", "c", b"hello")
        etag = h["ETag"]
        status, _, _ = cli.request("GET", "/bkt/c",
                                   headers={"If-None-Match": etag})
        assert status == 304
        status, _, _ = cli.request("GET", "/bkt/c",
                                   headers={"If-Match": '"wrong"'})
        assert status == 412

    def test_conditional_matrix(self, cli):
        """RFC 7232 over the S3 front door: 304/412 short-circuit
        before any shard IO, with the precedence S3 implements."""
        cli.make_bucket("bkt")
        h = cli.put_object("bkt", "c", b"conditional body")
        etag = h["ETag"]
        head = cli.head_object("bkt", "c")
        lastmod = head["Last-Modified"]
        past = "Mon, 01 Jan 2001 00:00:00 GMT"
        future = "Fri, 01 Jan 2038 00:00:00 GMT"

        for val in (etag, f'"zzz", {etag}', "*"):
            st, hdrs, body = cli.request(
                "GET", "/bkt/c", headers={"If-None-Match": val})
            assert (st, body) == (304, b""), val
            assert hdrs.get("ETag") == etag     # 304 carries validators
            assert hdrs.get("Last-Modified") == lastmod
        st, _, _ = cli.request(
            "GET", "/bkt/c", headers={"If-None-Match": f"W/{etag}"})
        assert st == 304
        st, _, body = cli.request(
            "GET", "/bkt/c", headers={"If-None-Match": '"other"'})
        assert st == 200 and body == b"conditional body"

        st, _, _ = cli.request(
            "GET", "/bkt/c", headers={"If-Match": '"wrong"'})
        assert st == 412
        st, _, body = cli.request(
            "GET", "/bkt/c", headers={"If-Match": etag})
        assert st == 200 and body == b"conditional body"

        st, _, _ = cli.request(
            "GET", "/bkt/c", headers={"If-Modified-Since": future})
        assert st == 304
        st, _, _ = cli.request(
            "GET", "/bkt/c", headers={"If-Modified-Since": past})
        assert st == 200
        st, _, _ = cli.request(
            "GET", "/bkt/c", headers={"If-Unmodified-Since": past})
        assert st == 412
        st, _, _ = cli.request(
            "GET", "/bkt/c", headers={"If-Unmodified-Since": future})
        assert st == 200

        st, _, _ = cli.request(
            "GET", "/bkt/c", headers={"If-None-Match": '"other"',
                                      "If-Modified-Since": future})
        assert st == 200
        st, _, _ = cli.request(
            "GET", "/bkt/c", headers={"If-Match": etag,
                                      "If-Unmodified-Since": past})
        assert st == 200

        st, _, _ = cli.request(
            "HEAD", "/bkt/c", headers={"If-None-Match": etag})
        assert st == 304
        st, _, _ = cli.request(
            "HEAD", "/bkt/c", headers={"If-Match": '"wrong"'})
        assert st == 412

        st, _, _ = cli.request(
            "GET", "/bkt/nope", headers={"If-Match": '"x"'})
        assert st == 404

    def test_multi_delete(self, cli):
        cli.make_bucket("bkt")
        for i in range(3):
            cli.put_object("bkt", f"k{i}", b"x")
        body = cli.delete_objects("bkt", ["k0", "k1", "k2", "missing"])
        assert body.count(b"<Deleted>") == 4
        keys, _ = cli.list_objects("bkt")
        assert keys == []

    def test_bad_md5_rejected(self, pkg, cli):
        cli.make_bucket("bkt")
        with pytest.raises(pkg.S3ClientError) as ei:
            cli.put_object("bkt", "x", b"data",
                           headers={"Content-MD5": "AAAAAAAAAAAAAAAAAAAAAA=="})
        assert ei.value.code == "BadDigest"


class TestListing:
    def test_list_with_delimiter(self, cli):
        cli.make_bucket("bkt")
        for key in ("a/1", "a/2", "b/1", "top"):
            cli.put_object("bkt", key, b"x")
        keys, prefixes = cli.list_objects("bkt", delimiter="/")
        assert keys == ["top"]
        assert prefixes == ["a/", "b/"]
        keys, prefixes = cli.list_objects("bkt", prefix="a/", delimiter="/")
        assert keys == ["a/1", "a/2"]
        assert prefixes == []

    def test_list_v1(self, cli):
        cli.make_bucket("bkt")
        cli.put_object("bkt", "z", b"x")
        keys, _ = cli.list_objects("bkt", v2=False)
        assert keys == ["z"]


class TestVersioning:
    def test_versioned_put_delete(self, pkg, cli):
        cli.make_bucket("vbkt")
        cli.set_versioning("vbkt", True)
        h1 = cli.put_object("vbkt", "k", b"v1")
        h2 = cli.put_object("vbkt", "k", b"v2")
        v1 = h1.get("x-amz-version-id")
        v2 = h2.get("x-amz-version-id")
        assert v1 and v2 and v1 != v2
        assert cli.get_object("vbkt", "k") == b"v2"
        assert cli.get_object("vbkt", "k", version_id=v1) == b"v1"
        # unversioned delete -> delete marker; old versions still readable
        h = cli.delete_object("vbkt", "k")
        assert h.get("x-amz-delete-marker") == "true"
        with pytest.raises(pkg.S3ClientError):
            cli.get_object("vbkt", "k")
        assert cli.get_object("vbkt", "k", version_id=v2) == b"v2"


class TestMultipartAPI:
    def test_multipart_roundtrip(self, cli):
        cli.make_bucket("mpb")
        uid = cli.create_multipart("mpb", "big")
        p1 = payload(5 << 20, seed=11)
        p2 = payload(1 << 20, seed=12)
        e1 = cli.upload_part("mpb", "big", uid, 1, p1)
        e2 = cli.upload_part("mpb", "big", uid, 2, p2)
        cli.complete_multipart("mpb", "big", uid, [(1, e1), (2, e2)])
        got = cli.get_object("mpb", "big")
        assert got == p1 + p2
        h = cli.head_object("mpb", "big")
        assert h["ETag"].strip('"').endswith("-2")

    def test_abort(self, pkg, cli):
        cli.make_bucket("mpb")
        uid = cli.create_multipart("mpb", "x")
        cli.upload_part("mpb", "x", uid, 1, b"data")
        cli.abort_multipart("mpb", "x", uid)
        with pytest.raises(pkg.S3ClientError) as ei:
            cli.complete_multipart("mpb", "x", uid, [(1, "whatever")])
        assert ei.value.code == "NoSuchUpload"


class TestAuth:
    def test_bad_secret_rejected(self, pkg, srv):
        bad = pkg.S3Client(srv.endpoint, ACCESS, "wrong-secret",
                           **pkg.client_kw)
        with pytest.raises(pkg.S3ClientError) as ei:
            bad.list_buckets()
        assert ei.value.code == "SignatureDoesNotMatch"

    def test_unknown_access_key(self, pkg, srv):
        bad = pkg.S3Client(srv.endpoint, "nobody", "x", **pkg.client_kw)
        with pytest.raises(pkg.S3ClientError) as ei:
            bad.list_buckets()
        assert ei.value.code == "InvalidAccessKeyId"

    def test_anonymous_rejected(self, srv):
        conn = http.client.HTTPConnection(srv.host, srv.port,
                                          timeout=TIMEOUT)
        conn.request("GET", "/")
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        assert resp.status == 403 and b"AccessDenied" in body

    def test_presigned_get(self, pkg, srv, cli):
        cli.make_bucket("bkt")
        cli.put_object("bkt", "p", b"presigned!")
        url = pkg.sigv4.presign_url(cli.creds, "GET", "/bkt/p", {},
                                    host=f"{srv.host}:{srv.port}")
        path, _, qs = url.partition("?")
        status, _, data = cli.request("GET", path, raw_query=qs)
        assert status == 200 and data == b"presigned!"

    def test_presigned_tampered_fails(self, pkg, srv, cli):
        cli.make_bucket("bkt")
        cli.put_object("bkt", "p2", b"x")
        url = pkg.sigv4.presign_url(cli.creds, "GET", "/bkt/p2", {},
                                    host=f"{srv.host}:{srv.port}")
        path, _, qs = url.partition("?")
        qs = qs.replace("Signature=", "Signature=0")
        status, _, data = cli.request("GET", path, raw_query=qs)
        assert status == 403

    def test_streaming_chunked_put(self, pkg, srv, cli):
        cli.make_bucket("bkt")
        data = payload(200000, seed=9)
        creds = cli.creds
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        scope = f"{amz_date[:8]}/{creds.region}/s3/aws4_request"
        # Sign with the streaming payload marker, then chunk-encode.
        headers = {"Host": f"{srv.host}:{srv.port}"}
        auth = pkg.sigv4.sign_request(
            creds, "PUT", "/bkt/streamed", {}, headers,
            payload="STREAMING-AWS4-HMAC-SHA256-PAYLOAD", now=now)
        headers.update(auth)
        seed_sig = auth["Authorization"].rpartition("Signature=")[2]
        body = pkg.sigv4.encode_streaming_body(creds, scope, amz_date,
                                               seed_sig, data)
        status, _, resp = cli.request("PUT", "/bkt/streamed", body=body,
                                      headers=headers, raw_query="")
        assert status == 200, resp
        assert cli.get_object("bkt", "streamed") == data

    def test_streaming_decode_rejects_tamper(self, pkg):
        creds = pkg.sigv4.Credentials(ACCESS, SECRET)
        amz_date = "20260101T000000Z"
        scope = f"20260101/{creds.region}/s3/aws4_request"
        seed = "ab" * 32
        body = pkg.sigv4.encode_streaming_body(creds, scope, amz_date, seed,
                                               b"hello")
        headers = {"authorization":
                   f"AWS4-HMAC-SHA256 Credential={ACCESS}/{scope}, "
                   f"SignedHeaders=host, Signature={seed}",
                   "x-amz-date": amz_date}
        assert pkg.sigv4.decode_streaming_body(creds, headers,
                                               body) == b"hello"
        bad = body.replace(b"hello", b"hellx")
        with pytest.raises(pkg.S3Error):
            pkg.sigv4.decode_streaming_body(creds, headers, bad)

    def test_streaming_reader_caps_declared_chunk_size(self, pkg):
        """A declared multi-GiB chunk is rejected before it is buffered:
        the chunk-size header is untrusted."""
        creds = pkg.sigv4.Credentials(ACCESS, SECRET)
        amz_date = "20260101T000000Z"
        scope = f"20260101/{creds.region}/s3/aws4_request"
        raw = io.BytesIO(b"140000000;chunk-signature=" + b"ab" * 32 +
                         b"\r\n" + b"x" * 1024)
        headers = {"authorization":
                   f"AWS4-HMAC-SHA256 Credential={ACCESS}/{scope}, "
                   f"SignedHeaders=host, Signature={'ab' * 32}",
                   "x-amz-date": amz_date}
        rd = pkg.sigv4.StreamingSigV4Reader(creds, headers, raw)
        with pytest.raises(pkg.S3Error) as ei:
            rd.read(100)
        assert ei.value.api.code == "EntityTooLarge"


class TestKeyEncoding:
    def test_unicode_and_space_keys(self, cli):
        cli.make_bucket("enc")
        for key in ("a b/c d.txt", "ünïcode/κλειδί", "pct%41key"):
            cli.put_object("enc", key, key.encode())
            assert cli.get_object("enc", key) == key.encode()
        keys, _ = cli.list_objects("enc", prefix="a b/")
        assert keys == ["a b/c d.txt"]


class TestTLS:
    def test_https_front_door(self, pkg, tmp_path):
        """TLS listener from a certificate and key file."""
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import NameOID

        key = rsa.generate_private_key(public_exponent=65537,
                                       key_size=2048)
        name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                             "127.0.0.1")])
        now = datetime.datetime.now(datetime.timezone.utc)
        cert = (x509.CertificateBuilder()
                .subject_name(name).issuer_name(name)
                .public_key(key.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now - datetime.timedelta(minutes=1))
                .not_valid_after(now + datetime.timedelta(days=1))
                .sign(key, hashes.SHA256()))
        cert_file = tmp_path / "public.crt"
        key_file = tmp_path / "private.key"
        cert_file.write_bytes(cert.public_bytes(
            serialization.Encoding.PEM))
        key_file.write_bytes(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))

        pools = pkg.pools(tmp_path, "t")
        srv = pkg.S3Server(pools,
                           pkg.sigv4.Credentials("tlsroot",
                                                 "tlsroot-secret1"),
                           certs=(str(cert_file), str(key_file))).start()
        try:
            assert srv.endpoint.startswith("https://")
            cli = pkg.S3Client(srv.endpoint, "tlsroot", "tlsroot-secret1",
                               verify_tls=False, **pkg.client_kw)
            cli.make_bucket("tlsb")
            cli.put_object("tlsb", "k", b"over tls")
            assert cli.get_object("tlsb", "k") == b"over tls"
        finally:
            srv.shutdown()
            close_pools(pools)


class TestPortOnly:
    """What the slim server does that its JAX counterpart does through
    planes the port does not have."""

    def test_unported_planes_answer_not_implemented(self, tmp_path):
        pools = PORT.pools(tmp_path, "n")
        srv = PORT.S3Server(pools, port_sigv4.Credentials(
            ACCESS, SECRET)).start()
        try:
            cli = PORT.S3Client(srv.endpoint, ACCESS, SECRET,
                                timeout=TIMEOUT)
            cli.make_bucket("npx")
            cli.put_object("npx", "o", b"plain")
            # An existing bucket is a 409 (the JAX package answers 500).
            with pytest.raises(PORT.S3ClientError) as ei:
                cli.make_bucket("npx")
            assert (ei.value.status, ei.value.code) == \
                (409, "BucketAlreadyOwnedByYou")
            # SSE, the encryption config and Select are served
            # (tests/test_torch_sse.py, test_torch_select.py): SSE-S3
            # without a KMS is refused as the JAX server refuses it, a
            # missing encryption config is a 404 and an empty Select
            # request malformed.
            for method, path, query, headers, want in (
                    ("PUT", "/npx/x", None,
                     {"x-amz-server-side-encryption": "AES256"},
                     (400, b"no KMS configured")),
                    ("GET", "/npx", {"encryption": ""}, None,
                     (404, b"ServerSideEncryptionConfigurationNotFound")),
                    ("POST", "/npx/o", {"select": ""}, None,
                     (400, b"MalformedXML"))):
                st, _, body = cli.request(method, path, query=query,
                                          headers=headers)
                assert st == want[0] and want[1] in body, (path, body)
            for method, path, query, headers, item in (
                    # Lifecycle, replication, object lock, retention
                    # and notification configs are served
                    # (tests/test_torch_lifecycle.py,
                    # test_torch_object_lock.py, test_torch_replication.py,
                    # test_torch_notify.py).
                    # Restore and the admin tier API are served
                    # (tests/test_torch_tier.py); below, a server without
                    # a tier manager refuses them.
                    ("GET", "/minio/admin/v3/bandwidth", None, None, "10"),
                    # Heal sequences, `info`, `datausage` and the pools
                    # are served; the service actions only on a cluster
                    # node.
                    ("POST", "/minio/admin/v3/service",
                     {"action": "restart"}, None, "10"),
                    # The server configuration is served
                    # (tests/test_torch_config.py).
                    ("GET", "/minio/admin/v3/profile", None, None, "10")):
                st, _, body = cli.request(method, path, query=query,
                                          headers=headers)
                assert st == 501, (method, path, body)
                assert b"NotImplemented" in body
                assert f"item {item})".encode() in body, body
            st, _, body = cli.request("POST", "/npx/o",
                                      query={"restore": ""})
            assert st == 501 and b"tiering not enabled" in body, body
            assert cli.admin("GET", "tier")[0] == 501
            # The metrics plane, unsigned.
            for path, headers in (("/minio/v2/metrics/node", {}),
                                  ("/minio/v2/metrics/cluster", {})):
                conn = http.client.HTTPConnection(srv.host, srv.port,
                                                  timeout=TIMEOUT)
                conn.request("GET", path, headers=headers)
                resp = conn.getresponse()
                body = resp.read()
                conn.close()
                assert resp.status == 501 and b"NotImplemented" in body
            # A bucket tagging config is stored, read back and deleted.
            tags = b"<Tagging><TagSet></TagSet></Tagging>"
            cli._check(*cli.request("PUT", "/npx", query={"tagging": ""},
                                    body=tags))
            st, _, got = cli.request("GET", "/npx", query={"tagging": ""})
            assert (st, got) == (200, tags)
            st, _, _ = cli.request("DELETE", "/npx", query={"tagging": ""})
            assert st == 204
            st, _, got = cli.request("GET", "/npx", query={"tagging": ""})
            assert st == 404 and b"NoSuchTagSet" in got
        finally:
            srv.shutdown()
            close_pools(pools)

    def test_object_stored_through_unported_plane_not_served(self,
                                                             tmp_path):
        """An object whose metadata names an SSE algorithm this server
        does not know is refused, not served as plain bytes (HEAD
        answers), a deflated object is served inflated, and a tiered
        stub in a server without a tier manager is refused; a quota'd
        bucket takes no write."""
        pools = PORT.pools(tmp_path, "q")
        srv = PORT.S3Server(pools, port_sigv4.Credentials(
            ACCESS, SECRET)).start()
        try:
            cli = PORT.S3Client(srv.endpoint, ACCESS, SECRET,
                                timeout=TIMEOUT)
            cli.make_bucket("tqx")
            import zlib
            text = b"a line of text\n" * 8
            for i, (key, value, stored, want) in enumerate((
                    ("x-mtpu-internal-sse-algo", "on", b"sealed bytes",
                     (403, 200)),
                    ("x-mtpu-internal-compression", "deflate",
                     zlib.compress(text, 1), (200, 200)),
                    ("x-mtpu-internal-tier", "on", b"sealed bytes",
                     (501, 501)))):
                pools.put_object("tqx", f"o{i}", stored, metadata={
                    key: value,
                    "x-mtpu-internal-client-size": str(len(text))})
                for method, code in zip(("GET", "HEAD"), want):
                    st, _, body = cli.request(method, f"/tqx/o{i}")
                    assert st == code, (key, method)
                    if st == 200 and method == "GET":
                        assert body == text
            # A quota another package stored is enforced: the bucket's
            # 36 bytes are over it, so the PUT is refused.
            srv.handlers.meta.put("tqx", "quota", b'{"quota": 1}')
            st, _, body = cli.request("PUT", "/tqx/new", body=b"x")
            assert st == 403 and b"QuotaExceeded" in body
            st, _, _ = cli.request("GET", "/tqx/new")
            assert st == 404
        finally:
            srv.shutdown()
            close_pools(pools)

    def test_drain_refuses_new_requests(self, tmp_path):
        pools = PORT.pools(tmp_path, "r")
        srv = PORT.S3Server(pools, port_sigv4.Credentials(
            ACCESS, SECRET)).start()
        try:
            cli = PORT.S3Client(srv.endpoint, ACCESS, SECRET,
                                timeout=TIMEOUT)
            st, _, _ = cli.request("GET", "/minio/health/ready")
            assert st == 200
            assert srv.drain(timeout=5)["leftover"] == 0
            st, h, _ = cli.request("GET", "/")
            assert st == 503 and h.get("Retry-After") == "1"
            st, _, _ = cli.request("GET", "/minio/health/ready")
            assert st == 503
            st, _, _ = cli.request("GET", "/minio/health/live")
            assert st == 200
        finally:
            srv.shutdown()
            close_pools(pools)
        with pytest.raises(OSError):
            socket.create_connection((srv.host, srv.port), timeout=2)


class TestTierFrontDoor:
    """The tier's front door on both servers over a directory tier:
    the admin `tier` and `ilm` endpoints, a stub's storage class on
    HEAD, `POST ?restore` for some days (x-amz-restore) and for good,
    and a restore of a plain object (InvalidObjectState).  The answers
    must agree (tests/test_torch_tier.py holds the bytes and the
    journal)."""

    @staticmethod
    def _run(pkg, tmp_path) -> list:
        import json as _json
        import minio_tpu.bucket.tier as jax_tier
        import minio_tpu_torch.bucket.tier as port_tier
        tier_mod = port_tier if pkg is PORT else jax_tier
        pools = pkg.pools(tmp_path / pkg.name, "t")
        tm = tier_mod.TierManager(pools)
        srv = pkg.S3Server(pools, pkg.sigv4.Credentials(ACCESS, SECRET),
                           tier_mgr=tm).start()
        out = []
        try:
            cli = pkg.S3Client(srv.endpoint, ACCESS, SECRET,
                               **pkg.client_kw)

            def admin(method, sub, doc=None, query=None):
                st, _, body = cli.request(
                    method, f"/minio/admin/v3/{sub}", query=query,
                    body=_json.dumps(doc).encode() if doc else b"")
                out.append((method, sub, st, _json.loads(body or b"{}")))

            def s3(method, path, query=None, body=b"", keep=()):
                st, h, data = cli.request(method, path, query=query,
                                          body=body)
                # An error's body carries a request id: keep its Code.
                what = (data.split(b"<Code>")[1].split(b"</Code>")[0]
                        if st >= 400 else hashlib.sha256(data).hexdigest())
                out.append((method, path, st,
                            {k: h.get(k) for k in keep}, what))
                return h

            data = np.random.default_rng(7).bytes(300_000)
            cli.make_bucket("tfd")
            cli.put_object("tfd", "obj", data)
            cli.put_object("tfd", "plain", data[:1000])
            admin("POST", "tier", {"name": "warm", "type": "fs",
                                   "path": str(tmp_path / pkg.name / "w")})
            admin("POST", "tier", {"name": "warm", "type": "fs",
                                   "path": str(tmp_path / "other")})
            admin("GET", "tier")
            admin("POST", "ilm", {"bucket": "tfd", "object": "obj",
                                  "tier": "WARM"})
            admin("POST", "ilm", {"bucket": "tfd", "object": "obj",
                                  "tier": "WARM"})
            keep = ("Content-Length", "x-amz-storage-class",
                    "x-amz-restore")
            s3("HEAD", "/tfd/obj", keep=keep)
            s3("GET", "/tfd/obj", keep=keep)
            s3("POST", "/tfd/plain", {"restore": ""})
            s3("POST", "/tfd/obj", {"restore": ""}, body=b"<bad")
            s3("POST", "/tfd/obj", {"restore": ""},
               body=b"<RestoreRequest><Days>0</Days></RestoreRequest>")
            s3("POST", "/tfd/obj", {"restore": ""},
               body=b"<RestoreRequest><Days>2</Days></RestoreRequest>")
            h = s3("HEAD", "/tfd/obj", keep=keep[:2])
            assert h["x-amz-restore"].startswith(
                'ongoing-request="false", expiry-date="')
            s3("GET", "/tfd/obj", keep=keep[:2])
            s3("POST", "/tfd/obj", {"restore": ""})
            s3("HEAD", "/tfd/obj", keep=keep)
            s3("POST", "/tfd/obj", {"restore": ""})
            admin("GET", "tier")
            admin("DELETE", "tier", query={"name": "warm"})
            admin("DELETE", "tier", query={"name": "warm"})
            doc = tm.stats()
            out.append({k: doc[k] for k in (
                "transitioned", "restored", "freed", "journal_pending")})
        finally:
            srv.shutdown()
            close_pools(pools)
        return out

    def test_tier_requests_match_jax(self, tmp_path):
        jax_out = self._run(JAX, tmp_path)
        port_out = self._run(PORT, tmp_path)
        assert port_out == jax_out
        statuses = [r[2] for r in port_out[:-1]]
        assert statuses == [200, 409, 200, 200, 200, 200, 200, 403, 400,
                            400, 202, 200, 200, 202, 200, 403, 200, 200,
                            404], statuses
        assert port_out[-1] == {"transitioned": 1, "restored": 2,
                                "freed": 1, "journal_pending": 0}

    def test_a_rule_for_an_unknown_arn_is_refused(self, tmp_path):
        """The port refuses a `?notification` rule whose ARN names no
        registered target (MinIO's ARN check), and stores nothing."""
        pools = PORT.pools(tmp_path, "a")
        srv = PORT.S3Server(pools, port_sigv4.Credentials(
            ACCESS, SECRET)).start()
        try:
            cli = PORT.S3Client(srv.endpoint, ACCESS, SECRET,
                                timeout=TIMEOUT)
            cli.make_bucket("arnb")
            rules = (b"<NotificationConfiguration><QueueConfiguration>"
                     b"<Queue>arn:minio:sqs::1:webhook</Queue><Event>"
                     b"s3:ObjectCreated:*</Event></QueueConfiguration>"
                     b"</NotificationConfiguration>")
            st, _, body = cli.request("PUT", "/arnb",
                                      query={"notification": ""},
                                      body=rules)
            assert st == 400 and b"InvalidArgument" in body, body
            assert b"arn:minio:sqs::1:webhook" in body
            st, _, body = cli.request("GET", "/arnb",
                                      query={"notification": ""})
            assert st == 404 and b"NoSuchNotificationConfiguration" in body
        finally:
            srv.shutdown()
            close_pools(pools)
