"""Streamed bodies through the port's S3 front door (device="cpu"): the
HTTP probes of tests/test_streaming.py (TestHTTPStreaming,
TestStreamingSigV4Edges, TestContentMD5Conformance), each run against
the JAX package's server on its hashlib digest path
(MTPU_NATIVE_DIGEST=0, the only one the port has) and against the
port's; and the streamed GET (`get_object_iter`) of both packages'
erasure sets: chunks bounded by one device batch, ranged reads, many
concurrent streams, and a read that fails before its first chunk
answering an S3 error."""

import base64
import concurrent.futures as cf
import datetime
import hashlib
import http.client as hc
from types import SimpleNamespace

import pytest

import minio_tpu.engine.erasure_set as jax_es_mod
import minio_tpu.server.client as jax_client
import minio_tpu.server.server as jax_server
import minio_tpu.server.sigv4 as jax_sigv4
import minio_tpu_torch.engine.erasure_set as port_es_mod
import minio_tpu_torch.server.client as port_client
import minio_tpu_torch.server.server as port_server
import minio_tpu_torch.server.sigv4 as port_sigv4
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.storage.drive import LocalDrive
from test_streaming import PatternReader, pattern_bytes
from test_torch_server import TIMEOUT, close_pools

BLOCK_SIZE = port_es_mod.BLOCK_SIZE
BATCH_BLOCKS = port_es_mod.BATCH_BLOCKS
assert (BLOCK_SIZE, BATCH_BLOCKS) == (jax_es_mod.BLOCK_SIZE,
                                      jax_es_mod.BATCH_BLOCKS)
ACCESS, SECRET = "strmadmin", "strmadmin-secret"


def _jax_set(root, prefix):
    return jax_es_mod.ErasureSet(
        [JaxLocalDrive(str(root / f"{prefix}{i}")) for i in range(4)])


def _port_set(root, prefix):
    return port_es_mod.ErasureSet(
        [LocalDrive(str(root / f"{prefix}{i}")) for i in range(4)],
        device="cpu")


JAX = SimpleNamespace(
    name="jax", erasure_set=_jax_set, S3Server=jax_server.S3Server,
    S3Client=jax_client.S3Client, S3ClientError=jax_client.S3ClientError,
    sigv4=jax_sigv4, client_kw={})
PORT = SimpleNamespace(
    name="port", erasure_set=_port_set, S3Server=port_server.S3Server,
    S3Client=port_client.S3Client, S3ClientError=port_client.S3ClientError,
    sigv4=port_sigv4, client_kw={"timeout": TIMEOUT})


def close_set(es):
    if isinstance(es, port_es_mod.ErasureSet):
        es.close()
    else:
        es.pool.shutdown(wait=True)
        es._iter_pool.shutdown(wait=True)


@pytest.fixture(params=[JAX, PORT], ids=lambda p: p.name)
def pkg(request, monkeypatch):
    # The JAX package's hashlib digest path: the port has no other.
    monkeypatch.setenv("MTPU_NATIVE_DIGEST", "0")
    return request.param


@pytest.fixture()
def es(pkg, tmp_path):
    s = pkg.erasure_set(tmp_path, "d")
    s.make_bucket("strm")
    yield s
    close_set(s)


@pytest.fixture()
def srv(pkg, tmp_path):
    from test_torch_server import _jax_pools, _port_pools
    pools = (_jax_pools if pkg is JAX else _port_pools)(tmp_path, "s")
    s = pkg.S3Server(pools, pkg.sigv4.Credentials(ACCESS, SECRET)).start()
    yield s
    s.shutdown()
    close_pools(pools)


@pytest.fixture()
def cli(pkg, srv):
    return pkg.S3Client(srv.endpoint, ACCESS, SECRET, **pkg.client_kw)


class TestStreamingGet:
    def test_iter_chunks_are_bounded(self, es):
        size = 3 * BATCH_BLOCKS * BLOCK_SIZE + 4321
        r = PatternReader(size)
        es.put_object("strm", "iter", r)
        fi, it = es.get_object_iter("strm", "iter")
        total = 0
        h = hashlib.md5()
        for chunk in it:
            assert len(chunk) <= BATCH_BLOCKS * BLOCK_SIZE
            total += len(chunk)
            h.update(chunk)
        assert total == size and h.hexdigest() == r.md5.hexdigest()
        assert fi.size == size

    def test_iter_ranged(self, es):
        size = BATCH_BLOCKS * BLOCK_SIZE + 100
        raw = pattern_bytes(size)
        es.put_object("strm", "rng", raw)
        off, ln = BLOCK_SIZE - 7, 2 * BLOCK_SIZE + 13
        fi, it = es.get_object_iter("strm", "rng", offset=off, length=ln)
        assert b"".join(it) == raw[off:off + ln]
        # across the batch boundary, and an inline object's slice
        off = BATCH_BLOCKS * BLOCK_SIZE - 5
        _, it = es.get_object_iter("strm", "rng", offset=off, length=50)
        assert b"".join(it) == raw[off:off + 50]
        es.put_object("strm", "small", raw[:5000])
        _, it = es.get_object_iter("strm", "small", offset=10, length=20)
        assert b"".join(it) == raw[10:30]

    def test_many_concurrent_streamed_gets_no_deadlock(self, es):
        """More concurrent GET streams than pool workers all make
        progress (prefetch runs on its own executor)."""
        raw = pattern_bytes(2 * BLOCK_SIZE + 17)
        for i in range(3):
            es.put_object("strm", f"o{i}", raw)

        def drain(i):
            _, it = es.get_object_iter("strm", f"o{i % 3}")
            return sum(len(c) for c in it)

        with cf.ThreadPoolExecutor(max_workers=8) as ex:
            futs = [ex.submit(drain, i) for i in range(8)]
            done, not_done = cf.wait(futs, timeout=60)
            assert not not_done, "streamed GETs deadlocked"
            assert all(f.result() == len(raw) for f in done)


class TestHTTPStreaming:
    def test_streamed_put_and_get(self, cli):
        cli.make_bucket("hstrm")
        size = 3 * BLOCK_SIZE + 777
        r = PatternReader(size)
        h = cli.put_object_stream("hstrm", "obj", r, size)
        assert h["ETag"].strip('"') == r.md5.hexdigest()
        got = hashlib.md5()
        n = 0
        for piece in cli.get_object_stream("hstrm", "obj"):
            got.update(piece)
            n += len(piece)
        assert n == size and got.hexdigest() == r.md5.hexdigest()

    def test_streamed_put_small_inline(self, cli):
        cli.make_bucket("hstrm2")
        r = PatternReader(5000)
        cli.put_object_stream("hstrm2", "small", r, 5000)
        assert hashlib.md5(
            cli.get_object("hstrm2", "small")).hexdigest() \
            == r.md5.hexdigest()

    def test_signed_payload_mismatch_rejected(self, pkg, cli):
        """A signed (non-streaming) sha256 that doesn't match the body
        fails the PUT and stores nothing."""
        cli.make_bucket("hstrm3")
        body = b"actual body bytes" * 100
        headers = {"Host": f"{cli.host}:{cli.port}",
                   "Content-Length": str(len(body))}
        auth = pkg.sigv4.sign_request(cli.creds, "PUT", "/hstrm3/bad", {},
                                      headers, b"some other payload")
        headers.update(auth)
        conn = hc.HTTPConnection(cli.host, cli.port, timeout=TIMEOUT)
        conn.request("PUT", "/hstrm3/bad", body=body, headers=headers)
        resp = conn.getresponse()
        out = resp.read()
        conn.close()
        assert resp.status == 400, out
        assert b"XAmzContentSHA256Mismatch" in out
        st, _, _ = cli.request("GET", "/hstrm3/bad")
        assert st == 404

    def test_aws_chunked_streaming_put(self, pkg, cli):
        """aws-chunked bodies decode and verify chunk signatures on the
        fly."""
        cli.make_bucket("hstrm4")
        payload = pattern_bytes(2 * BLOCK_SIZE + 33, seed=9)
        st, out = _aws_chunked_put(pkg, cli, "/hstrm4/chunked", payload)
        assert st == 200, out
        assert cli.get_object("hstrm4", "chunked") == payload

    def test_streamed_multipart_part(self, cli):
        cli.make_bucket("hstrm5")
        upload_id = cli.create_multipart("hstrm5", "mp")
        part = pattern_bytes(6 * 1024 * 1024, seed=3)
        etag1 = cli.upload_part("hstrm5", "mp", upload_id, 1, part)
        etag2 = cli.upload_part("hstrm5", "mp", upload_id, 2, b"tail")
        cli.complete_multipart("hstrm5", "mp", upload_id,
                               [(1, etag1), (2, etag2)])
        assert cli.get_object("hstrm5", "mp") == part + b"tail"

    def test_chunked_te_capped_and_malformed_rejected(self, pkg, cli):
        """Transfer-Encoding: chunked with no Content-Length is bounded,
        and a malformed chunk line is a 400."""
        cli.make_bucket("hstrm6")
        headers = {"Host": f"{cli.host}:{cli.port}",
                   "Transfer-Encoding": "chunked",
                   "x-amz-content-sha256": "UNSIGNED-PAYLOAD"}
        auth = pkg.sigv4.sign_request(cli.creds, "PUT", "/hstrm6/mal", {},
                                      headers, "UNSIGNED-PAYLOAD")
        headers.update(auth)
        conn = hc.HTTPConnection(cli.host, cli.port, timeout=TIMEOUT)
        conn.putrequest("PUT", "/hstrm6/mal", skip_host=True,
                        skip_accept_encoding=True)
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.endheaders()
        conn.send(b"zz\r\ngarbage\r\n")        # malformed chunk size
        resp = conn.getresponse()
        out = resp.read()
        conn.close()
        assert resp.status == 400, out
        assert b"IncompleteBody" in out

    def test_copy_with_body_keeps_connection_sane(self, cli):
        """A copy-source PUT whose request carries a body drains it."""
        cli.make_bucket("hstrm7")
        cli.put_object("hstrm7", "src", b"copy me")
        r = PatternReader(256 * 1024)
        cli.put_object_stream("hstrm7", "dst", r, 256 * 1024,
                              headers={"x-amz-copy-source": "/hstrm7/src"})
        assert cli.get_object("hstrm7", "dst") == b"copy me"

    def test_first_chunk_failure_is_an_error_response(self, srv, cli):
        """A read that fails before any data decodes answers an S3
        error, not a 200 with a severed body."""
        cli.make_bucket("hstrm8")
        size = 2 * BLOCK_SIZE
        cli.put_object_stream("hstrm8", "obj", PatternReader(size), size)
        es = srv.pools.pools[0].sets[0]
        saved = list(es.drives)
        es.drives[0] = es.drives[1] = es.drives[2] = None
        try:
            st, _, data = cli.request("GET", "/hstrm8/obj")
            assert st >= 400, (st, data[:100])
        finally:
            es.drives[:] = saved


def _aws_chunked_put(pkg, cli, path, payload, chunk_size=256 * 1024,
                     extra_headers=None, tamper_at=None):
    """An aws-chunked signed PUT; returns (status, body).  With
    tamper_at=k, flips one payload byte inside chunk k AFTER signing:
    a mid-stream chunk-signature-chain mismatch."""
    now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    scope = f"{amz_date[:8]}/{cli.creds.region}/s3/aws4_request"
    headers = {"Host": f"{cli.host}:{cli.port}"}
    headers.update(extra_headers or {})
    auth = pkg.sigv4.sign_request(cli.creds, "PUT", path, {}, headers,
                                  pkg.sigv4.STREAMING_PAYLOAD, now=now)
    headers.update(auth)
    seed_sig = auth["Authorization"].rsplit("Signature=", 1)[1]
    wire = bytearray(pkg.sigv4.encode_streaming_body(
        cli.creds, scope, amz_date, seed_sig, payload,
        chunk_size=chunk_size))
    if tamper_at is not None:
        # frame layout: "<hex-size>;chunk-signature=<64 hex>\r\n<data>\r\n"
        off = 0
        for k in range(tamper_at + 1):
            size = min(chunk_size, len(payload) - k * chunk_size)
            header = len(f"{size:x}") + len(";chunk-signature=") + 64 + 2
            if k == tamper_at:
                wire[off + header] ^= 0xFF
                break
            off += header + size + 2
    headers["Content-Length"] = str(len(wire))
    conn = hc.HTTPConnection(cli.host, cli.port, timeout=TIMEOUT)
    try:
        conn.request("PUT", path, body=bytes(wire), headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _raw_put(pkg, cli, path, wire, decoded_len):
    """A streaming-signed PUT of a hand-made aws-chunked body."""
    now = datetime.datetime.now(datetime.timezone.utc)
    headers = {"Host": f"{cli.host}:{cli.port}"}
    auth = pkg.sigv4.sign_request(cli.creds, "PUT", path, {}, headers,
                                  pkg.sigv4.STREAMING_PAYLOAD, now=now)
    headers.update(auth)
    headers["Content-Length"] = str(len(wire))
    headers["x-amz-decoded-content-length"] = str(decoded_len)
    conn = hc.HTTPConnection(cli.host, cli.port, timeout=TIMEOUT)
    try:
        conn.request("PUT", path, body=wire, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class TestStreamingSigV4Edges:
    def test_midstream_tampered_chunk_no_partial_object(self, pkg, cli):
        """A chunk-signature-chain mismatch after valid leading chunks
        is a 403 and leaves NO object behind."""
        cli.make_bucket("edge1")
        payload = pattern_bytes(BLOCK_SIZE + 70_000, seed=21)
        st, out = _aws_chunked_put(pkg, cli, "/edge1/tampered", payload,
                                   chunk_size=64 * 1024, tamper_at=2)
        assert st == 403, out
        assert b"SignatureDoesNotMatch" in out
        st, _, _ = cli.request("GET", "/edge1/tampered")
        assert st == 404
        st, out = _aws_chunked_put(pkg, cli, "/edge1/tampered", payload,
                                   chunk_size=64 * 1024)
        assert st == 200, out
        assert cli.get_object("edge1", "tampered") == payload

    def test_oversized_chunk_declaration_rejected(self, pkg, cli):
        """A declared chunk size over MAX_CHUNK_SIZE is rejected before
        the server buffers it."""
        cli.make_bucket("edge2")
        wire = b"40000000;chunk-signature=" + b"0" * 64 + b"\r\n"
        st, out = _raw_put(pkg, cli, "/edge2/huge", wire, 0x40000000)
        assert st == 400, out
        assert b"EntityTooLarge" in out

    def test_negative_chunk_size_rejected(self, pkg, cli):
        """A signed/underscored/'+'-prefixed chunk-size field is a
        framing error."""
        cli.make_bucket("edge4")
        for bad in (b"-40", b"+40", b"4_0", b""):
            wire = (bad + b";chunk-signature=" + b"0" * 64 + b"\r\n"
                    + b"x" * 64 + b"\r\n0;chunk-signature=" + b"0" * 64
                    + b"\r\n\r\n")
            st, out = _raw_put(pkg, cli, "/edge4/neg", wire, 64)
            assert st == 400, (bad, out)
            assert b"IncompleteBody" in out, (bad, out)
        st, _, _ = cli.request("GET", "/edge4/neg")
        assert st == 404

    def test_zero_length_payload_final_chunk_only(self, pkg, cli):
        """An empty aws-chunked body is just the zero-length final chunk
        and stores an empty object."""
        cli.make_bucket("edge3")
        st, out = _aws_chunked_put(pkg, cli, "/edge3/empty", b"")
        assert st == 200, out
        assert cli.get_object("edge3", "empty") == b""


def _b64md5(data: bytes) -> str:
    return base64.b64encode(hashlib.md5(data).digest()).decode()


class TestContentMD5Conformance:
    """Content-MD5 semantics (cf. internal/hash/reader.go): a malformed
    header is InvalidDigest, a well-formed but wrong one BadDigest, and
    a rejected PUT stores nothing, on the simple and the aws-chunked
    path."""

    def test_simple_put_good_digest(self, cli):
        cli.make_bucket("md5a")
        body = pattern_bytes(100_000, seed=31)
        h = cli.put_object("md5a", "ok", body,
                           headers={"Content-MD5": _b64md5(body)})
        assert h["ETag"].strip('"') == hashlib.md5(body).hexdigest()
        assert cli.get_object("md5a", "ok") == body

    def test_simple_put_mismatch_is_bad_digest(self, pkg, cli):
        cli.make_bucket("md5b")
        body = pattern_bytes(50_000, seed=32)
        with pytest.raises(pkg.S3ClientError) as ei:
            cli.put_object("md5b", "bad", body,
                           headers={"Content-MD5": _b64md5(b"other bytes")})
        assert ei.value.code == "BadDigest"
        st, _, _ = cli.request("GET", "/md5b/bad")
        assert st == 404

    def test_malformed_base64_is_invalid_digest(self, pkg, cli):
        cli.make_bucket("md5c")
        with pytest.raises(pkg.S3ClientError) as ei:
            cli.put_object("md5c", "mal", b"data",
                           headers={"Content-MD5": "!!!not-base64!!!"})
        assert ei.value.code == "InvalidDigest"
        st, _, _ = cli.request("GET", "/md5c/mal")
        assert st == 404

    def test_wrong_length_digest_is_invalid_digest(self, pkg, cli):
        cli.make_bucket("md5d")
        short = base64.b64encode(b"8 bytes!").decode()   # valid b64, not 16B
        with pytest.raises(pkg.S3ClientError) as ei:
            cli.put_object("md5d", "short", b"data",
                           headers={"Content-MD5": short})
        assert ei.value.code == "InvalidDigest"

    def test_aws_chunked_good_digest(self, pkg, cli):
        cli.make_bucket("md5e")
        body = pattern_bytes(300_000, seed=33)
        st, out = _aws_chunked_put(
            pkg, cli, "/md5e/ok", body,
            extra_headers={"Content-MD5": _b64md5(body),
                           "x-amz-decoded-content-length": str(len(body))})
        assert st == 200, out
        assert cli.get_object("md5e", "ok") == body

    def test_aws_chunked_mismatch_rejected_before_write(self, pkg, cli):
        cli.make_bucket("md5f")
        body = pattern_bytes(300_000, seed=34)
        st, out = _aws_chunked_put(
            pkg, cli, "/md5f/bad", body,
            extra_headers={"Content-MD5": _b64md5(b"not the body"),
                           "x-amz-decoded-content-length": str(len(body))})
        assert st == 400, out
        assert b"BadDigest" in out
        st, _, _ = cli.request("GET", "/md5f/bad")
        assert st == 404
