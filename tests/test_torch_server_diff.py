"""The port's S3 server held to the JAX package's, request for request
(device="cpu").  Tolerance: exact.

- A seeded request script (numpy default_rng) drives a JAX S3Server and
  the port's, each over its own drives: every handler of the slice and
  its errors.  Per request: the status, the S3 error Code, the headers
  ETag, Content-Length, Content-Range, Content-Type, x-amz-meta-* and
  whether x-amz-version-id is present, the XML body with request ids,
  dates, version ids and upload ids normalised, and every other body
  byte for byte.
- Across packages on the same drives: objects written through one
  package's server (plain, multipart, versioned, a delete marker) are
  read through the other's, byte for byte, in both directions.
- SigV4: sign_request, presign_url and encode_streaming_body of both
  packages give the same strings and bytes for seeded inputs and a
  fixed clock.
"""

import base64
import datetime
import hashlib
import re

import numpy as np
import pytest

import minio_tpu.server.sigv4 as jax_sigv4
import minio_tpu_torch.server.sigv4 as port_sigv4
from test_torch_server import (JAX, PORT, TIMEOUT, _jax_pools, _port_pools,
                               close_pools)

ACCESS, SECRET = "diffadmin", "diffadmin-secret"
SEED = 20261017
MIB = 1 << 20
_COMPARED = ("ETag", "Content-Length", "Content-Range", "Content-Type")
_NORMALISED = ("RequestId", "LastModified", "VersionId", "UploadId",
               "NextVersionIdMarker")


#: Requests the port answers as MinIO does and the JAX server does not:
#: label -> ((JAX status, Code), (port status, Code)).  A PUT of a bucket
#: the caller already owns is 409 BucketAlreadyOwnedByYou in MinIO
#: (cmd/bucket-handlers.go PutBucketHandler); the JAX server's handler
#: crashes on it.
_DIVERGES = {"/dbk#again": ((500, b"InternalError"),
                            (409, b"BucketAlreadyOwnedByYou"))}


def _normalise_xml(body: bytes) -> bytes:
    for tag in _NORMALISED:
        body = re.sub(rb"<%s>[^<]*</%s>" % (tag.encode(), tag.encode()),
                      b"<%s>*</%s>" % (tag.encode(), tag.encode()), body)
    return body


class Recorder:
    """Sends the script's requests to one server and records what the
    comparison reads of each response."""

    def __init__(self, pkg, srv):
        self.cli = pkg.S3Client(srv.endpoint, ACCESS, SECRET,
                                **pkg.client_kw)
        self.records = []

    def __call__(self, method, path, query=None, headers=None, body=b"",
                 label=None, anonymous=False):
        import http.client
        if anonymous:
            conn = http.client.HTTPConnection(self.cli.host, self.cli.port,
                                              timeout=TIMEOUT)
            try:
                conn.request(method, path)
                resp = conn.getresponse()
                st, h, data = resp.status, dict(resp.getheaders()), \
                    resp.read()
            finally:
                conn.close()
        else:
            st, h, data = self.cli.request(method, path, query=query,
                                           headers=headers, body=body)
        code = ""
        if st >= 400 and data.startswith(b"<?xml"):
            code = re.search(rb"<Code>([^<]*)</Code>", data).group(1)
        is_xml = h.get("Content-Type") == "application/xml"
        self.records.append({
            "request": (method, label or path, sorted((query or {}))),
            "status": st, "code": code,
            "headers": {k: h.get(k) for k in _COMPARED}
            | {k: v for k, v in h.items() if k.startswith("x-amz-meta-")},
            "version_id": "x-amz-version-id" in h,
            "body": _normalise_xml(data) if is_xml
            else hashlib.sha256(data).hexdigest(),
        })
        return st, h, data


def _b64md5(data: bytes) -> str:
    return base64.b64encode(hashlib.md5(data).digest()).decode()


def _id(data: bytes, tag: str) -> str:
    return re.search(rb"<%s>([^<]*)</%s>" % (tag.encode(), tag.encode()),
                     data).group(1).decode()


def script(do, seed: int) -> None:
    """74 requests: every handler of the slice and its errors."""
    rng = np.random.default_rng(seed)

    def body(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    small, large = body(int(rng.integers(1024, 100 * 1024))), \
        body(3 * MIB + int(rng.integers(1, 100_000)))
    # buckets
    do("PUT", "/dbk")
    do("PUT", "/dbk", label="/dbk#again")           # see _DIVERGES
    do("PUT", "/AB")                                # InvalidBucketName
    do("HEAD", "/dbk")
    do("HEAD", "/nosuchbkt")
    do("GET", "/dbk", {"location": ""})
    # objects
    do("PUT", "/dbk/dir/small", headers={"x-amz-meta-color": "blue",
                                         "Content-Type": "text/plain"},
       body=small)
    do("PUT", "/dbk/dir/large", body=large)
    do("PUT", "/dbk/top", headers={"Content-MD5": _b64md5(small[:999])},
       body=small[:999])
    do("PUT", "/dbk/bad", headers={"Content-MD5": _b64md5(b"x")},
       body=small[:10])                             # BadDigest
    do("PUT", "/dbk/bad", headers={"Content-MD5": "!!nope!!"},
       body=small[:10])                             # InvalidDigest
    do("PUT", "/dbk/rrs", headers={"x-amz-storage-class":
                                   "REDUCED_REDUNDANCY"}, body=large[:5000])
    do("PUT", "/dbk/zz", headers={"x-amz-storage-class": "GLACIERX"},
       body=b"x")                                   # InvalidStorageClass
    do("GET", "/dbk/dir/small")
    do("GET", "/dbk/dir/large")
    do("GET", "/dbk/dir/large", headers={"Range": "bytes=300000-1349999"})
    do("GET", "/dbk/dir/large", headers={"Range": "bytes=-500"})
    do("GET", "/dbk/dir/large", headers={"Range": f"bytes={len(large)}-"})
    do("HEAD", "/dbk/dir/small")
    do("HEAD", "/dbk/rrs")
    _, h, _ = do("HEAD", "/dbk/top")
    do("GET", "/dbk/top", headers={"If-None-Match": h["ETag"]})
    do("GET", "/dbk/top", headers={"If-Match": '"wrong"'})
    do("GET", "/dbk/nosuchkey")                     # NoSuchKey
    do("GET", "/nosuchbkt/k")                       # NoSuchBucket
    do("PUT", "/dbk/copy", headers={"x-amz-copy-source": "/dbk/dir/large"})
    do("GET", "/dbk/copy")
    do("PUT", "/dbk/dir/small", {"tagging": ""},
       body=b"<Tagging><TagSet><Tag><Key>k 1</Key><Value>v&amp;2</Value>"
            b"</Tag></TagSet></Tagging>")
    do("GET", "/dbk/dir/small", {"tagging": ""})
    do("PUT", "/dbk", {"tagging": ""},
       body=b"<Tagging><TagSet></TagSet></Tagging>")
    do("GET", "/dbk", {"tagging": ""})
    # listings
    do("GET", "/dbk", {"list-type": "2", "delimiter": "/"})
    do("GET", "/dbk", {"list-type": "2", "prefix": "dir/"})
    _, _, page = do("GET", "/dbk", {"max-keys": "2"})
    do("GET", "/dbk", {"max-keys": "2", "marker": _id(page, "NextMarker")})
    _, _, page = do("GET", "/dbk", {"list-type": "2", "max-keys": "2"})
    do("GET", "/dbk", {"list-type": "2", "max-keys": "2",
                       "continuation-token":
                       _id(page, "NextContinuationToken")})
    # versioning
    do("PUT", "/vbk")
    do("GET", "/vbk", {"versioning": ""})
    do("PUT", "/vbk", {"versioning": ""},
       body=b"<VersioningConfiguration><Status>Enabled</Status>"
            b"</VersioningConfiguration>")
    do("GET", "/vbk", {"versioning": ""})
    _, h1, _ = do("PUT", "/vbk/k", body=body(2000))
    do("PUT", "/vbk/k", body=body(3000))
    do("GET", "/vbk/k")
    do("GET", "/vbk/k", {"versionId": h1["x-amz-version-id"]},
       label="/vbk/k?versionId=v1")
    do("DELETE", "/vbk/k")                          # a delete marker
    do("GET", "/vbk/k")                             # NoSuchKey
    do("GET", "/vbk", {"versions": ""})
    do("DELETE", "/vbk/k", {"versionId": h1["x-amz-version-id"]},
       label="/vbk/k?versionId=v1")
    do("GET", "/vbk/k", {"versionId": h1["x-amz-version-id"]},
       label="/vbk/k?versionId=v1")                 # NoSuchVersion
    do("GET", "/vbk", {"versions": ""})
    # multipart
    p1, p2 = body(5 * MIB + int(rng.integers(1, 1000))), body(777)
    _, _, x = do("POST", "/dbk/mp", {"uploads": ""},
                 headers={"x-amz-meta-mp": "yes"})
    uid = _id(x, "UploadId")
    _, e1, _ = do("PUT", "/dbk/mp", {"partNumber": "1", "uploadId": uid},
                  body=p1, label="/dbk/mp?part1")
    _, e2, _ = do("PUT", "/dbk/mp", {"partNumber": "2", "uploadId": uid},
                  body=p2, label="/dbk/mp?part2")
    _, _, x = do("PUT", "/dbk/mp", {"partNumber": "3", "uploadId": uid},
                 headers={"x-amz-copy-source": "/dbk/dir/large",
                          "x-amz-copy-source-range": "bytes=10-5009"},
                 label="/dbk/mp?part3-copy")
    e3 = _id(x, "ETag").strip('"')
    do("GET", "/dbk/mp", {"uploadId": uid}, label="/dbk/mp?list-parts")
    do("GET", "/dbk", {"uploads": ""})
    parts = [(1, e1["ETag"].strip('"')), (2, e2["ETag"].strip('"')),
             (3, e3)]

    def complete(parts):
        inner = "".join(f"<Part><PartNumber>{n}</PartNumber><ETag>\"{e}\""
                        f"</ETag></Part>" for n, e in parts)
        return do("POST", "/dbk/mp", {"uploadId": uid},
                  body=f"<CompleteMultipartUpload>{inner}"
                       f"</CompleteMultipartUpload>".encode(),
                  label="/dbk/mp?complete")
    complete([(1, parts[0][1]), (2, "0" * 32)])     # InvalidPart
    complete([(2, parts[1][1]), (1, parts[0][1])])  # InvalidPartOrder
    complete([(2, parts[1][1]), (3, parts[2][1])])  # EntityTooSmall
    complete(parts)
    do("GET", "/dbk/mp")
    do("GET", "/dbk/mp", headers={"Range": f"bytes={5 * MIB - 3}-"
                                           f"{5 * MIB + 1000}"})
    do("HEAD", "/dbk/mp")
    _, _, x = do("POST", "/dbk/ab", {"uploads": ""})
    uid = _id(x, "UploadId")
    do("DELETE", "/dbk/ab", {"uploadId": uid}, label="/dbk/ab?abort")
    do("POST", "/dbk/ab", {"uploadId": uid},
       body=b"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
            b"<ETag>x</ETag></Part></CompleteMultipartUpload>",
       label="/dbk/ab?complete")                    # NoSuchUpload
    # deletes
    do("DELETE", "/dbk")                            # BucketNotEmpty
    do("POST", "/dbk", {"delete": ""},
       body=b"<Delete><Object><Key>dir/small</Key></Object><Object><Key>"
            b"nosuch</Key></Object><Object><Key>copy</Key></Object>"
            b"</Delete>")
    do("DELETE", "/dbk/top")
    do("DELETE", "/dbk/top")                        # a no-op, 204
    do("GET", "/dbk", {"list-type": "2"})
    do("GET", "/", anonymous=True)                  # AccessDenied
    do("GET", "/")


def _serve(pkg, pools):
    return pkg.S3Server(pools, pkg.sigv4.Credentials(ACCESS, SECRET)).start()


def test_request_script_matches_jax(tmp_path):
    records = {}
    for pkg, make in ((JAX, _jax_pools), (PORT, _port_pools)):
        pools = make(tmp_path / pkg.name, "d")
        srv = _serve(pkg, pools)
        try:
            rec = Recorder(pkg, srv)
            script(rec, SEED)
            records[pkg.name] = rec.records
        finally:
            srv.shutdown()
            close_pools(pools)
    jax_recs, port_recs = records["jax"], records["port"]
    assert len(jax_recs) == len(port_recs) >= 40
    codes = {r["code"] for r in jax_recs}
    for code in (b"NoSuchKey", b"NoSuchBucket", b"BucketNotEmpty",
                 b"InvalidRange", b"PreconditionFailed", b"BadDigest",
                 b"NoSuchUpload", b"InvalidPart", b"AccessDenied"):
        assert code in codes, code
    for j, p in zip(jax_recs, port_recs):
        label = j["request"][1]
        if label in _DIVERGES:
            assert ((j["status"], j["code"]), (p["status"], p["code"])) \
                == _DIVERGES[label], label
            continue
        assert p == j, j["request"]


# -- across packages on the same drives ------------------------------------------

def _write_side(do, rng):
    """Plain, multipart, versioned objects and a delete marker; returns
    what the reader checks: (path, version id or "", bytes or None)."""
    plain, big = rng.bytes(70_000), rng.bytes(2 * MIB + 12345)
    do("PUT", "/xbk")
    do("PUT", "/xbk/plain", body=plain)
    do("PUT", "/xbk/big", body=big)
    _, _, x = do("POST", "/xbk/mp", {"uploads": ""})
    uid = _id(x, "UploadId")
    p1, p2 = rng.bytes(5 * MIB), rng.bytes(4321)
    _, e1, _ = do("PUT", "/xbk/mp", {"partNumber": "1", "uploadId": uid},
                  body=p1)
    _, e2, _ = do("PUT", "/xbk/mp", {"partNumber": "2", "uploadId": uid},
                  body=p2)
    inner = "".join(f"<Part><PartNumber>{n}</PartNumber><ETag>{e['ETag']}"
                    f"</ETag></Part>" for n, e in ((1, e1), (2, e2)))
    do("POST", "/xbk/mp", {"uploadId": uid},
       body=f"<CompleteMultipartUpload>{inner}"
            f"</CompleteMultipartUpload>".encode())
    do("PUT", "/vxb")
    do("PUT", "/vxb", {"versioning": ""},
       body=b"<VersioningConfiguration><Status>Enabled</Status>"
            b"</VersioningConfiguration>")
    v1, v2 = rng.bytes(3000), rng.bytes(MIB + 5)
    _, h1, _ = do("PUT", "/vxb/k", body=v1)
    _, h2, _ = do("PUT", "/vxb/k", body=v2)
    _, hm, _ = do("PUT", "/vxb/m", body=v1)
    do("DELETE", "/vxb/m")
    return [("/xbk/plain", "", plain), ("/xbk/big", "", big),
            ("/xbk/mp", "", p1 + p2), ("/vxb/k", "", v2),
            ("/vxb/k", h1["x-amz-version-id"], v1),
            ("/vxb/k", h2["x-amz-version-id"], v2),
            ("/vxb/m", "", None),
            ("/vxb/m", hm["x-amz-version-id"], v1)]


@pytest.mark.parametrize("writer,reader", [(PORT, JAX), (JAX, PORT)],
                         ids=["port-to-jax", "jax-to-port"])
def test_objects_cross_packages(tmp_path, writer, reader):
    makers = {"jax": _jax_pools, "port": _port_pools}
    pools = makers[writer.name](tmp_path, "d")
    srv = _serve(writer, pools)
    try:
        expect = _write_side(Recorder(writer, srv),
                             np.random.default_rng(SEED))
    finally:
        srv.shutdown()
        close_pools(pools)
    # The reader adopts the writer's format.json on the same drives.
    pools = makers[reader.name](tmp_path, "d")
    srv = _serve(reader, pools)
    try:
        cli = reader.S3Client(srv.endpoint, ACCESS, SECRET,
                              **reader.client_kw)
        for path, vid, want in expect:
            st, h, got = cli.request("GET", path,
                                     query={"versionId": vid} if vid
                                     else None)
            if want is None:
                assert st == 404 and b"NoSuchKey" in got, path
                continue
            assert st == 200 and got == want, (path, vid)
            assert h["ETag"].strip('"') == (
                hashlib.md5(want).hexdigest() if "mp" not in path
                else h["ETag"].strip('"'))
        st, _, x = cli.request("GET", "/vxb", query={"versions": ""})
        assert st == 200
        assert x.count(b"<Version>") == 3 and x.count(b"<DeleteMarker>") == 1
        st, _, x = cli.request("GET", "/vxb", query={"versioning": ""})
        assert b"<Status>Enabled</Status>" in x
    finally:
        srv.shutdown()
        close_pools(pools)


# -- SigV4 against the JAX module ------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sigv4_matches_jax(seed):
    rng = np.random.default_rng(seed)
    now = datetime.datetime(2026, 1, 2, 3, 4, int(rng.integers(0, 60)),
                            tzinfo=datetime.timezone.utc)
    secret = rng.bytes(12).hex()
    creds = [m.Credentials(f"ak{seed}", secret,
                           "us-west-2" if seed else "us-east-1")
             for m in (jax_sigv4, port_sigv4)]
    path = f"/b{seed}/key with space/ü{seed}"
    query = {"x-id": [str(rng.integers(0, 1000))], "a": ["1", "2"],
             "empty": [""]}
    headers = {"Host": "127.0.0.1:9000", "Content-Type": "text/plain",
               "x-amz-meta-n": f"  v{seed}  w  "}
    payload = rng.bytes(int(rng.integers(0, 5000)))
    for p in (payload, jax_sigv4.UNSIGNED_PAYLOAD,
              jax_sigv4.STREAMING_PAYLOAD):
        assert port_sigv4.sign_request(creds[1], "PUT", path, query,
                                       headers, p, now=now) == \
            jax_sigv4.sign_request(creds[0], "PUT", path, query, headers,
                                   p, now=now)
    assert port_sigv4.presign_url(creds[1], "GET", path, query,
                                  "127.0.0.1:9000", expires=600,
                                  now=now) == \
        jax_sigv4.presign_url(creds[0], "GET", path, query,
                              "127.0.0.1:9000", expires=600, now=now)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    scope = f"{amz_date[:8]}/{creds[0].region}/s3/aws4_request"
    for chunk in (1024, 64 * 1024):
        assert port_sigv4.encode_streaming_body(
            creds[1], scope, amz_date, "ab" * 32, payload,
            chunk_size=chunk) == jax_sigv4.encode_streaming_body(
            creds[0], scope, amz_date, "ab" * 32, payload, chunk_size=chunk)
    # and the port's server-side checks accept what the JAX signer made
    signed = dict(headers)
    signed.update(jax_sigv4.sign_request(creds[0], "PUT", path, query,
                                         headers, payload, now=now))
    assert port_sigv4.verify_header_signature(
        creds[1], "PUT", path, query, signed, payload, now=now) == \
        (hashlib.sha256(payload).hexdigest(), creds[1].access_key)
