"""S3 API handlers: bucket/object/multipart surface over ServerPools.

The port of minio_tpu/server/handlers.py (the cmd/object-handlers.go /
cmd/bucket-handlers.go / cmd/bucket-listobjects-handlers.go role),
dispatched by (method, path-shape, query) like cmd/api-router.go:175
registers routes.  Handlers speak to the object layer
(engine/pools.ServerPools) only; the erasure engine below reaches the
kernels.

Without the planes of later items: a request that needs one answers
NotImplemented and names its ROADMAP.md Queue A item (`unported`).  That
covers SSE, compression, tiering and restore, replication, object lock
(retention, legal hold), quota, notifications, S3 Select, and the bucket
configs other than versioning, tagging and policy.  An object another
package stored encrypted, compressed or tiered is not served as if it
were plain, and a bucket that carries a quota or an object-lock config
takes no write that would bypass it.  Snowball tars are extracted on PUT
and zip members served on GET (server/extract.py); who may call a
handler is decided before it runs (server.py `_authorize`).
"""

from __future__ import annotations

import base64
import datetime
import email.utils
import hashlib
import time
import urllib.parse
import xml.etree.ElementTree as ET

from ..bucket.metadata import META_BUCKET, BucketMetadataSys
from ..config.config import ConfigSys
from ..engine.pools import ServerPools
from ..iam.policy import Policy
from ..storage.errors import StorageError
from ..storage.xlmeta import FileInfo
from ..utils import streams
from . import extract
from .api_errors import S3Error, from_storage_error

MAX_OBJECT_SIZE = 5 * 1024 ** 4    # 5 TiB (docs/minio-limits.md)
MAX_KEY_LEN = 1024

# User metadata prefix passed through to storage.
AMZ_META_PREFIX = "x-amz-meta-"

# Request headers and stored metadata keys of the planes this server
# does not have (the JAX package's crypto/sse.py, utils/compress.py,
# bucket/tier.py and server/extract.py).
_SSE_HEADERS = ("x-amz-server-side-encryption",
                "x-amz-server-side-encryption-customer-algorithm")
_TRANSFORM_KEYS = {
    "x-mtpu-internal-sse-algo": "SSE",
    "x-mtpu-internal-compression": "compression",
    "x-mtpu-internal-tier": "tiering",
}
#: The size a client sees of an object another package stored
#: transformed or tiered (listings report it, as the JAX package does).
_CLIENT_SIZE_KEY = "x-mtpu-internal-client-size"
_TIER_SIZE_KEY = "x-mtpu-internal-tier-size"


def unported(what: str, item: str = "10") -> S3Error:
    """The answer to a request that needs a plane of a later item."""
    return S3Error("NotImplemented",
                   f"{what} is not in this server yet (ROADMAP.md Queue A "
                   f"item {item})")


def _iso(ns: int) -> str:
    dt = datetime.datetime.fromtimestamp(ns / 1e9, datetime.timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"


def _http_date(ns: int) -> str:
    return email.utils.formatdate(ns / 1e9, usegmt=True)


def _xml(root: ET.Element) -> bytes:
    return (b'<?xml version="1.0" encoding="UTF-8"?>'
            + ET.tostring(root, encoding="unicode").encode())


def _el(parent, tag, text=None):
    e = ET.SubElement(parent, tag)
    if text is not None:
        e.text = str(text)
    return e


S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


class Response:
    def __init__(self, status: int = 200, body: bytes = b"",
                 headers: dict[str, str] | None = None, body_iter=None):
        """body_iter: optional iterator of byte chunks streamed to the
        client instead of `body`; headers must carry Content-Length."""
        self.status = status
        self.body = body
        self.body_iter = body_iter
        self.headers = headers or {}


def error_response(err: S3Error, resource: str, request_id: str) -> Response:
    root = ET.Element("Error")
    _el(root, "Code", err.api.code)
    _el(root, "Message", err.message)
    _el(root, "Resource", resource)
    _el(root, "RequestId", request_id)
    return Response(err.api.http_status, _xml(root),
                    {"Content-Type": "application/xml"})


def _logical_size(fi: FileInfo) -> int:
    return int(fi.metadata.get(_CLIENT_SIZE_KEY,
                               fi.metadata.get(_TIER_SIZE_KEY, fi.size)))


def _stream(first, rest):
    """`first`, then what `rest` yields; closing the stream closes
    `rest` (a GET cut short cancels its prefetched segment)."""
    try:
        yield first
        yield from rest
    finally:
        close = getattr(rest, "close", None)
        if close is not None:
            close()


def _valid_bucket_name(name: str) -> bool:
    if not (3 <= len(name) <= 63) or name.startswith(".mtpu"):
        return False
    ok = set("abcdefghijklmnopqrstuvwxyz0123456789.-")
    return (all(c in ok for c in name) and not name.startswith((".", "-"))
            and not name.endswith((".", "-")))


class S3Handlers:
    """All bucket/object handlers; one instance per server."""

    def __init__(self, pools: ServerPools):
        self.pools = pools
        try:
            pools.make_bucket(META_BUCKET)
        except StorageError:
            pass
        self.meta = BucketMetadataSys(pools)
        self.config_sys = ConfigSys(pools)

    # x-amz-storage-class -> storage_class config key (parity source,
    # cf. GetParityForSC at cmd/erasure-object.go:761 and
    # internal/config/storageclass/storage-class.go).
    SC_HEADER = "x-amz-storage-class"
    STORAGE_CLASSES = {"STANDARD": "standard", "REDUCED_REDUNDANCY": "rrs"}

    def _parity_for_request(self, h: dict, metadata: dict) -> int | None:
        """Parse x-amz-storage-class: validate, map through the
        storage_class config to a parity count, and record the class on
        the object (non-STANDARD only, like AWS listings)."""
        sc = h.get(self.SC_HEADER, "").upper()
        if not sc:
            return None
        if sc not in self.STORAGE_CLASSES:
            raise S3Error("InvalidStorageClass")
        if sc != "STANDARD":
            metadata[self.SC_HEADER] = sc
        return self.config_sys.parity_for_class(self.STORAGE_CLASSES[sc])

    @staticmethod
    def _refuse_transformed(fi: FileInfo) -> None:
        """An object stored through a plane this server lacks is not
        served, copied or re-tagged as if its bytes were plain."""
        for key, plane in _TRANSFORM_KEYS.items():
            if fi.metadata.get(key):
                raise unported(f"an object stored with {plane}")

    def _refuse_write_gates(self, bucket: str) -> None:
        """A bucket whose quota or object-lock config another package
        stored takes no write or delete that would bypass it."""
        for kind, plane in (("quota", "bucket quota"),
                            ("object_lock", "object lock")):
            if self.meta.get(bucket, kind) is not None:
                raise unported(f"a bucket with {plane}")

    # ---- bucket config helpers (persisted via BucketMetadataSys) ----------

    def bucket_versioning_enabled(self, bucket: str) -> bool:
        data = self.meta.get(bucket, "versioning")
        return data is not None and b"<Status>Enabled</Status>" in data

    # ---- service level ----------------------------------------------------

    def list_buckets(self) -> Response:
        root = ET.Element("ListAllMyBucketsResult", xmlns=S3_NS)
        owner = _el(root, "Owner")
        _el(owner, "ID", "mtpu")
        _el(owner, "DisplayName", "mtpu")
        bl = _el(root, "Buckets")
        for b in self.pools.list_buckets():
            if b == META_BUCKET:
                continue
            be = _el(bl, "Bucket")
            _el(be, "Name", b)
            _el(be, "CreationDate", _iso(0))
        return Response(200, _xml(root), {"Content-Type": "application/xml"})

    # ---- bucket level -----------------------------------------------------

    def make_bucket(self, bucket: str) -> Response:
        if not _valid_bucket_name(bucket):
            raise S3Error("InvalidBucketName")
        try:
            self.pools.make_bucket(bucket)
        except StorageError as e:
            # An existing bucket is 409 BucketAlreadyOwnedByYou (the JAX
            # package answers 500 here).
            raise from_storage_error(e) from None
        return Response(200, headers={"Location": f"/{bucket}"})

    def head_bucket(self, bucket: str) -> Response:
        if not self.pools.bucket_exists(bucket) or bucket == META_BUCKET:
            raise S3Error("NoSuchBucket")
        return Response(200)

    def delete_bucket(self, bucket: str) -> Response:
        if self.pools.list_objects(bucket, max_keys=1):
            raise S3Error("BucketNotEmpty")
        self.pools.delete_bucket(bucket)
        self.meta.drop_bucket(bucket)
        return Response(204)

    def get_bucket_location(self, bucket: str) -> Response:
        self.head_bucket(bucket)
        root = ET.Element("LocationConstraint", xmlns=S3_NS)
        return Response(200, _xml(root), {"Content-Type": "application/xml"})

    def put_bucket_versioning(self, bucket: str, body: bytes) -> Response:
        self.head_bucket(bucket)
        self.meta.put(bucket, "versioning", body)
        return Response(200)

    def get_bucket_versioning(self, bucket: str) -> Response:
        self.head_bucket(bucket)
        data = self.meta.get(bucket, "versioning")
        root = ET.Element("VersioningConfiguration", xmlns=S3_NS)
        if data is not None and b"Enabled" in data:
            _el(root, "Status", "Enabled")
        return Response(200, _xml(root), {"Content-Type": "application/xml"})

    # ---- bucket sub-resource configs --------------------------------------

    #: Bucket configs this server stores: ?policy (a JSON policy the
    #: server authorizes anonymous requests by) and ?tagging (a blob).
    _CONFIG_KINDS = {"policy": ("policy", "NoSuchBucketPolicy"),
                     "tagging": ("tagging", "NoSuchTagSet")}
    #: Bucket configs whose plane waits for ROADMAP.md Queue A item 10.
    UNPORTED_CONFIGS = ("lifecycle", "notification", "replication",
                        "quota", "object-lock", "encryption")

    def put_bucket_config(self, bucket: str, sub: str,
                          body: bytes) -> Response:
        self.head_bucket(bucket)
        kind, _ = self._CONFIG_KINDS[sub]
        if kind == "policy":
            # Validate before storing (cf. PutBucketPolicyHandler).
            try:
                Policy(body.decode())
            except Exception:  # noqa: BLE001 — any parse failure
                raise S3Error("MalformedXML") from None
        self.meta.put(bucket, kind, body)
        return Response(200)

    def get_bucket_config(self, bucket: str, sub: str) -> Response:
        self.head_bucket(bucket)
        kind, missing_code = self._CONFIG_KINDS[sub]
        data = self.meta.get(bucket, kind)
        if data is None:
            raise S3Error(missing_code)
        ctype = "application/json" if kind == "policy" else \
            "application/xml"
        return Response(200, data, {"Content-Type": ctype})

    def delete_bucket_config(self, bucket: str, sub: str) -> Response:
        self.head_bucket(bucket)
        kind, _ = self._CONFIG_KINDS[sub]
        self.meta.delete(bucket, kind)
        return Response(204)

    # ---- listing ----------------------------------------------------------

    @staticmethod
    def _group_by_delimiter(infos: list[FileInfo], prefix: str,
                            delimiter: str):
        contents, prefixes, seen = [], [], set()
        for fi in infos:
            rest = fi.name[len(prefix):]
            if delimiter and delimiter in rest:
                cp = prefix + rest.split(delimiter)[0] + delimiter
                if cp not in seen:
                    seen.add(cp)
                    prefixes.append(cp)
            else:
                contents.append(fi)
        return contents, prefixes

    def list_objects(self, bucket: str, query: dict) -> Response:
        v2 = query.get("list-type", [""])[0] == "2"
        prefix = query.get("prefix", [""])[0]
        delimiter = query.get("delimiter", [""])[0]
        max_keys = min(int(query.get("max-keys", ["1000"])[0] or 1000), 1000)
        if v2:
            marker = query.get("continuation-token", [""])[0] or \
                query.get("start-after", [""])[0]
        else:
            marker = query.get("marker", [""])[0]
        self.head_bucket(bucket)

        # The names after the marker, from the metacache's page.
        infos = self.pools.list_objects(bucket, prefix, marker=marker,
                                        max_keys=100000)
        contents, prefixes = self._group_by_delimiter(infos, prefix, delimiter)

        # Merge and truncate in lexical order over both kinds of entries.
        entries = sorted(
            [("o", fi.name, fi) for fi in contents]
            + [("p", p, None) for p in prefixes], key=lambda t: t[1])
        truncated = len(entries) > max_keys
        entries = entries[:max_keys]
        next_marker = entries[-1][1] if (truncated and entries) else ""

        root = ET.Element("ListBucketResult", xmlns=S3_NS)
        _el(root, "Name", bucket)
        _el(root, "Prefix", prefix)
        if delimiter:
            _el(root, "Delimiter", delimiter)
        _el(root, "MaxKeys", max_keys)
        _el(root, "IsTruncated", "true" if truncated else "false")
        if v2:
            _el(root, "KeyCount", len(entries))
            if truncated:
                _el(root, "NextContinuationToken", next_marker)
        else:
            _el(root, "Marker", marker)
            if truncated:
                _el(root, "NextMarker", next_marker)
        for kind, name, fi in entries:
            if kind == "p":
                cp = _el(root, "CommonPrefixes")
                _el(cp, "Prefix", name)
            else:
                c = _el(root, "Contents")
                _el(c, "Key", name)
                _el(c, "LastModified", _iso(fi.mod_time_ns))
                _el(c, "ETag", f'"{fi.metadata.get("etag", "")}"')
                _el(c, "Size", _logical_size(fi))
                _el(c, "StorageClass",
                    fi.metadata.get(self.SC_HEADER, "STANDARD"))
        return Response(200, _xml(root), {"Content-Type": "application/xml"})

    def list_object_versions(self, bucket: str, query: dict) -> Response:
        """GET /bucket?versions (cf. ListObjectVersionsHandler,
        cmd/bucket-listobjects-handlers.go)."""
        prefix = query.get("prefix", [""])[0]
        max_keys = min(int(query.get("max-keys", ["1000"])[0] or 1000),
                       1000)
        key_marker = query.get("key-marker", [""])[0]
        vid_marker = query.get("version-id-marker", [""])[0]
        self.head_bucket(bucket)
        root = ET.Element("ListVersionsResult", xmlns=S3_NS)
        _el(root, "Name", bucket)
        _el(root, "Prefix", prefix)
        _el(root, "MaxKeys", max_keys)
        if key_marker:
            _el(root, "KeyMarker", key_marker)
        if vid_marker:
            _el(root, "VersionIdMarker", vid_marker)
        truncated_el = _el(root, "IsTruncated", "false")
        count = 0
        names = self.pools.list_object_names(bucket, prefix)
        names = sorted(n for n in names if n >= key_marker) \
            if key_marker else sorted(names)
        past_vid_marker = not vid_marker
        last_emitted = ("", "")
        for name in names:
            try:
                versions = self.pools.list_object_versions(bucket, name)
            except StorageError:
                continue
            if name == key_marker and vid_marker and not past_vid_marker:
                # Marker version deleted between pages: losing the rest
                # of the key's history is worse than re-emitting it —
                # treat a missing marker as "start of key".
                vids = {v.version_id or "null" for v in versions}
                if vid_marker not in vids:
                    past_vid_marker = True
            for v in versions:
                vid = v.version_id or "null"
                if name == key_marker:
                    # resume strictly after the marker version
                    if not past_vid_marker:
                        if vid == vid_marker:
                            past_vid_marker = True
                        continue
                    if not vid_marker:
                        continue        # key-marker alone: skip its key
                if count >= max_keys:
                    # markers name the LAST RETURNED item (AWS
                    # semantics); the next page resumes strictly after
                    truncated_el.text = "true"
                    _el(root, "NextKeyMarker", last_emitted[0])
                    _el(root, "NextVersionIdMarker", last_emitted[1])
                    return Response(200, _xml(root),
                                    {"Content-Type": "application/xml"})
                last_emitted = (name, vid)
                tag = "DeleteMarker" if v.deleted else "Version"
                e = _el(root, tag)
                _el(e, "Key", v.name or name)
                _el(e, "VersionId", vid)
                _el(e, "IsLatest", "true" if v.is_latest else "false")
                _el(e, "LastModified", _iso(v.mod_time_ns))
                if not v.deleted:
                    _el(e, "ETag", f'"{v.metadata.get("etag", "")}"')
                    _el(e, "Size", _logical_size(v))
                count += 1
        return Response(200, _xml(root), {"Content-Type": "application/xml"})

    # ---- object level -----------------------------------------------------

    @staticmethod
    def _object_headers(fi: FileInfo) -> dict[str, str]:
        h = {
            "ETag": f'"{fi.metadata.get("etag", "")}"',
            "Last-Modified": _http_date(fi.mod_time_ns),
            "Content-Type": fi.metadata.get(
                "content-type", "application/octet-stream"),
            "Accept-Ranges": "bytes",
        }
        if fi.version_id:
            h["x-amz-version-id"] = fi.version_id
        if S3Handlers.SC_HEADER in fi.metadata:
            h[S3Handlers.SC_HEADER] = fi.metadata[S3Handlers.SC_HEADER]
        for k, v in fi.metadata.items():
            if k.startswith(AMZ_META_PREFIX):
                h[k] = v
        return h

    @staticmethod
    def _check_conditions(headers: dict[str, str],
                          fi: FileInfo) -> Response | None:
        """If-Match / If-None-Match / If-(Un)modified-Since with RFC
        7232 §6 precedence (cf. checkPreconditions,
        cmd/object-handlers-common.go): If-Match beats
        If-Unmodified-Since, If-None-Match beats If-Modified-Since.

        Returns a body-less 304 Response (carrying the §4.1-required
        ETag/Last-Modified validators, NOT an XML error body — clients
        revalidate their cache from these headers) when the client's
        copy is fresh, or None to proceed; a failed writer-side
        precondition raises S3Error("PreconditionFailed") → 412.

        Runs BEFORE any range parse or shard IO: the cheapest possible
        hot-key hit is the one that never touches a drive.
        """
        etag = fi.metadata.get("etag", "")
        h = {k.lower(): v for k, v in headers.items()}

        def etag_match(spec: str) -> bool:
            # Comma-separated entity-tag list; W/ weak tags compare by
            # opaque value (weak comparison is fine for GET/HEAD).
            if spec.strip() == "*":
                return True
            for cand in spec.split(","):
                cand = cand.strip()
                if cand.startswith("W/"):
                    cand = cand[2:]
                if cand.strip('"') == etag:
                    return True
            return False

        def parse_http_date(s):
            try:
                d = email.utils.parsedate_to_datetime(s)
            except (TypeError, ValueError):
                return None
            if d is not None and d.tzinfo is None:
                d = d.replace(tzinfo=datetime.timezone.utc)
            return d

        mod = datetime.datetime.fromtimestamp(
            fi.mod_time_ns / 1e9, datetime.timezone.utc).replace(microsecond=0)
        im = h.get("if-match")
        if im is not None:
            if not etag_match(im):
                raise S3Error("PreconditionFailed")
        else:
            ius = parse_http_date(h.get("if-unmodified-since", ""))
            if ius is not None and mod > ius:
                raise S3Error("PreconditionFailed")

        def not_modified() -> Response:
            nh = {"ETag": f'"{etag}"',
                  "Last-Modified": _http_date(fi.mod_time_ns)}
            if fi.version_id:
                nh["x-amz-version-id"] = fi.version_id
            return Response(304, b"", nh)

        inm = h.get("if-none-match")
        if inm is not None:
            if etag_match(inm):
                return not_modified()
        else:
            ims = parse_http_date(h.get("if-modified-since", ""))
            if ims is not None and mod <= ims:
                return not_modified()
        return None

    @staticmethod
    def _parse_range(spec: str, size: int) -> tuple[int, int] | None:
        """HTTP Range -> (offset, length). cf. cmd/httprange.go."""
        if not spec.startswith("bytes="):
            return None
        r = spec[len("bytes="):]
        if "," in r:
            raise S3Error("InvalidRange", "multiple ranges not supported")
        start_s, _, end_s = r.partition("-")
        try:
            if start_s == "":                   # suffix: last N bytes
                n = int(end_s)
                if n == 0:
                    raise S3Error("InvalidRange")
                start = max(size - n, 0)
                return start, size - start
            start = int(start_s)
            end = int(end_s) if end_s else size - 1
        except ValueError:
            # RFC 7233: a syntactically malformed Range is IGNORED
            # (whole object), not a 416.
            return None
        if start >= size:
            raise S3Error("InvalidRange")
        end = min(end, size - 1)
        if end < start:
            raise S3Error("InvalidRange")
        return start, end - start + 1

    def get_object(self, bucket: str, key: str, query: dict,
                   headers: dict[str, str], head: bool = False) -> Response:
        version_id = query.get("versionId", [""])[0]
        if extract.is_zip_extract_get(headers):
            split = extract.split_zip_path(key)
            if split is not None:
                # A member of a zip object, read whole from the object
                # (cf. cmd/s3-zip-handlers.go).
                zip_key, member = split
                _, zip_bytes = self._read_source(bucket, zip_key,
                                                 version_id)
                data = extract.read_zip_member(bytes(zip_bytes), member)
                h = {"Content-Length": str(len(data)),
                     "Content-Type": "application/octet-stream",
                     "Accept-Ranges": "none"}
                return Response(200, b"" if head else data, h)
        try:
            fi = self.pools.head_object(bucket, key, version_id)
        except StorageError as e:
            raise from_storage_error(e) from None
        cond = self._check_conditions(headers, fi)
        if cond is not None:
            return cond
        self._refuse_transformed(fi)

        size = fi.size
        rng = headers.get("Range") or headers.get("range")
        offset, length = 0, size
        partial = False
        if rng:
            parsed = self._parse_range(rng, size)
            if parsed:
                offset, length = parsed
                partial = True
        body_iter = None
        if not head:
            # The body streams off the erasure engine in device-batch
            # chunks: O(batch) memory (the GetObjectReader role).
            try:
                fi, body_iter = self.pools.get_object_iter(
                    bucket, key, offset, length, version_id)
                # Pull the FIRST chunk now: once headers are on the wire
                # a failure can only sever the connection, so quorum and
                # bitrot errors that surface at once must still become
                # S3 error responses.
                first = next(body_iter, b"")
            except StorageError as e:
                raise from_storage_error(e) from None
            body_iter = _stream(first, body_iter)

        h = self._object_headers(fi)
        if partial:
            h["Content-Range"] = \
                f"bytes {offset}-{offset + length - 1}/{size}"
            h["Content-Length"] = str(length)
            status = 206
        else:
            h["Content-Length"] = str(size)
            status = 200
        return Response(status, b"", h, body_iter=body_iter)

    def put_object(self, bucket: str, key: str, body,
                   headers: dict[str, str]) -> Response:
        """`body` is bytes or a reader.  A reader streams straight into
        the erasure engine in O(batch) memory; Content-MD5 verification
        drains it first, so a rejected body stages nothing."""
        if len(key) > MAX_KEY_LEN:
            raise S3Error("KeyTooLongError")
        h = {k.lower(): v for k, v in headers.items()}
        if "x-amz-copy-source" in h:
            if streams.is_reader(body):
                # Copy requests carry no meaningful body; drain so the
                # keep-alive socket isn't left desynced.
                while body.read(1 << 20):
                    pass
            return self._copy_object(bucket, key, h)
        if any(h.get(k) for k in _SSE_HEADERS):
            raise unported("server-side encryption")
        if h.get("x-amz-replication-status") == "REPLICA":
            raise unported("replication")
        # aws-chunked bodies declare the PAYLOAD length separately; the
        # wire Content-Length includes chunk headers + signatures.
        declared_size = (len(body) if isinstance(body, (bytes, bytearray))
                         else int(h.get("x-amz-decoded-content-length")
                                  or h.get("content-length") or 0))
        if declared_size > MAX_OBJECT_SIZE:
            raise S3Error("EntityTooLarge")
        if streams.is_reader(body):
            # Hard cap BEFORE any draining: an undeclared-length
            # (chunked TE) body must not grow past the object limit, in
            # memory or on disk.
            body = streams.MaxSizeReader(
                body, MAX_OBJECT_SIZE,
                exc=lambda msg: S3Error("EntityTooLarge"))
            if h.get("content-md5") or extract.is_snowball_put(headers):
                body = streams.ensure_bytes(body)
        if extract.is_snowball_put(headers):
            # Auto-extract a tar body into one object per member under
            # the key prefix (cf. PutObjectExtract, cmd/untar.go:100).
            n = 0
            for sub_key, data, _meta in extract.extract_tar(body, key):
                self.put_object(bucket, sub_key, data, {})
                n += 1
            return Response(200, headers={"x-mtpu-extracted-objects":
                                          str(n)})
        md5_hdr = h.get("content-md5")
        if md5_hdr:
            # Conformance split (cf. internal/hash/reader.go): a header
            # that does not decode to exactly one MD5 digest is
            # InvalidDigest; a well-formed digest that disagrees with
            # the body is BadDigest.  validate=True matters — lenient
            # b64decode silently drops non-alphabet bytes and would
            # misreport malformed headers as mismatches.  Runs before
            # put_object, so nothing is staged for a rejected body.
            try:
                want = base64.b64decode(md5_hdr, validate=True)
            except ValueError:
                raise S3Error("InvalidDigest") from None
            if len(want) != 16:
                raise S3Error("InvalidDigest")
            if hashlib.md5(body).digest() != want:
                raise S3Error("BadDigest")
        metadata = {k: v for k, v in h.items()
                    if k.startswith(AMZ_META_PREFIX)}
        if "content-type" in h:
            metadata["content-type"] = h["content-type"]
        parity = self._parity_for_request(h, metadata)
        self._refuse_write_gates(bucket)
        versioned = self.bucket_versioning_enabled(bucket)
        try:
            fi = self.pools.put_object(bucket, key, body, metadata=metadata,
                                       versioned=versioned, parity=parity)
        except StorageError as e:
            raise from_storage_error(e) from None
        resp_headers = {"ETag": f'"{fi.metadata.get("etag", "")}"'}
        if fi.version_id:
            resp_headers["x-amz-version-id"] = fi.version_id
        return Response(200, headers=resp_headers)

    def _copy_source(self, h: dict[str, str]) -> tuple[str, str, str]:
        src = urllib.parse.unquote(h["x-amz-copy-source"]).lstrip("/")
        src_bucket, _, src_key = src.partition("/")
        src_vid = ""
        if "?versionId=" in src_key:
            src_key, _, src_vid = src_key.partition("?versionId=")
        return src_bucket, src_key, src_vid

    def _read_source(self, bucket: str, key: str, version_id: str):
        """(fi, bytes) of a copy source."""
        try:
            fi, data = self.pools.get_object(bucket, key,
                                             version_id=version_id)
        except StorageError as e:
            raise from_storage_error(e) from None
        self._refuse_transformed(fi)
        return fi, data

    def _copy_object(self, bucket: str, key: str,
                     h: dict[str, str]) -> Response:
        if any(h.get(k) for k in _SSE_HEADERS):
            raise unported("server-side encryption")
        src_bucket, src_key, src_vid = self._copy_source(h)
        fi, data = self._read_source(src_bucket, src_key, src_vid)
        metadata = dict(fi.metadata)
        metadata.pop("etag", None)
        if h.get("x-amz-metadata-directive", "COPY") == "REPLACE":
            # REPLACE swaps the USER metadata only; the internal keys
            # ride along.
            metadata = {k: v for k, v in h.items()
                        if k.startswith(AMZ_META_PREFIX)}
            metadata.update({k: v for k, v in fi.metadata.items()
                             if k.startswith("x-mtpu-internal-")})
        versioned = self.bucket_versioning_enabled(bucket)
        # Storage class: an explicit request header re-classes the copy;
        # otherwise the source's class (already riding in metadata)
        # keeps its parity (cf. CopyObject storage-class handling,
        # cmd/object-handlers.go).
        if self.SC_HEADER in h:
            metadata.pop(self.SC_HEADER, None)
            parity = self._parity_for_request(h, metadata)
        elif self.SC_HEADER in metadata:
            parity = self.config_sys.parity_for_class(
                self.STORAGE_CLASSES.get(metadata[self.SC_HEADER],
                                         "standard"))
        else:
            parity = None
        self._refuse_write_gates(bucket)
        try:
            out = self.pools.put_object(bucket, key, bytes(data),
                                        metadata=metadata,
                                        versioned=versioned, parity=parity)
        except StorageError as e:
            raise from_storage_error(e) from None
        root = ET.Element("CopyObjectResult", xmlns=S3_NS)
        _el(root, "ETag", f'"{out.metadata.get("etag", "")}"')
        _el(root, "LastModified", _iso(out.mod_time_ns))
        return Response(200, _xml(root), {"Content-Type": "application/xml"})

    def delete_object(self, bucket: str, key: str, query: dict,
                      headers: dict[str, str] | None = None) -> Response:
        version_id = query.get("versionId", [""])[0]
        versioned = self.bucket_versioning_enabled(bucket)
        self._refuse_write_gates(bucket)
        try:
            dm = self.pools.delete_object(bucket, key, version_id, versioned)
        except StorageError as e:
            err = from_storage_error(e)
            # S3 DELETE of a nonexistent key is a 204 no-op.
            if err.api.code == "NoSuchKey":
                return Response(204)
            raise err from None
        h = {}
        if dm is not None and dm.version_id:
            h = {"x-amz-version-id": dm.version_id,
                 "x-amz-delete-marker": "true"}
        return Response(204, headers=h)

    # ---- object tagging ---------------------------------------------------

    def put_object_tagging(self, bucket: str, key: str, query: dict,
                           body: bytes) -> Response:
        fi = self._head_for_update(bucket, key, query)
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML") from None
        for el in root.iter():
            if "}" in el.tag:
                el.tag = el.tag.split("}", 1)[1]
        pairs = []
        for tag_el in root.iter("Tag"):
            k = tag_el.findtext("Key") or ""
            v = tag_el.findtext("Value") or ""
            pairs.append(f"{urllib.parse.quote(k)}={urllib.parse.quote(v)}")
        self._update_metadata(bucket, key, fi,
                              {"x-amz-tagging": "&".join(pairs)})
        return Response(200)

    def get_object_tagging(self, bucket: str, key: str,
                           query: dict) -> Response:
        fi = self._head_for_update(bucket, key, query)
        root = ET.Element("Tagging", xmlns=S3_NS)
        ts = _el(root, "TagSet")
        raw = fi.metadata.get("x-amz-tagging", "")
        if raw:
            for pair in raw.split("&"):
                k, _, v = pair.partition("=")
                te = _el(ts, "Tag")
                _el(te, "Key", urllib.parse.unquote(k))
                _el(te, "Value", urllib.parse.unquote(v))
        return Response(200, _xml(root), {"Content-Type": "application/xml"})

    def _head_for_update(self, bucket: str, key: str, query: dict):
        version_id = query.get("versionId", [""])[0]
        try:
            return self.pools.head_object(bucket, key, version_id)
        except StorageError as e:
            raise from_storage_error(e) from None

    def _update_metadata(self, bucket: str, key: str, fi,
                         updates: dict) -> None:
        """Merge metadata keys into an existing version in place
        (cf. updateObjectMetadata, cmd/erasure-object.go:1513)."""
        meta = dict(fi.metadata)
        meta.update({k: v for k, v in updates.items() if v})
        for k, v in updates.items():
            if not v:
                meta.pop(k, None)
        fi.metadata = meta
        try:
            self.pools.update_object_metadata(bucket, key, fi)
        except StorageError as e:
            raise from_storage_error(e) from None

    def delete_objects(self, bucket: str, body: bytes,
                       can_delete=None) -> Response:
        """POST /bucket?delete — multi-object delete
        (cf. DeleteMultipleObjectsHandler, cmd/bucket-handlers.go).
        `can_delete(key, version_id) -> bool` authorizes each key
        individually: a bucket-level check would bypass object-path
        Deny statements."""
        self.head_bucket(bucket)
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML") from None
        quiet = root.findtext("Quiet", "false").lower() == "true" or \
            root.findtext(f"{{{S3_NS}}}Quiet", "false").lower() == "true"
        out = ET.Element("DeleteResult", xmlns=S3_NS)
        for obj in list(root.iter("Object")) + list(
                root.iter(f"{{{S3_NS}}}Object")):
            key = obj.findtext("Key") or obj.findtext(f"{{{S3_NS}}}Key") or ""
            vid = obj.findtext("VersionId") or \
                obj.findtext(f"{{{S3_NS}}}VersionId") or ""
            if can_delete is not None and not can_delete(key, vid):
                ee = _el(out, "Error")
                _el(ee, "Key", key)
                _el(ee, "Code", "AccessDenied")
                _el(ee, "Message", "Access Denied.")
                continue
            try:
                # Through the single-delete path, so its gates apply.
                q = {"versionId": [vid]} if vid else {}
                self.delete_object(bucket, key, q)
                if not quiet:
                    d = _el(out, "Deleted")
                    _el(d, "Key", key)
            except (S3Error, StorageError) as e:
                err = from_storage_error(e)
                ee = _el(out, "Error")
                _el(ee, "Key", key)
                _el(ee, "Code", err.api.code)
                _el(ee, "Message", err.message)
        return Response(200, _xml(out), {"Content-Type": "application/xml"})

    # ---- multipart --------------------------------------------------------

    def create_multipart(self, bucket: str, key: str,
                         headers: dict[str, str]) -> Response:
        h = {k.lower(): v for k, v in headers.items()}
        if any(h.get(k) for k in _SSE_HEADERS):
            raise unported("server-side encryption")
        metadata = {k: v for k, v in h.items()
                    if k.startswith(AMZ_META_PREFIX)}
        if "content-type" in h:
            metadata["content-type"] = h["content-type"]
        # Storage class fixes the stripe geometry for EVERY part now
        # (cf. newMultipartUpload, cmd/erasure-multipart.go:39).
        parity = self._parity_for_request(h, metadata)
        self._refuse_write_gates(bucket)
        try:
            upload_id = self.pools.new_multipart_upload(bucket, key,
                                                        metadata=metadata,
                                                        parity=parity)
        except StorageError as e:
            raise from_storage_error(e) from None
        root = ET.Element("InitiateMultipartUploadResult", xmlns=S3_NS)
        _el(root, "Bucket", bucket)
        _el(root, "Key", key)
        _el(root, "UploadId", upload_id)
        return Response(200, _xml(root), {"Content-Type": "application/xml"})

    def put_part(self, bucket: str, key: str, query: dict,
                 body, headers: dict[str, str] | None = None) -> Response:
        upload_id = query.get("uploadId", [""])[0]
        part_number = int(query.get("partNumber", ["0"])[0])
        if not (1 <= part_number <= 10000):
            raise S3Error("InvalidArgument", "part number out of range")
        h = {k.lower(): v for k, v in (headers or {}).items()}
        if "x-amz-copy-source" in h:
            if streams.is_reader(body):
                # Copy requests carry no meaningful body; drain so the
                # keep-alive socket isn't left desynced.
                while body.read(1 << 20):
                    pass
            return self._upload_part_copy(bucket, key, upload_id,
                                          part_number, h)
        try:
            info = self.pools.put_object_part(bucket, key, upload_id,
                                              part_number, body)
        except StorageError as e:
            raise from_storage_error(e) from None
        return Response(200, headers={"ETag": f'"{info.etag}"'})

    def _upload_part_copy(self, bucket: str, key: str, upload_id: str,
                          part_number: int, h: dict[str, str]) -> Response:
        """UploadPartCopy (cf. CopyObjectPartHandler,
        cmd/object-handlers.go): source an upload part from an existing
        object, or a byte range of it."""
        src_bucket, src_key, src_vid = self._copy_source(h)
        if not src_bucket or not src_key:
            raise S3Error("InvalidArgument", "bad x-amz-copy-source")
        fi, data = self._read_source(src_bucket, src_key, src_vid)
        rng = h.get("x-amz-copy-source-range", "")
        if rng:
            if not rng.startswith("bytes="):
                raise S3Error("InvalidArgument",
                              "x-amz-copy-source-range must be bytes=")
            start_s, _, end_s = rng[len("bytes="):].partition("-")
            try:
                start = int(start_s)
                end = int(end_s) if end_s else len(data) - 1
            except ValueError:
                raise S3Error("InvalidArgument", rng) from None
            # UploadPartCopy ranges are strict: both ends must lie
            # inside the source object (unlike GET's RFC 7233 clamping).
            if start < 0 or end < start or end >= len(data):
                raise S3Error("InvalidRange", rng)
            data = memoryview(data)[start:end + 1]
        try:
            info = self.pools.put_object_part(bucket, key, upload_id,
                                              part_number, bytes(data))
        except StorageError as e:
            raise from_storage_error(e) from None
        root = ET.Element("CopyPartResult", xmlns=S3_NS)
        _el(root, "ETag", f'"{info.etag}"')
        _el(root, "LastModified", _iso(time.time_ns()))
        return Response(200, _xml(root),
                        {"Content-Type": "application/xml"})

    def complete_multipart(self, bucket: str, key: str, query: dict,
                           body: bytes) -> Response:
        upload_id = query.get("uploadId", [""])[0]
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML") from None
        parts = []
        for p in list(root.iter("Part")) + list(root.iter(f"{{{S3_NS}}}Part")):
            num = p.findtext("PartNumber") or \
                p.findtext(f"{{{S3_NS}}}PartNumber")
            etag = (p.findtext("ETag") or p.findtext(f"{{{S3_NS}}}ETag")
                    or "").strip('"')
            parts.append((int(num), etag))
        versioned = self.bucket_versioning_enabled(bucket)
        self._refuse_write_gates(bucket)
        try:
            fi = self.pools.complete_multipart_upload(
                bucket, key, upload_id, parts, versioned=versioned)
        except StorageError as e:
            raise from_storage_error(e) from None
        root = ET.Element("CompleteMultipartUploadResult", xmlns=S3_NS)
        _el(root, "Bucket", bucket)
        _el(root, "Key", key)
        _el(root, "ETag", f'"{fi.metadata.get("etag", "")}"')
        return Response(200, _xml(root), {"Content-Type": "application/xml"})

    def abort_multipart(self, bucket: str, key: str, query: dict) -> Response:
        upload_id = query.get("uploadId", [""])[0]
        try:
            self.pools.abort_multipart_upload(bucket, key, upload_id)
        except StorageError as e:
            raise from_storage_error(e) from None
        return Response(204)

    def list_parts(self, bucket: str, key: str, query: dict) -> Response:
        upload_id = query.get("uploadId", [""])[0]
        try:
            parts = self.pools.list_parts(bucket, key, upload_id)
        except StorageError as e:
            raise from_storage_error(e) from None
        root = ET.Element("ListPartsResult", xmlns=S3_NS)
        _el(root, "Bucket", bucket)
        _el(root, "Key", key)
        _el(root, "UploadId", upload_id)
        _el(root, "IsTruncated", "false")
        for p in parts:
            pe = _el(root, "Part")
            _el(pe, "PartNumber", p.number)
            _el(pe, "ETag", f'"{p.etag}"')
            _el(pe, "Size", p.size)
        return Response(200, _xml(root), {"Content-Type": "application/xml"})

    def list_multipart_uploads(self, bucket: str, query: dict) -> Response:
        prefix = query.get("prefix", [""])[0]
        self.head_bucket(bucket)
        uploads = self.pools.list_multipart_uploads(bucket, prefix)
        root = ET.Element("ListMultipartUploadsResult", xmlns=S3_NS)
        _el(root, "Bucket", bucket)
        _el(root, "Prefix", prefix)
        _el(root, "IsTruncated", "false")
        for u in uploads:
            ue = _el(root, "Upload")
            _el(ue, "Key", u["object"])
            _el(ue, "UploadId", u["upload_id"])
        return Response(200, _xml(root), {"Content-Type": "application/xml"})
