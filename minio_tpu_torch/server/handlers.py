"""S3 API handlers: bucket/object/multipart surface over ServerPools.

The port of minio_tpu/server/handlers.py (the cmd/object-handlers.go /
cmd/bucket-handlers.go / cmd/bucket-listobjects-handlers.go role),
dispatched by (method, path-shape, query) like cmd/api-router.go:175
registers routes.  Handlers speak to the object layer
(engine/pools.ServerPools) only; the erasure engine below reaches the
kernels.

The data-protection planes are served: object lock (bucket/
object_lock.py: default retention on PUT, a client's delete or
unversioned overwrite of a protected version refused, ?retention and
?legal-hold), lifecycle configs (bucket/lifecycle.py, applied by the
scanner) and bucket replication (bucket/replication.py: each write
journaled for the remote target, replica PUTs keeping the source's
version id and mod time, the GET proxied to the target while the bucket
resyncs).  Bucket notifications are served (bucket/notify.py): a PUT,
a multipart complete and a DELETE publish their event, with the
object's logical size, to the rules of `?notification`, validated
before they are stored (a rule whose ARN names no registered target is
refused).  The tier is served (bucket/tier.py, `tier_mgr`): lifecycle
Transition rules, GETs of a transitioned stub read through from its tier
(ranged too), HEAD and GET report the tier as the storage class and a
temporary restore's `x-amz-restore`, and a stub's overwrite or hard
delete frees its tier copy through the tier journal (restore is the
server's `POST ?restore`).  The object transforms are served
(crypto/sse.py, utils/compress.py): a PUT compresses what passes the
filter when compression is on (`compress_enabled`, or the configuration's
`compression.enable`) and then seals it under SSE-S3, SSE-KMS or SSE-C
before the erasure engine sees it; GET, HEAD, copies, UploadPartCopy,
the replication proxy and S3 Select (`select_object_content`,
s3select/) reverse them, from the drives or through the tier, whichever
package stored the object.  A multipart upload with SSE headers is
refused (the JAX package stores its parts plain), and the bucket
`?encryption` config is stored, not applied to PUTs without SSE headers,
as in the JAX package.  A bucket's hard quota is
enforced at PUT and multipart complete (bucket/quota.py: usage from the
scanner's last cycle, as in the JAX package, else from a live listing).
Snowball tars are extracted on PUT and zip members served on GET
(server/extract.py); who may call a handler is decided before it runs
(server.py `_authorize`).
"""

from __future__ import annotations

import base64
import contextlib
import datetime
import email.utils
import hashlib
import time
import urllib.parse
import xml.etree.ElementTree as ET

from ..bucket import object_lock as ol
from ..bucket.notify import parse_notification_config
from ..bucket import quota as bq
from ..bucket import replication as repl
from ..bucket.lifecycle import Lifecycle
from ..bucket.tier import (RESTORE_EXPIRY_KEY, TIER_NAME_KEY,
                           TIER_SIZE_KEY, _TIER_META_KEYS)
from ..bucket.metadata import META_BUCKET, BucketMetadataSys
from ..config.config import ConfigSys
from ..crypto import sse
from ..crypto.kms import kms_from_env
from ..engine.pools import ServerPools
from ..iam.policy import Policy
from ..observe.span import span as _span
from ..ops import metalanes
from ..storage.errors import ErrObjectNotFound, StorageError
from ..storage.xlmeta import FileInfo
from ..utils import compress as cz
from ..utils import streams
from . import extract
from .api_errors import S3Error, from_storage_error

MAX_OBJECT_SIZE = 5 * 1024 ** 4    # 5 TiB (docs/minio-limits.md)
MAX_KEY_LEN = 1024

# User metadata prefix passed through to storage.
AMZ_META_PREFIX = "x-amz-meta-"

#: The SSE request headers (crypto/sse.py).
_SSE_HEADERS = (sse.H_SSE, sse.H_SSEC_ALGO)
#: The size a client sees of an object stored transformed (compressed,
#: sealed) or of a tiered stub; listings report it, as the JAX package
#: does.
_CLIENT_SIZE_KEY = "x-mtpu-internal-client-size"
#: The SSE-C headers of a copy's source, by the request header each
#: stands for.
_COPY_SOURCE_SSEC = {
    sse.H_SSEC_ALGO: "x-amz-copy-source-server-side-encryption-"
                     "customer-algorithm",
    sse.H_SSEC_KEY: "x-amz-copy-source-server-side-encryption-"
                    "customer-key",
    sse.H_SSEC_MD5: "x-amz-copy-source-server-side-encryption-"
                    "customer-key-md5",
}


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
                 headers: dict[str, str] | None = None, body_iter=None,
                 body_file=None):
        """body_iter: optional iterator of byte chunks streamed to the
        client instead of `body`; headers must carry Content-Length.
        body_file: optional list of ops.zerocopy.FilePlan, whose verified
        shard runs are the body, sent with os.sendfile (the TLS and
        oracle writers read them through plan.read_all()); headers must
        carry Content-Length."""
        self.status = status
        self.body = body
        self.body_iter = body_iter
        self.body_file = body_file
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
                               fi.metadata.get(TIER_SIZE_KEY, fi.size)))


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

    def __init__(self, pools: ServerPools, scanner=None, replication=None,
                 notify=None, tier_mgr=None, kms=None,
                 compress_enabled: bool = False):
        self.pools = pools
        # crypto/kms.py (or crypto/kes.py) for SSE-S3 and SSE-KMS: by
        # default from MTPU_KMS_SECRET_KEY; None refuses those PUTs
        # rather than seal under a known key.
        self.kms = kms if kms is not None else kms_from_env()
        # Compression of what passes utils/compress.py's filter; the
        # configuration's compression.enable turns it on as well.
        self.compress_enabled = compress_enabled
        # bucket/tier.TierManager: transitions, read-through, restore and
        # the freeing of tier copies; None serves no tiered stub.
        self.tier_mgr = tier_mgr
        # Called with no argument when a notification rule names an ARN
        # this process has no target for: the server registers the
        # targets a configuration set since its boot enabled.
        self.refresh_targets = None
        # bucket/notify.NotificationSystem: each object event is
        # published there; None publishes nothing.
        self.notify = notify
        # bucket/replication.ReplicationPool: each write's task, the
        # proxy GET; None replicates nothing.  Its copies read the
        # plaintext through this server's transforms.
        self.replication = replication
        if isinstance(replication, repl.ReplicationPool):
            replication.read_source = self._replica_source
        # Where quota reads usage (background/scanner.py: the running
        # scanner, or in a pool worker without one its persisted usage);
        # None lists the bucket live.
        self.scanner = scanner
        try:
            pools.make_bucket(META_BUCKET)
        except StorageError:
            pass
        self.meta = BucketMetadataSys(pools)
        self.config_sys = ConfigSys(pools)
        self.apply_config()

    def apply_config(self) -> None:
        """What the server configuration sets beyond each request's own
        reads: the K+1 read trim (engine/erasure_set.
        _read_version_fanout) reads for the parity this server writes
        its STANDARD class at."""
        standard = self.config_sys.parity_for_class("standard")
        if standard is not None:
            for pool in self.pools.pools:
                for es in pool.sets:
                    es.trim_parity = es.clamp_parity(standard)

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

    def _compressing(self) -> bool:
        return self.compress_enabled or self.config_sys.compression_enabled()

    def _reverse(self, meta: dict, data, headers: dict, bucket: str,
                 key: str):
        """An object's stored bytes -> its plaintext: unseal, then
        decompress (the reverse of put_object's transforms)."""
        if sse.is_encrypted(meta):
            try:
                data = sse.decrypt_for_get(bytes(data), meta, headers,
                                           self.kms, bucket, key)
            except sse.SSEError as e:
                raise S3Error("AccessDenied", str(e)) from None
        return cz.decompress(data, meta)

    def _check_key(self, meta: dict, headers: dict, head: bool = False
                   ) -> None:
        """The key a sealed object needs, checked from the request and
        the metadata before a shard is read, so a refused GET or HEAD
        reads nothing (the checks and answers of decrypt_for_get; HEAD's
        the JAX HEAD's)."""
        algo = meta.get(sse.META_ALGO, "")
        if algo == "SSE-S3" and self.kms is None and not head:
            raise S3Error("AccessDenied",
                          "object is KMS encrypted; no KMS configured")
        if algo != "SSE-C":
            return
        try:
            k = sse.parse_ssec_key(headers)
        except sse.SSEError as e:
            raise S3Error("AccessDenied", str(e)) from None
        md5 = base64.b64encode(hashlib.md5(k).digest()).decode() \
            if k is not None else None
        if head and md5 != meta.get(sse.META_KEY_MD5, ""):
            raise S3Error("AccessDenied", "SSE-C key required for HEAD")
        if k is None:
            raise S3Error("AccessDenied",
                          "object is SSE-C encrypted; key required")
        if md5 != meta.get(sse.META_KEY_MD5, ""):
            raise S3Error("AccessDenied",
                          "SSE-C key does not match object key")

    def _read_plaintext(self, bucket: str, key: str, version_id: str,
                        headers: dict) -> tuple:
        """(fi, plaintext) of an object: its stored bytes (a
        transitioned stub's read through from its tier) with the
        transforms reversed.  The stub is judged by the returned fi, so
        a concurrent transition cannot hand over an empty body as
        data."""
        try:
            fi, stored = self.pools.get_object(bucket, key,
                                               version_id=version_id)
            if self.tier_mgr is None and fi.metadata.get(TIER_NAME_KEY) \
                    and not fi.size:
                raise S3Error("NotImplemented", "the object is in a tier "
                              "and this server has no tier manager")
            if self._tiered(fi):
                stored = self.tier_mgr.read_through(fi)
        except StorageError as e:
            raise from_storage_error(e) from None
        return fi, self._reverse(fi.metadata, stored, headers, bucket, key)

    def _replica_source(self, bucket: str, key: str, version_id: str
                        ) -> tuple:
        """(fi, plaintext) of a version to replicate: _read_plaintext
        without a request.  An SSE-C version, whose key only its client
        holds, and a sealed one without a KMS are unreplicable; a
        missing version raises the storage error that drops the task."""
        fi, stored = self.pools.get_object(bucket, key,
                                           version_id=version_id)
        algo = fi.metadata.get(sse.META_ALGO, "")
        if algo == "SSE-C" or (algo and self.kms is None):
            raise repl.ErrUnreplicable(
                f"{bucket}/{key}: {algo} without its key cannot be "
                "copied")
        if self._tiered(fi):
            stored = self.tier_mgr.read_through(fi)
        return fi, self._reverse(fi.metadata, stored, {}, bucket, key)

    def _tiered(self, fi: FileInfo) -> bool:
        """A transitioned stub whose bytes live in its tier (not a live
        temporary restore, whose hot copy is served as any object)."""
        return (self.tier_mgr is not None
                and self.tier_mgr.is_transitioned(fi)
                and not self.tier_mgr.restore_fresh(fi))

    def _lock_config(self, bucket: str) -> dict | None:
        """The bucket's object-lock config, when it is enabled."""
        data = self.meta.get(bucket, "object_lock")
        if data is None:
            return None
        try:
            cfg = ol.parse_lock_config(data)
        except Exception:  # noqa: BLE001
            return None
        return cfg if cfg.get("enabled") else None

    def _lock_gate(self, bucket: str, key: str, h: dict[str, str],
                   metadata: dict, versioned: bool) -> None:
        """A write into an object-lock bucket: an unversioned overwrite
        of a protected version is refused, and the new version takes the
        bucket's default retention, the request's own headers winning."""
        cfg = self._lock_config(bucket)
        if cfg is None:
            return
        if not versioned:
            self._refuse_locked(bucket, key)
        metadata.update(ol.default_retention_metadata(cfg))
        for hk in (ol.RET_MODE_KEY, ol.RET_DATE_KEY, ol.LEGAL_HOLD_KEY):
            if hk in h:
                metadata[hk] = h[hk]

    def _refuse_locked(self, bucket: str, key: str, version_id: str = "",
                       bypass: bool = False) -> None:
        """ObjectLocked when the version a write or delete would destroy
        is under retention or a legal hold (GOVERNANCE yields to
        `bypass`)."""
        try:
            prev = self.pools.head_object(bucket, key, version_id)
        except StorageError:
            return
        reason = ol.check_delete_allowed(prev.metadata,
                                         bypass_governance=bypass)
        if reason:
            raise S3Error("ObjectLocked", reason)

    def _proxy_get_response(self, bucket: str, key: str, version_id: str,
                            headers: dict, head: bool) -> Response | None:
        """Serve a GET whose local copy is missing from the bucket's
        replication target (proxyGetToReplicationTarget,
        cmd/bucket-replication.go:825), or None for the 404.  Only while
        the bucket resyncs: outside a resync a local miss means the
        object does not exist, and a stale replica must not bring back
        what was deleted.  A version-pinned read stays local."""
        if self.replication is None or version_id:
            return None
        st = self.replication.resync_status(bucket)
        if not st or st.get("status") != "running":
            return None
        try:
            meta, data = self.replication.proxy_get(
                bucket, key, {k: v for k, v in headers.items()
                              if k.lower() in _COPY_SOURCE_SSEC})
        except repl.ErrReplicationTargetDown as e:
            # The target may hold the key but cannot be asked: 503, not
            # a 404 that would say it does not exist.
            raise S3Error("ReplicationRemoteConnectionError",
                          str(e)) from None
        except repl.ErrReplicaDenied as e:
            raise S3Error("AccessDenied", str(e)) from None
        except StorageError:
            return None
        data = self._reverse(meta, data, headers, bucket, key)
        cond_fi = FileInfo(volume=bucket, name=key, size=len(data),
                           metadata=dict(meta))
        cond = self._check_conditions(headers, cond_fi)
        if cond is not None:
            return cond
        h = {"Content-Length": str(len(data)),
             "Content-Type": meta.get("content-type",
                                      "application/octet-stream"),
             repl.STATUS_KEY: "REPLICA"}
        if meta.get("etag"):
            h["ETag"] = f'"{meta["etag"]}"'
        rng = headers.get("Range") or headers.get("range")
        if rng:
            parsed = self._parse_range(rng, len(data))
            if parsed:
                off, ln = parsed
                h["Content-Range"] = f"bytes {off}-{off + ln - 1}/{len(data)}"
                h["Content-Length"] = str(ln)
                return Response(
                    206, b"" if head else memoryview(data)[off:off + ln], h)
        return Response(200, b"" if head else data, h)

    # ---- bucket config helpers (persisted via BucketMetadataSys) ----------

    def bucket_versioning_enabled(self, bucket: str) -> bool:
        data = self.meta.get(bucket, "versioning")
        return data is not None and b"<Status>Enabled</Status>" in data

    def _publish_event(self, event: str, bucket: str, key: str,
                       size: int = 0, etag: str = "",
                       version_id: str = "") -> None:
        if self.notify is not None:
            self.notify.publish(event, bucket, key, size=size, etag=etag,
                                version_id=version_id)

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
    #: server authorizes anonymous requests by), ?quota (JSON: the hard
    #: quota enforced at PUT and multipart complete, and the bandwidth
    #: budget the QoS plane enforces), ?tagging (a blob), ?lifecycle
    #: (applied by the scanner), ?replication (wired into the
    #: replication pool), ?notification (the notification system's
    #: rules), ?object-lock and ?encryption (stored and served, not
    #: applied to a PUT without SSE headers, as in the JAX package).
    _CONFIG_KINDS = {
        "lifecycle": ("lifecycle", "NoSuchLifecycleConfiguration"),
        "policy": ("policy", "NoSuchBucketPolicy"),
        "notification": ("notification",
                         "NoSuchNotificationConfiguration"),
        "replication": ("replication",
                        "ReplicationConfigurationNotFoundError"),
        "quota": ("quota", "NoSuchBucketPolicy"),
        "object-lock": ("object_lock", "NoSuchObjectLockConfiguration"),
        "tagging": ("tagging", "NoSuchTagSet"),
        "encryption": ("encryption",
                       "ServerSideEncryptionConfigurationNotFoundError"),
    }

    def put_bucket_config(self, bucket: str, sub: str,
                          body: bytes) -> Response:
        self.head_bucket(bucket)
        kind, _ = self._CONFIG_KINDS[sub]
        # Validate before storing (cf. the per-config parse in
        # cmd/bucket-handlers.go).
        try:
            if kind == "lifecycle":
                Lifecycle.parse(body)
            elif kind == "notification":
                rules = parse_notification_config(body)
                self._check_arns(rules)
            elif kind == "replication":
                rules = repl.parse_replication_config(body)
                # The targets are checked BEFORE the config persists: a
                # 400 must not leave a config that fails its wiring at
                # every boot.  No registered target at all defers the
                # wiring (wire_bucket answers False).
                targets = repl.parse_targets(
                    self.meta.get(bucket, "replication_targets"))
                if targets:
                    registered = {t.get("targetBucket", "")
                                  for t in targets}
                    unmatched = [r.target_bucket for r in rules
                                 if r.target_bucket not in registered]
                    if unmatched:
                        raise S3Error(
                            "InvalidArgument",
                            f"replication rules reference unregistered "
                            f"target bucket(s) {unmatched}; register "
                            f"them with admin bucket-remote first")
            elif kind == "object_lock":
                ol.parse_lock_config(body)
            elif kind == "policy":
                Policy(body.decode())
            elif kind == "quota":
                cfg = bq.parse_quota_config(body)
                if cfg["quota"] < 0 or cfg["bandwidth"] < 0:
                    raise S3Error(
                        "InvalidArgument",
                        "quota and bandwidth must be non-negative")
        except S3Error:
            raise
        except Exception:  # noqa: BLE001 — any parse failure
            raise S3Error("MalformedXML") from None
        self.meta.put(bucket, kind, body)
        if kind == "notification" and self.notify is not None:
            self.notify.set_bucket_rules(bucket, rules)
        if kind == "replication" and self.replication is not None:
            try:
                repl.wire_bucket(self.replication, self.meta, bucket)
            except Exception as e:  # noqa: BLE001 — wiring's verdict
                # A config whose wiring fails (a target unregistered in
                # the window since the check) is rolled back, so no boot
                # replays a known-bad config.
                self.meta.delete(bucket, kind)
                raise S3Error("InvalidArgument",
                              f"replication wiring: {e}") from None
        return Response(200)

    def _check_arns(self, rules) -> None:
        """A rule whose ARN names no registered target is refused, as
        MinIO refuses it when it parses the configuration (its events
        would go nowhere).  Targets enabled through `admin config set`
        since the boot are registered first."""
        if self.notify is None:
            return
        unknown = [r.arn for r in rules if r.arn not in self.notify.targets]
        if unknown and self.refresh_targets is not None:
            self.refresh_targets()
            unknown = [r.arn for r in rules
                       if r.arn not in self.notify.targets]
        if unknown:
            raise S3Error(
                "InvalidArgument",
                f"A specified destination ARN does not exist or is not "
                f"well-formed: {', '.join(unknown)} (enable its notify_* "
                f"subsystem first)")

    def get_bucket_config(self, bucket: str, sub: str) -> Response:
        self.head_bucket(bucket)
        kind, missing_code = self._CONFIG_KINDS[sub]
        data = self.meta.get(bucket, kind)
        if data is None:
            raise S3Error(missing_code)
        ctype = "application/json" if kind in ("policy", "quota") else \
            "application/xml"
        return Response(200, data, {"Content-Type": ctype})

    def delete_bucket_config(self, bucket: str, sub: str) -> Response:
        self.head_bucket(bucket)
        kind, _ = self._CONFIG_KINDS[sub]
        self.meta.delete(bucket, kind)
        if kind == "notification" and self.notify is not None:
            self.notify.set_bucket_rules(bucket, [])
        if kind == "replication" and self.replication is not None:
            # Replication stops now, not at the next restart.
            self.replication.unconfigure(bucket)
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
        if repl.STATUS_KEY in fi.metadata:
            h[repl.STATUS_KEY] = fi.metadata[repl.STATUS_KEY]
        if TIER_NAME_KEY in fi.metadata:
            # A transitioned stub: its tier is the storage class the
            # client sees, and a temporary restore adds x-amz-restore
            # (cf. postRestoreOpts, cmd/object-handlers.go).
            h[S3Handlers.SC_HEADER] = fi.metadata[TIER_NAME_KEY]
            exp = fi.metadata.get(RESTORE_EXPIRY_KEY)
            if exp:
                try:
                    h["x-amz-restore"] = (
                        'ongoing-request="false", expiry-date="'
                        + _http_date(int(float(exp) * 1e9)) + '"')
                except ValueError:
                    pass
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
                _, zip_bytes = self._read_plaintext(bucket, zip_key,
                                                    version_id, headers)
                data = extract.read_zip_member(bytes(zip_bytes), member)
                h = {"Content-Length": str(len(data)),
                     "Content-Type": "application/octet-stream",
                     "Accept-Ranges": "none"}
                return Response(200, b"" if head else data, h)
        # The request's ignition note for the metadata lanes, counted
        # once with the engine's own: concurrent HEAD and GET elections
        # of distinct keys then share per-drive read_version_many rounds
        # (a lone request keeps the single-op fan-out).
        mb = metalanes.get() if metalanes.enabled() else None
        try:
            with mb.reading() if mb is not None else \
                    contextlib.nullcontext():
                fi = self.pools.head_object(bucket, key, version_id)
        except ErrObjectNotFound as e:
            resp = self._proxy_get_response(bucket, key, version_id,
                                            headers, head)
            if resp is None:
                raise from_storage_error(e) from None
            return resp
        except StorageError as e:
            raise from_storage_error(e) from None
        cond = self._check_conditions(headers, fi)
        if cond is not None:
            return cond
        if self.tier_mgr is None and fi.metadata.get(TIER_NAME_KEY):
            # A stub's body is empty: never serve it as the object.
            raise S3Error("NotImplemented", "the object is in a tier and "
                          "this server has no tier manager")

        tiered = self._tiered(fi)
        transcoded = (sse.is_encrypted(fi.metadata)
                      or cz.is_compressed(fi.metadata))
        size = _logical_size(fi) if (tiered or transcoded) else fi.size
        rng = headers.get("Range") or headers.get("range")
        offset, length = 0, size
        partial = False
        if rng:
            parsed = self._parse_range(rng, size)
            if parsed:
                offset, length = parsed
                partial = True
        data = b""
        body_iter = body_file = None
        if transcoded:
            self._check_key(fi.metadata, headers, head)
        if not head and transcoded:
            # A sealed or compressed object is decoded whole, then
            # sliced by the logical range (cf. the GetObjectReader's
            # decrypt and decompress stack, cmd/object-api-utils.go:528);
            # the slice is a view of the one plaintext buffer.
            fi, full = self._read_plaintext(bucket, key, version_id,
                                            headers)
            data = memoryview(full)[offset:offset + length]
        elif not head and tiered:
            # A transitioned stub streams from its tier in bounded
            # chunks, the range passed through; the first chunk is
            # pulled now so a tier that is down is still an S3 error.
            try:
                body_iter = self.tier_mgr.read_through_iter(
                    fi, offset, length)
                first = next(body_iter, b"")
            except StorageError as e:
                raise from_storage_error(e) from None
            body_iter = _stream(first, body_iter)
        elif not head:
            try:
                # A whole healthy GET of a k=1 object gets a verified
                # sendfile plan: the body never enters the process
                # (ops/zerocopy.py).  None on any gate: ranged, cached,
                # inline, degraded, k > 1, zero-copy off.
                with _span("engine.sendfile_plan"):
                    got = self.pools.sendfile_plan(bucket, key, offset,
                                                   length, version_id)
                if got is not None:
                    fi, body_file = got
                else:
                    # The body streams off the erasure engine in
                    # device-batch chunks: O(batch) memory (the
                    # GetObjectReader role).
                    with _span("engine.get_object"):
                        fi, body_iter = self.pools.get_object_iter(
                            bucket, key, offset, length, version_id)
                        # Pull the FIRST chunk now: once headers are on
                        # the wire a failure can only sever the
                        # connection, so quorum and bitrot errors that
                        # surface at once must still become S3 error
                        # responses.
                        first = next(body_iter, b"")
                    body_iter = _stream(first, body_iter)
            except StorageError as e:
                raise from_storage_error(e) from None

        h = self._object_headers(fi)
        h.update(sse.response_headers(fi.metadata))
        if partial:
            h["Content-Range"] = \
                f"bytes {offset}-{offset + length - 1}/{size}"
            h["Content-Length"] = str(length)
            status = 206
        else:
            h["Content-Length"] = str(size)
            status = 200
        return Response(status, data, h, body_iter=body_iter,
                        body_file=body_file)

    def select_object_content(self, bucket: str, key: str, query: dict,
                              body: bytes,
                              headers: dict[str, str]) -> Response:
        """POST /bucket/key?select&select-type=2 (cf.
        SelectObjectContentHandler, cmd/object-handlers.go:101): the
        object's plaintext, through its tier and its transforms, queried
        by s3select/; the answer is the AWS event stream."""
        from ..s3select.engine import execute_select, parse_select_request
        from ..s3select.sql import SQLError
        try:
            opts = parse_select_request(body)
        except ET.ParseError:
            raise S3Error("MalformedXML") from None
        version_id = query.get("versionId", [""])[0]
        _, data = self._read_plaintext(bucket, key, version_id, headers)
        try:
            out = execute_select(bytes(data), opts)
        except SQLError as e:
            raise S3Error("SelectParseError", str(e)) from None
        except Exception as e:  # noqa: BLE001 — bad data/query combos
            raise S3Error("SelectParseError",
                          f"{type(e).__name__}: {e}") from None
        return Response(200, out,
                        {"Content-Type": "application/octet-stream"})

    def put_object(self, bucket: str, key: str, body,
                   headers: dict[str, str]) -> Response:
        """`body` is bytes or a reader.  A reader streams straight into
        the erasure engine in O(batch) memory; the transforms (the
        compression filter passing, SSE headers) and Content-MD5
        verification drain it first, so a rejected body stages
        nothing."""
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
        # aws-chunked bodies declare the PAYLOAD length separately; the
        # wire Content-Length includes chunk headers + signatures.
        declared_size = (len(body) if isinstance(body, (bytes, bytearray))
                         else int(h.get("x-amz-decoded-content-length")
                                  or h.get("content-length") or 0))
        if declared_size > MAX_OBJECT_SIZE:
            raise S3Error("EntityTooLarge")
        compress = self._compressing() and cz.is_compressible(
            key, h.get("content-type", ""), declared_size)
        if streams.is_reader(body):
            # Hard cap BEFORE any draining: an undeclared-length
            # (chunked TE) body must not grow past the object limit, in
            # memory or on disk.
            body = streams.MaxSizeReader(
                body, MAX_OBJECT_SIZE,
                exc=lambda msg: S3Error("EntityTooLarge"))
            if (h.get("content-md5") or extract.is_snowball_put(headers)
                    or compress or any(h.get(k) for k in _SSE_HEADERS)):
                body = streams.ensure_bytes(body)
                declared_size = len(body)
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
        # An incoming replica (the server strips the marker from callers
        # without s3:ReplicateObject) is stored REPLICA, which GET and
        # HEAD report and which replicates no further (the active-active
        # loop guard), under the source's version id and mod time.
        is_replica = h.get(repl.STATUS_KEY) == "REPLICA"
        put_kw = {}
        if is_replica:
            metadata[repl.STATUS_KEY] = "REPLICA"
            try:
                mtime = int(h.get(repl.REPL_MTIME_HEADER) or 0)
            except ValueError:
                mtime = 0
            if mtime:
                put_kw["mod_time_ns"] = mtime
        parity = self._parity_for_request(h, metadata)

        # Quota enforcement (cf. enforceBucketQuotaHard,
        # cmd/bucket-quota.go).
        quota_raw = self.meta.get(bucket, "quota")
        if quota_raw is not None:
            qcfg = bq.parse_quota_config(quota_raw)
            reason = bq.check_quota(self.pools, bucket, declared_size, qcfg,
                                    self.scanner)
            if reason:
                raise S3Error("QuotaExceeded", reason)
            if streams.is_reader(body) and not declared_size \
                    and qcfg.get("quota", 0) > 0:
                # Undeclared-length stream on a quota'd bucket: cap at
                # the remaining allowance so chunked TE can't bypass it.
                remaining = max(0, qcfg["quota"]
                                - bq.current_bucket_bytes(
                                    self.pools, bucket, self.scanner))
                body = streams.MaxSizeReader(
                    body, remaining,
                    exc=lambda msg: S3Error("QuotaExceeded", msg))
        versioned = self.bucket_versioning_enabled(bucket)
        if is_replica and versioned and h.get(repl.REPL_VID_HEADER):
            put_kw["version_id"] = h[repl.REPL_VID_HEADER]
        self._lock_gate(bucket, key, h, metadata, versioned)
        # An unversioned overwrite of a transitioned stub destroys it:
        # its tier copy is freed once the new version stands.
        replaced = self._tiered_version(bucket, key) \
            if not versioned else None
        # The transforms: compress, then seal (the reference composes
        # them so, cf. cmd/object-api-utils.go:903 and
        # cmd/encryption-v1.go:303).
        stored = body
        transform_meta: dict = {}
        if compress and cz.is_compressible(
                key, metadata.get("content-type", ""), len(body)):
            stored, cu = cz.compress(stored)
            transform_meta.update(cu)
        try:
            stored, su = sse.encrypt_for_put(stored, h, self.kms, bucket,
                                             key)
        except sse.SSEError as e:
            raise S3Error("InvalidArgument", str(e)) from None
        transform_meta.update(su)
        if transform_meta:
            transform_meta[_CLIENT_SIZE_KEY] = str(len(body))
            metadata.update(transform_meta)
        try:
            with _span("engine.put_object"):
                fi = self.pools.put_object(bucket, key, stored,
                                           metadata=metadata,
                                           versioned=versioned,
                                           parity=parity, **put_kw)
        except StorageError as e:
            raise from_storage_error(e) from None
        if replaced is not None:
            self.tier_mgr.on_version_deleted(replaced)
        etag = fi.metadata.get("etag", "")
        self._publish_event("s3:ObjectCreated:Put", bucket, key,
                            size=_logical_size(fi), etag=etag,
                            version_id=fi.version_id)
        if self.replication is not None and not is_replica:
            self.replication.on_put(bucket, key,
                                    version_id=fi.version_id or "")
        resp_headers = {"ETag": f'"{etag}"'}
        if fi.version_id:
            resp_headers["x-amz-version-id"] = fi.version_id
        return Response(200, headers=resp_headers)

    def _tiered_version(self, bucket: str, key: str,
                        version_id: str = "") -> FileInfo | None:
        """The version a write or hard delete would destroy, when it is
        a transitioned stub (its tier copy must then be freed)."""
        if self.tier_mgr is None:
            return None
        try:
            prev = self.pools.head_object(bucket, key, version_id)
        except StorageError:
            return None
        return prev if self.tier_mgr.is_transitioned(prev) else None

    def _copy_source(self, h: dict[str, str]) -> tuple[str, str, str]:
        src = urllib.parse.unquote(h["x-amz-copy-source"]).lstrip("/")
        src_bucket, _, src_key = src.partition("/")
        src_vid = ""
        if "?versionId=" in src_key:
            src_key, _, src_vid = src_key.partition("?versionId=")
        return src_bucket, src_key, src_vid

    def _read_source(self, bucket: str, key: str, version_id: str):
        """(fi, stored bytes) of a copy source.  A transitioned stub is
        not a source until it is restored (InvalidObjectState, as S3
        answers for an archived object); a live temporary restore's hot
        copy is, without the tier keys."""
        try:
            fi, data = self.pools.get_object(bucket, key,
                                             version_id=version_id)
        except StorageError as e:
            raise from_storage_error(e) from None
        if fi.metadata.get(TIER_NAME_KEY):
            if self._tiered(fi) or self.tier_mgr is None:
                raise S3Error("InvalidObjectState",
                              "the object is in its tier: restore it "
                              "first")
            fi.metadata = {k: v for k, v in fi.metadata.items()
                           if k not in _TIER_META_KEYS}
        return fi, data

    def _copy_object(self, bucket: str, key: str,
                     h: dict[str, str]) -> Response:
        src_bucket, src_key, src_vid = self._copy_source(h)
        fi, data = self._read_source(src_bucket, src_key, src_vid)
        metadata = dict(fi.metadata)
        metadata.pop("etag", None)
        if h.get("x-amz-metadata-directive", "COPY") == "REPLACE":
            # REPLACE swaps the USER metadata only; the internal keys
            # (the transforms' keys describe the stored bytes) ride
            # along.
            metadata = {k: v for k, v in h.items()
                        if k.startswith(AMZ_META_PREFIX)}
            metadata.update({k: v for k, v in fi.metadata.items()
                             if k.startswith("x-mtpu-internal-")})
        data = self._reseal(h, fi, data, metadata, src_bucket, src_key,
                            bucket, key)
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
        # The copy's replication status is its own (the source's would
        # make it a REPLICA, or claim a copy that never ran); the lock
        # and replication apply to the copy as to a PUT, which the JAX
        # package's copy skips.
        metadata.pop(repl.STATUS_KEY, None)
        self._lock_gate(bucket, key, h, metadata, versioned)
        try:
            out = self.pools.put_object(bucket, key, bytes(data),
                                        metadata=metadata,
                                        versioned=versioned, parity=parity)
        except StorageError as e:
            raise from_storage_error(e) from None
        if self.replication is not None:
            self.replication.on_put(bucket, key,
                                    version_id=out.version_id or "")
        root = ET.Element("CopyObjectResult", xmlns=S3_NS)
        _el(root, "ETag", f'"{out.metadata.get("etag", "")}"')
        _el(root, "LastModified", _iso(out.mod_time_ns))
        return Response(200, _xml(root), {"Content-Type": "application/xml"})

    def _reseal(self, h: dict[str, str], fi: FileInfo, data, metadata: dict,
                src_bucket: str, src_key: str, bucket: str, key: str):
        """A copy's stored bytes.  Ciphertext is never copied as it is
        (an SSE-C object key is bound to the source's path, and a sealed
        destination needs a fresh seal): a sealed source is unsealed
        with the key of the x-amz-copy-source-...-customer-* headers,
        and the copy sealed as the request asks, an SSE-S3 source
        staying SSE-S3 unless it asks otherwise (as AWS does).  The
        compressed bytes stay compressed.  Updates `metadata`."""
        src_algo = fi.metadata.get(sse.META_ALGO, "")
        try:
            dst_wants_sse = (sse.parse_ssec_key(h) is not None
                             or h.get(sse.H_SSE, "") in ("AES256",
                                                         "aws:kms"))
        except sse.SSEError as e:
            raise S3Error("InvalidArgument", str(e)) from None
        if not (src_algo or dst_wants_sse):
            return data
        src_h = {hk: h.get(ck, "") for hk, ck in _COPY_SOURCE_SSEC.items()}
        try:
            data = sse.decrypt_for_get(bytes(data), fi.metadata, src_h,
                                       self.kms, src_bucket, src_key)
        except sse.SSEError as e:
            raise S3Error("AccessDenied", str(e)) from None
        for mk in (sse.META_ALGO, sse.META_KEY_MD5, sse.META_SSEC_IV,
                   sse.META_KMS_KEY_ID, sse.META_SEALED_KEY,
                   sse.META_ACTUAL_SIZE):
            metadata.pop(mk, None)
        eff_h = dict(h)
        if src_algo == "SSE-S3" and not dst_wants_sse:
            eff_h[sse.H_SSE] = "AES256"
        plain_len = len(data)            # after compression, if any
        try:
            data, su = sse.encrypt_for_put(data, eff_h, self.kms, bucket,
                                           key)
        except sse.SSEError as e:
            raise S3Error("InvalidArgument", str(e)) from None
        metadata.update(su)
        if not cz.is_compressed(metadata):
            # The client size is the plaintext's (sealing adds bytes); a
            # plain copy has none.
            if su:
                metadata[_CLIENT_SIZE_KEY] = str(plain_len)
            else:
                metadata.pop(_CLIENT_SIZE_KEY, None)
        return data

    def delete_object(self, bucket: str, key: str, query: dict,
                      headers: dict[str, str] | None = None) -> Response:
        version_id = query.get("versionId", [""])[0]
        versioned = self.bucket_versioning_enabled(bucket)
        hl = {k.lower(): v for k, v in (headers or {}).items()}
        # Only a hard delete (a version id, or an unversioned bucket)
        # destroys data: that is what retention and a legal hold refuse
        # (cf. enforceRetentionForDeletion); a delete marker keeps the
        # version readable.
        tiered = None
        if version_id or not versioned:
            self._refuse_locked(bucket, key, version_id, hl.get(
                "x-amz-bypass-governance-retention", "") == "true")
            tiered = self._tiered_version(bucket, key, version_id)
        try:
            dm = self.pools.delete_object(bucket, key, version_id, versioned)
        except StorageError as e:
            err = from_storage_error(e)
            # S3 DELETE of a nonexistent key is a 204 no-op.
            if err.api.code == "NoSuchKey":
                return Response(204)
            raise err from None
        # Only a hard delete frees the tier copy; a delete marker keeps
        # the version readable.
        if tiered is not None and dm is None:
            self.tier_mgr.on_version_deleted(tiered)
        self._publish_event(
            "s3:ObjectRemoved:DeleteMarkerCreated" if dm is not None
            else "s3:ObjectRemoved:Delete", bucket, key,
            version_id=version_id)
        # Only a delete of the CURRENT object reaches the target (removing
        # a noncurrent version must not take down the target's live
        # copy), and a REPLICA-marked delete, a peer's worker's, does not
        # bounce back.
        if self.replication is not None and not version_id \
                and hl.get(repl.STATUS_KEY) != "REPLICA":
            self.replication.on_delete(
                bucket, key,
                version_id=(dm.version_id or "") if dm is not None else "",
                delete_marker=dm is not None)
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

    def put_object_retention(self, bucket: str, key: str, query: dict,
                             body: bytes,
                             headers: dict | None = None) -> Response:
        fi = self._head_for_update(bucket, key, query)
        try:
            new_meta = ol.parse_retention_xml(body)
        except ET.ParseError:
            raise S3Error("MalformedXML") from None
        if ol._parse_date(new_meta.get(ol.RET_DATE_KEY, "")) is None:
            raise S3Error("InvalidRetentionDate")
        hl = {k.lower(): v for k, v in (headers or {}).items()}
        bypass = hl.get("x-amz-bypass-governance-retention", "") == "true"
        # COMPLIANCE retention only extends; GOVERNANCE needs the bypass
        # to shorten (cf. enforceRetentionBypass).
        if ol.is_retention_active(fi.metadata):
            old_mode = fi.metadata.get(ol.RET_MODE_KEY, "").upper()
            old_until = ol._parse_date(fi.metadata.get(ol.RET_DATE_KEY, ""))
            new_until = ol._parse_date(new_meta[ol.RET_DATE_KEY])
            shrinking = old_until and new_until and new_until < old_until
            if old_mode == "COMPLIANCE" and shrinking:
                raise S3Error("ObjectLocked",
                              "compliance retention cannot be shortened")
            if old_mode == "GOVERNANCE" and shrinking and not bypass:
                raise S3Error("ObjectLocked",
                              "governance retention needs bypass")
        self._update_metadata(bucket, key, fi, new_meta)
        return Response(200)

    def get_object_retention(self, bucket: str, key: str,
                             query: dict) -> Response:
        fi = self._head_for_update(bucket, key, query)
        if not fi.metadata.get(ol.RET_MODE_KEY):
            raise S3Error("NoSuchObjectLockConfiguration")
        return Response(200, ol.retention_xml(fi.metadata),
                        {"Content-Type": "application/xml"})

    def put_object_legal_hold(self, bucket: str, key: str, query: dict,
                              body: bytes) -> Response:
        fi = self._head_for_update(bucket, key, query)
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML") from None
        status = (root.findtext("Status")
                  or root.findtext(f"{{{S3_NS}}}Status") or "OFF")
        self._update_metadata(bucket, key, fi,
                              {ol.LEGAL_HOLD_KEY: status.upper()})
        return Response(200)

    def get_object_legal_hold(self, bucket: str, key: str,
                              query: dict) -> Response:
        fi = self._head_for_update(bucket, key, query)
        root = ET.Element("LegalHold", xmlns=S3_NS)
        _el(root, "Status",
            "ON" if ol.is_legal_hold_on(fi.metadata) else "OFF")
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
        # The target's copy picks up the new metadata (tags, retention,
        # legal hold; cf. replicateMetadata); a replica never
        # re-replicates.
        if self.replication is not None \
                and meta.get(repl.STATUS_KEY) != "REPLICA":
            self.replication.on_metadata(bucket, key,
                                         version_id=fi.version_id or "")

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
            # The JAX package ignores these headers and stores the parts
            # plain; the port refuses rather than store plaintext a
            # client asked to have sealed (ROADMAP.md standing records).
            raise S3Error("NotImplemented", "server-side encryption of a "
                          "multipart upload is not served")
        metadata = {k: v for k, v in h.items()
                    if k.startswith(AMZ_META_PREFIX)}
        if "content-type" in h:
            metadata["content-type"] = h["content-type"]
        # Storage class fixes the stripe geometry for EVERY part now
        # (cf. newMultipartUpload, cmd/erasure-multipart.go:39).
        parity = self._parity_for_request(h, metadata)
        # The default retention stamps the upload now; the overwrite
        # check runs at complete, when the object is published.
        cfg = self._lock_config(bucket)
        if cfg is not None:
            metadata.update(ol.default_retention_metadata(cfg))
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
        object, or a byte range of it.  The source is read as plaintext
        (through its tier, unsealed with the x-amz-copy-source-...-
        customer-* key, decompressed): the part joins a new stream of its
        own, and copied and uploaded parts complete byte-identical."""
        src_bucket, src_key, src_vid = self._copy_source(h)
        if not src_bucket or not src_key:
            raise S3Error("InvalidArgument", "bad x-amz-copy-source")
        src_h = {hk: h.get(ck, "") for hk, ck in _COPY_SOURCE_SSEC.items()}
        fi, data = self._read_plaintext(src_bucket, src_key, src_vid, src_h)
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
        # The same quota gate as put_object: multipart must not be a
        # quota bypass (the reference runs it in
        # CompleteMultipartUploadHandler too).
        quota_raw = self.meta.get(bucket, "quota")
        if quota_raw is not None:
            try:
                stored = {p.number: p
                          for p in self.pools.list_parts(bucket, key,
                                                         upload_id)}
            except StorageError as e:
                raise from_storage_error(e) from None
            total = sum(stored[n].size for n, _ in parts if n in stored)
            reason = bq.check_quota(self.pools, bucket, total,
                                    bq.parse_quota_config(quota_raw),
                                    self.scanner)
            if reason:
                raise S3Error("QuotaExceeded", reason)
        # The overwrite check (the upload took its retention at create).
        self._lock_gate(bucket, key, {}, {}, versioned)
        try:
            with _span("engine.complete_multipart"):
                fi = self.pools.complete_multipart_upload(
                    bucket, key, upload_id, parts, versioned=versioned)
        except StorageError as e:
            raise from_storage_error(e) from None
        self._publish_event(
            "s3:ObjectCreated:CompleteMultipartUpload", bucket, key,
            size=_logical_size(fi), etag=fi.metadata.get("etag", ""),
            version_id=fi.version_id)
        if self.replication is not None:
            self.replication.on_put(bucket, key,
                                    version_id=fi.version_id or "")
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
