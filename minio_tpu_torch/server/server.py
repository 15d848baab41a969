"""The single-node S3 HTTP server: routing, auth dispatch, streamed bodies.

The slim port of minio_tpu/server/server.py (the reference's
internal/http server + cmd/routers.go:82 + cmd/auth-handler.go:281): a
threading HTTP server whose one dispatch point classifies a request
(presigned v2/v4 / header-signed v2/v4 / streaming-signed / anonymous),
verifies its signature against root, IAM users, service accounts and
STS credentials, authorizes it by identity policy (an anonymous one by
bucket policy) before any handler runs, then routes on (method, path
shape, query) the way cmd/api-router.go:175 registers routes.  Object
PUTs and parts stream from the socket into the erasure engine; GETs
stream back in device batches.  Browser POST-policy uploads carry their
own signature and are authorized from the form.

The admin API serves IAM's users, groups, policies and service accounts,
heal sequences (`heal`: POST starts one, GET lists their status), `info`
(drives, sets and the scanner's usage), `datausage`, the pools (`pools`;
`pool/add` attaches a pool to the running deployment, live; and
`pool/decommission` with action start, pause, resume or cancel, GET for
status), the replication targets (`bucket-remote`: POST registers one,
GET lists them, DELETE drops one by ARN) and the replication plane
(`replication`: GET its counters and, with `bucket=`, the bucket's
resync; POST `{"op": "resync", "bucket": ...}` starts or resumes one)
and the server configuration (`config`: GET the subsystems, or with
`subsys=` one subsystem's values, POST `{"subsys", "key", "value"}` sets
one, and a `notify_*` target it enables registers at once;
`config-help`), the tiers (`tier`: GET lists them with their usage and
the journal's pending records, POST registers one, `{"name", "type":
"fs" | "s3" | "pool", ...}`, PUT replaces one, DELETE `?name=` drops
one) and the ILM plane (`ilm`: GET the tier manager's counters, POST
`{"op": "drain"}` drains the tier journal and `{"bucket", "object",
"tier"}` transitions one object) and the KMS (`kms/status`,
`kms/key/list`, POST `kms/key/create?key-id=`, `kms/key/status?key-id=`);
POST / is STS
(AssumeRole, WebIdentity and ClientGrants through OIDC, LDAPIdentity,
Certificate over mTLS).  Objects serve ?retention and ?legal-hold, and
`POST ?restore` copies a transitioned version back from its tier: for
good, or with `<RestoreRequest><Days>N</Days></RestoreRequest>` for N
days, after which the scanner drops the hot copy (bucket/tier.py), and
`POST ?select&select-type=2` runs S3 Select over the object's plaintext
(s3select/).

Bucket notifications (bucket/notify.py): the server's
NotificationSystem holds the buckets' `?notification` rules and the
targets the configuration's enabled `notify_*` subsystems build at boot
(bucket/event_targets.targets_from_config; they park in
MTPU_NOTIFY_STORE_DIR while their service is down).
ListenNotification streams the process's events as NDJSON:
`GET /{bucket}?events=...` (with `prefix`, `suffix`, `duration`) and
`GET /minio/listen` for every bucket.  In the worker pool each worker
streams the events it served.

What answers NotImplemented, with its ROADMAP.md Queue A item: the
other admin endpoints and metrics (but the worker pool's, the hot
tier's, the metadata plane's, the admission plane's, the notification
targets' and a cluster node's families at /minio/v2/metrics/node).
Spans, the rest of the metrics, the audit trail and federation stay in
the JAX package for now.

In a worker pool a pool change reaches every worker through
pool-topology.json and the shared topology generation (server/
topology.py); a drain's mover runs in worker 0 alone, another worker
records the admin's request in the drain's journal, and every worker
answers status from the journal (background/decom.py).

A cluster node (server/cluster.py) mounts its RPC router
(`rpc_router`): POST /minio/rpc/... goes to the storage, lock and peer
planes with their bearer token and msgpack, before the drain gate,
admission and S3 auth, as the reference serves them on its main port.
Its front door starts before the object layer exists: until
`bind_object_layer`, S3 requests answer 503 ServerNotInitialized and
/minio/health/ready 503.  /minio/health/cluster answers 200 while every
erasure set keeps write quorum (observe/health.py), with `maintenance=N`
counting N more drives as gone.

Admission (server/qos.py) runs around dispatch, after the drain gate:
every request but /minio/health/, /minio/admin/, /minio/v2/metrics and
/minio/listen (a bucket's listen stream does) takes a slot of the
fork-shared plane or is shed with 503
SlowDown, Retry-After: 1, and a closed connection; after authentication
the tenant's req/s and bytes/s buckets and the bucket's bandwidth
budget (its quota config) may refuse it the same way, and a response's
bytes are charged to both after it is sent.

Responses leave through the zero-copy writer while MTPU_ZEROCOPY is on
(ops/zerocopy.py): the header block, built by the same send_header
calls, goes out with the body in one gathered sendmsg, and a verified
sendfile plan (a whole k=1 GET, ErasureSet.sendfile_plan) by
os.sendfile.  TLS, chunked framing and MTPU_ZEROCOPY=0 keep the buffered
writer, byte for byte the same on the wire.
"""

from __future__ import annotations

import datetime
import json
import os
import secrets
import socket
import ssl
import sys
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..bucket import notify as _notify
from ..bucket import replication as repl
from ..engine.pools import ServerPools
from ..iam.iam import Identity
from ..iam.ldap import LDAPError
from ..iam.oidc import OIDCError
from ..iam.policy import Policy, PolicyError
from ..observe.health import cluster_health
from ..ops import zerocopy as zc
from ..storage.errors import StorageError
from ..utils import streams
from . import postpolicy, qos as _qos, sigv2
from .api_errors import S3Error, from_storage_error
from .handlers import Response, S3Handlers, error_response, unported
from .sigv4 import (STREAMING_PAYLOAD, UNSIGNED_PAYLOAD, Credentials,
                    StreamingSigV4Reader, decode_streaming_body,
                    verify_header_signature, verify_presigned)

MAX_HEADER_BODY = 5 * 1024 ** 3      # max single PUT (5 GiB part limit)
STS_NS = "https://sts.amazonaws.com/doc/2011-06-15/"


def _family(out: list, name: str, help_: str, rows) -> None:
    """One Prometheus gauge family: rows of (labels dict, value)."""
    out.append(f"# HELP {name} {help_}")
    out.append(f"# TYPE {name} gauge")
    for labels, v in rows:
        lab = ",".join(f'{k}="{v2}"' for k, v2 in labels.items())
        out.append(f"{name}{{{lab}}} {v}" if lab else f"{name} {v}")


#: mtpu_hotcache_* families: (stats key, family, help), the JAX
#: package's names (minio_tpu/observe/metrics.py)
_HOT_FAMILIES = (
    ("hits", "mtpu_hotcache_hits_total", "Hot-object cache hits"),
    ("misses", "mtpu_hotcache_misses_total", "Hot-object cache misses"),
    ("meta_hits", "mtpu_hotcache_meta_hits_total",
     "Metadata-only hot-object cache hits (HEAD)"),
    ("hit_ratio", "mtpu_hotcache_hit_ratio", "Hot-object cache hit ratio"),
    ("fills", "mtpu_hotcache_fills_total",
     "Verified reads admitted to the hot-object cache"),
    ("evictions", "mtpu_hotcache_evictions_total",
     "Hot-object cache CLOCK evictions"),
    ("bypassed", "mtpu_hotcache_bypassed_total",
     "Reads that bypassed the hot-object cache fill"),
    ("stale_gen", "mtpu_hotcache_stale_generation_total",
     "Hot-object entries or fills dropped by a generation bump"),
    ("invalidations", "mtpu_hotcache_invalidations_total",
     "Bucket generation bumps (mutations)"),
    ("ghost_defers", "mtpu_hotcache_ghost_defers_total",
     "First misses the two-hit filter kept out"),
    ("entries", "mtpu_hotcache_entries", "Hot-object cache entries"),
    ("cached_bytes", "mtpu_hotcache_usage_bytes",
     "Body bytes held by the hot-object cache"),
    ("segment_bytes", "mtpu_hotcache_total_bytes",
     "Hot-object cache segment size"),
    ("in_use_bytes", "mtpu_hotcache_arena_in_use_bytes",
     "Hot-object arena bytes in use, pinned runs included"))


#: mtpu_meta_* families: (counter, family, help), the JAX package's
#: names (minio_tpu/observe/metrics.py) and two of the port's (the keys
#: the read rounds served, the largest group commit)
_META_FAMILIES = (
    ("meta_publishes", "mtpu_meta_publishes_total",
     "xl.meta publishes across all drives (solo + batched)"),
    ("meta_fsyncs", "mtpu_meta_fsyncs_total",
     "syncs paying for metadata publishes (group commit amortizes a "
     "journal fsync and a drive sync over a whole batch)"),
    ("fsyncs_per_object", "mtpu_meta_fsyncs_per_object",
     "Amortized fsyncs per xl.meta publish (oracle: 1.0)"),
    ("meta_group_commits", "mtpu_meta_group_commits_total",
     "Group-committed metadata batches (one journal fsync and one "
     "drive sync each)"),
    ("meta_group_items", "mtpu_meta_group_items_total",
     "xl.meta publishes carried inside group commits"),
    ("batch_occupancy", "mtpu_meta_batch_occupancy",
     "Mean publishes per group commit"),
    ("meta_group_max", "mtpu_meta_group_items_max",
     "Most publishes in one group commit"),
    ("meta_journal_replays", "mtpu_meta_journal_replays_total",
     "xl.meta entries republished from metadata journal segments at "
     "boot recovery"),
    ("meta_read_requests", "mtpu_meta_read_requests_total",
     "Engine metadata reads (quorum _read_metadata calls)"),
    ("read_rounds", "mtpu_meta_read_rounds_total",
     "Per-drive metadata read dispatches serving those requests"),
    ("read_keys", "mtpu_meta_read_keys_total",
     "Metadata lookups those dispatches served"),
    ("fanouts_per_request", "mtpu_meta_read_fanouts_per_request",
     "Drive dispatches per metadata read (oracle: N drives; coalescing "
     "drives it below 1)"),
    ("trim_hits", "mtpu_meta_trim_hits_total",
     "K+1-trimmed read fan-outs accepted at quorum"),
    ("trim_fallbacks", "mtpu_meta_trim_fallbacks_total",
     "Trimmed fan-outs that widened to the remaining drives"),
    ("lane_dispatches", "mtpu_meta_lane_dispatches_total",
     "Metadata lane dispatcher rounds"),
    ("inline_ops", "mtpu_meta_inline_ops_total",
     "Lane submits executed inline on the caller's thread (idle fast "
     "path)"))


def meta_counters() -> dict:
    """This process's metadata-plane counters (ops/metalanes.py, the
    drives' publishes, the engine's elections), with the ratios."""
    from ..engine import erasure_set
    from ..ops import metalanes
    from ..storage import drive
    c = {**drive.stats(), **metalanes.counters(),
         "meta_read_requests": erasure_set.stats()["meta_read_requests"]}
    c["fsyncs_per_object"] = (c["meta_fsyncs"] / c["meta_publishes"]
                              if c["meta_publishes"] else 0.0)
    c["batch_occupancy"] = (c["meta_group_items"] / c["meta_group_commits"]
                            if c["meta_group_commits"] else 0.0)
    c["fanouts_per_request"] = (c["read_rounds"] / c["meta_read_requests"]
                                if c["meta_read_requests"] else 0.0)
    return c


def qos_families(out: list, plane) -> None:
    """The admission plane's mtpu_qos_* families, the JAX package's names
    (minio_tpu/observe/metrics.py): pool-wide, from the shared slab."""
    st = plane.stats()
    for key, name, help_ in (
            ("inflight", "mtpu_qos_requests_inflight",
             "Admission slots currently held (pool-wide: the slab is "
             "fork-shared)"),
            ("waiting", "mtpu_qos_queue_depth",
             "Requests waiting in the admission deadline queue"),
            ("pressure", "mtpu_qos_pressure",
             "Admission occupancy EMA in [0,1] — the signal background "
             "planes yield to"),
            ("queue_wait_seconds", "mtpu_qos_queue_wait_seconds_total",
             "Summed admission-queue wait of requests that were "
             "eventually admitted"),
            ("tenant_throttled", "mtpu_qos_tenant_throttled_total",
             "Requests refused by per-tenant token buckets (req/s or "
             "bandwidth)"),
            ("bucket_throttled", "mtpu_qos_bucket_throttled_total",
             "Requests refused by per-bucket bandwidth budgets")):
        _family(out, name, help_, [({}, st[key])])
    _family(out, "mtpu_qos_admitted_total",
            "Requests admitted through the overload plane by tenant class",
            [({"tenant_class": c}, row["admitted"])
             for c, row in st["classes"].items()])
    _family(out, "mtpu_qos_shed_total",
            "Requests shed with 503 SlowDown by tenant class",
            [({"tenant_class": c}, row["shed"])
             for c, row in st["classes"].items()])
    _family(out, "mtpu_qos_shed_reason_total",
            "Admission sheds by cause (queue: bounded queue full; "
            "deadline: MTPU_REQUESTS_DEADLINE_MS expired waiting)",
            [({"reason": "queue"}, st["shed_queue"]),
             ({"reason": "deadline"}, st["shed_deadline"])])
    _family(out, "mtpu_qos_bg_yields_total",
            "Background-plane yields to foreground pressure (shrunk "
            "batch concurrency + paced batches)",
            [({"plane": "all"}, st["bg_yields"])]
            + [({"plane": n}, k)
               for n, k in st["bg_yields_by_plane"].items()])


#: mtpu_notify_* families: (counter, family, help)
NOTIFY_FAMILIES = (
    ("sent", "mtpu_notify_events_sent_total",
     "Events handed to notification targets by matching rules"),
    ("delivered", "mtpu_notify_events_delivered_total",
     "Events their target acknowledged (first try or retried)"),
    ("parked", "mtpu_notify_events_parked_total",
     "Events parked in a target's queue store while it was down"),
    ("retried", "mtpu_notify_events_retried_total",
     "Parked events a retry pass delivered"),
    ("dropped", "mtpu_notify_events_dropped_total",
     "Events whose rule names an ARN with no registered target"),
    ("backlog", "mtpu_notify_backlog_events",
     "Events parked in this process's queue stores now"))


def notify_counters(notify) -> dict:
    """This process's event counters and its targets' backlog."""
    c = _notify.stats()
    c["backlog"] = notify.backlog_depth() if notify is not None else 0
    return c


def node_families(tier, worker_id: int | None = None,
                  kernels: bool = False, qos_plane=None,
                  cluster_node=None, notify=None) -> str:
    """The hot tier's families (pool-wide: its counters live in shared
    memory), the admission plane's (pool-wide too), this process's
    zero-copy sends, metadata plane and notification targets (each
    labelled with the worker in a pool), a cluster node's peer liveness
    and RPC client counters and, with `kernels`, this process's kernel
    launches and items."""
    out: list[str] = []
    if cluster_node is not None:
        from ..rpc import rest
        peers = cluster_node.peer_info()
        _family(out, "mtpu_peer_online", "Peer node answering its RPC planes",
                [({"peer": p["endpoint"]}, int(p["online"])) for p in peers])
        _family(out, "mtpu_peer_transitions_total",
                "Online/offline flips of the peer's RPC endpoint",
                [({"peer": p["endpoint"]}, p["transitions"]) for p in peers])
        rs = rest.stats()
        _family(out, "mtpu_rpc_retries_total",
                "Idempotent RPCs retried on a transient transport fault",
                [({}, rs["retries"])])
    if qos_plane is not None:
        qos_families(out, qos_plane)
    if tier is not None:
        st = tier.stats()
        for key, name, help_ in _HOT_FAMILIES:
            _family(out, name, help_, [({}, st[key])])
    lab = {} if worker_id is None else {"worker": worker_id}
    mc = meta_counters()
    for key, name, help_ in _META_FAMILIES:
        v = mc[key]
        _family(out, name, help_,
                [(lab, round(v, 6) if isinstance(v, float) else v)])
    nc = notify_counters(notify)
    for key, name, help_ in NOTIFY_FAMILIES:
        _family(out, name, help_, [(lab, nc[key])])
    zs = zc.stats()
    for key, help_ in (
            ("sendmsg", "Responses sent by one gathered sendmsg"),
            ("sendmsg_bytes", "Body bytes sent by gathered sendmsg"),
            ("sendfile", "Responses sent by verified sendfile plans"),
            ("sendfile_bytes", "Body bytes sent by sendfile"),
            ("hot_views", "Hot-tier hits served as shared-arena views"),
            ("hot_view_bytes", "Body bytes served as shared-arena views"),
            ("fallbacks", "Verified plans sent through userspace")):
        _family(out, f"mtpu_zerocopy_{key}_total", help_, [(lab, zs[key])])
    if kernels:
        from ..ops import erasure_cuda, fused, highwayhash_cuda, mxhash_torch
        launches = {"gf_matmul": erasure_cuda.LAUNCHES,
                    "hh256": highwayhash_cuda.LAUNCHES,
                    "mxh256": mxhash_torch.LAUNCHES}
        _family(out, "mtpu_kernel_launches_total",
                "Kernel launches in this process",
                [({"kernel": k}, v) for k, v in launches.items()])
        _family(out, "mtpu_kernel_items_total",
                "Kernel work items in this process",
                [({"kernel": k}, v) for k, v in fused.ITEMS.items()])
    return "\n".join(out) + "\n"


class S3Server:
    """Owns the object layer, the root credentials, the identity planes
    and the HTTP plumbing.  `certs` = (cert file, key file) serves HTTPS;
    `client_ca` then verifies the client certificates that
    AssumeRoleWithCertificate reads.  `iam` (an iam.iam.IAMSys) holds
    the other identities, `oidc` (iam.oidc.OpenIDConfig) and `ldap`
    (iam.ldap.LDAPConfig) the STS identity providers; without `iam`
    only root authenticates and policy is not consulted.

    In the pre-fork pool (server/workers.py) each worker binds the
    shared port with `reuse_port`; `worker_plane` (a WorkerPlane) and
    `worker_id` let it count its requests, flag its drain and serve the
    pool's Prometheus families at /minio/v2/metrics/node."""

    def __init__(self, pools: ServerPools | None, creds: Credentials,
                 host: str = "127.0.0.1", port: int = 0,
                 certs: tuple[str, str] | None = None, iam=None,
                 oidc=None, ldap=None, client_ca: str | None = None,
                 reuse_port: bool = False, worker_plane=None,
                 worker_id: int | None = None, rpc_router=None,
                 scanner=None, replication=None, notify=None,
                 tier_mgr=None, kms=None, compress_enabled: bool = False):
        self.pools = pools
        # The handlers' KMS (None: crypto/kms.kms_from_env()) and
        # compression switch (server/handlers.py).
        self.kms = kms
        self.compress_enabled = compress_enabled
        # bucket/tier.TierManager (the boot's; None serves no tier and
        # refuses restore and the admin tier API).
        self.tier_mgr = tier_mgr
        # A cluster node's RPC planes, served under this port; its
        # ClusterNode (set by server/cluster.boot_cluster_node) gives the
        # peers' liveness to the metrics.
        self.rpc_router = rpc_router
        self.cluster_node = None
        self.service_event = ""            # "" | "restart" | "stop"
        self.heal_state = None
        self.worker_plane = worker_plane
        self.worker_id = worker_id
        self.creds = creds                 # root credentials (policy bypass)
        self.iam = iam
        self.oidc = oidc
        self.ldap = ldap
        self.client_ca = client_ca
        # The data scanner (background/scanner.py), whose lifecycle is
        # the process's; quota, `info` and `datausage` read its usage.
        self.scanner = scanner
        # The process's bucket/replication.ReplicationPool (the boot's;
        # None replicates nothing), wired from the persisted configs.
        self.replication = replication
        # The bucket/notify.NotificationSystem the handlers publish to:
        # the caller's, or one of this server's own, which shutdown()
        # closes.
        self._own_notify = notify is None
        self.notify = notify if notify is not None else \
            _notify.NotificationSystem()
        # The notify_* settings the registered targets were built from.
        self._notify_seen = None
        # The process that runs decommission movers: one process alone,
        # or the pool's worker 0.
        self.decom_owner = worker_plane is None or worker_id == 0
        self.handlers = None
        if pools is not None:
            self._bind_handlers(pools)
        # Overload plane (server/qos.py): the process-tree singleton; in
        # the pool the supervisor made it before the fork, so every
        # worker draws on one cap.
        self.qos = _qos.get_plane()
        self._qos_bw_cache: dict = {}
        # Graceful drain (the cmd/signals.go role): once draining, new S3
        # requests bounce with 503 + Retry-After while inflight ones
        # finish, through the last byte of every streamed GET.
        self.draining = False
        self._inflight = 0
        self._drain_cv = threading.Condition()
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = "MinioTPU"
            # TCP_NODELAY: the buffered writer sends headers then body,
            # two writes; with Nagle the body waits for the client's
            # delayed ACK of the headers (the zero-copy writer sends
            # both in one sendmsg instead).
            disable_nagle_algorithm = True
            # Per-connection socket timeout: a client that stalls
            # mid-body for this long surfaces as TimeoutError in the
            # dispatch below and maps to a clean RequestTimeout.
            timeout = float(os.environ.get("MTPU_SOCKET_TIMEOUT",
                                           "60") or 60)

            def log_message(self, fmt, *args):  # quiet
                pass

            def _respond(self, resp: Response):
                body = resp.body or b""
                chunked = resp.headers.get(
                    "Transfer-Encoding") == "chunked"
                # The zero-copy writer: plain TCP only (an SSLSocket has
                # no sendmsg, and sendfile cannot cross the record
                # layer), never with chunked framing.
                use_zc = (zc.zerocopy_enabled() and not chunked
                          and not isinstance(self.connection,
                                             ssl.SSLSocket))
                if resp.body_file is not None and not use_zc:
                    # TLS or the oracle: the verified plans through
                    # userspace, the same bytes the sends would carry.
                    try:
                        if self.command != "HEAD":
                            body = b"".join(p.read_all()
                                            for p in resp.body_file)
                    finally:
                        for p in resp.body_file:
                            p.close()
                    resp.body_file = None
                    zc.record("fallbacks")
                self.send_response(resp.status)
                for k, v in resp.headers.items():
                    self.send_header(k, v)
                if "Content-Length" not in resp.headers and not chunked:
                    self.send_header("Content-Length", str(len(body)))
                self.send_header("x-amz-request-id", self.request_id)
                # security headers on every response (the
                # addSecurityHeaders middleware, cmd/generic-handlers.go)
                self.send_header("X-Content-Type-Options", "nosniff")
                self.send_header("X-XSS-Protection", "1; mode=block")
                self.send_header("Content-Security-Policy",
                                 "block-all-mixed-content")
                if use_zc:
                    self._respond_zc(resp, body)
                    return
                self.end_headers()
                if self.command == "HEAD":
                    return
                if resp.body_iter is None:
                    if len(body):
                        self.wfile.write(body)
                    return
                # Streamed body: chunks go socket-ward as they decode; a
                # failure mid-stream can only sever the connection (the
                # headers are gone), as in the reference once the
                # response has begun.
                try:
                    for chunk in resp.body_iter:
                        if not len(chunk):
                            continue
                        if chunked:
                            self.wfile.write(b"%x\r\n" % len(chunk)
                                             + bytes(chunk) + b"\r\n")
                        else:
                            self.wfile.write(chunk)
                    if chunked:
                        self.wfile.write(b"0\r\n\r\n")
                finally:
                    close = getattr(resp.body_iter, "close", None)
                    if close is not None:
                        close()

            def _respond_zc(self, resp: Response, body):
                """The header block end_headers() would flush, taken
                from the same send_response/send_header calls, leaves
                with the first body segment in one sendmsg, or ahead of
                the sendfile runs: the same bytes on the wire in one or
                two syscalls."""
                self._headers_buffer.append(b"\r\n")
                hdr = b"".join(self._headers_buffer)
                self._headers_buffer = []
                sock = self.connection
                if self.command == "HEAD":
                    zc.send_gather(sock, (hdr,))
                    return
                if resp.body_file is not None:
                    try:
                        zc.send_gather(sock, (hdr,))
                        n = sum(zc.send_file(sock, p.fd, p.runs)
                                for p in resp.body_file)
                        zc.record("sendfile", n)
                    finally:
                        for p in resp.body_file:
                            p.close()
                    return
                if resp.body_iter is None:
                    n = zc.send_gather(sock, (hdr, body)) - len(hdr)
                    zc.record("sendmsg", n)
                    return
                try:
                    it = iter(resp.body_iter)
                    first = next(it, None)
                    segs = [hdr] if first is None else [hdr, first]
                    n = zc.send_gather(sock, segs) - len(hdr)
                    for chunk in it:
                        n += zc.send_gather(sock, (chunk,))
                    zc.record("sendmsg", n)
                finally:
                    close = getattr(resp.body_iter, "close", None)
                    if close is not None:
                        close()

            def _handle(self):
                # Drain gate + inflight count around the WHOLE request
                # (dispatch and response write): drain() waits for the
                # count to reach zero, so a SIGTERM never severs a
                # response mid-stream.
                path = urllib.parse.unquote(
                    urllib.parse.urlsplit(self.path).path)
                if path.startswith("/minio/rpc/") and \
                        outer.rpc_router is not None:
                    # An inter-node plane: its bearer token and msgpack,
                    # no S3 signature (cf. the storage REST server's
                    # auth, cmd/storage-rest-server.go).
                    length = int(self.headers.get("Content-Length",
                                                  0) or 0)
                    body = self.rfile.read(length) if length else b""
                    status, out = outer.rpc_router.handle(
                        path, self.headers.get("Authorization", ""), body)
                    self.request_id = secrets.token_hex(8)
                    self._respond(Response(
                        status, out,
                        {"Content-Type": "application/msgpack"}))
                    return
                if outer.draining and not path.startswith("/minio/health/"):
                    self.request_id = secrets.token_hex(8)
                    resp = error_response(
                        S3Error("ServiceUnavailable",
                                "server is draining for shutdown"),
                        path, self.request_id)
                    resp.headers["Retry-After"] = "1"
                    self.close_connection = True
                    try:
                        self._respond(resp)
                    except (BrokenPipeError, ConnectionResetError,
                            TimeoutError):
                        pass
                    return
                # Admission control (server/qos.py): one fork-shared
                # requests-max semaphore with a deadline queue.  Exempt:
                # the health, admin, metrics and listen planes — an
                # operator must be able to see and steer a saturated
                # server (cmd/handler-api.go maxClients exempts its
                # health endpoints the same way).
                qos_slot = False
                if _qos.qos_enabled() and not path.startswith(
                        ("/minio/health/", "/minio/admin/",
                         "/minio/v2/metrics", "/minio/listen")):
                    klass = _qos.tenant_class(
                        _qos.peek_access_key(self.headers))
                    verdict, _ = outer.qos.acquire(klass)
                    if verdict != "ok":
                        self.request_id = secrets.token_hex(8)
                        resp = error_response(
                            S3Error("SlowDown",
                                    "server is at capacity; request "
                                    "shed by admission control"),
                            path, self.request_id)
                        resp.headers["Retry-After"] = "1"
                        self.close_connection = True
                        try:
                            self._respond(resp)
                        except (BrokenPipeError, ConnectionResetError,
                                TimeoutError):
                            pass
                        return
                    qos_slot = True
                with outer._drain_cv:
                    outer._inflight += 1
                if outer.worker_plane is not None:
                    outer.worker_plane.state.note_request(outer.worker_id)
                try:
                    self._handle_inner()
                finally:
                    if qos_slot:
                        outer.qos.release()
                    with outer._drain_cv:
                        outer._inflight -= 1
                        outer._drain_cv.notify_all()

            def _handle_inner(self):
                self.request_id = secrets.token_hex(8)
                # The verified identity of THIS request (handler
                # instances persist across keep-alive requests):
                # _dispatch stamps it once authentication succeeds.
                self.qos_access_key = ""
                parsed = urllib.parse.urlsplit(self.path)
                path = urllib.parse.unquote(parsed.path)
                query = urllib.parse.parse_qs(parsed.query,
                                              keep_blank_values=True)
                try:
                    if outer.handlers is None and \
                            not path.startswith("/minio/health/"):
                        raise S3Error("ServerNotInitialized")
                    if path.startswith("/minio/") and \
                            not path.startswith("/minio/admin/") and \
                            path != "/minio/listen":
                        resp = outer._dispatch_internal(path, query)
                    else:
                        resp = outer._dispatch(self, path, query)
                except S3Error as e:
                    resp = error_response(e, path, self.request_id)
                    if e.api.code == "SlowDown":
                        # Throttle 503s (tenant/bucket token buckets)
                        # carry the same retry hint as admission sheds.
                        resp.headers["Retry-After"] = "1"
                    # A failed request may leave unread body bytes on
                    # the socket (streaming PUTs); don't reuse it.
                    self.close_connection = True
                except streams.StreamError as e:
                    # Malformed or truncated request body: 400-class,
                    # not a handler crash.
                    resp = error_response(
                        S3Error("IncompleteBody", str(e)), path,
                        self.request_id)
                    self.close_connection = True
                except TimeoutError:
                    # Client stalled mid-body past the socket timeout.
                    resp = error_response(
                        S3Error("RequestTimeout",
                                "client read timed out mid-request"),
                        path, self.request_id)
                    self.close_connection = True
                except (BrokenPipeError, ConnectionResetError):
                    # Client went away mid-body: nothing to tell them.
                    self.close_connection = True
                    return
                except Exception as e:  # noqa: BLE001 — a handler crash
                    resp = error_response(
                        S3Error("InternalError",
                                f"{type(e).__name__}: {e}"),
                        path, self.request_id)
                    self.close_connection = True
                # Post-paid bandwidth accounting: tenant and bucket
                # buckets run a bounded debt (a GET's size is unknown
                # at admission), repaid before the next admit.  The
                # charge is made as the response leaves, before its
                # first byte: a client's next request, on any
                # connection, finds it made.  Both charges short-circuit
                # unless a rate is configured.
                if _qos.qos_enabled() and resp.status < 400:
                    resp_size = (int(resp.headers.get("Content-Length", 0)
                                     or 0)
                                 if resp.body_iter is not None
                                 or resp.body_file is not None
                                 else len(resp.body or b""))
                    nbytes = resp_size + int(
                        self.headers.get("Content-Length", 0) or 0)
                    ak = self.qos_access_key
                    if ak:
                        outer.qos.charge_tenant_bw(
                            ak, _qos.tenant_class(ak), nbytes)
                    req_bucket = ("" if path.startswith("/minio/")
                                  else path.split("/", 2)[1]
                                  if path.count("/") >= 1 else "")
                    if req_bucket:
                        outer.qos.charge_bucket_bw(
                            req_bucket, outer._qos_bucket_rate(req_bucket),
                            nbytes)
                try:
                    self._respond(resp)
                except (BrokenPipeError, ConnectionResetError,
                        TimeoutError):
                    self.close_connection = True
                    return

            do_GET = do_PUT = do_POST = do_DELETE = do_HEAD = _handle

        class _TLSThreadingHTTPServer(ThreadingHTTPServer):
            """TLS handshakes run in the per-connection worker thread:
            wrapping the listening socket would park the accept loop in
            a blocking handshake, letting one silent client stall the
            whole endpoint."""
            ssl_context = None
            # The listen backlog (socketserver's default is 5): a burst
            # of 16 clients connecting at once overflowed it, and the
            # connections past it were reset.
            request_queue_size = 128

            def server_bind(self):
                if reuse_port:
                    # Pre-fork pool: every worker binds the same (host,
                    # port) and the kernel spreads connections over them.
                    self.socket.setsockopt(socket.SOL_SOCKET,
                                           socket.SO_REUSEPORT, 1)
                super().server_bind()

            def finish_request(self, request, client_address):
                if self.ssl_context is None:
                    super().finish_request(request, client_address)
                    return
                request.settimeout(10)       # bound the handshake
                try:
                    request = self.ssl_context.wrap_socket(
                        request, server_side=True)
                    request.settimeout(60)
                except (ssl.SSLError, OSError):
                    try:
                        request.close()
                    except OSError:
                        pass
                    return
                try:
                    super().finish_request(request, client_address)
                finally:
                    # shutdown_request() operates on the ORIGINAL
                    # socket (detached by wrap_socket); close the TLS
                    # socket here so close_notify is sent.
                    try:
                        request.close()
                    except OSError:
                        pass

        self._httpd = _TLSThreadingHTTPServer((host, port), _Handler)
        self.tls = certs is not None
        if certs is not None:
            cert_file, key_file = certs
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert_file, key_file)
            if client_ca:
                # mTLS for AssumeRoleWithCertificate: clients MAY present
                # a certificate; those that do are verified against this
                # CA and their CN names their policy.
                ctx.load_verify_locations(client_ca)
                ctx.verify_mode = ssl.CERT_OPTIONAL
            self._httpd.ssl_context = ctx
        self.port = self._httpd.server_port
        self.host = host
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "S3Server":
        # A short poll keeps shutdown() quick; the loop is idle between.
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()
        return self

    def shutdown(self) -> None:
        """Stop accepting and close the listener; the caller owns the
        object layer (pools.close())."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._own_notify:
            self.notify.close()

    def drain(self, timeout: float | None = None) -> dict:
        """Graceful drain (the cmd/signals.go handleSignals role): new S3
        requests bounce with 503 + Retry-After and /minio/health/ready
        answers 503, then wait for every inflight request, through its
        last response byte, up to MTPU_DRAIN_TIMEOUT seconds.
        Idempotent; the caller still owns shutdown()."""
        if timeout is None:
            timeout = float(os.environ.get("MTPU_DRAIN_TIMEOUT",
                                           "10") or 10)
        t0 = time.monotonic()
        deadline = t0 + timeout
        if self.worker_plane is not None and self.worker_id is not None:
            # Pool mode: any worker's metrics show this one leaving.
            self.worker_plane.state.set_draining(self.worker_id)
        with self._drain_cv:
            self.draining = True
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._drain_cv.wait(timeout=min(left, 0.25))
            leftover = self._inflight
        if self.replication is not None:
            # Compact the intent journal, so the next boot replays a
            # checkpoint, not the tail (the pool itself is the boot's to
            # stop: a cluster node's restart keeps it).
            self.replication.checkpoint()
        return {"draining": True, "leftover": leftover,
                "duration_s": time.monotonic() - t0}

    @property
    def endpoint(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://{self.host}:{self.port}"

    # -- auth ----------------------------------------------------------------

    def _read_body(self, req) -> bytes:
        length = int(req.headers.get("Content-Length", 0) or 0)
        if length > MAX_HEADER_BODY:
            raise S3Error("EntityTooLarge")
        if length:
            return req.rfile.read(length)
        if req.headers.get("Transfer-Encoding", "").lower() == "chunked":
            # HTTP chunked framing (not aws-chunked), bounded like the
            # streamed path.
            return streams.ensure_bytes(self._body_reader(req))
        return b""

    def _lookup_creds(self, access_key: str) -> Credentials | None:
        """Root first, then IAM identities (users, service accounts,
        STS credentials)."""
        if access_key == self.creds.access_key:
            return self.creds
        if self.iam is not None:
            ident = self.iam.lookup(access_key)
            if ident is not None:
                return Credentials(ident.access_key, ident.secret_key,
                                   self.creds.region)
        return None

    def _check_session_token(self, access_key: str, token: str) -> None:
        """STS credentials must present their session token."""
        if self.iam is None:
            return
        ident = self.iam.lookup(access_key)
        if ident is not None and ident.kind == "sts":
            if token != ident.session_token:
                raise S3Error("InvalidAccessKeyId",
                              "missing or wrong session token")

    def _verify_signature(self, req, path: str, query: dict,
                          headers: dict, body: bytes | None):
        """Classify and verify the request's signature from its headers
        and query (cf. checkRequestAuthType, cmd/auth-handler.go:281):
        (payload declaration, access key).  The declaration is SigV4's
        x-amz-content-sha256 for a header-signed request, else None; the
        access key is "" for an anonymous request.  `body` is None on the
        streamed path (the payload hash is checked as it streams)."""
        header_token = req.headers.get("x-amz-security-token", "")
        if "X-Amz-Signature" in query:
            ak = verify_presigned(self._lookup_creds, req.command, path,
                                  query, headers)
            self._check_session_token(
                ak, query.get("X-Amz-Security-Token", [""])[0])
            return None, ak
        if sigv2.is_v2_presigned(query):
            ak = sigv2.verify_presigned_v2(self._lookup_creds,
                                           req.command, path, query,
                                           headers)
            self._check_session_token(
                ak, query.get("X-Amz-Security-Token",
                              query.get("SecurityToken", [""]))[0]
                or header_token)
            return None, ak
        auth = req.headers.get("Authorization", "")
        if not auth:
            # Anonymous: allowed only where the bucket policy grants it
            # (the PolicySys role, cmd/bucket-policy.go); _authorize
            # makes that call with access key "".
            return None, ""
        if sigv2.is_v2_header(auth):
            # V2 signs no payload hash; the body is not verified
            # (exactly the reference's V2 semantics).
            ak = sigv2.verify_header_v2(self._lookup_creds, req.command,
                                        path, query, headers)
            self._check_session_token(ak, header_token)
            return None, ak
        payload_decl, ak = verify_header_signature(
            self._lookup_creds, req.command, path, query, headers, body)
        self._check_session_token(ak, header_token)
        return payload_decl, ak

    def _authenticate(self, req, path: str,
                      query: dict) -> tuple[bytes, str]:
        """Read the body whole, verify the request's signature; returns
        (decoded body, access key), "" for an anonymous request."""
        headers = {k: v for k, v in req.headers.items()}
        headers.setdefault("Host", f"{self.host}:{self.port}")
        body = self._read_body(req)
        payload_decl, ak = self._verify_signature(req, path, query,
                                                  headers, body)
        if payload_decl == STREAMING_PAYLOAD:
            body = decode_streaming_body(self._lookup_creds, headers, body)
        return body, ak

    def _body_reader(self, req):
        """The raw request body as a bounded reader (no buffering)."""
        length = int(req.headers.get("Content-Length", 0) or 0)
        if length > MAX_HEADER_BODY:
            raise S3Error("EntityTooLarge")
        if req.headers.get("Transfer-Encoding", "").lower() == "chunked":
            # No declared length: bound the stream so chunked TE can't
            # bypass the 5 GiB part limit.
            return streams.MaxSizeReader(
                streams.HTTPChunkedReader(req.rfile), MAX_HEADER_BODY,
                exc=lambda msg: S3Error("EntityTooLarge"))
        return streams.LimitedReader(req.rfile, length)

    def _authenticate_streaming(self, req, path: str, query: dict):
        """Auth for stream-eligible requests: verify the signature from
        headers alone and return (body reader, access_key); the body
        never lands in server memory whole, and nothing of it is read
        here, so a request _authorize refuses leaves it on the socket
        (the connection is then closed).  SigV4 signed-payload requests
        get a SHA-256-verifying reader (hash checked at EOF, like the
        reference's hash.Reader); aws-chunked bodies a per-chunk
        signature-verifying decoder."""
        headers = {k: v for k, v in req.headers.items()}
        headers.setdefault("Host", f"{self.host}:{self.port}")
        raw = self._body_reader(req)
        payload_decl, ak = self._verify_signature(req, path, query,
                                                  headers, None)
        if payload_decl == STREAMING_PAYLOAD:
            decoded = StreamingSigV4Reader(self._lookup_creds, headers,
                                           raw)
            declared = int(req.headers.get("x-amz-decoded-content-length",
                                           0) or 0)
            if declared:
                # The declared decoded length is what the handler sizes
                # the object by; hold the stream to it.
                decoded = streams.ExactLengthReader(
                    decoded, declared,
                    exc=lambda msg: S3Error("IncompleteBody", msg))
            return decoded, ak
        if payload_decl not in (None, UNSIGNED_PAYLOAD):
            raw = streams.HashVerifyReader(
                raw, payload_decl,
                exc=lambda msg: S3Error("XAmzContentSHA256Mismatch"))
        return raw, ak

    @staticmethod
    def _stream_eligible(method: str, path: str, query: dict) -> bool:
        """Data PUTs (object body / multipart part) stream; small-body
        subresource PUTs and everything else buffer."""
        if method != "PUT":
            return False
        parts = path.lstrip("/").split("/", 1)
        if len(parts) < 2 or not parts[1]:
            return False                 # bucket-level PUT (config XML)
        return not any(q in query for q in
                       ("tagging", "retention", "legal-hold"))

    # -- dispatch ------------------------------------------------------------

    def bind_object_layer(self, pools: ServerPools, iam=None,
                          scanner=None, replication=None,
                          wire=None) -> None:
        """Install the object layer after a cluster boot: the listener
        was up first so that peers reached this node's planes while it
        waited for the format (cf. cmd/server-main.go:441).  `wire(h)`
        hooks the new handlers up before any request reaches them; the
        node reports ready only once they serve."""
        if scanner is not None:
            self.scanner = scanner
        if replication is not None:
            self.replication = replication
        if iam is not None:
            self.iam = iam
        if self.tier_mgr is None:
            # The tier plane needs the object layer: stand it up now
            # (its journal replayed), as the JAX server does; tiering
            # must not block a boot.
            from ..bucket.tier import TierManager
            try:
                self.tier_mgr = TierManager(pools)
            except Exception as e:  # noqa: BLE001
                print(f"minio_tpu_torch: tier manager: {e}",
                      file=sys.stderr, flush=True)
        self._bind_handlers(pools, wire)
        self.pools = pools

    def _bind_handlers(self, pools: ServerPools, wire=None) -> None:
        """The handlers over the object layer; the scanner applies the
        buckets' lifecycle from their config store, and every bucket
        with a persisted replication config and registered targets
        replicates again (cf. the JAX `_reload_replication`)."""
        h = S3Handlers(pools, self._usage_source(pools),
                       replication=self.replication, notify=self.notify,
                       tier_mgr=self.tier_mgr, kms=self.kms,
                       compress_enabled=self.compress_enabled)
        h.refresh_targets = lambda: self._register_new_targets(h, True)
        if self.scanner is not None:
            self.scanner.attach_config(h.meta, self.tier_mgr)
        if self.replication is not None:
            for bucket in pools.list_buckets():
                self._wire_replication(h, bucket)
        self._register_config_targets(h, pools)
        if wire is not None:
            wire(h)
        self.handlers = h

    def _register_config_targets(self, h: S3Handlers, pools) -> None:
        """Boot-time notification wiring (the JAX server's of the same
        name): every enabled notify_* subsystem's target, parking under
        MTPU_NOTIFY_STORE_DIR (one store for the pool's workers),
        and every bucket's persisted rules.  A bad target config is
        logged, not fatal."""
        self._register_new_targets(h)
        self._load_notification_rules(h, pools)

    def _register_new_targets(self, h: S3Handlers,
                              reread: bool = False) -> None:
        """Register the target of each enabled notify_* subsystem whose
        ARN has none yet (at the boot every one; after a configuration
        set, here or in another process (`reread` loads the stored
        configuration first), the ones it enabled).  Nothing is built
        while the notify_* settings are those of the last registration.
        A target already registered keeps running: a changed setting of
        its subsystem applies at the next boot."""
        import os as _os
        from ..bucket.event_targets import targets_from_config
        store = _os.environ.get("MTPU_NOTIFY_STORE_DIR") or None
        try:
            if reread:
                h.config_sys.load()
            cs = h.config_sys
            seen = tuple((sub, tuple(sorted(cs.get_subsys(sub).items())))
                         for sub in cs.help()["subsystems"]
                         if sub.startswith("notify_"))
            if seen == self._notify_seen:
                return
            for t in targets_from_config(cs, store_dir=store):
                if t.arn in self.notify.targets:
                    close = getattr(t, "close", None)
                    if close is not None:
                        close()
                    continue
                self.notify.register_target(t)
            self._notify_seen = seen
        except Exception as e:  # noqa: BLE001 — not boot-fatal
            print(f"minio_tpu_torch: notify config targets: {e}",
                  file=sys.stderr, flush=True)

    def _load_notification_rules(self, h: S3Handlers, pools) -> None:
        try:
            self.notify.load_rules(h.meta, pools.list_buckets())
        except Exception as e:  # noqa: BLE001 — keep serving
            print(f"minio_tpu_torch: notify rule reload: {e}",
                  file=sys.stderr, flush=True)

    def reload_bucket_configs(self) -> None:
        """Another process (a worker of the pool, a cluster node) stored
        or deleted a bucket config or the server configuration: reread
        the configuration, drop the cached bucket configs, register the
        notification targets it enabled, reload the notification rules,
        the persisted tiers, and rewire replication from the persisted
        configs (a removed config or target unwires)."""
        self.handlers.config_sys.load()
        self.handlers.apply_config()
        self.handlers.meta.invalidate()
        self._register_new_targets(self.handlers)
        self._load_notification_rules(self.handlers, self.pools)
        if self.tier_mgr is not None:
            self.tier_mgr.load_persisted_tiers()
        if self.replication is None:
            return
        for bucket in self.pools.list_buckets():
            try:
                wired = repl.wire_bucket(self.replication,
                                         self.handlers.meta, bucket)
            except Exception as e:  # noqa: BLE001 — the wiring's verdict
                print(f"minio_tpu_torch: replication wiring {bucket}: "
                      f"{e}", file=sys.stderr, flush=True)
                continue
            if not wired:
                self.replication.unconfigure(bucket)

    def _wire_replication(self, h: S3Handlers, bucket: str) -> None:
        """(Re)wire one bucket's rules and remote targets into the pool
        (nothing until both halves exist; a bad registration is logged,
        the wiring is asynchronous to the request that stored it)."""
        if self.replication is None:
            return
        try:
            repl.wire_bucket(self.replication, h.meta, bucket)
        except Exception as e:  # noqa: BLE001 — the wiring's verdict
            print(f"minio_tpu_torch: replication wiring {bucket}: {e}",
                  file=sys.stderr, flush=True)

    def _may_replicate(self, access_key: str) -> bool:
        """The s3:ReplicateObject gate of the incoming REPLICA marker."""
        if access_key == self.creds.access_key:
            return True              # root (targets usually register it)
        if self.iam is None or not access_key:
            return False
        ident = self.iam.lookup(access_key)
        return ident is not None and self.iam.is_allowed(
            ident, "s3:ReplicateObject", "*")

    def _usage_source(self, pools):
        """What quota and the admin read usage from: the scanner, bound
        to the bucket configuration (item 10's lifecycle binds there),
        or in a pool worker without one, the usage worker 0's scanner
        persisted; None without either."""
        if self.scanner is not None:
            return self.scanner
        if self.worker_plane is not None:
            from ..background.scanner import PersistedUsage
            return PersistedUsage(pools)
        return None

    def _dispatch_internal(self, path: str, query: dict) -> Response:
        """Unauthenticated infra endpoints (cf.
        cmd/healthcheck-handler.go)."""
        if path == "/minio/health/live":
            return Response(200)
        if path == "/minio/health/ready":
            # ready = the object layer bound and not draining: load
            # balancers stop routing here first.
            if self.draining:
                return Response(503, headers={"Retry-After": "1"})
            return Response(200 if self.pools is not None else 503)
        if self.pools is None:
            return Response(503)
        if path == "/minio/health/cluster":
            maint = int(query.get("maintenance", ["0"])[0] or 0)
            ok, detail = cluster_health(self.pools, maint)
            return Response(200 if ok else 503, json.dumps(detail).encode(),
                            {"Content-Type": "application/json"})
        tier = getattr(self.pools, "hot_tier", None)
        if path == "/minio/v2/metrics/node" and (
                self.worker_plane is not None or tier is not None
                or self.cluster_node is not None):
            # The worker pool's families, the hot tier's, a cluster
            # node's peers and this process's zero-copy sends (with its
            # kernels' launches and items outside a pool, whose plane
            # carries them); the registry's others wait for observe/
            # (ROADMAP Queue A item 10).
            text = (self.worker_plane.render_prom()
                    if self.worker_plane is not None else "")
            text += node_families(
                tier, self.worker_id, kernels=self.worker_plane is None,
                qos_plane=self.qos if _qos.qos_enabled() else None,
                cluster_node=self.cluster_node, notify=self.notify)
            return Response(200, text.encode(),
                            {"Content-Type": "text/plain; version=0.0.4"})
        if path.startswith("/minio/v2/metrics/"):
            raise unported("metrics")
        raise S3Error("MethodNotAllowed")

    def _dispatch(self, req, path: str, query: dict) -> Response:
        if self._stream_eligible(req.command, path, query):
            body, access_key = self._authenticate_streaming(req, path,
                                                            query)
        else:
            body, access_key = self._authenticate(req, path, query)
        # Auth succeeded: the bandwidth charge after the response goes
        # to this identity.
        req.qos_access_key = access_key
        method = req.command
        headers = {k: v for k, v in req.headers.items()}
        if not self._may_replicate(access_key):
            # The replication marker and the version-fidelity headers
            # come only from principals allowed to replicate: any other
            # writer could mark its objects REPLICA and exempt them from
            # replication (the reference strips them the same way).
            headers = {k: v for k, v in headers.items()
                       if k.lower() not in _REPLICA_HEADERS}
        if path.startswith("/minio/admin/"):
            return self._dispatch_admin(access_key, method, path, query,
                                        body)
        if path == "/minio/listen":
            # Every bucket's events (the minio extension), an admin
            # plane action.
            self._admin_authorize(access_key, "listen", method)
            return self._listen_response("", query)
        h = self.handlers
        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0] if parts[0] else ""
        key = parts[1] if len(parts) > 1 else ""
        self._qos_checks(access_key, bucket)
        if not bucket:
            if method == "POST":
                return self._handle_sts(access_key, body, req)
            if method == "GET":
                self._authorize(access_key, method, "", "", query,
                                req.client_address[0])
                return h.list_buckets()
            raise S3Error("MethodNotAllowed")
        ctype = headers.get("Content-Type", headers.get("content-type", ""))
        form_post = (method == "POST" and not key and "delete" not in query
                     and ctype.startswith("multipart/form-data"))
        if not form_post:
            # Before any handler: a refused streamed PUT leaves its body
            # unread and never reaches the engine.  Browser form posts
            # carry their own signed POST policy; _handle_post_upload
            # authenticates and authorizes from the form.
            self._authorize(access_key, method, bucket, key, query,
                            req.client_address[0])
        if not key:
            return self._dispatch_bucket(method, bucket, query, headers,
                                         body, access_key)
        return self._dispatch_object(method, bucket, key, query, headers,
                                     body)

    def _qos_checks(self, access_key: str, bucket: str) -> None:
        """Per-tenant QoS after authentication (the VERIFIED identity
        throttles, unlike the admission peek): the req/s token bucket and
        a positive balance on the post-paid bandwidth bucket; then the
        bucket's bandwidth budget (the `bandwidth` field of its quota
        config, cmd/bucket-quota.go enforcement riding the same config
        as the hard quota).  Each short-circuits unless a rate is
        configured, so the oracle path costs one env read."""
        if not _qos.qos_enabled():
            return
        if access_key:
            klass = _qos.tenant_class(access_key)
            if not self.qos.tenant_admit(access_key, klass):
                raise S3Error("SlowDown",
                              "per-tenant request rate exceeded")
            if not self.qos.tenant_bw_ok(access_key, klass):
                raise S3Error("SlowDown",
                              "per-tenant bandwidth budget exceeded")
        if bucket:
            rate = self._qos_bucket_rate(bucket)
            if rate > 0 and not self.qos.bucket_bw_ok(bucket, rate):
                raise S3Error("SlowDown",
                              f"bucket {bucket} bandwidth budget exceeded")

    def _qos_bucket_rate(self, bucket: str) -> float:
        """Per-bucket bandwidth budget (bytes/s) from the bucket quota
        config, cached ~5s so the request path never pays a metadata
        read per GET (0 = unlimited / no config)."""
        now = time.monotonic()
        hit = self._qos_bw_cache.get(bucket)
        if hit is not None and now - hit[1] < 5.0:
            return hit[0]
        rate = 0.0
        try:
            raw = self.handlers.meta.get(bucket, "quota")
            if raw is not None:
                from ..bucket.quota import parse_quota_config
                rate = float(parse_quota_config(raw).get("bandwidth", 0))
        except Exception:  # noqa: BLE001 — bad config ≠ blocked IO
            rate = 0.0
        self._qos_bw_cache[bucket] = (rate, now)
        return rate

    # -- authorization (cf. checkRequestAuthType policy check) ---------------

    _CONFIG_ACTIONS = {
        "lifecycle": "LifecycleConfiguration",
        "policy": "BucketPolicy",
        "notification": "BucketNotification",
        "replication": "ReplicationConfiguration",
        "quota": "BucketPolicy",
        "object-lock": "BucketObjectLockConfiguration",
        "tagging": "BucketTagging",
        "encryption": "EncryptionConfiguration",
    }

    @staticmethod
    def _s3_action(method: str, bucket: str, key: str, query: dict) -> str:
        verb = {"GET": "Get", "HEAD": "Get", "PUT": "Put",
                "DELETE": "Delete"}.get(method, "Get")
        if key:
            for sub, base in (("tagging", "ObjectTagging"),
                              ("retention", "ObjectRetention"),
                              ("legal-hold", "ObjectLegalHold")):
                if sub in query:
                    return f"s3:{verb}{base}"
        elif bucket:
            for sub, base in S3Server._CONFIG_ACTIONS.items():
                if sub in query:
                    return f"s3:{verb}{base}"
        if not bucket:
            return "s3:ListAllMyBuckets"
        if not key:
            if method == "GET":
                if "location" in query:
                    return "s3:GetBucketLocation"
                if "versioning" in query:
                    return "s3:GetBucketVersioning"
                if "uploads" in query:
                    return "s3:ListBucketMultipartUploads"
                return "s3:ListBucket"
            if method == "HEAD":
                return "s3:ListBucket"
            if method == "PUT":
                if "versioning" in query:
                    return "s3:PutBucketVersioning"
                return "s3:CreateBucket"
            if method == "DELETE":
                return "s3:DeleteBucket"
            if method == "POST" and "delete" in query:
                return "s3:DeleteObject"
            return "s3:ListBucket"
        if method in ("GET", "HEAD"):
            if "uploadId" in query:
                return "s3:ListMultipartUploadParts"
            return ("s3:GetObjectVersion" if "versionId" in query
                    else "s3:GetObject")
        if method == "PUT":
            return "s3:PutObject"
        if method == "DELETE":
            if "uploadId" in query:
                return "s3:AbortMultipartUpload"
            return ("s3:DeleteObjectVersion" if "versionId" in query
                    else "s3:DeleteObject")
        if method == "POST":
            if "select" in query:
                return "s3:GetObject"
            if "restore" in query:
                return "s3:RestoreObject"
            return "s3:PutObject"
        return "s3:GetObject"

    def _bucket_policy(self, bucket: str) -> Policy | None:
        """The bucket's stored policy; None when it has none or it does
        not parse (then it grants nothing)."""
        data = self.handlers.meta.get(bucket, "policy")
        if data is None:
            return None
        try:
            return Policy(data.decode())
        except (PolicyError, ValueError):
            return None

    def _authorize(self, access_key: str, method: str, bucket: str,
                   key: str, query: dict, source_ip: str = "") -> None:
        action = self._s3_action(method, bucket, key, query)
        resource = f"{bucket}/{key}" if key else bucket
        ctx = {"s3:prefix": query.get("prefix", [""])[0],
               "aws:SourceIp": source_ip}
        if access_key == "":
            # Anonymous request: only a bucket policy can grant it (cf.
            # PolicySys.IsAllowed for anonymous, cmd/auth-handler.go +
            # cmd/bucket-policy.go).
            pol = self._bucket_policy(bucket) if bucket else None
            if pol is not None and pol.is_allowed(action, resource, ctx,
                                                  principal="*"):
                return
            raise S3Error("AccessDenied", "anonymous access denied")
        if access_key == self.creds.access_key or self.iam is None:
            return                               # root bypasses policy
        ident = self.iam.lookup(access_key)
        if ident is None:
            raise S3Error("InvalidAccessKeyId")
        if not self.iam.is_allowed(ident, action, resource, ctx):
            raise S3Error("AccessDenied",
                          f"{action} on {resource} denied")

    def _delete_authorizer(self, access_key: str, bucket: str):
        """Per-key authorization of a multi-object delete: None (root,
        no per-key checks) or can_delete(key, version_id) -> bool, so
        object-path Deny statements hold key by key."""
        if access_key == self.creds.access_key:
            return None
        if access_key == "":
            # Anonymous: each key needs a bucket-policy DeleteObject
            # grant; a Put-only public bucket must not allow deletes.
            pol = self._bucket_policy(bucket)

            def can_anon(key: str, version_id: str) -> bool:
                if pol is None:
                    return False
                action = ("s3:DeleteObjectVersion" if version_id
                          else "s3:DeleteObject")
                return pol.is_allowed(action, f"{bucket}/{key}",
                                      principal="*")
            return can_anon
        # Past authentication, a key that is neither root nor "" is an
        # IAM identity, so self.iam is set.
        ident = self.iam.lookup(access_key)

        def can_delete(key: str, version_id: str) -> bool:
            if ident is None:
                return False
            action = ("s3:DeleteObjectVersion" if version_id
                      else "s3:DeleteObject")
            return self.iam.is_allowed(ident, action, f"{bucket}/{key}")
        return can_delete

    # -- admin API: IAM (cf. registerAdminRouter, cmd/admin-router.go:40) ----

    # Endpoint -> madmin-style admin policy action (cf. AdminAction
    # constants, github.com/minio/pkg/iam/policy/admin-action.go).
    _ADMIN_ACTIONS = {
        "info": "admin:ServerInfo",
        "datausage": "admin:DataUsageInfo",
        "heal": "admin:Heal",
        "trace": "admin:ServerTrace",
        "console": "admin:ConsoleLog",
        "users": "admin:*User",          # method-refined below
        "bucket-remote": "admin:SetBucketTarget",
        "service-accounts": "admin:*ServiceAccount",
        "groups": "admin:*Group",
        "policies": "admin:*Policy",
        "config": "admin:ConfigUpdate",
        "config-help": "admin:ConfigUpdate",
        "profile": "admin:Profiling",
        "service": "admin:ServiceRestart",
        "tier": "admin:SetTier",
        "ilm": "admin:SetTier",
        "replication": "admin:SetBucketTarget",
        "inspect": "admin:InspectData",
        "kms": "admin:KMSKeyStatus",
        "top": "admin:ServerTrace",
        "listen": "admin:ListenNotification",
        "bandwidth": "admin:BandwidthMonitor",
        "pools": "admin:ServerInfo",
        "pool": "admin:Decommission",
        "site-replication": "admin:SiteReplicationInfo",
        "metrics": "admin:Prometheus",
        "healthinfo": "admin:OBDInfo",
    }
    #: The IAM endpoints' write and read actions by method.
    _ADMIN_BY_METHOD = {
        "admin:*User": ({"GET": "admin:ListUsers",
                         "POST": "admin:CreateUser",
                         "DELETE": "admin:DeleteUser"}, "admin:CreateUser"),
        "admin:*Group": ({"GET": "admin:ListGroups",
                          "POST": "admin:AddUserToGroup",
                          "DELETE": "admin:RemoveUserFromGroup"},
                         "admin:AddUserToGroup"),
        "admin:*Policy": ({"GET": "admin:GetPolicy",
                           "POST": "admin:CreatePolicy",
                           "DELETE": "admin:DeletePolicy"},
                          "admin:CreatePolicy"),
        "admin:*ServiceAccount": ({"GET": "admin:ListServiceAccounts",
                                   "POST": "admin:CreateServiceAccount",
                                   "DELETE": "admin:RemoveServiceAccount"},
                                  "admin:CreateServiceAccount"),
    }

    def _admin_authorize(self, access_key: str, sub: str,
                         method: str) -> None:
        """Root always; otherwise an IAM identity whose policies allow
        the endpoint's admin: action (cf. checkAdminRequestAuth,
        cmd/admin-handler-utils.go: non-root admins are first-class)."""
        if access_key == self.creds.access_key:
            return
        if self.iam is None or not access_key:
            raise S3Error("AccessDenied", "admin API requires credentials")
        ident = self.iam.lookup(access_key)
        if ident is None:
            raise S3Error("InvalidAccessKeyId")
        base = self._ADMIN_ACTIONS.get(sub.split("/")[0], "admin:*")
        if base == "admin:KMSKeyStatus" and method == "POST":
            base = "admin:KMSCreateKey"
        elif base in self._ADMIN_BY_METHOD:
            by_method, default = self._ADMIN_BY_METHOD[base]
            base = by_method.get(method, default)
        elif base == "admin:Decommission" and method == "GET":
            base = "admin:ServerInfo"        # status is read-only
        elif base == "admin:SiteReplicationInfo" and method != "GET":
            base = "admin:SiteReplicationOperation"
        if not self.iam.is_allowed(ident, base, "*"):
            raise S3Error("AccessDenied", f"{base} denied")

    def _dispatch_admin(self, access_key: str, method: str, path: str,
                        query: dict, body: bytes) -> Response:
        """The admin API's IAM endpoints (cf.
        cmd/admin-handlers-users.go); every other endpoint answers
        NotImplemented (item 10)."""
        sub = path[len("/minio/admin/v1/"):].strip("/")
        self._admin_authorize(access_key, sub, method)
        if sub == "heal":
            return self._admin_heal(method, query)
        if sub == "info" and method == "GET":
            return self._admin_info()
        if sub == "datausage" and method == "GET":
            return self._admin_datausage()
        if sub == "pools" and method == "GET":
            return self._admin_pools()
        if sub == "pool/add" and method == "POST":
            return self._admin_pool_add(body)
        if sub == "pool/decommission":
            return self._admin_decommission(method, query)
        if sub == "service" and method == "POST" and \
                self.cluster_node is not None:
            return self._admin_service(query)
        if sub == "bucket-remote":
            return self._admin_bucket_remote(method, query, body)
        if sub == "replication":
            return self._admin_replication(method, query, body)
        if sub == "config":
            return self._admin_config(method, query, body)
        if sub == "tier":
            return self._admin_tier(method, query, body)
        if sub == "ilm":
            return self._admin_ilm(method, body)
        if sub.startswith("kms"):
            return self._admin_kms(sub, method, query)
        if sub == "config-help" and method == "GET":
            return _json(self.handlers.config_sys.help(
                query.get("subsys", [""])[0]))
        handler = {"users": self._admin_users,
                   "service-accounts": self._admin_service_accounts,
                   "policies": self._admin_policies,
                   "groups": self._admin_groups}.get(sub)
        if handler is None:
            raise unported(f"the admin API's {sub or 'root'} endpoint")
        if self.iam is None:
            return _json({"error": "IAM not enabled"}, 501)
        def arg(name: str) -> str:
            return query.get(name, [""])[0]
        req = json.loads(body or b"{}") if method == "POST" else {}
        resp = handler(method, arg, req)
        if resp is None:
            raise S3Error("MethodNotAllowed",
                          f"unknown admin endpoint {sub!r}")
        return resp

    def _admin_kms(self, sub: str, method: str, query: dict) -> Response:
        """The KMS admin API (cf. the KMSCreateKey and KMSKeyStatus
        handlers, cmd/admin-router.go:40): `kms/status`, `kms/key/list`,
        `kms/key/create?key-id=` (POST) and `kms/key/status?key-id=`."""
        from ..crypto.kms import KMSError
        kms = self.handlers.kms
        if kms is None:
            return _json({"error": "KMS not configured"}, 501)
        if sub == "kms/status" and method == "GET":
            return _json({"name": type(kms).__name__,
                          "defaultKeyId": kms.key_id,
                          "endpoints": {"local": "online"}})
        if sub == "kms/key/list" and method == "GET":
            return _json({"keys": kms.list_keys()})
        if sub == "kms/key/create" and method == "POST":
            key_id = query.get("key-id", [""])[0]
            if not key_id:
                raise S3Error("InvalidArgument", "key-id required")
            try:
                kms.create_key(key_id)
            except KMSError as e:
                raise S3Error("InvalidArgument", str(e)) from None
            return _json({"created": key_id})
        if sub == "kms/key/status" and method == "GET":
            return _json(kms.key_status(
                query.get("key-id", [kms.key_id])[0]))
        raise S3Error("MethodNotAllowed")

    def _admin_config(self, method: str, query: dict,
                      body: bytes) -> Response:
        """`mc admin config get/set` (cf. cmd/admin-handlers-config-kv.go)
        over the handlers' ConfigSys, which the data path reads: a set
        applies to the next request, through every worker of the pool and
        every node of a cluster once they reload (the ConfigSys's
        on_write hook)."""
        cs = self.handlers.config_sys
        if method == "GET":
            subsys = query.get("subsys", [""])[0]
            if subsys:
                return _json({subsys: cs.get_subsys(subsys)})
            return _json(cs.help())
        if method == "POST":
            req = json.loads(body or b"{}")
            try:
                cs.set(req["subsys"], req["key"], req["value"])
            except KeyError as e:
                raise S3Error("InvalidArgument", str(e)) from None
            self.handlers.apply_config()
            if req["subsys"].startswith("notify_"):
                self._register_new_targets(self.handlers)
            return _json({"ok": True})
        raise S3Error("MethodNotAllowed")

    def _admin_tier(self, method: str, query: dict,
                    body: bytes) -> Response:
        """`mc admin tier add/ls/rm` (cf. AddTierHandler / ListTierHandler,
        cmd/admin-handlers-pools.go).  A registration persists on the
        system volume (credentials sealed with the KMS, refused without
        one); a duplicate name is 409 unless PUT replaces it (the
        credential rotation of EditTierHandler)."""
        tm = self.tier_mgr
        if tm is None:
            return _json({"error": "tiering not enabled"}, 501)
        if method == "GET":
            st = tm.stats()
            return _json({"tiers": tm.list_tiers(), "usage": st["tiers"],
                          "journal_pending": st["journal_pending"]})
        if method == "DELETE":
            name = query.get("name", [""])[0]
            if not name:
                raise S3Error("InvalidArgument", "name required")
            try:
                removed = tm.remove_tier(name)
            except ValueError as e:
                return _json({"error": str(e)}, 409)
            if not removed:
                return _json({"error": f"no tier {name!r}"}, 404)
            return _json({"ok": True})
        if method in ("POST", "PUT"):
            req = json.loads(body or b"{}")
            try:
                name = req["name"]
                kind = req.get("type", "fs")
                if kind not in ("fs", "s3", "pool"):
                    raise S3Error("InvalidArgument",
                                  f"unknown tier type {kind!r}")
                cfg = {k: v for k, v in req.items() if k != "name"}
                tm.add_tier(name, tm.backend_for(cfg), config=cfg,
                            replace=method == "PUT")
            except KeyError as e:
                raise S3Error("InvalidArgument",
                              f"missing field {e}") from None
            except ValueError as e:
                return _json({"error": str(e)}, 409)
            except StorageError as e:
                # No KMS to seal its credentials, or a stored config
                # that cannot be rewritten.
                raise S3Error("InvalidArgument", str(e)) from None
            return _json({"ok": True})
        raise S3Error("MethodNotAllowed")

    def _admin_ilm(self, method: str, body: bytes) -> Response:
        """The ILM plane: GET the tier manager's counters; POST
        `{"op": "drain"}` drains the journal, `{"bucket", "object",
        "tier"}` transitions one object now (what the scanner does on its
        own cadence)."""
        tm = self.tier_mgr
        if tm is None:
            return _json({"error": "tiering not enabled"}, 501)
        if method == "GET":
            return _json(tm.stats())
        if method != "POST":
            raise S3Error("MethodNotAllowed")
        req = json.loads(body or b"{}")
        if req.get("op") == "drain":
            freed = tm.drain_journal()
            return _json({"freed": freed, "pending": tm.journal.pending()})
        bkt, okey, tname = (req.get("bucket"), req.get("object"),
                            req.get("tier"))
        if not bkt or not okey or not tname:
            raise S3Error("InvalidArgument",
                          "bucket, object, tier required")
        try:
            moved = tm.transition_object(bkt, okey, tname,
                                         req.get("versionId", ""))
        except StorageError as e:
            raise from_storage_error(e) from None
        return _json({"transitioned": bool(moved)})

    def _restore(self, bucket: str, key: str, query: dict,
                 body: bytes) -> Response:
        """POST ?restore (PostRestoreObjectHandler): an empty body
        restores for good; `<RestoreRequest><Days>N</Days>` for N days
        (`x-amz-restore`, the scanner re-expires it).  202 Accepted; a
        version that is not transitioned is InvalidObjectState."""
        tm = self.tier_mgr
        if tm is None:
            raise S3Error("NotImplemented", "tiering not enabled")
        days = None
        if body:
            try:
                root = ET.fromstring(body)
                dtext = root.findtext(".//{*}Days") or \
                    root.findtext(".//Days")
                if dtext is not None:
                    days = float(dtext)
                    if days <= 0:
                        raise ValueError(dtext)
            except ET.ParseError:
                raise S3Error("MalformedXML") from None
            except ValueError as e:
                raise S3Error("InvalidArgument", f"bad Days: {e}") from None
        try:
            restored = tm.restore_object(
                bucket, key, query.get("versionId", [""])[0], days=days)
        except StorageError as e:
            raise from_storage_error(e) from None
        if not restored:
            raise S3Error("InvalidObjectState")
        return Response(202)

    def _listen_response(self, bucket: str, query: dict) -> Response:
        """ListenNotification: `GET /{bucket}?events=...` (and the minio
        extension `GET /minio/listen` with bucket="") as a chunked NDJSON
        stream of this process's live S3 event records (cf.
        ListenNotificationHandler, cmd/bucket-notification-handlers.go).
        `duration` (seconds) bounds the stream for polling clients."""
        if bucket and not self.pools.bucket_exists(bucket):
            raise S3Error("NoSuchBucket", bucket)
        prefix = query.get("prefix", [""])[0]
        suffix = query.get("suffix", [""])[0]
        names = [n for ns in query.get("events", [])
                 for n in ns.split(",") if n]
        try:
            max_s = float(query.get("duration", ["0"])[0] or 0)
        except ValueError:
            max_s = 0.0
        return Response(
            200, b"",
            {"Content-Type": "application/x-ndjson",
             "Transfer-Encoding": "chunked"},
            body_iter=self._listen_stream(bucket, prefix, suffix, names,
                                          max_s))

    def _listen_stream(self, bucket, prefix, suffix, names, max_s: float,
                       poll: float = 0.05):
        from fnmatch import fnmatch
        q = self.notify.subscribe_events(2000)
        try:
            deadline = (time.monotonic() + max_s) if max_s > 0 else None
            last = time.monotonic()
            while deadline is None or time.monotonic() < deadline:
                sent = False
                while q:
                    ev = q.popleft()
                    if bucket and ev["bucket"] != bucket:
                        continue
                    key = ev["key"]
                    if prefix and not key.startswith(prefix):
                        continue
                    if suffix and not key.endswith(suffix):
                        continue
                    if names and not any(fnmatch(ev["eventName"], pat)
                                         for pat in names):
                        continue
                    yield json.dumps(
                        {"Records": [ev["record"]]}).encode() + b"\n"
                    sent = True
                now = time.monotonic()
                if sent:
                    last = now
                elif now - last > 5.0:
                    # Keepalive blank line: NDJSON consumers skip it,
                    # and the write is how a client hangup shows.
                    yield b"\n"
                    last = now
                time.sleep(poll)
        finally:
            self.notify.unsubscribe_events(q)

    def _admin_service(self, query: dict) -> Response:
        """A cluster node's service action (cf. ServiceHandler,
        cmd/admin-handlers.go): `restart` and `stop` are recorded in
        `service_event`, and the node's serve loop
        (server/__main__.cluster_main) drains, shuts down and, on a
        restart, boots the node again."""
        action = query.get("action", ["status"])[0]
        if action == "status":
            return _json({"action": "status",
                          "serviceEvent": self.service_event,
                          "at": time.time()})
        if action not in ("restart", "stop"):
            raise S3Error("InvalidArgument",
                          f"unknown service action {action!r}")
        self.service_event = action
        return _json({"action": action, "acknowledged": True,
                      "at": time.time()})

    def _admin_heal(self, method: str, query: dict) -> Response:
        """Heal sequences (background/heal_ops.py, the allHealState
        role): POST starts one over `bucket` / `prefix` (`deep=true`
        verifies every frame), GET lists every sequence's status."""
        if self.heal_state is None:
            from ..background.heal_ops import HealState
            self.heal_state = HealState(self.pools)
        if method == "POST":
            seq = self.heal_state.launch(
                bucket=query.get("bucket", [""])[0],
                prefix=query.get("prefix", [""])[0],
                deep=query.get("deep", [""])[0] == "true")
            return _json(seq.status())
        return _json({"sequences": self.heal_state.statuses()})

    # -- admin API: replication ----------------------------------------------

    def _admin_bucket_remote(self, method: str, query: dict,
                             body: bytes) -> Response:
        """A bucket's remote targets (cf. SetRemoteTargetHandler,
        cmd/admin-bucket-handlers.go): where its replication rules copy
        to, persisted beside its configs and wired again at boot."""
        bucket = query.get("bucket", [""])[0]
        if not bucket:
            raise S3Error("InvalidArgument", "bucket required")
        meta = self.handlers.meta
        targets = repl.parse_targets(meta.get(bucket, "replication_targets"))
        if method == "GET":
            return _json({"targets": [
                {k: v for k, v in t.items() if k != "secretKey"}
                for t in targets]})
        if method == "POST":
            req = json.loads(body or b"{}")
            try:
                tb = req["targetBucket"]
                prev = next((t for t in targets
                             if t.get("targetBucket") == tb), None)
                kept = [t for t in targets if t.get("targetBucket") != tb]
                entry = {
                    # Registering again (a credential rotation) keeps the
                    # ARN: a handle held elsewhere stays valid.
                    "arn": (prev["arn"] if prev else
                            f"arn:minio:replication::{len(kept) + 1}:{tb}"),
                    "endpoint": req["endpoint"],
                    "accessKey": req["accessKey"],
                    "secretKey": req["secretKey"],
                    "targetBucket": tb,
                }
            except KeyError as e:
                raise S3Error("InvalidArgument", str(e)) from None
            meta.put(bucket, "replication_targets",
                     json.dumps(kept + [entry]).encode())
            self._wire_replication(self.handlers, bucket)
            return _json({"arn": entry["arn"]})
        if method == "DELETE":
            arn = query.get("arn", [""])[0]
            remaining = [t for t in targets if t.get("arn") != arn]
            if len(remaining) == len(targets):
                return _json({"error": f"no target with arn {arn!r}"}, 404)
            meta.put(bucket, "replication_targets",
                     json.dumps(remaining).encode())
            # Unwired now: nothing more goes to a deregistered target.
            if self.replication is not None:
                self.replication.unconfigure(bucket)
                if remaining:
                    self._wire_replication(self.handlers, bucket)
            return _json({"ok": True})
        raise S3Error("MethodNotAllowed")

    def _admin_replication(self, method: str, query: dict,
                           body: bytes) -> Response:
        """The replication plane (cf. the ReplicationDiag and resync
        admin APIs): GET its counters (with `bucket=` its resync state);
        POST {"op": "resync", "bucket": ...} starts or resumes one."""
        rp = self.replication
        if rp is None:
            return _json({"error": "replication not enabled"}, 501)
        if method == "GET":
            out = rp.stats()
            bkt = query.get("bucket", [""])[0]
            if bkt:
                out["resync"] = rp.resync_status(bkt)
            if self.worker_id is not None:
                # Each worker of a pool runs its own pool and journal:
                # the answer names whose counters these are.
                out["worker"] = self.worker_id
            return _json(out)
        if method == "POST":
            req = json.loads(body or b"{}")
            if req.get("op") == "resync":
                bkt = req.get("bucket")
                if not bkt:
                    raise S3Error("InvalidArgument", "bucket required")
                return _json(rp.start_resync(bkt))
            raise S3Error("InvalidArgument", "unknown op")
        raise S3Error("MethodNotAllowed")

    # -- admin API: usage and the pool lifecycle ------------------------------

    def _admin_info(self) -> Response:
        """The madmin InfoMessage's shape (cf. ServerInfoHandler,
        cmd/admin-handlers.go): health, buckets, and the objects and bytes
        of the scanner's last cycle, every drive's state."""
        ok, detail = cluster_health(self.pools)
        n_buckets = len([b for b in self.pools.list_buckets()
                         if b != ".mtpu.sys"])
        n_objects = usage_size = 0
        src = self.handlers.scanner
        u = src.latest_usage() if src is not None else None
        if u is not None:
            for bu in u.buckets.values():
                n_objects += bu.objects
                usage_size += bu.bytes
        drives = []
        for pi, pool in enumerate(self.pools.pools):
            for si, es in enumerate(pool.sets):
                for di, d in enumerate(es.drives):
                    if d is None:
                        state = "offline"
                    elif hasattr(d, "health_state"):
                        state = d.health_state()
                    else:
                        state = "ok"
                    row = {"pool_index": pi, "set_index": si,
                           "drive_index": di, "state": state,
                           "endpoint": getattr(d, "root", "")}
                    if hasattr(d, "health_info"):
                        hi = d.health_info()
                        row["breaker"] = {
                            k: hi.get(k, default) for k, default in (
                                ("consecutive_errors", 0),
                                ("consecutive_slow", 0),
                                ("last_fault", ""),
                                ("transitions", []))}
                    drives.append(row)
        peers = (self.cluster_node.peer_info()
                 if self.cluster_node is not None else [])
        pool_proc = ({"owner": self.worker_plane.state.owner_info(),
                      "workers": self.worker_plane.state.worker_rows()}
                     if self.worker_plane is not None else None)
        return _json({
            "mode": "online" if ok else "degraded",
            "peers": peers,
            "pool": pool_proc,
            "deploymentID": self.pools.deployment_id,
            "buckets": {"count": n_buckets},
            "objects": {"count": n_objects},
            "usage": {"size": usage_size},
            "servers": [{"state": "online",
                         "endpoint": f"{self.host}:{self.port}",
                         "drives": drives}],
            "backend": {"backendType": "Erasure", "sets": detail["sets"]},
            "deploymentId": self.pools.deployment_id,
            "sets": detail["sets"],
            "replication": (self.replication.stats()
                            if self.replication is not None else None),
            "ilm": (self.tier_mgr.stats()
                    if self.tier_mgr is not None else None),
        })

    def _admin_datausage(self) -> Response:
        """The scanner's last cycle (a cycle now when none has run); a
        pool worker without the scanner reads what worker 0's
        persisted."""
        src = self.handlers.scanner
        if src is None:
            return _json({"error": "scanner not running"}, 503)
        usage = src.latest_usage()
        if usage is None and self.scanner is not None:
            usage = self.scanner.scan_cycle()
        if usage is None:
            return _json({"error": "no scan cycle has completed"}, 503)
        return _json({"buckets": {b: u.to_obj()
                                  for b, u in usage.buckets.items()},
                      "scannedAt": usage.scanned_at})

    def _admin_pools(self) -> Response:
        """Every pool's sets, drives and capacity, and its drain state
        (cf. ListPools, cmd/admin-handlers-pools.go)."""
        out = []
        cap = {r["pool"]: r for r in self.pools.pool_status()}
        for pi, pool in enumerate(self.pools.pools):
            drives = online = 0
            for es in pool.sets:
                for d in es.drives:
                    drives += 1
                    if d is not None and (not hasattr(d, "is_online")
                                          or d.is_online()):
                        online += 1
            crow = cap.get(pi, {})
            row = {"pool": pi, "sets": len(pool.sets),
                   "drivesPerSet": pool.sets[0].n if pool.sets else 0,
                   "drivesTotal": drives, "drivesOnline": online,
                   "decommissioning": pi in self.pools.draining,
                   "totalBytes": crow.get("total", 0),
                   "freeBytes": crow.get("free", 0)}
            if "decommission" in crow:
                row["decommission"] = crow["decommission"]
            out.append(row)
        return _json({"pools": out,
                      "placement": self.pools.placement_pools()})

    def _pool_self_test(self, es) -> None:
        """One PUT, GET and DELETE through every set of a new pool before
        it becomes a placement candidate: a pool with a dead drive path
        fails the admin call, not the first client write routed to it.
        The PUT's encode and the GET's verify run on the card (in a
        worker pool, through the device owner's lanes)."""
        probe_bucket = ".mtpu.pool-selftest"
        try:
            es.make_bucket(probe_bucket)
        except StorageError:
            pass
        try:
            for i, s in enumerate(es.sets):
                payload = secrets.token_bytes(1024)
                key = f"probe-{i}"
                s.put_object(probe_bucket, key, payload)
                _, got = s.get_object(probe_bucket, key)
                if bytes(got) != payload:
                    raise ValueError(f"pool self-test: set {i} read "
                                     "mismatch")
                s.delete_object(probe_bucket, key)
        finally:
            try:
                es.delete_bucket(probe_bucket, force=True)
            except StorageError:
                pass

    def _pool_add(self, spec: str,
                  set_drive_count: int | None = None) -> int:
        """Attach a new pool, live: expand the drive spec, sweep, wrap and
        format its drives as the boot does, self-test every set, make
        every bucket on it, give it an MRF queue, then tell the other
        workers (server/topology.py)."""
        from .__main__ import expand_ellipses
        from .topology import attach_built_pool
        paths = [p for part in spec.split() for p in expand_ellipses(part)]
        if not paths:
            raise ValueError("empty drives spec")
        idx = attach_built_pool(
            self.pools, {"paths": paths, "set_drive_count": set_drive_count},
            sweep=True, check=self._pool_self_test)
        self._propagate_topology()
        return idx

    def _propagate_topology(self) -> None:
        """Persist pool-topology.json and wake the other workers (the
        shared topology generation; nothing more in one process)."""
        from .topology import save_topology
        save_topology(self.pools)
        if self.worker_plane is not None:
            self.worker_plane.state.bump_topology_gen()

    def _admin_pool_add(self, body: bytes) -> Response:
        req = json.loads(body or b"{}")
        spec = req.get("drives", "")
        if not spec:
            raise S3Error("InvalidArgument",
                          "drives spec required (ellipses ok)")
        try:
            idx = self._pool_add(spec,
                                 int(req.get("setDriveCount", 0)) or None)
        except (ValueError, StorageError) as e:
            raise S3Error("InvalidArgument", str(e)) from None
        return _json({"pool": idx,
                      "placement": self.pools.placement_pools()})

    def _admin_decommission(self, method: str, query: dict) -> Response:
        """A drain's lifecycle (cf. StartDecommission, Status and Cancel,
        cmd/admin-handlers-pools.go).  The mover runs where
        `decom_owner`; another worker records the request in the drain's
        journal for it.  Status is read from the journal everywhere."""
        from ..background import decom
        q_pool = query.get("pool", [""])[0]
        if method == "GET":
            if q_pool:
                st = decom.pool_status(self.pools, int(q_pool))
                if st is None:
                    return _json({"error": "no decommission for pool "
                                           f"{q_pool}"}, 404)
                return _json(st)
            rows = [decom.pool_status(self.pools, i)
                    for i in range(len(self.pools.pools))]
            return _json({"decommissions": [r for r in rows
                                            if r is not None]})
        if method != "POST":
            raise S3Error("MethodNotAllowed")
        if not q_pool:
            raise S3Error("InvalidArgument", "pool required")
        idx = int(q_pool)
        action = query.get("action", ["start"])[0]
        try:
            if self.decom_owner:
                st = self._decom_here(idx, action)
            else:
                st = decom.request(self.pools, idx, action)
        except ValueError as e:
            raise S3Error("InvalidArgument", str(e)) from None
        if st is None:
            return _json({"error": f"no decommission for pool {idx}"}, 404)
        self._propagate_topology()
        return _json(st)

    def _decom_here(self, idx: int, action: str) -> dict | None:
        """The owner's side of an admin action on pool `idx`'s drain."""
        from ..background import decom
        d = self.pools.decommissions.get(idx)
        if d is None and action != "start":
            # A drain this process did not start (a worker recorded it,
            # or the boot found its journal) is the journal's to name.
            decom.reconcile(self.pools)
            d = self.pools.decommissions.get(idx)
        if action == "start":
            if d is not None and d.state in decom.ACTIVE_STATES:
                return d.status()            # an idempotent start
            d = decom.Decommissioner(
                self.pools, idx,
                journal_path=decom.find_journals(self.pools).get(idx))
            d.start()
        elif d is None:
            return None
        elif action == "pause":
            d.pause()
        elif action == "resume":
            d.resume()
        elif action == "cancel":
            d.cancel()
        else:
            raise ValueError(f"unknown action {action!r}")
        return d.status()

    def _admin_users(self, method, arg, req) -> Response | None:
        if method == "GET":
            return _json({"users": self.iam.list_users()})
        if method == "POST":
            try:
                if req.get("attachPolicies") is not None:
                    # a policy-mapping update for an EXISTING identity
                    # (cf. SetPolicyForUserOrGroup)
                    self.iam.attach_policy(req["accessKey"],
                                           req["attachPolicies"])
                else:
                    self.iam.add_user(req["accessKey"], req["secretKey"],
                                      req.get("policies", []),
                                      status=req.get("status", "enabled"))
            except (KeyError, ValueError) as e:
                raise S3Error("InvalidArgument", str(e)) from None
            return _json({"ok": True})
        if method == "DELETE":
            self.iam.remove_user(arg("accessKey"))
            return _json({"ok": True})
        return None

    def _admin_service_accounts(self, method, arg, req) -> Response | None:
        if method == "GET":
            return _json({"accounts": self.iam.list_service_accounts(
                arg("parent"))})
        if method == "POST":
            try:
                ident = self.iam.add_service_account(
                    req["parent"], req.get("policies", []),
                    access_key=req.get("accessKey", ""),
                    secret_key=req.get("secretKey", ""))
            except KeyError as e:
                raise S3Error("InvalidArgument", str(e)) from None
            return _json({"accessKey": ident.access_key,
                          "secretKey": ident.secret_key})
        if method == "DELETE":
            self.iam.remove_user(arg("accessKey"))
            return _json({"ok": True})
        return None

    def _admin_policies(self, method, arg, req) -> Response | None:
        if method == "GET":
            name = arg("name")
            if name:
                try:
                    return _json({"name": name,
                                  "policy": self.iam.get_policy_doc(name)})
                except KeyError:
                    return _json({"error": f"no policy {name!r}"}, 404)
            return _json({"policies": self.iam.list_policies()})
        if method == "POST":
            try:
                self.iam.set_policy(req["name"], req["policy"])
            except (KeyError, ValueError) as e:
                raise S3Error("InvalidArgument", str(e)) from None
            return _json({"ok": True})
        if method == "DELETE":
            try:
                self.iam.remove_policy(arg("name"))
            except KeyError as e:
                return _json({"error": f"no policy {e}"}, 404)
            except ValueError as e:          # a built-in policy
                return _json({"error": str(e)}, 409)
            return _json({"ok": True})
        return None

    def _admin_groups(self, method, arg, req) -> Response | None:
        if method == "GET":
            name = arg("name")
            if name:
                try:
                    return _json(self.iam.group_info(name))
                except KeyError:
                    return _json({"error": f"no group {name!r}"}, 404)
            return _json({"groups": self.iam.list_groups()})
        if method == "POST":
            try:
                name = req["name"]
                if req.get("removeMembers"):
                    self.iam.remove_group_members(name,
                                                  req["removeMembers"])
                else:
                    self.iam.add_group(name, req.get("members", []),
                                       req.get("policies"))
                if "setPolicies" in req:
                    self.iam.set_group_policy(name, req["setPolicies"])
            except KeyError as e:
                raise S3Error("InvalidArgument", str(e)) from None
            return _json({"ok": True})
        if method == "DELETE":
            try:
                self.iam.remove_group(arg("name"))
            except KeyError as e:
                return _json({"error": f"no group {e}"}, 404)
            except ValueError as e:
                return _json({"error": str(e)}, 409)
            return _json({"ok": True})
        return None

    # -- STS (cf. cmd/sts-handlers.go:99) ------------------------------------

    @staticmethod
    def _duration(form: dict) -> int:
        try:
            return int(form.get("DurationSeconds", ["3600"])[0])
        except ValueError:
            raise S3Error("InvalidArgument",
                          "DurationSeconds must be an integer") from None

    @staticmethod
    def _sts_credentials_xml(action: str, ident) -> Response:
        exp = datetime.datetime.fromtimestamp(
            ident.expiration, datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ")
        root = ET.Element(f"{action}Response", xmlns=STS_NS)
        result = ET.SubElement(root, f"{action}Result")
        c = ET.SubElement(result, "Credentials")
        for tag, val in (("AccessKeyId", ident.access_key),
                         ("SecretAccessKey", ident.secret_key),
                         ("SessionToken", ident.session_token),
                         ("Expiration", exp)):
            ET.SubElement(c, tag).text = val
        xml_body = (b'<?xml version="1.0" encoding="UTF-8"?>'
                    + ET.tostring(root, encoding="unicode").encode())
        return Response(200, xml_body, {"Content-Type": "application/xml"})

    def _handle_sts(self, access_key: str, body: bytes, req) -> Response:
        """POST / : the STS actions, a form-encoded body."""
        form = urllib.parse.parse_qs(body.decode("utf-8", "replace"))
        action = form.get("Action", [""])[0]
        if action == "AssumeRoleWithWebIdentity":
            return self._handle_sts_web_identity(form)
        if action == "AssumeRoleWithClientGrants":
            # The same OIDC token flow, legacy field names.
            return self._handle_sts_web_identity(
                form, token_field="Token",
                action_name="AssumeRoleWithClientGrants")
        if action == "AssumeRoleWithLDAPIdentity":
            return self._handle_sts_ldap(form)
        if action == "AssumeRoleWithCertificate":
            return self._handle_sts_certificate(form, req)
        if action != "AssumeRole":
            raise S3Error("NotImplemented", "unknown STS action")
        if self.iam is None:
            raise S3Error("NotImplemented", "IAM is not enabled")
        if access_key == "":
            raise S3Error("AccessDenied", "AssumeRole must be signed")
        if access_key == self.creds.access_key:
            parent = Identity(access_key=access_key,
                              secret_key=self.creds.secret_key,
                              kind="root")
        else:
            parent = self.iam.lookup(access_key)
            if parent is None or parent.kind == "sts":
                raise S3Error("AccessDenied", "cannot assume from here")
        duration = self._duration(form)
        policy_doc = None
        if form.get("Policy", [""])[0]:
            try:
                policy_doc = json.loads(form["Policy"][0])
            except ValueError:
                raise S3Error("MalformedXML", "bad inline policy") from None
        ident = self.iam.assume_role(parent, duration, policy_doc)
        return self._sts_credentials_xml("AssumeRole", ident)

    def _handle_sts_web_identity(
            self, form: dict, token_field: str = "WebIdentityToken",
            action_name: str = "AssumeRoleWithWebIdentity") -> Response:
        """AssumeRoleWithWebIdentity / AssumeRoleWithClientGrants:
        token-authenticated (unsigned) STS (cf.
        cmd/sts-handlers.go:48-115)."""
        if self.iam is None or self.oidc is None:
            raise S3Error("NotImplemented", "OIDC is not configured")
        token = form.get(token_field, [""])[0]
        if not token:
            raise S3Error("InvalidArgument", f"missing {token_field}")
        try:
            claims = self.oidc.validate(token)
        except OIDCError as e:
            raise S3Error("AccessDenied", f"token rejected: {e}") from None
        policies = self.oidc.policies_from(claims)
        if not policies:
            raise S3Error("AccessDenied", "token grants no policies")
        parent = Identity(access_key=f"oidc:{claims.get('sub', 'unknown')}",
                          secret_key="", kind="user", policies=policies)
        ident = self.iam.assume_role(parent, self._duration(form))
        return self._sts_credentials_xml(action_name, ident)

    def _handle_sts_ldap(self, form: dict) -> Response:
        """AssumeRoleWithLDAPIdentity: the LDAP client binds as the user
        (the directory is the credential check) and the user's groups
        map to IAM policies (cf. internal/config/identity/ldap)."""
        if self.iam is None or self.ldap is None:
            raise S3Error("NotImplemented", "LDAP is not configured")
        username = form.get("LDAPUsername", [""])[0]
        password = form.get("LDAPPassword", [""])[0]
        if not username or not password:
            raise S3Error("InvalidArgument",
                          "LDAPUsername and LDAPPassword required")
        try:
            user_dn, policies = self.ldap.authenticate(username, password)
        except LDAPError as e:
            raise S3Error("AccessDenied",
                          f"LDAP authentication failed: {e}") from None
        except OSError as e:
            raise S3Error("ServiceUnavailable",
                          f"LDAP directory unreachable: {e}") from None
        if not policies:
            raise S3Error("AccessDenied",
                          "LDAP identity grants no policies")
        parent = Identity(access_key=f"ldap:{user_dn}", secret_key="",
                          kind="user", policies=policies)
        ident = self.iam.assume_role(parent, self._duration(form))
        return self._sts_credentials_xml("AssumeRoleWithLDAPIdentity",
                                         ident)

    def _handle_sts_certificate(self, form: dict, req) -> Response:
        """AssumeRoleWithCertificate: the TLS layer verified the client
        certificate against `client_ca`; its CN names the IAM policy the
        credentials carry (cf. internal/config/identity/tls)."""
        if self.iam is None:
            raise S3Error("NotImplemented", "IAM is not enabled")
        getpeer = getattr(req.connection, "getpeercert", None)
        cert = getpeer() if getpeer is not None else None
        if not cert:
            raise S3Error("AccessDenied",
                          "a verified TLS client certificate is required")
        cn = ""
        for rdn in cert.get("subject", ()):
            for key, val in rdn:
                if key == "commonName":
                    cn = val
        if not cn:
            raise S3Error("AccessDenied", "client certificate has no CN")
        if cn not in self.iam.list_policies():
            raise S3Error("AccessDenied",
                          f"no IAM policy named {cn!r} for this "
                          "certificate")
        parent = Identity(access_key=f"tls:{cn}", secret_key="",
                          kind="user", policies=[cn])
        ident = self.iam.assume_role(parent, self._duration(form))
        return self._sts_credentials_xml("AssumeRoleWithCertificate",
                                         ident)

    # -- browser POST uploads (cf. PostPolicyBucketHandler) ------------------

    def _handle_post_upload(self, bucket: str, content_type: str,
                            body: bytes) -> Response:
        """Auth rides in the form (a signed POST policy): the request
        arrives anonymous and is authenticated and authorized here."""
        fields = postpolicy.parse_multipart_form(content_type, body)
        file_data, filename = fields.get("file", (b"", ""))
        key = fields.get("key", (b"", ""))[0].decode("utf-8", "replace")
        if not key:
            raise S3Error("InvalidArgument", "missing key field")
        key = key.replace("${filename}", filename)
        access_key = postpolicy.verify_post_signature(self._lookup_creds,
                                                      fields)
        postpolicy.check_post_policy(fields["policy"][0], fields,
                                     len(file_data), bucket=bucket)
        self._authorize(access_key, "PUT", bucket, key, {})
        headers = {}
        ct = fields.get("content-type")
        if ct:
            headers["Content-Type"] = ct[0].decode("utf-8", "replace")
        resp = self.handlers.put_object(bucket, key, file_data, headers)
        resp.status = 204
        return resp

    def _dispatch_bucket(self, method, bucket, query, headers, body,
                         access_key) -> Response:
        h = self.handlers
        config_sub = next((s for s in h._CONFIG_KINDS if s in query), None)
        if method == "PUT":
            if "versioning" in query:
                return h.put_bucket_versioning(bucket, body)
            if config_sub:
                return h.put_bucket_config(bucket, config_sub, body)
            return h.make_bucket(bucket)
        if method == "HEAD":
            return h.head_bucket(bucket)
        if method == "DELETE":
            if config_sub:
                return h.delete_bucket_config(bucket, config_sub)
            return h.delete_bucket(bucket)
        if method == "POST":
            if "delete" in query:
                return h.delete_objects(
                    bucket, body,
                    can_delete=self._delete_authorizer(access_key, bucket))
            ctype = headers.get("Content-Type",
                                headers.get("content-type", ""))
            if ctype.startswith("multipart/form-data"):
                return self._handle_post_upload(bucket, ctype, body)
            raise S3Error("MethodNotAllowed")
        if method == "GET":
            if "events" in query:
                # ListenNotification (the reference registers the route
                # with Queries("events", ...)).
                return self._listen_response(bucket, query)
            if "location" in query:
                return h.get_bucket_location(bucket)
            if "versioning" in query:
                return h.get_bucket_versioning(bucket)
            if config_sub:
                return h.get_bucket_config(bucket, config_sub)
            if "uploads" in query:
                return h.list_multipart_uploads(bucket, query)
            if "versions" in query:
                return h.list_object_versions(bucket, query)
            return h.list_objects(bucket, query)
        raise S3Error("MethodNotAllowed")

    def _dispatch_object(self, method, bucket, key, query, headers,
                         body) -> Response:
        h = self.handlers
        if method == "PUT":
            if "partNumber" in query and "uploadId" in query:
                return h.put_part(bucket, key, query, body, headers)
            if "tagging" in query:
                return h.put_object_tagging(bucket, key, query, body)
            if "retention" in query:
                return h.put_object_retention(bucket, key, query, body,
                                              headers)
            if "legal-hold" in query:
                return h.put_object_legal_hold(bucket, key, query, body)
            return h.put_object(bucket, key, body, headers)
        if method == "GET":
            if "uploadId" in query:
                return h.list_parts(bucket, key, query)
            if "tagging" in query:
                return h.get_object_tagging(bucket, key, query)
            if "retention" in query:
                return h.get_object_retention(bucket, key, query)
            if "legal-hold" in query:
                return h.get_object_legal_hold(bucket, key, query)
            return h.get_object(bucket, key, query, headers)
        if method == "HEAD":
            return h.get_object(bucket, key, query, headers, head=True)
        if method == "DELETE":
            if "uploadId" in query:
                return h.abort_multipart(bucket, key, query)
            return h.delete_object(bucket, key, query, headers)
        if method == "POST":
            if "restore" in query:
                return self._restore(bucket, key, query, body)
            if "select" in query:
                return h.select_object_content(bucket, key, query, body,
                                               headers)
            if "uploads" in query:
                return h.create_multipart(bucket, key, headers)
            if "uploadId" in query:
                return h.complete_multipart(bucket, key, query, body)
            raise S3Error("MethodNotAllowed")
        raise S3Error("MethodNotAllowed")


#: The replication marker and the replica-fidelity headers, honored only
#: from a principal allowed s3:ReplicateObject.
_REPLICA_HEADERS = ("x-amz-replication-status", "x-mtpu-repl-version-id",
                    "x-mtpu-repl-mtime")


def _json(obj, status: int = 200) -> Response:
    return Response(status, json.dumps(obj).encode(),
                    {"Content-Type": "application/json"})
