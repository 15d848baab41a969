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

The admin API serves IAM's users, groups, policies and service accounts;
POST / is STS (AssumeRole, WebIdentity and ClientGrants through OIDC,
LDAPIdentity, Certificate over mTLS).  What answers NotImplemented, with
its ROADMAP.md Queue A item: the other admin endpoints, metrics and
listen (item 10); cluster health (item 9).  Spans, metrics, the audit
trail, QoS, federation and zero-copy sends stay in the JAX package for
now.
"""

from __future__ import annotations

import datetime
import json
import os
import secrets
import ssl
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..engine.pools import ServerPools
from ..iam.iam import Identity
from ..iam.ldap import LDAPError
from ..iam.oidc import OIDCError
from ..iam.policy import Policy, PolicyError
from ..utils import streams
from . import postpolicy, sigv2
from .api_errors import S3Error
from .handlers import Response, S3Handlers, error_response, unported
from .sigv4 import (STREAMING_PAYLOAD, UNSIGNED_PAYLOAD, Credentials,
                    StreamingSigV4Reader, decode_streaming_body,
                    verify_header_signature, verify_presigned)

MAX_HEADER_BODY = 5 * 1024 ** 3      # max single PUT (5 GiB part limit)
STS_NS = "https://sts.amazonaws.com/doc/2011-06-15/"


class S3Server:
    """Owns the object layer, the root credentials, the identity planes
    and the HTTP plumbing.  `certs` = (cert file, key file) serves HTTPS;
    `client_ca` then verifies the client certificates that
    AssumeRoleWithCertificate reads.  `iam` (an iam.iam.IAMSys) holds
    the other identities, `oidc` (iam.oidc.OpenIDConfig) and `ldap`
    (iam.ldap.LDAPConfig) the STS identity providers; without `iam`
    only root authenticates and policy is not consulted."""

    def __init__(self, pools: ServerPools, creds: Credentials,
                 host: str = "127.0.0.1", port: int = 0,
                 certs: tuple[str, str] | None = None, iam=None,
                 oidc=None, ldap=None, client_ca: str | None = None):
        self.pools = pools
        self.creds = creds                 # root credentials (policy bypass)
        self.iam = iam
        self.oidc = oidc
        self.ldap = ldap
        self.client_ca = client_ca
        self.handlers = S3Handlers(pools)
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
            # TCP_NODELAY: a response leaves as headers then body, two
            # writes; with Nagle the body waits for the client's delayed
            # ACK of the headers (the JAX package's zero-copy writer
            # sends both in one sendmsg instead).
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

            def _handle(self):
                # Drain gate + inflight count around the WHOLE request
                # (dispatch and response write): drain() waits for the
                # count to reach zero, so a SIGTERM never severs a
                # response mid-stream.
                path = urllib.parse.unquote(
                    urllib.parse.urlsplit(self.path).path)
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
                with outer._drain_cv:
                    outer._inflight += 1
                try:
                    self._handle_inner()
                finally:
                    with outer._drain_cv:
                        outer._inflight -= 1
                        outer._drain_cv.notify_all()

            def _handle_inner(self):
                self.request_id = secrets.token_hex(8)
                parsed = urllib.parse.urlsplit(self.path)
                path = urllib.parse.unquote(parsed.path)
                query = urllib.parse.parse_qs(parsed.query,
                                              keep_blank_values=True)
                try:
                    if path.startswith("/minio/") and \
                            not path.startswith("/minio/admin/") and \
                            path != "/minio/listen":
                        resp = outer._dispatch_internal(path)
                    else:
                        resp = outer._dispatch(self, path, query)
                except S3Error as e:
                    resp = error_response(e, path, self.request_id)
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
                try:
                    self._respond(resp)
                except (BrokenPipeError, ConnectionResetError,
                        TimeoutError):
                    self.close_connection = True

            do_GET = do_PUT = do_POST = do_DELETE = do_HEAD = _handle

        class _TLSThreadingHTTPServer(ThreadingHTTPServer):
            """TLS handshakes run in the per-connection worker thread:
            wrapping the listening socket would park the accept loop in
            a blocking handshake, letting one silent client stall the
            whole endpoint."""
            ssl_context = None

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
        with self._drain_cv:
            self.draining = True
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._drain_cv.wait(timeout=min(left, 0.25))
            leftover = self._inflight
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

    def _dispatch_internal(self, path: str) -> Response:
        """Unauthenticated infra endpoints (cf.
        cmd/healthcheck-handler.go)."""
        if path == "/minio/health/live":
            return Response(200)
        if path == "/minio/health/ready":
            # ready = serving and not draining: load balancers stop
            # routing here first.
            if self.draining:
                return Response(503, headers={"Retry-After": "1"})
            return Response(200)
        if path == "/minio/health/cluster":
            raise unported("cluster health", "9")
        if path.startswith("/minio/v2/metrics/"):
            raise unported("metrics")
        raise S3Error("MethodNotAllowed")

    def _dispatch(self, req, path: str, query: dict) -> Response:
        if self._stream_eligible(req.command, path, query):
            body, access_key = self._authenticate_streaming(req, path,
                                                            query)
        else:
            body, access_key = self._authenticate(req, path, query)
        method = req.command
        headers = {k: v for k, v in req.headers.items()}
        if path.startswith("/minio/admin/"):
            return self._dispatch_admin(access_key, method, path, query,
                                        body)
        if path == "/minio/listen":
            self._admin_authorize(access_key, "listen", method)
            raise unported("listen")
        h = self.handlers
        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0] if parts[0] else ""
        key = parts[1] if len(parts) > 1 else ""
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
        unported_sub = next((s for s in h.UNPORTED_CONFIGS if s in query),
                            None)
        if unported_sub and method in ("GET", "PUT", "DELETE"):
            raise unported(f"bucket {unported_sub} configuration")
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
                raise unported("bucket notifications (listen)")
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
        if method in ("GET", "PUT") and ("retention" in query
                                         or "legal-hold" in query):
            raise unported("object retention and legal hold")
        if method == "PUT":
            if "partNumber" in query and "uploadId" in query:
                return h.put_part(bucket, key, query, body, headers)
            if "tagging" in query:
                return h.put_object_tagging(bucket, key, query, body)
            return h.put_object(bucket, key, body, headers)
        if method == "GET":
            if "uploadId" in query:
                return h.list_parts(bucket, key, query)
            if "tagging" in query:
                return h.get_object_tagging(bucket, key, query)
            return h.get_object(bucket, key, query, headers)
        if method == "HEAD":
            return h.get_object(bucket, key, query, headers, head=True)
        if method == "DELETE":
            if "uploadId" in query:
                return h.abort_multipart(bucket, key, query)
            return h.delete_object(bucket, key, query, headers)
        if method == "POST":
            if "restore" in query:
                raise unported("restore from a tier")
            if "select" in query:
                raise unported("S3 Select")
            if "uploads" in query:
                return h.create_multipart(bucket, key, headers)
            if "uploadId" in query:
                return h.complete_multipart(bucket, key, query, body)
            raise S3Error("MethodNotAllowed")
        raise S3Error("MethodNotAllowed")


def _json(obj, status: int = 200) -> Response:
    return Response(status, json.dumps(obj).encode(),
                    {"Content-Type": "application/json"})
