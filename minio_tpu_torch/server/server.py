"""The single-node S3 HTTP server: routing, auth dispatch, streamed bodies.

The slim port of minio_tpu/server/server.py (the reference's
internal/http server + cmd/routers.go:82 + cmd/auth-handler.go:281): a
threading HTTP server whose one dispatch point classifies a request
(presigned / header-signed / streaming-signed / anonymous), verifies
SigV4, then routes on (method, path shape, query) the way
cmd/api-router.go:175 registers routes.  Object PUTs and parts stream
from the socket into the erasure engine; GETs stream back in device
batches.

Authorization is the root credentials' alone: an anonymous request is
AccessDenied.  What answers NotImplemented, with its ROADMAP.md Queue A
item: SigV2 and POST-policy uploads and STS (item 3b); bucket policies,
IAM, the admin API, metrics and listen (item 10); cluster health (item
9).  Spans, metrics, the audit trail, QoS, federation and zero-copy
sends stay in the JAX package for now.
"""

from __future__ import annotations

import os
import secrets
import ssl
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..engine.pools import ServerPools
from ..utils import streams
from .api_errors import S3Error
from .handlers import Response, S3Handlers, error_response, unported
from .sigv4 import (STREAMING_PAYLOAD, UNSIGNED_PAYLOAD, Credentials,
                    StreamingSigV4Reader, decode_streaming_body,
                    verify_header_signature, verify_presigned)

MAX_HEADER_BODY = 5 * 1024 ** 3      # max single PUT (5 GiB part limit)


def _is_v2_header(auth: str) -> bool:
    """A SigV2 Authorization header (minio_tpu/server/sigv2.py:81)."""
    return auth.startswith("AWS ") and ":" in auth


def _is_v2_presigned(query: dict) -> bool:
    """A SigV2 presigned query (minio_tpu/server/sigv2.py:85)."""
    return "AWSAccessKeyId" in query and "Signature" in query


class S3Server:
    """Owns the object layer, the root credentials and the HTTP
    plumbing.  `certs` = (cert file, key file) serves HTTPS."""

    def __init__(self, pools: ServerPools, creds: Credentials,
                 host: str = "127.0.0.1", port: int = 0,
                 certs: tuple[str, str] | None = None):
        self.pools = pools
        self.creds = creds                 # root credentials
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
        return self.creds if access_key == self.creds.access_key else None

    @staticmethod
    def _refuse_v2(auth: str, query: dict) -> None:
        if _is_v2_presigned(query) or _is_v2_header(auth):
            raise unported("SigV2 authentication", "3b")

    def _authenticate(self, req, path: str,
                      query: dict) -> tuple[bytes, str]:
        """Classify + verify auth; returns (decoded body, access_key),
        "" for an anonymous request.  cf. checkRequestAuthType,
        cmd/auth-handler.go:281."""
        headers = {k: v for k, v in req.headers.items()}
        headers.setdefault("Host", f"{self.host}:{self.port}")
        body = self._read_body(req)
        auth = req.headers.get("Authorization", "")
        self._refuse_v2(auth, query)
        if "X-Amz-Signature" in query:
            return body, verify_presigned(self._lookup_creds, req.command,
                                          path, query, headers)
        if not auth:
            return body, ""
        payload_decl, ak = verify_header_signature(
            self._lookup_creds, req.command, path, query, headers, body)
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
        never lands in server memory whole.  Signed-payload requests get
        a SHA-256-verifying reader (hash checked at EOF, like the
        reference's hash.Reader); aws-chunked bodies a per-chunk
        signature-verifying decoder."""
        headers = {k: v for k, v in req.headers.items()}
        headers.setdefault("Host", f"{self.host}:{self.port}")
        raw = self._body_reader(req)
        auth = req.headers.get("Authorization", "")
        self._refuse_v2(auth, query)
        if "X-Amz-Signature" in query:
            return raw, verify_presigned(self._lookup_creds, req.command,
                                         path, query, headers)
        if not auth:
            return raw, ""
        payload_decl, ak = verify_header_signature(
            self._lookup_creds, req.command, path, query, headers,
            body=None)
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
        if payload_decl != UNSIGNED_PAYLOAD:
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
        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0] if parts[0] else ""
        key = parts[1] if len(parts) > 1 else ""
        if method == "POST" and not bucket:
            raise unported("STS", "3b")
        ctype = headers.get("Content-Type", headers.get("content-type", ""))
        if (method == "POST" and bucket and not key
                and "delete" not in query
                and ctype.startswith("multipart/form-data")):
            raise unported("POST-policy upload", "3b")
        if not access_key:
            # Only a bucket policy could grant it (item 10).
            raise S3Error("AccessDenied", "anonymous access denied")
        if path.startswith("/minio/admin/") or path == "/minio/listen":
            raise unported("the admin API and listen")
        h = self.handlers
        if not bucket:
            if method == "GET":
                return h.list_buckets()
            raise S3Error("MethodNotAllowed")
        if not key:
            return self._dispatch_bucket(method, bucket, query, body)
        return self._dispatch_object(method, bucket, key, query, headers,
                                     body)

    def _dispatch_bucket(self, method, bucket, query, body) -> Response:
        h = self.handlers
        unported_sub = next((s for s in h.UNPORTED_CONFIGS if s in query),
                            None)
        if unported_sub and method in ("GET", "PUT", "DELETE"):
            raise unported(f"bucket {unported_sub} configuration")
        config_sub = "tagging" if "tagging" in query else None
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
                return h.delete_objects(bucket, body)
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
