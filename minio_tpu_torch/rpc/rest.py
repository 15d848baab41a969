"""RPC core: msgpack over HTTP POST with a bearer token, plane versions
and a health-checked client.

Counterpart of minio_tpu/rpc/rest.py (the reference's internal/rest,
client.go:76,126), with the same wire, so a node of either package
answers the other's calls:

- every RPC is `POST /minio/rpc/{plane}/{version}/{method}` with an
  msgpack map as its body and `Authorization: Bearer <token>`;
- 200 carries the msgpack result; an error is 4xx/5xx with msgpack
  `{"err": <storage error class>, "msg": ...}`, raised again on the
  client as that class (the errors-over-the-wire table of
  cmd/storage-rest-server.go); a bad token is 403;
- each plane declares its wire version (storage v3, lock v2, peer v3,
  health v1); a request at another version is refused with 426 and a
  typed `RPCVersionMismatch` before any method runs, an unknown plane
  with 404 (cf. storageRESTVersion, cmd/storage-rest-common.go:21).

The client marks its endpoint offline on a transport failure and a
background loop probes `health.health` with capped, jittered backoff
until the peer answers; while offline a call fails at once.
Idempotent calls (reads) get a short bounded retry on a transient
transport fault before the endpoint is declared offline; writes never
retry, since a lost response cannot be told from a lost request.
`stats()` counts the retries, the online/offline flips and the calls
refused because the request's deadline ran out.

The per-request RPC deadline (MTPU_RPC_DEADLINE_MS, the reference's
context deadline on its storage REST calls): the S3 front door arms
`set_deadline` for each request, and every RPC the request fans out to
gets min(its own timeout, the budget left); once the budget is spent a
call raises `DeadlineExceeded` without dialing, is never retried and
never marks the peer offline.  The budget is a contextvar registered
with observe/span.py's `carry_var`, so `wrap_ctx` carries it into the
engine's fan-out threads.

The router is transport-independent: `RPCServer` gives it a listener of
its own (tests), and a cluster node mounts the same router under its S3
port (server/server.py), as the reference serves every inter-node plane
on the main port.

Not ported: the seeded network-fault injector (`ChaosTransport`,
MTPU_NETCHAOS), which belongs to the net-chaos tools (ROADMAP Queue A
item 11).
"""

from __future__ import annotations

import contextvars
import errno
import hmac
import http.client
import os
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..cluster.dynamic_timeout import DynamicTimeout
from ..storage import errors as se
from ..utils import msgpackx

HEALTH_METHOD = "health.health"
_ERR_CLASSES = {
    name: cls for name, cls in vars(se).items()
    if isinstance(cls, type) and issubclass(cls, se.StorageError)}

#: Client-side plane versions; each plane module sets its own entry at
#: import, so client and server share one constant.
DEFAULT_PLANE_VERSIONS: dict[str, str] = {"health": "v1"}

#: errnos of a transient peer or network condition (cf.
#: xnet.IsNetworkOrHostDown, internal/net/net.go).
_RETRYABLE_ERRNOS = frozenset({
    errno.ECONNREFUSED, errno.ECONNRESET, errno.ECONNABORTED,
    errno.EPIPE, errno.EHOSTUNREACH, errno.ENETUNREACH,
    errno.ETIMEDOUT, errno.EAGAIN})

_STATS_MU = threading.Lock()
_STATS = {"retries": 0, "went_offline": 0, "came_online": 0,
          "deadline_exceeded": 0}


def stats() -> dict:
    """The process's RPC client counters: idempotent retries, the
    endpoints' offline and online transitions, and the calls refused on
    a spent request deadline."""
    with _STATS_MU:
        return dict(_STATS)


def _count(key: str) -> None:
    with _STATS_MU:
        _STATS[key] += 1


def _is_retryable(exc: BaseException) -> bool:
    """Refused, reset, broken pipe, timeout, peer hung up: worth one more
    try of an idempotent call.  Anything else is not transient."""
    if isinstance(exc, (TimeoutError, ConnectionError,
                        http.client.RemoteDisconnected)):
        return True
    if isinstance(exc, OSError):
        return exc.errno in _RETRYABLE_ERRNOS
    if isinstance(exc, http.client.HTTPException):
        # BadStatusLine("") is a peer that closed mid-response.
        return isinstance(exc, http.client.BadStatusLine)
    return False


class NetworkError(Exception):
    """A transport failure (connect, timeout, HTTP), not an application
    error: quorum logic treats it as an offline drive.  `retryable`
    marks the plausibly transient ones."""

    def __init__(self, msg: str, *, retryable: bool = False):
        super().__init__(msg)
        self.retryable = retryable


class DeadlineExceeded(NetworkError):
    """The caller's request deadline budget ran out before (or while)
    dialing the peer.  NOT a peer-health event: the peer may be fine —
    the REQUEST is out of time — so the client never marks the endpoint
    offline for it, and it is never retried."""

    def __init__(self, msg: str):
        super().__init__(msg, retryable=False)


#: Absolute monotonic deadline for the current request, or None.  Set at
#: the S3 front door from MTPU_RPC_DEADLINE_MS and consulted by every
#: RPC the request fans out to: each hop gets min(per-call timeout,
#: remaining budget), so one wedged peer can never eat more than the
#: request's whole budget.
_DEADLINE: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "mtpu_rpc_deadline", default=None)


def set_deadline(seconds: float):
    """Arm a deadline `seconds` from now; returns the reset token."""
    return _DEADLINE.set(time.monotonic() + seconds)


def clear_deadline(token) -> None:
    _DEADLINE.reset(token)


def deadline_remaining() -> float | None:
    """Seconds left in the current request's budget (may be <= 0), or
    None when no deadline is armed."""
    dl = _DEADLINE.get()
    if dl is None:
        return None
    return dl - time.monotonic()


def request_deadline_ms() -> float:
    """The configured per-request RPC budget (MTPU_RPC_DEADLINE_MS), or
    0 when unset/disabled."""
    try:
        return float(os.environ.get("MTPU_RPC_DEADLINE_MS", "0") or 0)
    except ValueError:
        return 0.0


# Pool-hop propagation: erasure fan-outs run on worker threads, which
# have their own contextvars context; span.wrap_ctx re-sets registered
# vars in the worker so the deadline budget survives the hop.
from ..observe.span import carry_var as _carry_var  # noqa: E402

_carry_var(_DEADLINE)


class RPCVersionMismatch(Exception):
    """The peer speaks another plane version: a deployment error (mixed
    binaries), never retried and never a health event."""

    def __init__(self, plane: str, got: str, want: str):
        self.plane, self.got, self.want = plane, got, want
        super().__init__(
            f"rpc plane {plane!r}: peer wants {want}, client speaks "
            f"{got}; upgrade the older node")


def pack_error(e: Exception) -> bytes:
    return msgpackx.packb({"err": type(e).__name__, "msg": str(e)})


def unpack_error(data: bytes) -> Exception:
    try:
        obj = msgpackx.unpackb(data)
        if obj.get("err") == "RPCVersionMismatch":
            return RPCVersionMismatch(obj.get("plane", "?"),
                                      obj.get("got", "?"),
                                      obj.get("want", "?"))
        cls = _ERR_CLASSES.get(obj.get("err", ""), se.StorageError)
        return cls(obj.get("msg", ""))
    except Exception:  # noqa: BLE001 — a garbled body is still an error
        return se.StorageError(data[:200])


class RPCRouter:
    """Method table and plane-version gate, independent of transport.

    Methods register as "plane.name" and are reached at
    POST /minio/rpc/{plane}/{version}/{name}, under the reserved /minio/
    prefix so that no bucket can shadow a plane (cf. cmd/routers.go:27)."""

    def __init__(self, token: str):
        self.token = token
        self._planes: dict[str, str] = {"health": "v1"}
        self._methods: dict[str, object] = {
            HEALTH_METHOD: lambda p: {"ok": True}}

    def register_plane(self, plane: str, version: str) -> None:
        self._planes[plane] = version

    def register(self, name: str, fn) -> None:
        self._planes.setdefault(name.split(".", 1)[0], "v1")
        self._methods[name] = fn

    def handle(self, path: str, auth_header: str,
               body: bytes) -> tuple[int, bytes]:
        """-> (HTTP status, msgpack body); the token is checked first."""
        if not hmac.compare_digest(auth_header or "",
                                   f"Bearer {self.token}"):
            return 403, pack_error(se.ErrFileAccessDenied("bad rpc token"))
        parts = path.strip("/").split("/")
        if len(parts) != 5 or parts[0] != "minio" or parts[1] != "rpc":
            return 404, pack_error(se.StorageError(f"no such path {path}"))
        _, _, plane, version, method = parts
        want = self._planes.get(plane)
        if want is None:
            return 404, pack_error(
                se.StorageError(f"no such rpc plane {plane!r}"))
        if version != want:
            return 426, msgpackx.packb(
                {"err": "RPCVersionMismatch", "plane": plane,
                 "got": version, "want": want})
        fn = self._methods.get(f"{plane}.{method}")
        if fn is None:
            return 404, pack_error(
                se.StorageError(f"no such method {plane}.{method}"))
        try:
            payload = msgpackx.unpackb(body) if body else {}
            return 200, msgpackx.packb(fn(payload))
        except se.StorageError as e:
            return 500, pack_error(e)
        except Exception as e:  # noqa: BLE001 — typed over the wire
            return 500, pack_error(se.StorageError(
                f"{type(e).__name__}: {e}"))


class RPCServer:
    """An RPCRouter on a listener of its own."""

    def __init__(self, token: str, host: str = "127.0.0.1", port: int = 0,
                 router: RPCRouter | None = None):
        self.router = router or RPCRouter(token)
        self.token = token
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0) or 0)
                body = self.rfile.read(length) if length else b""
                status, out = outer.router.handle(
                    self.path, self.headers.get("Authorization", ""), body)
                self.send_response(status)
                self.send_header("Content-Length", str(len(out)))
                self.send_header("Content-Type", "application/msgpack")
                self.end_headers()
                self.wfile.write(out)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = host, self._httpd.server_port
        self._thread: threading.Thread | None = None

    def register(self, name: str, fn) -> None:
        self.router.register(name, fn)

    def register_plane(self, plane: str, version: str) -> None:
        self.router.register_plane(plane, version)

    def start(self) -> "RPCServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"


class RPCClient:
    """A POST caller with online/offline health state.

    A failed call marks the endpoint offline at once; a background
    checker, started then, probes `health` every `check_interval`
    seconds (doubling, capped at MTPU_PEER_PROBE_MAX_S, jittered) and
    flips it back online when the peer answers (cf.
    internal/rest/client.go:76-124).  Per-call deadlines adapt to the
    peer's measured latency within [min(1, timeout), 4 x timeout].

    `versions` maps plane -> version for the request path; planes
    default to DEFAULT_PLANE_VERSIONS.  `tls_context` dials HTTPS."""

    #: Extra attempts of an idempotent call on a retryable transport
    #: fault, before the endpoint is declared offline.
    RETRIES = 2

    def __init__(self, endpoint: str, token: str, timeout: float = 10.0,
                 check_interval: float = 1.0,
                 versions: dict[str, str] | None = None,
                 tls_context=None):
        host, _, port = endpoint.rpartition(":")
        self.host, self.port = host, int(port)
        self.token = token
        self.timeout = timeout
        self.check_interval = check_interval
        self.tls_context = tls_context
        self.versions = dict(DEFAULT_PLANE_VERSIONS)
        if versions:
            self.versions.update(versions)
        self._online = True
        self._checker_running = False
        self._lock = threading.Lock()
        self._closed = False
        self.dyn_timeout = DynamicTimeout(
            default_s=timeout, minimum_s=min(1.0, timeout),
            maximum_s=timeout * 4)
        self.transitions = 0
        self.last_seen = 0.0
        self.offline_since = 0.0
        self.probe_failures = 0

    # -- health --------------------------------------------------------------

    def is_online(self) -> bool:
        return self._online

    def _mark_offline(self) -> None:
        flipped = False
        with self._lock:
            if self._online:
                self._online = False
                self.transitions += 1
                self.offline_since = time.monotonic()
                flipped = True
            if not self._checker_running and not self._closed:
                self._checker_running = True
                threading.Thread(target=self._health_loop,
                                 daemon=True).start()
        if flipped:
            _count("went_offline")

    def _mark_online(self) -> None:
        with self._lock:
            if self._online:
                return
            self._online = True
            self._checker_running = False
            self.transitions += 1
            self.offline_since = 0.0
        self.probe_failures = 0
        _count("came_online")

    def _health_loop(self) -> None:
        # Capped exponential backoff with jitter: a peer that just died
        # is probed soon, a long-dead one at most every
        # MTPU_PEER_PROBE_MAX_S, and the survivors never probe a
        # rebooting node in lockstep.
        try:
            max_s = float(os.environ.get("MTPU_PEER_PROBE_MAX_S",
                                         "15") or 15)
        except ValueError:
            max_s = 15.0
        attempt = 0
        while not self._closed:
            delay = min(self.check_interval * (2 ** attempt), max_s)
            time.sleep(delay * (0.5 + random.random()))
            try:
                self._raw_call(HEALTH_METHOD, {}, timeout=2.0)
            except (NetworkError, se.StorageError):
                attempt += 1
                self.probe_failures = attempt
                continue
            self._mark_online()
            return
        with self._lock:
            self._checker_running = False

    def probe_now(self) -> bool:
        """A synchronous health probe: flips the endpoint online when the
        peer answers, and returns whether it did."""
        try:
            self._raw_call(HEALTH_METHOD, {}, timeout=2.0)
        except (NetworkError, se.StorageError):
            return False
        self._mark_online()
        return True

    def peer_info(self) -> dict:
        """The liveness row of this peer."""
        now = time.monotonic()
        return {
            "endpoint": f"{self.host}:{self.port}",
            "online": self._online,
            "transitions": self.transitions,
            "last_seen_ago_s": (round(now - self.last_seen, 3)
                                if self.last_seen else -1.0),
            "offline_for_s": (round(now - self.offline_since, 3)
                              if self.offline_since else 0.0),
            "probe_failures": self.probe_failures,
            "timeout_s": round(self.dyn_timeout.timeout(), 3),
        }

    def close(self) -> None:
        self._closed = True

    # -- calls ---------------------------------------------------------------

    def _path_for(self, method: str) -> str:
        plane, _, name = method.partition(".")
        return f"/minio/rpc/{plane}/{self.versions.get(plane, 'v1')}/{name}"

    def _raw_call(self, method: str, payload: dict,
                  timeout: float | None = None) -> object:
        body = msgpackx.packb(payload)
        me = f"{self.host}:{self.port} {method}"
        # Effective per-call timeout: explicit (health probes) wins,
        # else the peer's measured adaptive deadline — both clamped to
        # the request's remaining deadline budget.
        eff = timeout if timeout is not None else self.dyn_timeout.timeout()
        rem = deadline_remaining()
        if rem is not None:
            if rem <= 0:
                _count("deadline_exceeded")
                raise DeadlineExceeded(f"{me}: request deadline exhausted")
            eff = min(eff, rem)
        if self.tls_context is not None:
            conn = http.client.HTTPSConnection(
                self.host, self.port, timeout=eff, context=self.tls_context)
        else:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=eff)
        t0 = time.monotonic()
        try:
            conn.request("POST", self._path_for(method), body=body,
                         headers={"Authorization": f"Bearer {self.token}",
                                  "Content-Type": "application/msgpack"})
            resp = conn.getresponse()
            data = resp.read()
        except (OSError, http.client.HTTPException) as e:
            if isinstance(e, TimeoutError):
                # Only a real timeout grows the adaptive deadline.
                self.dyn_timeout.log_timeout()
            raise NetworkError(f"{me}: {e}",
                               retryable=_is_retryable(e)) from None
        finally:
            conn.close()
        self.dyn_timeout.log_success(time.monotonic() - t0)
        self.last_seen = time.monotonic()
        if resp.status != 200:
            raise unpack_error(data)
        return msgpackx.unpackb(data) if data else None

    def call(self, method: str, payload: dict | None = None,
             idempotent: bool = False) -> object:
        """One RPC.  An application error from the peer (a StorageError)
        does not mark it offline, nor does a version mismatch; only a
        transport failure does.  `idempotent` allows RETRIES more
        attempts, with jittered exponential backoff, on a retryable
        transport fault."""
        if not self._online:
            raise NetworkError(f"{self.host}:{self.port} is offline")
        attempts = self.RETRIES + 1 if idempotent else 1
        for i in range(attempts):
            try:
                return self._raw_call(method, payload or {})
            except DeadlineExceeded:
                # Out of REQUEST budget, not a peer fault: never retried
                # (there is no time left) and never a health event.
                raise
            except NetworkError as e:
                if e.retryable and i + 1 < attempts:
                    _count("retries")
                    time.sleep(0.05 * (2 ** i) * (1.0 + 0.5 * random.random()))
                    continue
                self._mark_offline()
                raise
