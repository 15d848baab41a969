"""The port's copy of minio_tpu/observe/audit.py.

Structured audit + error log targets (internal/logger audit plane).

One JSON entry per S3/admin request — including requests rejected
before handler dispatch (auth failure, drain 503, malformed chunked
framing) — fanned into pluggable ASYNC targets.  The request path only
ever does a non-blocking bounded-queue put: a slow or dead sink sheds
entries (counted, exported as mtpu_audit_dropped_total) instead of
stalling the data plane.

Targets:
  - FileAuditTarget: fsync-free JSONL appender (flush to page cache
    per entry; audit is an operational trail, not a durability log).
  - WebhookAuditTarget: HTTP POST per entry with capped-exponential-
    backoff retry; exhausted retries drop the entry (counted).

Configured by the MTPU_AUDIT env (comma-separated):
  MTPU_AUDIT=file:/var/log/mtpu-audit.jsonl,webhook:http://collector/
Unset, empty, or "0" disables the plane entirely (the kill switch —
the request path then skips entry construction too).
"""

from __future__ import annotations

import collections
import datetime
import http.client
import json
import os
import threading
import time
from urllib.parse import urlparse

#: Per-target bounded queue depth (entries) before load shedding.
QUEUE_ENV = "MTPU_AUDIT_QUEUE"
DEFAULT_QUEUE = 1024


class AuditTarget:
    """Bounded async sink: `send` never blocks (a deque append behind
    a length check — no lock handoff, no drain-thread wakeup per
    request), a dedicated polling drain thread delivers in batches.
    Subclasses implement `_deliver` (per entry) and may override
    `_deliver_batch` when the sink amortizes (one write+flush per
    batch for the file target)."""

    kind = "base"
    #: Drain poll interval — the ceiling on delivery latency, and the
    #: reason the request path never pays a context switch: the drain
    #: thread wakes on its own clock, not per enqueue.
    POLL_S = 0.02
    #: Max entries pulled per drain pass (bounds sink-call latency).
    BATCH = 512

    def __init__(self, name: str, queue_size: int | None = None):
        if queue_size is None:
            queue_size = int(os.environ.get(QUEUE_ENV, "") or
                             DEFAULT_QUEUE)
        self.name = name
        self.maxsize = max(1, queue_size)
        self._q: collections.deque = collections.deque()
        self.emitted = 0        # entries delivered to the sink
        self.dropped = 0        # entries shed (queue full / sink dead)
        self.retries = 0        # delivery re-attempts (webhook)
        self._closed = False
        self._closing = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"audit-{self.kind}", daemon=True)
        self._thread.start()

    # -- request path --------------------------------------------------------

    def send(self, entry: dict) -> None:
        """Non-blocking enqueue: a full queue sheds the entry (counted)
        rather than stalling the request that produced it."""
        if len(self._q) >= self.maxsize:
            self.dropped += 1
            return
        self._q.append(entry)

    # -- drain thread --------------------------------------------------------

    def _run(self) -> None:
        while True:
            closing = self._closing.is_set()
            batch = []
            while self._q and len(batch) < self.BATCH:
                batch.append(self._q.popleft())
            if batch:
                try:
                    ok = self._deliver_batch(batch)
                    self.emitted += ok
                    self.dropped += len(batch) - ok
                except Exception:  # noqa: BLE001 — a sink bug never
                    self.dropped += len(batch)      # kills the drain
                continue            # drain to empty before sleeping
            if closing:
                self._on_close()
                return
            self._closing.wait(self.POLL_S)

    def _deliver_batch(self, batch: list[dict]) -> int:
        ok = 0
        for entry in batch:
            try:
                ok += bool(self._deliver(entry))
            except Exception:  # noqa: BLE001 — count, keep draining
                pass
        return ok

    def _deliver(self, entry: dict) -> bool:
        raise NotImplementedError

    def _on_close(self) -> None:
        pass

    # -- lifecycle / introspection ------------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        """Flush what is queued (one final drain pass runs after the
        closing flag is set), then stop the drain thread."""
        if self._closed:
            return
        self._closed = True
        self._closing.set()
        self._thread.join(timeout)

    def stats(self) -> dict:
        return {"target": self.name, "kind": self.kind,
                "emitted": self.emitted, "dropped": self.dropped,
                "retries": self.retries, "queued": len(self._q)}


class FileAuditTarget(AuditTarget):
    """JSONL file appender.  flush() per entry (page cache), never
    fsync — an audit trail must not serialize the write path on disk
    latency the way the MRF journal deliberately does."""

    kind = "file"

    def __init__(self, path: str, queue_size: int | None = None):
        self.path = path
        self._fh = open(path, "a", encoding="utf-8")
        super().__init__(name=path, queue_size=queue_size)

    def _deliver_batch(self, batch: list[dict]) -> int:
        self._fh.write("".join(
            json.dumps(e, separators=(",", ":")) + "\n" for e in batch))
        self._fh.flush()
        return len(batch)

    def _deliver(self, entry: dict) -> bool:
        return self._deliver_batch([entry]) == 1

    def _on_close(self) -> None:
        try:
            self._fh.flush()
            self._fh.close()
        except Exception:  # noqa: BLE001
            pass


class WebhookAuditTarget(AuditTarget):
    """HTTP POST per entry with capped exponential backoff.  Retrying
    happens on the drain thread, so a struggling collector back-
    pressures into the bounded queue (which sheds), never into the
    request path."""

    kind = "webhook"
    MAX_TRIES = 5
    BACKOFF_BASE_S = 0.05
    BACKOFF_CAP_S = 2.0

    def __init__(self, url: str, queue_size: int | None = None,
                 timeout: float = 2.0):
        u = urlparse(url)
        self.url = url
        self.tls = u.scheme == "https"
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or (443 if self.tls else 80)
        self.req_path = (u.path or "/") + (f"?{u.query}" if u.query
                                           else "")
        self.timeout = timeout
        super().__init__(name=url, queue_size=queue_size)

    def _deliver(self, entry: dict) -> bool:
        body = json.dumps(entry).encode()
        delay = self.BACKOFF_BASE_S
        for attempt in range(self.MAX_TRIES):
            if attempt:
                self.retries += 1
                time.sleep(delay)
                delay = min(delay * 2, self.BACKOFF_CAP_S)
            try:
                cls = (http.client.HTTPSConnection if self.tls
                       else http.client.HTTPConnection)
                conn = cls(self.host, self.port, timeout=self.timeout)
                try:
                    conn.request("POST", self.req_path, body=body,
                                 headers={"Content-Type":
                                          "application/json"})
                    resp = conn.getresponse()
                    resp.read()
                    if resp.status < 300:
                        return True
                finally:
                    conn.close()
            except OSError:
                continue
        return False


def targets_from_env(spec: str | None = None) -> list[AuditTarget]:
    """Build the target list from MTPU_AUDIT (or an explicit spec).
    Unknown target kinds fail loudly — a typo must not silently
    disable the audit trail."""
    if spec is None:
        spec = os.environ.get("MTPU_AUDIT", "")
    spec = spec.strip()
    if not spec or spec == "0":
        return []
    out: list[AuditTarget] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if part.startswith("file:"):
            out.append(FileAuditTarget(part[len("file:"):]))
        elif part.startswith("webhook:"):
            out.append(WebhookAuditTarget(part[len("webhook:"):]))
        elif part.startswith(("http://", "https://")):
            out.append(WebhookAuditTarget(part))
        else:
            raise ValueError(f"unknown MTPU_AUDIT target {part!r}")
    return out


def build_entry(*, api: str, method: str, path: str, status: int,
                error_code: str | None = None,
                bucket: str | None = None,
                object_name: str | None = None,
                access_key: str = "", source_ip: str = "",
                request_id: str = "", rx: int = 0, tx: int = 0,
                duration_ms: float = 0.0,
                stages: dict[str, float] | None = None,
                node: str = "", worker: int | None = None) -> dict:
    """One structured audit record (richer sibling of
    observe.logger.audit_entry, which stays for the console/ring
    logging plane)."""
    entry = {
        "version": "2",
        "time": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="milliseconds"),
        "node": node,
        "worker": worker,
        "api": {
            "name": api,
            "method": method,
            "statusCode": status,
            "errorCode": error_code,
            "rx": rx,
            "tx": tx,
            "timeToResponseMs": round(duration_ms, 3),
        },
        "bucket": bucket,
        "object": object_name,
        "requestPath": path,
        "requestID": request_id,
        "accessKey": access_key,
        "remoteHost": source_ip,
    }
    if stages:
        entry["stages"] = {k: round(v, 3) for k, v in stages.items()}
    return entry
