"""The port's copy of minio_tpu/observe/logger.py.

Structured logging + audit events with pluggable targets.

The internal/logger equivalent: JSON log records with levels and
request-scoped fields, fan-out to targets (console/ring buffer/HTTP
webhook), one-time dedup (logOnce), and S3 audit entries
(internal/logger/audit.go) describing every API call.
"""

from __future__ import annotations

import datetime
import http.client
import json
import sys
import threading
import urllib.parse
from collections import deque


class ConsoleTarget:
    def __init__(self, stream=None):
        self.stream = stream or sys.stderr

    def send(self, entry: dict) -> None:
        self.stream.write(json.dumps(entry) + "\n")


class RingTarget:
    """In-memory ring — feeds `admin console`-style live tails
    (cf. cmd/consolelogger.go)."""

    def __init__(self, size: int = 1000):
        self.entries: deque = deque(maxlen=size)
        self._mu = threading.Lock()

    def send(self, entry: dict) -> None:
        with self._mu:
            self.entries.append(entry)

    def tail(self, n: int = 100) -> list[dict]:
        with self._mu:
            return list(self.entries)[-n:]


class WebhookTarget:
    def __init__(self, endpoint: str, timeout: float = 3.0):
        self.endpoint = endpoint
        self.timeout = timeout
        self.failed = 0

    def send(self, entry: dict) -> None:
        u = urllib.parse.urlsplit(self.endpoint)
        try:
            conn = http.client.HTTPConnection(u.hostname, u.port or 80,
                                              timeout=self.timeout)
            conn.request("POST", u.path or "/",
                         body=json.dumps(entry).encode(),
                         headers={"Content-Type": "application/json"})
            conn.getresponse().read()
            conn.close()
        except OSError:
            self.failed += 1


class Logger:
    LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40,
              "fatal": 50}

    def __init__(self, level: str = "info"):
        self.level = self.LEVELS[level]
        self.targets: list = [ConsoleTarget()]
        self._once: set[str] = set()
        self._mu = threading.Lock()

    def add_target(self, target) -> None:
        self.targets.append(target)

    def _emit(self, level: str, msg: str, **fields) -> None:
        if self.LEVELS[level] < self.level:
            return
        entry = {"time": datetime.datetime.now(
                     datetime.timezone.utc).isoformat(),
                 "level": level, "message": msg, **fields}
        for t in self.targets:
            try:
                t.send(entry)
            except Exception:  # noqa: BLE001 — logging must not throw
                continue

    def info(self, msg: str, **fields) -> None:
        self._emit("info", msg, **fields)

    def warning(self, msg: str, **fields) -> None:
        self._emit("warning", msg, **fields)

    def error(self, msg: str, **fields) -> None:
        self._emit("error", msg, **fields)

    def log_once(self, level: str, msg: str, key: str, **fields) -> None:
        """Deduplicated logging (cf. logonce.go): one emission per key."""
        with self._mu:
            if key in self._once:
                return
            self._once.add(key)
        self._emit(level, msg, **fields)


def audit_entry(*, method: str, path: str, status: int, duration_ms: float,
                access_key: str = "", source_ip: str = "",
                request_id: str = "", api_name: str = "") -> dict:
    """S3 audit record (cf. internal/logger/message/audit)."""
    return {
        "version": "1",
        "time": datetime.datetime.now(
            datetime.timezone.utc).isoformat(),
        "api": {"name": api_name or method, "statusCode": status,
                "timeToResponse": f"{duration_ms:.2f}ms"},
        "requestPath": path,
        "requestID": request_id,
        "accessKey": access_key,
        "remoteHost": source_ip,
    }
