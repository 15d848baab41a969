"""HTTP trace pubsub: zero-cost when nobody subscribes.

The port's copy of minio_tpu/observe/trace.py (the cmd/http-tracer.go:117
+ internal/pubsub role).  `PubSub` publishes to every subscriber's
bounded queue and to none when nobody subscribes: ListenNotification
streams subscribe to the notification system's tap here
(bucket/notify.py), and the span tracer (observe/span.py) fans its trace
records out through one.  `HTTPTracer` builds one TraceInfo (timings,
sizes, status) per request, which the admin `trace` GET ring reads.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class PubSub:
    def __init__(self):
        self._mu = threading.Lock()
        self._subs: list[deque] = []

    def subscribe(self, maxlen: int = 1000) -> deque:
        q: deque = deque(maxlen=maxlen)
        with self._mu:
            self._subs.append(q)
        return q

    def unsubscribe(self, q: deque) -> None:
        with self._mu:
            try:
                self._subs.remove(q)
            except ValueError:
                pass

    def publish(self, item) -> None:
        with self._mu:
            subs = list(self._subs)
        for q in subs:
            q.append(item)

    @property
    def num_subscribers(self) -> int:
        with self._mu:
            return len(self._subs)


class HTTPTracer:
    def __init__(self):
        self.pubsub = PubSub()

    def active(self) -> bool:
        return self.pubsub.num_subscribers > 0

    def trace(self, *, method: str, path: str, status: int,
              duration_ms: float, request_size: int = 0,
              response_size: int = 0, api_name: str = "",
              source_ip: str = "") -> None:
        if not self.active():
            return
        self.pubsub.publish({
            "time": time.time(),
            "api": api_name or method,
            "method": method,
            "path": path,
            "statusCode": status,
            "durationMs": round(duration_ms, 3),
            "requestSize": request_size,
            "responseSize": response_size,
            "sourceIp": source_ip,
        })
