"""PubSub: publish to every subscriber's bounded queue, nothing to none.

The port's copy of the PubSub of minio_tpu/observe/trace.py (the
internal/pubsub role): ListenNotification streams subscribe to the
notification system's tap here (bucket/notify.py).  Publish is a no-op
when nobody subscribes.  The HTTP tracer of the same JAX module waits
for observe/ (ROADMAP.md Queue A item 10.5).
"""

from __future__ import annotations

import threading
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
