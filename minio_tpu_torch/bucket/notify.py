"""Event notification: rules, S3 event records, targets, queue store.

The port of minio_tpu/bucket/notify.py (the internal/event role): bucket
notification configs match (event name, prefix/suffix filter) -> target
ARN; matching object events become S3-format JSON records delivered to
targets.  Targets here: WebhookTarget (HTTP POST), the broker targets of
bucket/event_targets.py, and QueueTarget, an in-process queue with
optional on-disk persistence: the queue store (target/queuestore.go)
that parks an event while its target is down.

The port repairs five faults of the JAX store:

- A target with parked events retries them on its own, every
  `RETRY_INTERVAL_S` seconds, until none is left; the JAX
  `retry_backlog` has no caller, so a running JAX server never delivers
  a parked event.
- A parked event's file is removed only after that event was
  delivered (`QueueTarget.pending` / `ack`): a process killed during a
  retry pass loses nothing, and an event may arrive twice (delivery is
  at least once, as the reference's store gives).  The JAX `drain`
  unlinks every file of the store before the pass sends any.
- One store serves every process of a deployment: the pool's workers
  park in the kind's one directory (`<kind>/`, the JAX layout, which one
  process and a cluster node use too).  Its tickets come from a counter
  read and advanced under the store's flock (`<store>.seq`), so their
  names sort in pool-wide arrival order, and exactly one retry loop
  drains it: the one that holds the store's sender lock
  (`<store>.sender`), taken over by the next loop when its holder dies.
  What a pool of the per-worker layout left under `<kind>/w<N>` is
  adopted in ticket order (`adopt_store`).
- While the store holds an event, parked by any process, a new event
  parks behind it (`_Backlogged.send`), and the store's one sender
  delivers it in arrival order: once the target is back, a key's DELETE
  never reaches it before that key's parked PUT, whichever workers
  served the two.  The JAX `send` posts a new event straight away,
  overtaking the store.
- An event whose rule names an ARN with no registered target is counted
  (`dropped`).  The server refuses such a rule when it is stored
  (server/handlers.py `_check_arns`), as MinIO does; what is counted is
  what a rule stored before that check still names.

Counters (`stats`): events sent to targets, delivered, parked,
delivered by a retry pass, and dropped for want of a target; the server
adds the backlog's depth.
"""

from __future__ import annotations

import contextlib
import datetime
import fcntl
import http.client
import json
import os
import sys
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET

from ..observe.trace import PubSub

#: seconds between a target's retry passes over its parked events
RETRY_INTERVAL_S = 1.0

_STATS_MU = threading.Lock()
_STATS = {"sent": 0, "delivered": 0, "parked": 0, "retried": 0,
          "dropped": 0}


def _count(name: str, n: int = 1) -> None:
    with _STATS_MU:
        _STATS[name] += n


def stats() -> dict:
    """This process's event counters."""
    with _STATS_MU:
        return dict(_STATS)


class NotificationRule:
    def __init__(self, arn: str, events: list[str], prefix: str = "",
                 suffix: str = ""):
        self.arn = arn
        self.events = events
        self.prefix = prefix
        self.suffix = suffix

    def matches(self, event_name: str, key: str) -> bool:
        ok = any(event_name == e or
                 (e.endswith("*") and event_name.startswith(e[:-1]))
                 for e in self.events)
        return (ok and key.startswith(self.prefix)
                and key.endswith(self.suffix))


def parse_notification_config(xml_bytes: bytes) -> list[NotificationRule]:
    """NotificationConfiguration XML (QueueConfiguration entries)."""
    root = ET.fromstring(xml_bytes)
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    rules = []
    for qc in list(root.iter("QueueConfiguration")) + \
            list(root.iter("TopicConfiguration")) + \
            list(root.iter("CloudFunctionConfiguration")):
        arn = qc.findtext("Queue") or qc.findtext("Topic") or \
            qc.findtext("CloudFunction") or ""
        events = [e.text for e in qc.iter("Event") if e.text]
        prefix = suffix = ""
        for fr in qc.iter("FilterRule"):
            name = (fr.findtext("Name") or "").lower()
            value = fr.findtext("Value") or ""
            if name == "prefix":
                prefix = value
            elif name == "suffix":
                suffix = value
        rules.append(NotificationRule(arn, events, prefix, suffix))
    return rules


def make_event(event_name: str, bucket: str, key: str, size: int = 0,
               etag: str = "", version_id: str = "") -> dict:
    """S3 event record JSON (cf. internal/event/event.go)."""
    now = datetime.datetime.now(datetime.timezone.utc)
    return {
        "eventVersion": "2.1",
        "eventSource": "minio_tpu:s3",
        "eventTime": now.strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z",
        "eventName": event_name,
        "s3": {
            "s3SchemaVersion": "1.0",
            "bucket": {"name": bucket,
                       "arn": f"arn:aws:s3:::{bucket}"},
            "object": {"key": urllib.parse.quote(key),
                       "size": size, "eTag": etag,
                       "versionId": version_id,
                       "sequencer": uuid.uuid4().hex[:16]},
        },
    }


class QueueTarget:
    """In-process queue with optional persistence (the queue store): one
    JSON file per event in `store_dir`.

    A store directory is shared by every process that opens it (the
    pool's workers): the directory, not this process's memory, holds
    what is parked.  A ticket is `<n>-<random>.json`, n read and
    advanced under the flock of `<store_dir>.seq` (never below the
    clock's nanoseconds, so it sorts after what an older layout named by
    time), and its file is written under that lock: the names sort in
    arrival order across processes.  Without a store the queue lives in
    memory."""

    def __init__(self, arn: str, store_dir: str | None = None,
                 max_items: int = 10000):
        self.arn = arn
        self.store_dir = store_dir
        self.max_items = max_items
        self._mu = threading.Lock()
        # Without a store: ticket (a counter) -> event.
        self._items: dict[str, dict] = {}
        self._seq = 0
        if store_dir:
            os.makedirs(store_dir, exist_ok=True)

    @contextlib.contextmanager
    def _held(self):
        """This process's lock, then the store's flock of every process
        (on a descriptor opened for the hold: a dead holder's lock dies
        with it).  Yields the descriptor, whose file keeps the counter."""
        with self._mu:
            fd = os.open(self.store_dir + ".seq", os.O_RDWR | os.O_CREAT,
                         0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                yield fd
            finally:
                os.close(fd)             # drops the flock

    def _tickets(self) -> list[str]:
        try:
            names = os.listdir(self.store_dir)
        except OSError:
            return []
        return sorted(n for n in names if n.endswith(".json"))

    def _load(self, ticket: str) -> dict | None:
        try:
            with open(os.path.join(self.store_dir, ticket)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @property
    def events(self) -> list[dict]:
        return [ev for _, ev in self.pending()]

    def __len__(self) -> int:
        if self.store_dir:
            return len(self._tickets())
        with self._mu:
            return len(self._items)

    def _unlink(self, ticket: str) -> None:
        try:
            os.unlink(os.path.join(self.store_dir, ticket))
        except OSError:
            pass

    def send(self, event: dict) -> str:
        """Park `event`; returns its ticket."""
        if not self.store_dir:
            with self._mu:
                if len(self._items) >= self.max_items:
                    del self._items[next(iter(self._items))]
                self._seq += 1
                ticket = str(self._seq)
                self._items[ticket] = event
                return ticket
        with self._held() as fd:
            tickets = self._tickets()
            for old in tickets[:max(0, len(tickets) - self.max_items + 1)]:
                self._unlink(old)
            try:
                last = int(os.pread(fd, 32, 0).strip() or 0)
            except ValueError:
                last = 0
            n = max(last + 1, time.time_ns())
            os.ftruncate(fd, 0)
            os.pwrite(fd, b"%d\n" % n, 0)
            ticket = f"{n:020d}-{os.urandom(4).hex()}.json"
            path = os.path.join(self.store_dir, ticket)
            with open(path + ".tmp", "w") as f:
                json.dump(event, f)
            os.replace(path + ".tmp", path)
            return ticket

    def pending(self) -> list[tuple[str, dict]]:
        """The parked events in order, each with its ticket."""
        if not self.store_dir:
            with self._mu:
                return list(self._items.items())
        out = []
        for ticket in self._tickets():
            ev = self._load(ticket)
            if ev is not None:
                out.append((ticket, ev))
        return out

    def ack(self, ticket: str) -> None:
        """The event was delivered: forget it and remove its file."""
        if self.store_dir:
            self._unlink(ticket)
            return
        with self._mu:
            self._items.pop(ticket, None)

    def take_sender(self):
        """The store's sender lock (`<store_dir>.sender`, flock, not
        waited for): a descriptor to close when done, or None while
        another loop holds it.  Without a store there is nothing to
        share: always granted."""
        if not self.store_dir:
            return -1
        fd = os.open(self.store_dir + ".sender", os.O_RDWR | os.O_CREAT,
                     0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return None
        return fd


def adopt_store(store_dir: str, sources) -> int:
    """Move the event files of each directory in `sources` into
    `store_dir` (what another layout of the store left), under the
    store's lock, keeping their names (they sort in ticket order);
    returns how many moved."""
    os.makedirs(store_dir, exist_ok=True)
    moved = 0
    with QueueTarget("adopt", store_dir)._held():
        for src in sources:
            try:
                names = sorted(n for n in os.listdir(src)
                               if n.endswith(".json"))
            except OSError:
                continue
            for fn in names:
                try:
                    os.replace(os.path.join(src, fn),
                               os.path.join(store_dir, fn))
                    moved += 1
                except OSError:
                    continue
    return moved


class _Backlogged:
    """The park-and-retry shell of a delivering target: `_deliver(event)
    -> bool` is the subclass's.  A failed send parks the event and starts
    this target's retry loop, which runs while events are parked; of the
    loops over one store, the one holding its sender lock sends."""

    def _init_backlog(self, arn: str, store_dir: str | None) -> None:
        self.backlog = QueueTarget(arn + "-backlog", store_dir)
        self._retry_mu = threading.Lock()
        self._pass_mu = threading.Lock()
        self._retry_thread: threading.Thread | None = None
        self._sender = None              # the loop's sender lock, held
        self._closed = threading.Event()

    def kick(self) -> None:
        """Start the retry loop when events are parked (what a previous
        process left in the store): NotificationSystem.register_target
        calls it."""
        if len(self.backlog):
            self._start_retry()

    def send(self, event: dict) -> None:
        """Deliver `event` now when the store is empty, else (or when
        the delivery fails) park it behind the parked ones, whichever
        process parked them: the store's sender delivers in arrival
        order."""
        if not len(self.backlog):
            if self._deliver(event):
                _count("delivered")
                return
        self.backlog.send(event)
        _count("parked")
        self._start_retry()

    def retry_backlog(self) -> int:
        """One pass over the parked events, in order: each is removed
        from the store once delivered; the first that fails ends the
        pass (the target is still down).  A pass runs only under the
        store's sender lock (this loop's, or taken for the pass): while
        another process sends, it delivers nothing.  Returns how many
        were delivered."""
        sent = 0
        with self._pass_mu:
            own = self._sender is None
            lock = self.backlog.take_sender() if own else self._sender
            if lock is None:
                return 0
            try:
                for ticket, ev in self.backlog.pending():
                    if not self._deliver(ev):
                        break
                    self.backlog.ack(ticket)
                    sent += 1
                    _count("delivered")
                    _count("retried")
            finally:
                if own and lock >= 0:
                    os.close(lock)
        return sent

    def _start_retry(self) -> None:
        with self._retry_mu:
            if self._retry_thread is not None or self._closed.is_set():
                return
            self._retry_thread = threading.Thread(
                target=self._retry_loop, name="mtpu-notify-retry",
                daemon=True)
            self._retry_thread.start()

    def _drop_sender(self) -> None:
        with self._pass_mu:
            if self._sender is not None and self._sender >= 0:
                os.close(self._sender)
            self._sender = None

    def _retry_loop(self) -> None:
        try:
            while not self._closed.wait(RETRY_INTERVAL_S):
                if self._sender is None:
                    with self._pass_mu:
                        self._sender = self.backlog.take_sender()
                if self._sender is not None:
                    try:
                        self.retry_backlog()
                    except Exception as e:  # noqa: BLE001 — kept
                        print(f"minio_tpu_torch: notify {self.arn}: "
                              f"retry: {e}", file=sys.stderr, flush=True)
                with self._retry_mu:
                    if not len(self.backlog):
                        self._drop_sender()
                        self._retry_thread = None
                        return
        finally:
            with self._retry_mu:
                if self._retry_thread is threading.current_thread():
                    self._drop_sender()
                    self._retry_thread = None

    def close(self) -> None:
        """Stop the retry loop; parked events stay in the store."""
        self._closed.set()


class WebhookTarget(_Backlogged):
    def __init__(self, arn: str, endpoint: str, timeout: float = 5.0,
                 store_dir: str | None = None):
        self.arn = arn
        self.endpoint = endpoint
        self.timeout = timeout
        self._init_backlog(arn, store_dir)

    def _post(self, payload: bytes) -> bool:
        u = urllib.parse.urlsplit(self.endpoint)
        try:
            conn = http.client.HTTPConnection(u.hostname, u.port or 80,
                                              timeout=self.timeout)
            conn.request("POST", u.path or "/", body=payload,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            conn.close()
            return 200 <= resp.status < 300
        except OSError:
            return False

    def _deliver(self, event: dict) -> bool:
        return self._post(json.dumps({"Records": [event]}).encode())


class NotificationSystem:
    """Per-bucket rules + a target registry; the TargetList.Send role.

    Beside the configured targets there is a live PubSub tap
    (`subscribe_events`): ListenNotification streams attach there and
    see EVERY event of this process, configured rules or not, as the
    reference feeds listen channels from its event PubSub independently
    of target delivery (cmd/notification.go).  The event record is only
    built when a rule matched or a tap exists."""

    def __init__(self):
        self._mu = threading.Lock()
        self.targets: dict[str, object] = {}
        self.rules: dict[str, list[NotificationRule]] = {}
        self.pubsub = PubSub()

    def subscribe_events(self, maxlen: int = 1000):
        return self.pubsub.subscribe(maxlen)

    def unsubscribe_events(self, q) -> None:
        self.pubsub.unsubscribe(q)

    def register_target(self, target) -> None:
        with self._mu:
            self.targets[target.arn] = target
        kick = getattr(target, "kick", None)
        if kick is not None:
            kick()

    def set_bucket_rules(self, bucket: str,
                         rules: list[NotificationRule]) -> None:
        with self._mu:
            self.rules[bucket] = rules

    def load_rules(self, meta, buckets) -> None:
        """Every bucket's persisted rules from its config store (a
        BucketMetadataSys), replacing what this process held."""
        rules = {}
        for bucket in buckets:
            if bucket.startswith(".mtpu"):
                continue
            raw = meta.get(bucket, "notification")
            if raw:
                rules[bucket] = parse_notification_config(raw)
        with self._mu:
            self.rules = rules

    def backlog_depth(self) -> int:
        with self._mu:
            targets = list(self.targets.values())
        return sum(len(t.backlog) for t in targets
                   if hasattr(t, "backlog"))

    def close(self) -> None:
        """Stop every target's retry loop and connection."""
        with self._mu:
            targets = list(self.targets.values())
        for t in targets:
            close = getattr(t, "close", None)
            if close is not None:
                close()

    def publish(self, event_name: str, bucket: str, key: str, *,
                size: int = 0, etag: str = "",
                version_id: str = "") -> int:
        with self._mu:
            rules = list(self.rules.get(bucket, []))
            targets = dict(self.targets)
        sent = 0
        for rule in rules:
            if not rule.matches(event_name, key):
                continue
            target = targets.get(rule.arn)
            if target is None:
                _count("dropped")
                continue
            target.send(make_event(event_name, bucket, key, size, etag,
                                   version_id))
            sent += 1
        if sent:
            _count("sent", sent)
        if self.pubsub.num_subscribers:
            self.pubsub.publish({
                "bucket": bucket, "key": key, "eventName": event_name,
                "record": make_event(event_name, bucket, key, size,
                                     etag, version_id)})
        return sent
