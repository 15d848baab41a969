"""Bucket notifications of the port held to the JAX package's
(device="cpu").  Tolerance: exact.

- Rules and records: `parse_notification_config` yields equal rules for
  the same XML, rule matching agrees, and `make_event` gives equal
  records once `datetime` and `uuid` are pinned in both modules.
- The queue store: what one package parks the other loads.
- Over HTTP: `?notification` PUT, GET and DELETE, and PUT, DELETE,
  versioned DELETE and multipart complete through both servers, each
  publishing to an in-process webhook receiver: the responses and the
  delivered records are compared field by field (time and sequencer
  pinned, version ids checked against each server's own responses).
- ListenNotification: a stream gives the records of its bucket, prefix,
  suffix and event names, and ends at `duration`.
- The store's repairs, each against the JAX target's behaviour:
  a target that comes back gets its parked events with no call from the
  caller (the JAX target never retries), and an exception inside a retry
  pass leaves the unsent events in the store (the JAX pass has already
  unlinked them).
"""

import datetime as real_datetime
import http.server
import json
import os
import re
import threading
import time
import uuid as real_uuid

import pytest

import minio_tpu.bucket.notify as jax_notify
import minio_tpu_torch.bucket.notify as port_notify
from minio_tpu_torch.server.client import S3Client
from test_torch_server import JAX, PORT, TIMEOUT, close_pools
from test_torch_server_diff import Recorder

ACCESS, SECRET = "diffadmin", "diffadmin-secret"
ARN = "arn:minio:sqs::1:webhook"
MIB = 1 << 20


class Receiver:
    """A loopback webhook: collects each POST's JSON; while `up` is
    False it answers 503, which a target treats as an outage."""

    def __init__(self):
        self.bodies: list[dict] = []
        self.up = True
        self.posts = 0
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(n)
                outer.posts += 1
                if not outer.up:
                    self.send_response(503)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                outer.bodies.append(json.loads(data))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self._srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self._srv.server_port}/hook"
        threading.Thread(target=self._srv.serve_forever,
                         kwargs={"poll_interval": 0.05},
                         daemon=True).start()

    @property
    def records(self) -> list[dict]:
        return [r for b in self.bodies for r in b["Records"]]

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


@pytest.fixture()
def receiver():
    r = Receiver()
    yield r
    r.close()


class _PinnedDatetime:
    timezone = real_datetime.timezone

    class datetime:
        @staticmethod
        def now(tz=None):
            return real_datetime.datetime(2026, 10, 18, 12, 34, 56, 789123,
                                          tzinfo=real_datetime.timezone.utc)


class _PinnedUUID:
    @staticmethod
    def uuid4():
        return real_uuid.UUID(int=0x0123456789ABCDEF0123456789ABCDEF)


@pytest.fixture()
def pinned(monkeypatch):
    for mod in (jax_notify, port_notify):
        monkeypatch.setattr(mod, "datetime", _PinnedDatetime)
        monkeypatch.setattr(mod, "uuid", _PinnedUUID)


def _until(pred, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


# -- rules and records -------------------------------------------------------

_CONFIGS = [
    b"<NotificationConfiguration><QueueConfiguration><Id>q</Id><Queue>"
    b"arn:minio:sqs::1:webhook</Queue><Event>s3:ObjectCreated:*</Event>"
    b"</QueueConfiguration></NotificationConfiguration>",
    b'<NotificationConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03'
    b'-01/"><QueueConfiguration><Queue>arn:a</Queue><Event>s3:ObjectRemoved:'
    b'Delete</Event><Event>s3:ObjectCreated:Put</Event><Filter><S3Key>'
    b'<FilterRule><Name>prefix</Name><Value>logs/</Value></FilterRule>'
    b'<FilterRule><Name>Suffix</Name><Value>.txt</Value></FilterRule>'
    b'</S3Key></Filter></QueueConfiguration></NotificationConfiguration>',
    b"<NotificationConfiguration><TopicConfiguration><Topic>arn:t</Topic>"
    b"<Event>s3:*</Event></TopicConfiguration><CloudFunctionConfiguration>"
    b"<CloudFunction>arn:f</CloudFunction><Event>s3:ObjectCreated:"
    b"CompleteMultipartUpload</Event></CloudFunctionConfiguration>"
    b"</NotificationConfiguration>",
    b"<NotificationConfiguration></NotificationConfiguration>",
]

_EVENTS = ["s3:ObjectCreated:Put", "s3:ObjectCreated:CompleteMultipartUpload",
           "s3:ObjectRemoved:Delete", "s3:ObjectRemoved:DeleteMarkerCreated"]
_KEYS = ["a", "logs/x.txt", "logs/x.bin", "other/logs/y.txt", "sp ace+%/é"]


def _rules(mod, xml):
    return [(r.arn, r.events, r.prefix, r.suffix)
            for r in mod.parse_notification_config(xml)]


@pytest.mark.parametrize("xml", _CONFIGS, ids=range(len(_CONFIGS)))
def test_rules_match_jax(xml):
    assert _rules(port_notify, xml) == _rules(jax_notify, xml)
    jr = jax_notify.parse_notification_config(xml)
    pr = port_notify.parse_notification_config(xml)
    for ev in _EVENTS:
        for key in _KEYS:
            assert [r.matches(ev, key) for r in pr] == \
                [r.matches(ev, key) for r in jr], (ev, key)


def test_malformed_rules_raise_in_both():
    for mod in (jax_notify, port_notify):
        with pytest.raises(Exception):
            mod.parse_notification_config(b"<not-xml")


@pytest.mark.parametrize("event", _EVENTS)
@pytest.mark.parametrize("key", _KEYS)
def test_make_event_matches_jax(pinned, event, key):
    args = (event, "bkt", key, 12345, "0123abcd", "vid-1")
    assert port_notify.make_event(*args) == jax_notify.make_event(*args)
    assert port_notify.make_event(event, "b", key) == \
        jax_notify.make_event(event, "b", key)


def test_publish_and_tap_match_jax(pinned):
    """The same rules and targets: the same records at the targets and
    on the listen tap, and the same count returned."""
    out = {}
    for mod in (jax_notify, port_notify):
        ns = mod.NotificationSystem()
        q = mod.QueueTarget(ARN)
        ns.register_target(q)
        ns.set_bucket_rules("b", mod.parse_notification_config(
            _CONFIGS[0].replace(b"ObjectCreated:*", b"ObjectCreated:Put")))
        tap = ns.subscribe_events()
        sent = [ns.publish(ev, "b", k, size=3, etag="e", version_id="v")
                for ev in _EVENTS for k in _KEYS[:2]]
        sent.append(ns.publish("s3:ObjectCreated:Put", "other", "a"))
        ns.unsubscribe_events(tap)
        sent.append(ns.publish("s3:ObjectCreated:Put", "b", "after"))
        out[mod.__name__] = (sent, q.events, list(tap))
    jax, port = out.values()
    assert port == jax
    assert sum(port[0]) == 3 and len(port[2]) == 9


def test_queue_store_crosses_packages(tmp_path):
    """Events the JAX store parked load in the port's, and the other way
    round: one JSON file per event in the kind's directory."""
    evs = [{"eventName": "s3:ObjectCreated:Put", "i": i} for i in range(3)]
    jq = jax_notify.QueueTarget("arn-backlog", str(tmp_path / "j"))
    for ev in evs:
        jq.send(ev)
    pq = port_notify.QueueTarget("arn-backlog", str(tmp_path / "j"))
    assert sorted(e["i"] for e in pq.events) == [0, 1, 2]
    pq2 = port_notify.QueueTarget("arn-backlog", str(tmp_path / "p"))
    for ev in evs:
        pq2.send(ev)
    jq2 = jax_notify.QueueTarget("arn-backlog", str(tmp_path / "p"))
    assert [e["i"] for e in jq2.events] == [0, 1, 2]
    # The port names its files in arrival order: a reload keeps it.
    assert [e["i"] for e in port_notify.QueueTarget(
        "arn-backlog", str(tmp_path / "p")).events] == [0, 1, 2]
    assert len(os.listdir(tmp_path / "p")) == 3


def test_adopt_store_moves_event_files(tmp_path):
    q = port_notify.QueueTarget("x", str(tmp_path / "k" / "w1"))
    q.send({"i": 1})
    (tmp_path / "k" / "top.json").write_text('{"i": 0}')
    moved = port_notify.adopt_store(str(tmp_path / "k" / "w0"),
                                    [str(tmp_path / "k"),
                                     str(tmp_path / "k" / "w1")])
    assert moved == 2
    assert sorted(e["i"] for e in port_notify.QueueTarget(
        "x", str(tmp_path / "k" / "w0")).events) == [0, 1]
    assert os.listdir(tmp_path / "k" / "w1") == []


# -- the store's repairs ---------------------------------------------------------

def test_parked_events_are_retried_without_a_call(receiver, tmp_path,
                                                  monkeypatch):
    """Repair 1: events parked while the receiver was down reach it once
    it is back, with no retry call from the caller, and each file of the
    store goes once its event was delivered.  The JAX target parks them
    and never sends them (its retry_backlog has no caller)."""
    monkeypatch.setattr(port_notify, "RETRY_INTERVAL_S", 0.05)
    before = port_notify.stats()
    jt = jax_notify.WebhookTarget(ARN, receiver.url,
                                  store_dir=str(tmp_path / "jax"))
    pt = port_notify.WebhookTarget(ARN, receiver.url,
                                   store_dir=str(tmp_path / "port"))
    try:
        receiver.up = False
        for i in range(4):
            jt.send({"pkg": "jax", "i": i})
            pt.send({"pkg": "port", "i": i})
        assert len(jt.backlog.events) == len(pt.backlog.events) == 4
        assert len(os.listdir(tmp_path / "port")) == 4
        receiver.up = True
        _until(lambda: len(pt.backlog) == 0, "the port's retry")
        got = [r for b in receiver.bodies for r in b["Records"]]
        assert [r["i"] for r in got if r["pkg"] == "port"] == [0, 1, 2, 3]
        assert os.listdir(tmp_path / "port") == []
        time.sleep(0.3)
        assert not [r for r in got if r["pkg"] == "jax"]
        assert len(jt.backlog.events) == 4
        after = port_notify.stats()
        assert after["parked"] - before["parked"] == 4
        assert after["retried"] - before["retried"] == 4
        assert after["delivered"] - before["delivered"] == 4
    finally:
        pt.close()


def test_an_exception_inside_a_pass_keeps_the_unsent_events(tmp_path,
                                                           receiver):
    """Repair 2: a pass that dies at its second event (a process killed
    mid-pass) leaves that event and the later ones in the store; the
    first, delivered, is gone.  The JAX pass unlinks every file before
    it sends any: the same death loses all three."""
    class Boom(Exception):
        pass

    def dying(target, mod):
        real = target._post
        calls = {"n": 0}

        def post(payload):
            calls["n"] += 1
            if calls["n"] == 2:
                raise Boom()
            return real(payload)
        target._post = post
        return target

    results = {}
    for mod in (jax_notify, port_notify):
        store = str(tmp_path / mod.__name__.split(".")[0])
        t = mod.WebhookTarget(ARN, receiver.url, store_dir=store)
        receiver.up = False
        for i in range(3):
            t.send({"i": i})
        receiver.up = True
        if hasattr(t, "close"):
            t.close()                   # no background pass: ours only
        dying(t, mod)
        with pytest.raises(Boom):
            t.retry_backlog()
        reloaded = mod.QueueTarget("x", store)
        results[mod] = sorted(e["i"] for e in reloaded.events)
    assert results[port_notify] == [1, 2]
    assert results[jax_notify] == []


def test_broken_target_keeps_the_order_and_rest(tmp_path, receiver,
                                                monkeypatch):
    """A pass stops at the first event that fails: the rest wait for the
    next pass, in order, and nothing is delivered twice."""
    monkeypatch.setattr(port_notify, "RETRY_INTERVAL_S", 3600)
    t = port_notify.WebhookTarget(ARN, receiver.url,
                                  store_dir=str(tmp_path / "s"))
    try:
        receiver.up = False
        for i in range(5):
            t.send({"i": i})
        assert t.retry_backlog() == 0
        receiver.up = True
        assert t.retry_backlog() == 5
        assert [r["i"] for r in receiver.records] == [0, 1, 2, 3, 4]
        assert t.retry_backlog() == 0
    finally:
        t.close()


def test_register_target_starts_the_retry_of_a_loaded_store(
        tmp_path, receiver, monkeypatch):
    """What a previous process parked is delivered once a target over
    its store is registered (a respawn, a restart)."""
    monkeypatch.setattr(port_notify, "RETRY_INTERVAL_S", 0.05)
    old = port_notify.QueueTarget("x", str(tmp_path / "s"))
    for i in range(3):
        old.send({"i": i})
    ns = port_notify.NotificationSystem()
    t = port_notify.WebhookTarget(ARN, receiver.url,
                                  store_dir=str(tmp_path / "s"))
    ns.register_target(t)
    try:
        # A file goes once its event was delivered, just after the
        # receiver has it.
        _until(lambda: len(receiver.records) == 3
               and ns.backlog_depth() == 0, "the loaded events")
        assert [r["i"] for r in receiver.records] == [0, 1, 2]
    finally:
        ns.close()


# -- over HTTP, both servers -----------------------------------------------------

_RULES = (b"<NotificationConfiguration><QueueConfiguration><Id>all</Id>"
          b"<Queue>" + ARN.encode() + b"</Queue><Event>s3:ObjectCreated:*"
          b"</Event><Event>s3:ObjectRemoved:*</Event></QueueConfiguration>"
          b"<QueueConfiguration><Id>logs</Id><Queue>" + ARN.encode() +
          b"</Queue><Event>s3:ObjectCreated:Put</Event><Filter><S3Key>"
          b"<FilterRule><Name>prefix</Name><Value>logs/</Value></FilterRule>"
          b"<FilterRule><Name>suffix</Name><Value>.txt</Value></FilterRule>"
          b"</S3Key></Filter></QueueConfiguration>"
          b"</NotificationConfiguration>")


def _notify_script(do, data):
    """The notification requests; returns the version id each event
    should carry, in event order (read from the responses)."""
    vids = []

    def vid(h):
        return h.get("x-amz-version-id", "")

    do("PUT", "/nbk")
    do("GET", "/nbk", {"notification": ""})         # NoSuchNotification...
    do("PUT", "/nbk", {"notification": ""}, body=b"<not-xml")
    do("PUT", "/nbk", {"notification": ""}, body=_RULES)
    do("GET", "/nbk", {"notification": ""})
    for key, n in (("a", 1000), ("logs/x.txt", 70_000),
                   ("logs/x.bin", 10), ("big", 300_000)):
        _, h, _ = do("PUT", f"/nbk/{key}", body=data[:n])
        vids.append(vid(h))
        if key == "logs/x.txt":
            vids.append(vid(h))                     # both rules match
    do("DELETE", "/nbk/a")
    vids.append("")
    do("DELETE", "/nbk/nosuch")                     # 204, no event
    _, _, body = do("POST", "/nbk/mp", {"uploads": ""})
    upload = re.search(rb"<UploadId>([^<]*)</UploadId>", body).group(1) \
        .decode()
    etags = []
    for num, part in ((1, data[:5 * MIB]), (2, data[:1000])):
        _, h, _ = do("PUT", "/nbk/mp", {"partNumber": str(num),
                                        "uploadId": upload}, body=part,
                     label="/nbk/mp#part")
        etags.append(h["ETag"])
    xml = "<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag></Part>"
        for i, e in enumerate(etags)) + "</CompleteMultipartUpload>"
    do("POST", "/nbk/mp", {"uploadId": upload}, body=xml.encode(),
       label="/nbk/mp#complete")
    vids.append("")
    do("PUT", "/nbk", {"versioning": ""},
       body=b"<VersioningConfiguration><Status>Enabled</Status>"
            b"</VersioningConfiguration>")
    _, h, _ = do("PUT", "/nbk/v", body=data[:2000])
    first = vid(h)
    vids.append(first)
    _, h, _ = do("PUT", "/nbk/v", body=data[:3000])
    vids.append(vid(h))
    do("DELETE", "/nbk/v")                          # a delete marker
    vids.append("")
    do("DELETE", "/nbk/v", {"versionId": first}, label="/nbk/v#version")
    vids.append(first)
    do("DELETE", "/nbk", {"notification": ""})
    do("GET", "/nbk", {"notification": ""})
    do("PUT", "/nbk/after", body=data[:10])         # no rule: no event
    return vids


def test_notification_requests_match_jax(tmp_path, pinned):
    import numpy as np
    data = np.random.default_rng(20261018).bytes(5 * MIB + 7)
    records, events = {}, {}
    for pkg, mod in ((JAX, jax_notify), (PORT, port_notify)):
        recv = Receiver()
        pools = pkg.pools(tmp_path / pkg.name, "d")
        ns = mod.NotificationSystem()
        ns.register_target(mod.WebhookTarget(ARN, recv.url))
        srv = pkg.S3Server(pools, pkg.sigv4.Credentials(ACCESS, SECRET),
                           notify=ns).start()
        try:
            rec = Recorder(pkg, srv)
            vids = _notify_script(rec, data)
            records[pkg.name] = rec.records
            got = recv.records
            assert len(got) == len(vids) == 11
            for r, want in zip(got, vids):
                assert r["s3"]["object"]["versionId"] == want
                if want:
                    r["s3"]["object"]["versionId"] = "*"
            events[pkg.name] = got
        finally:
            srv.shutdown()
            close_pools(pools)
            recv.close()
    assert len(records["port"]) == len(records["jax"]) == 23
    for j, p in zip(records["jax"], records["port"]):
        assert p == j, j["request"]
    put = "s3:ObjectCreated:Put"
    assert [r["eventName"] for r in events["port"]] == [
        put] * 5 + ["s3:ObjectRemoved:Delete",
                    "s3:ObjectCreated:CompleteMultipartUpload", put, put,
                    "s3:ObjectRemoved:DeleteMarkerCreated",
                    "s3:ObjectRemoved:Delete"]
    assert [r["s3"]["object"]["size"] for r in events["port"]] == [
        1000, 70_000, 70_000, 10, 300_000, 0, 5 * MIB + 1000, 2000, 3000,
        0, 0]
    assert events["port"] == events["jax"]
    codes = {r["code"] for r in records["port"]}
    assert {b"NoSuchNotificationConfiguration", b"MalformedXML"} <= codes


def _listen(cli, path, query):
    st, h, body = cli.request("GET", path, query=query)
    assert st == 200, body
    assert h.get("Content-Type") == "application/x-ndjson"
    return [json.loads(line)["Records"][0]
            for line in body.split(b"\n") if line.strip()]


def test_listen_streams_matching_records_and_ends_at_duration(tmp_path):
    pools = PORT.pools(tmp_path, "d")
    srv = PORT.S3Server(pools, PORT.sigv4.Credentials(ACCESS, SECRET)
                        ).start()
    try:
        cli = S3Client(srv.endpoint, ACCESS, SECRET, timeout=TIMEOUT)
        for b in ("lb1", "lb2"):
            cli.make_bucket(b)
        streams = {}

        def listen(name, path, query):
            streams[name] = _listen(S3Client(srv.endpoint, ACCESS, SECRET,
                                             timeout=TIMEOUT), path, query)
        threads = [threading.Thread(target=listen, args=a) for a in (
            ("bucket", "/lb1", {"events": "s3:ObjectCreated:*",
                                "duration": "2"}),
            ("filtered", "/lb1", {"events": "s3:ObjectCreated:Put,"
                                            "s3:ObjectRemoved:*",
                                  "prefix": "p/", "suffix": ".x",
                                  "duration": "2"}),
            ("all", "/minio/listen", {"duration": "2"}))]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        _until(lambda: srv.notify.pubsub.num_subscribers == 3,
               "three subscribers")
        cli.put_object("lb1", "p/a.x", b"1")
        cli.put_object("lb1", "p/b.y", b"22")
        cli.put_object("lb1", "q/c.x", b"333")
        cli.put_object("lb2", "p/a.x", b"4444")
        cli.request("DELETE", "/lb1/p/a.x")
        for t in threads:
            t.join(timeout=30)
        took = time.monotonic() - t0
        assert 2.0 <= took < 10, took
        keys = {n: [(r["s3"]["bucket"]["name"], r["s3"]["object"]["key"],
                     r["eventName"]) for r in recs]
                for n, recs in streams.items()}
        put = "s3:ObjectCreated:Put"
        assert keys["bucket"] == [("lb1", "p/a.x", put), ("lb1", "p/b.y", put),
                                  ("lb1", "q/c.x", put)]
        assert keys["filtered"] == [("lb1", "p/a.x", put),
                                    ("lb1", "p/a.x",
                                     "s3:ObjectRemoved:Delete")]
        assert len(keys["all"]) == 5
        assert streams["bucket"][1]["s3"]["object"]["size"] == 2
        assert srv.notify.pubsub.num_subscribers == 0
        st, _, body = cli.request("GET", "/nosuchb", query={"events": ""})
        assert st == 404 and b"NoSuchBucket" in body
    finally:
        srv.shutdown()
        close_pools(pools)


def test_rules_reload_from_the_store(tmp_path, receiver):
    """A server booted over drives whose buckets hold `?notification`
    rules routes their events at once; reload_bucket_configs picks up a
    rule another process stored."""
    pools = PORT.pools(tmp_path, "d")
    try:
        ns = port_notify.NotificationSystem()
        ns.register_target(port_notify.WebhookTarget(ARN, receiver.url))
        srv = PORT.S3Server(pools, PORT.sigv4.Credentials(ACCESS, SECRET),
                            notify=ns).start()
        cli = S3Client(srv.endpoint, ACCESS, SECRET, timeout=TIMEOUT)
        cli.make_bucket("rb1")
        cli.make_bucket("rb2")
        cli._check(*cli.request("PUT", "/rb1", query={"notification": ""},
                                body=_RULES))
        srv.shutdown()
        ns2 = port_notify.NotificationSystem()
        ns2.register_target(port_notify.WebhookTarget(ARN, receiver.url))
        srv2 = PORT.S3Server(pools, PORT.sigv4.Credentials(ACCESS, SECRET),
                             notify=ns2).start()
        try:
            cli2 = S3Client(srv2.endpoint, ACCESS, SECRET, timeout=TIMEOUT)
            cli2.put_object("rb1", "k", b"x")
            cli2.put_object("rb2", "k", b"x")
            assert [(r["s3"]["bucket"]["name"], r["s3"]["object"]["key"])
                    for r in receiver.records] == [("rb1", "k")]
            # Another process stores rb2's rules under srv2's cache.
            srv2.handlers.meta.get("rb2", "notification")
            srv.handlers.meta.put("rb2", "notification", _RULES)
            srv2.reload_bucket_configs()
            cli2.put_object("rb2", "k2", b"x")
            assert receiver.records[-1]["s3"]["object"]["key"] == "k2"
        finally:
            srv2.shutdown()
    finally:
        close_pools(pools)


# -- order and unknown ARNs --------------------------------------------------

def _port_server(tmp_path, ns=None):
    pools = PORT.pools(tmp_path, "d")
    srv = PORT.S3Server(pools, PORT.sigv4.Credentials(ACCESS, SECRET),
                        notify=ns).start()
    return pools, srv, S3Client(srv.endpoint, ACCESS, SECRET,
                                timeout=TIMEOUT)


def test_a_parked_put_arrives_before_the_next_delete(tmp_path, receiver,
                                                     monkeypatch):
    """Order across an outage: a PUT's event parked while the target was
    down, then the DELETE of the same key once it is back but before the
    retry pass: the target gets the PUT first.  The DELETE parks behind
    the store; before the repair it went straight out and overtook it."""
    monkeypatch.setattr(port_notify, "RETRY_INTERVAL_S", 0.4)
    ns = port_notify.NotificationSystem()
    ns.register_target(port_notify.WebhookTarget(
        ARN, receiver.url, store_dir=str(tmp_path / "store")))
    pools, srv, cli = _port_server(tmp_path, ns)
    try:
        cli.make_bucket("ord")
        cli._check(*cli.request("PUT", "/ord", query={"notification": ""},
                                body=_RULES))
        receiver.up = False
        for i in range(3):
            cli.put_object("ord", "k", b"v%d" % i)
        receiver.up = True
        cli.delete_object("ord", "k")
        cli.put_object("ord", "other", b"x")
        _until(lambda: len(receiver.records) == 5, "the store's delivery")
        got = [(r["eventName"], r["s3"]["object"]["key"])
               for r in receiver.records]
        put, dele = "s3:ObjectCreated:Put", "s3:ObjectRemoved:Delete"
        assert got == [(put, "k")] * 3 + [(dele, "k"), (put, "other")]
        # The retry pass unlinks a ticket once its POST is answered, so
        # the receiver can hold the last record a beat before the store
        # is empty.
        _until(lambda: not os.listdir(tmp_path / "store"),
               "the store's last ticket unlinked")
    finally:
        srv.shutdown()
        ns.close()
        close_pools(pools)


def test_an_event_for_an_arn_without_target_is_counted(tmp_path, receiver):
    """A rule stored before the ARN check (here written to the config
    store behind the server's back) still names a missing target: its
    events are counted as dropped; the webhook's rule delivers."""
    ns = port_notify.NotificationSystem()
    ns.register_target(port_notify.WebhookTarget(ARN, receiver.url))
    pools, srv, cli = _port_server(tmp_path, ns)
    try:
        cli.make_bucket("drp")
        ghost = _RULES.replace(b"</NotificationConfiguration>", (
            b"<QueueConfiguration><Queue>arn:minio:sqs::1:kafka</Queue>"
            b"<Event>s3:ObjectCreated:*</Event></QueueConfiguration>"
            b"</NotificationConfiguration>"))
        srv.handlers.meta.put("drp", "notification", ghost)
        srv.reload_bucket_configs()
        before = port_notify.stats()
        cli.put_object("drp", "a", b"x")
        after = port_notify.stats()
        assert after["dropped"] - before["dropped"] == 1
        assert after["sent"] - before["sent"] == 1
        assert [r["s3"]["object"]["key"] for r in receiver.records] == ["a"]
    finally:
        srv.shutdown()
        close_pools(pools)


def test_a_target_set_through_admin_config_registers_at_once(tmp_path,
                                                            receiver):
    """`admin config set notify_webhook` without a restart: the target
    registers in the serving process, so a rule naming its ARN is stored
    and routes the next PUT (before, the rule was stored and its events
    dropped until a restart built the target)."""
    pools, srv, cli = _port_server(tmp_path)
    try:
        cli.make_bucket("adm")
        st, body = cli.request("PUT", "/adm", query={"notification": ""},
                               body=_RULES)[::2]
        assert st == 400 and b"InvalidArgument" in body
        for key, value in (("endpoint", receiver.url), ("enable", "on")):
            assert cli.admin("POST", "config", doc={
                "subsys": "notify_webhook", "key": key,
                "value": value}) == (200, {"ok": True})
        assert ARN in srv.notify.targets
        cli._check(*cli.request("PUT", "/adm", query={"notification": ""},
                                body=_RULES))
        cli.put_object("adm", "k", b"x")
        assert [r["s3"]["object"]["key"] for r in receiver.records] == ["k"]
    finally:
        srv.shutdown()
        close_pools(pools)
