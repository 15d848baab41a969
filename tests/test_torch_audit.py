"""The port's audit plane (minio_tpu_torch/observe/audit.py) held to the
JAX package's: the same requests through both servers, each with a file
target from MTPU_AUDIT, leave equal entries field for field (times,
request ids and the node's port aside), a request refused before
routing included; the webhook target delivers to a loopback collector;
a full queue sheds and counts; and the root span closes before the
entry is built, so its stages cover the response write."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import minio_tpu.observe.audit as jaudit
import minio_tpu_torch.observe.audit as paudit
import minio_tpu_torch.observe.span as pspan
from minio_tpu_torch.ops import coalesce, devcache

from test_torch_server import JAX, PORT, close_pools

ACCESS, SECRET = "auditadmin", "auditadmin-secret"
#: Fields that differ between any two runs: when, which request, and
#: the listening port in `node`.
_VOLATILE = ("time", "requestID", "node")


@pytest.fixture(autouse=True)
def cold_planes(monkeypatch):
    """Both tracers off (an entry carries stages only when its request
    was traced), the port's coalescer and device cache cold."""
    import minio_tpu.observe.span as jspan
    for sp in (jspan, pspan):
        sp.TRACER.configure(ring=0, sample=1.0)
    monkeypatch.setenv("MTPU_DEVCACHE", "0")
    coalesce.reset()
    devcache.reset()
    yield
    pspan.TRACER.configure(ring=0, sample=1.0)
    pspan.TRACER.reset()
    coalesce.reset()
    devcache.reset()


def _script(pkg, srv):
    cli = pkg.S3Client(srv.endpoint, ACCESS, SECRET, **pkg.client_kw)
    rng = np.random.default_rng(3)
    cli.make_bucket("aud")
    body = rng.integers(0, 256, (1 << 20) + 11, dtype=np.uint8).tobytes()
    cli.request("PUT", "/aud/big", body=body)
    cli.request("PUT", "/aud/small", body=body[:500])
    cli.request("GET", "/aud/big")
    cli.request("GET", "/aud/big", headers={"Range": "bytes=10-99"})
    cli.request("HEAD", "/aud/small")
    cli.request("GET", "/aud/nope")
    cli.request("DELETE", "/aud/small")
    # Refused before routing: a secret the server does not hold.
    bad = pkg.S3Client(srv.endpoint, ACCESS, "wrong-secret-key",
                       **pkg.client_kw)
    bad.request("GET", "/aud/big")


def _entries(pkg, tmp_path, tag, monkeypatch) -> list[dict]:
    path = tmp_path / f"{tag}.jsonl"
    monkeypatch.setenv("MTPU_AUDIT", f"file:{path}")
    pools = pkg.pools(tmp_path, tag)
    srv = pkg.S3Server(pools, pkg.sigv4.Credentials(ACCESS, SECRET)).start()
    try:
        _script(pkg, srv)
    finally:
        srv.shutdown()          # flushes and closes the targets
        close_pools(pools)
    return [json.loads(line) for line in path.read_text().splitlines()]


def _stable(entry: dict) -> dict:
    e = {k: v for k, v in entry.items() if k not in _VOLATILE}
    e["api"] = {k: v for k, v in e["api"].items()
                if k != "timeToResponseMs"}
    return e


def test_file_entries_match_the_jax_package(tmp_path, monkeypatch):
    jent = _entries(JAX, tmp_path, "j", monkeypatch)
    pent = _entries(PORT, tmp_path, "p", monkeypatch)
    assert len(pent) == len(jent) == 9
    assert all(p["requestID"] and p["time"] for p in pent)
    # An entry is queued once its response has left, so the next request
    # may queue first: compare the two trails as sets of entries.
    def key(e):
        return json.dumps(_stable(e), sort_keys=True)
    assert sorted(map(key, pent)) == sorted(map(key, jent))
    refused = [e for e in pent if e["api"]["statusCode"] == 403]
    assert len(refused) == 1 and refused[0]["object"] is None
    assert refused[0]["accessKey"] == ""
    assert sorted(e["api"]["name"] for e in pent) == sorted(
        ["api.PutBucket"] + ["api.PutObject"] * 2 + ["api.GetObject"] * 4
        + ["api.HeadObject", "api.DeleteObject"])
    assert (1 << 20) + 11 in [e["api"]["tx"] for e in pent]


def test_entry_stages_cover_the_response_write(tmp_path, monkeypatch):
    """With tracing on, an entry carries the flattened stage times of the
    request's root span, which closed before the entry was built: a
    streamed GET's engine stages are in it."""
    path = tmp_path / "t.jsonl"
    monkeypatch.setenv("MTPU_AUDIT", f"file:{path}")
    pspan.TRACER.configure(ring=16, sample=1.0)
    pools = PORT.pools(tmp_path, "t")
    srv = PORT.S3Server(pools, PORT.sigv4.Credentials(ACCESS,
                                                      SECRET)).start()
    try:
        cli = PORT.S3Client(srv.endpoint, ACCESS, SECRET, **PORT.client_kw)
        cli.make_bucket("aud")
        cli.request("PUT", "/aud/o", body=b"z" * ((2 << 20) + 1))
        st, _, got = cli.request("GET", "/aud/o")
        assert st == 200 and len(got) == (2 << 20) + 1
    finally:
        srv.shutdown()
        close_pools(pools)
    ent = [json.loads(x) for x in path.read_text().splitlines()]
    get, = [e for e in ent if e["api"]["name"] == "api.GetObject"]
    assert "engine.get_object" in get["stages"]
    assert "engine.read_part" in get["stages"]
    root = [r for r in pspan.TRACER.traces()
            if r["name"] == "api.GetObject"][-1]
    assert root["tags"]["status"] == 200


class _Collector(BaseHTTPRequestHandler):
    got: list = []

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        self.got.append(json.loads(self.rfile.read(n)))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


def test_webhook_target_delivers_and_env_spec_parses():
    _Collector.got = []
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Collector)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_port}/hook"
        for mod in (jaudit, paudit):
            targets = mod.targets_from_env(f"webhook:{url}")
            assert [x.kind for x in targets] == ["webhook"]
            targets[0].send(mod.build_entry(api="api.X", method="GET",
                                            path="/b/o", status=200))
            targets[0].close()
            assert targets[0].stats()["emitted"] == 1
        assert len(_Collector.got) == 2
        a, b = (_stable(e) for e in _Collector.got)
        assert a == b
        assert paudit.targets_from_env("0") == []
        with pytest.raises(ValueError, match="unknown MTPU_AUDIT"):
            paudit.targets_from_env("syslog:x")
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("fields", [
    {"method": "PUT", "path": "/b/k", "status": 200, "duration_ms": 3.2,
     "access_key": "ak", "source_ip": "1.2.3.4"},
    {"method": "GET", "path": "/b", "status": 403, "duration_ms": 0.004,
     "request_id": "r1", "api_name": "ListObjectsV2"}],
    ids=["put", "refused"])
def test_logger_audit_entry_matches_the_jax_package(fields):
    """The logger's audit record (observe/logger.py audit_entry), field
    for field the JAX package's but for its time."""
    import minio_tpu.observe.logger as jlogger
    import minio_tpu_torch.observe.logger as plogger
    j, p = (mod.audit_entry(**fields) for mod in (jlogger, plogger))
    assert j.pop("time") and p.pop("time")
    assert p == j
    assert p["api"]["statusCode"] == fields["status"]


def test_full_queue_sheds_and_counts(tmp_path):
    class Stalled(paudit.AuditTarget):
        kind = "stalled"

        def __init__(self):
            self.gate = threading.Event()
            super().__init__("stalled", queue_size=2)

        def _deliver(self, entry):
            self.gate.wait(5)
            return True

    t = Stalled()
    try:
        for i in range(20):
            t.send({"i": i})
        # At most two queued and two taken by the stalled drain.
        assert t.dropped >= 16
    finally:
        t.gate.set()
        t.close()
    assert t.emitted + t.dropped == 20
    deadline = time.monotonic() + 5
    while t._thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not t._thread.is_alive()
