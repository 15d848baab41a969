"""The port's observability endpoints held to the JAX server's through
tests/test_torch_server_diff.py's Recorder: the admin `trace` (GET ring
and POST stream), `top/apis`, `console`, `bandwidth`, `metrics/cluster`,
`healthinfo`, `profile` and `inspect`, then a two-node fleet scrape on
the CPU with one node stopped and one hung (node_up 0 within
MTPU_OBS_DEADLINE_MS), the unsigned node scrape, and the disabled span
path over HTTP (SPAN_ALLOCS unchanged across untraced requests)."""

import json
import re
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import minio_tpu_torch.observe.span as pspan
from minio_tpu_torch.ops import coalesce, devcache
from minio_tpu_torch.rpc import rest
from minio_tpu_torch.rpc.peer_rpc import (PeerRegistry, register_obs_rpc,
                                          register_peer_rpc)

from test_torch_server import JAX, PORT, TIMEOUT, close_pools
from test_torch_server_diff import Recorder

ACCESS, SECRET = "diffadmin", "diffadmin-secret"

#: Admin answers the port gives otherwise than the JAX server: label ->
#: the reason.  healthinfo's node document: the port has no native
#: digest lanes (its "digest" row is empty), and its "device_lanes" are
#: keyed by the lane's device name ("cpu", "cuda:0").
_DIVERGES = {
    "healthinfo#digest": "no native digest lanes in the port",
    "healthinfo#device_lanes": "lanes keyed by device name",
}


@pytest.fixture(autouse=True)
def cold_planes(monkeypatch):
    """Both packages' tracers off and empty (they are process-global),
    the port's coalescer and device cache cold."""
    import minio_tpu.observe.span as jspan
    for sp in (jspan, pspan):
        sp.TRACER.configure(ring=0, sample=1.0)
        sp.TRACER.reset()
    monkeypatch.setenv("MTPU_DEVCACHE", "0")
    coalesce.reset()
    devcache.reset()
    yield
    pspan.TRACER.configure(ring=0, sample=1.0)
    pspan.TRACER.reset()
    coalesce.reset()
    devcache.reset()


def _shape(obj):
    """A JSON document's structure: dict keys (recursively), list
    lengths, scalar types; the values that carry times, ports and ids
    drop out."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return type(obj).__name__


def _admin_script(do):
    """The observability endpoints, in an order whose answers depend
    only on the requests before them."""
    rng = np.random.default_rng(23)
    body = rng.integers(0, 256, (1 << 20) + 5, dtype=np.uint8).tobytes()
    adm = "/minio/admin/v3/"
    do("PUT", "/obk")
    do("GET", adm + "trace", label="trace#subscribe")
    do("PUT", "/obk/o", body=body)
    do("GET", "/obk/o")
    do("GET", adm + "trace", label="trace#ring")
    do("GET", adm + "top/apis")
    do("GET", adm + "console")
    do("GET", adm + "bandwidth")
    do("GET", adm + "bandwidth", {"buckets": "nosuch"})
    do("POST", adm + "trace", {"duration": "0.2"})
    do("GET", adm + "metrics/cluster")
    do("GET", adm + "healthinfo")
    do("GET", adm + "profile", label="profile#not-running")
    do("POST", adm + "profile")
    do("POST", adm + "profile", label="profile#again")
    do("GET", adm + "profile", label="profile#report")
    do("GET", adm + "inspect", {"volume": "obk", "file": "o"})
    do("GET", adm + "inspect", {"volume": "obk", "file": "none"},
       label="inspect#missing")
    do("GET", adm + "inspect", label="inspect#no-args")
    do("GET", adm + "no-such-endpoint")


def _run(pkg, tmp_path, tag):
    pools = pkg.pools(tmp_path, tag)
    srv = pkg.S3Server(pools, pkg.sigv4.Credentials(ACCESS, SECRET)).start()
    rec = Recorder(pkg, srv)
    bodies = []
    orig = rec.cli.request

    def keep(*a, **kw):
        out = orig(*a, **kw)
        bodies.append(out[2])
        return out
    rec.cli.request = keep
    try:
        _admin_script(rec)
    finally:
        srv.shutdown()
        close_pools(pools)
    return rec.records, bodies, srv.port


def test_admin_observability_matches_the_jax_server(tmp_path):
    jrec, jbodies, jport = _run(JAX, tmp_path, "j")
    prec, pbodies, pport = _run(PORT, tmp_path, "p")
    assert len(jrec) == len(prec) == 20
    for j, p, jb, pb in zip(jrec, prec, jbodies, pbodies):
        label = j["request"][1]
        assert (p["status"], p["code"]) == (j["status"], j["code"]), label
        assert p["headers"]["Content-Type"] == \
            j["headers"]["Content-Type"], label
        ctype = p["headers"]["Content-Type"] or ""
        if "trace" in label and j["request"][0] == "POST":
            # A span-tree stream: both empty (nothing ran meanwhile).
            assert pb.strip() == jb.strip() == b"", label
        elif ctype == "application/json":
            jd, pd = json.loads(jb), json.loads(pb)
            if label.endswith("healthinfo"):
                jn = jd["nodes"][f"127.0.0.1:{jport}"]
                pn = pd["nodes"][f"127.0.0.1:{pport}"]
                assert set(pn) == set(jn), label
                for key in jn:
                    if f"healthinfo#{key}" in _DIVERGES:
                        continue
                    if key in ("drives", "pools", "mrf", "peers", "audit",
                               "slo", "qos", "draining", "inflight"):
                        assert _shape(pn[key]) == _shape(jn[key]), key
                assert list(pd["node_up"].values()) == [1]
            elif label.endswith(("trace#ring", "top/apis", "console",
                                 "bandwidth", "inspect")) \
                    or "#" in label:
                assert _shape(pd) == _shape(jd), label
            if label.endswith(("top/apis", "console", "bandwidth")) \
                    or label.endswith(("#missing", "#again",
                                       "#not-running", "#no-args")):
                assert pd == jd, label
        elif ctype.startswith("text/plain; version=0.0.4"):
            jt = re.sub(rf":{jport}\b", ":N", jb.decode())
            pt = re.sub(rf":{pport}\b", ":N", pb.decode())
            jf = set(re.findall(r"# TYPE (\S+)", jt))
            pf = set(re.findall(r"# TYPE (\S+)", pt))
            assert jf <= pf, sorted(jf - pf)
            assert 'mtpu_node_up{node="127.0.0.1:N"} 1' in pt
            assert 'mtpu_node_up{node="127.0.0.1:N"} 1' in jt
    # The ring subscribed during the first GET, which it then records.
    rings = [[(r["method"], r["path"], r["statusCode"], r["api"])
              for r in json.loads(b[4])["trace"]] for b in (jbodies,
                                                            pbodies)]
    assert rings[1] == rings[0] == [
        ("GET", "/minio/admin/v3/trace", 200, "GET"),
        ("PUT", "/obk/o", 200, "PUT"), ("GET", "/obk/o", 200, "GET")]


def test_trace_stream_delivers_span_trees(tmp_path):
    """A POST trace stream turns tracing on and delivers each request's
    span tree (one root per request) with its tags, server-filtered."""
    pools = PORT.pools(tmp_path, "s")
    srv = PORT.S3Server(pools, PORT.sigv4.Credentials(ACCESS,
                                                      SECRET)).start()
    try:
        cli = PORT.S3Client(srv.endpoint, ACCESS, SECRET, timeout=TIMEOUT)
        cli.make_bucket("tbk")
        out = []
        t = threading.Thread(target=lambda: out.append(cli.request(
            "POST", "/minio/admin/v3/trace",
            query={"duration": "2", "path": "/tbk"})))
        t.start()
        deadline = time.monotonic() + 5
        while not pspan.TRACER.enabled and time.monotonic() < deadline:
            time.sleep(0.02)
        assert pspan.TRACER.enabled
        cli.put_object("tbk", "hello", b"h" * ((1 << 20) + 1))
        cli.get_object("tbk", "hello")
        cli.request("GET", "/other")
        t.join(timeout=15)
        st, _, body = out[0]
        assert st == 200
        recs = [json.loads(x) for x in body.splitlines() if x.strip()]
        assert [r["name"] for r in recs] == ["api.PutObject",
                                             "api.GetObject"]
        put = recs[0]
        assert put["tags"]["bucket"] == "tbk"
        assert put["tags"]["object"] == "hello"
        assert put["tags"]["status"] == 200 and not put["error"]
        assert any(c["name"] == "engine.put_object" for c in put["spans"])
        assert pspan.coverage(put) >= 0.8
        assert not pspan.TRACER.enabled
    finally:
        srv.shutdown()
        close_pools(pools)


def test_untraced_requests_allocate_no_spans(tmp_path):
    """With tracing off, PUTs, GETs and HEADs over HTTP materialise no
    Span object (the sentinel, not a wall-clock bound)."""
    pools = PORT.pools(tmp_path, "u")
    srv = PORT.S3Server(pools, PORT.sigv4.Credentials(ACCESS,
                                                      SECRET)).start()
    try:
        cli = PORT.S3Client(srv.endpoint, ACCESS, SECRET, timeout=TIMEOUT)
        cli.make_bucket("ubk")
        assert not pspan.TRACER.enabled
        before = pspan.SPAN_ALLOCS
        for i in range(4):
            cli.put_object("ubk", f"o{i}", bytes([i]) * (300_000 + i))
            cli.get_object("ubk", f"o{i}")
            cli.head_object("ubk", f"o{i}")
        assert pspan.SPAN_ALLOCS == before
    finally:
        srv.shutdown()
        close_pools(pools)


def _peer(srv, token):
    """A stand-in for a cluster node over `srv`'s RPC plane: the peer
    clients the admin fan-out dials."""
    return SimpleNamespace(peer_clients={}, notification=None,
                           peer_info=lambda: [c.peer_info() for c in
                                              srv.cluster_node.peer_clients
                                              .values()])


def test_fleet_scrape_with_a_node_stopped_and_one_hung(tmp_path,
                                                       monkeypatch):
    """Node A's metrics/cluster and healthinfo merge node B's answers
    (peer.metrics_text and peer.healthinfo over the RPC plane); with B
    stopped, B reads node_up 0 at once; a peer that accepts and never
    answers costs at most MTPU_OBS_DEADLINE_MS."""
    monkeypatch.setenv("MTPU_OBS_DEADLINE_MS", "1500")
    token = "fleet-token"
    servers, pools_l = [], []
    for tag in ("a", "b"):
        router = rest.RPCRouter(token)
        pools = PORT.pools(tmp_path, tag)
        srv = PORT.S3Server(pools, PORT.sigv4.Credentials(ACCESS, SECRET),
                            rpc_router=router).start()
        register_peer_rpc(router, PeerRegistry())
        register_obs_rpc(router, srv)
        servers.append(srv)
        pools_l.append(pools)
    a, b = servers
    hung = socket.socket()
    hung.bind(("127.0.0.1", 0))
    hung.listen(8)
    hport = hung.getsockname()[1]
    a.cluster_node = _peer(a, token)
    a.cluster_node.peer_clients = {
        ("127.0.0.1", b.port): rest.RPCClient(f"127.0.0.1:{b.port}", token,
                                              timeout=5)}
    cli = PORT.S3Client(a.endpoint, ACCESS, SECRET, timeout=TIMEOUT)
    me, nb = f"127.0.0.1:{a.port}", f"127.0.0.1:{b.port}"
    try:
        st, _, text = cli.request("GET", "/minio/admin/v3/metrics/cluster")
        text = text.decode()
        assert st == 200
        assert f'mtpu_node_up{{node="{me}"}} 1' in text
        assert f'mtpu_node_up{{node="{nb}"}} 1' in text
        assert f'mtpu_s3_requests_total{{api="GET",status="200",' \
               f'node="{me}"}}' not in text      # counted after render
        assert text.count("# TYPE mtpu_s3_requests_total ") == 1
        assert f'node="{nb}"' in text.split("mtpu_node_up")[0]
        # Unsigned, /minio/v2/metrics/cluster is the same fleet merge.
        import urllib.request
        with urllib.request.urlopen(
                f"{a.endpoint}/minio/v2/metrics/cluster", timeout=10) as r:
            v2 = r.read().decode()
        assert f'mtpu_node_up{{node="{nb}"}} 1' in v2
        assert f'node="{nb}"' in v2.split("mtpu_node_up")[0]
        st, out = cli.admin("GET", "healthinfo")
        assert st == 200 and out["node_up"] == {me: 1, nb: 1}
        assert out["nodes"][nb]["endpoint"] == nb
        # B stops: its client goes offline on the failed call.
        b.shutdown()
        t0 = time.monotonic()
        st, out = cli.admin("GET", "healthinfo")
        assert st == 200 and out["node_up"] == {me: 1, nb: 0}
        st, _, text = cli.request("GET", "/minio/admin/v3/metrics/cluster")
        assert f'mtpu_node_up{{node="{nb}"}} 0' in text.decode()
        assert time.monotonic() - t0 < 1.5
        # A peer that accepts and never answers: bounded by the budget.
        a.cluster_node.peer_clients[("127.0.0.1", hport)] = \
            rest.RPCClient(f"127.0.0.1:{hport}", token, timeout=30)
        t0 = time.monotonic()
        st, out = cli.admin("GET", "healthinfo")
        took = time.monotonic() - t0
        assert st == 200 and out["node_up"][f"127.0.0.1:{hport}"] == 0
        assert took < 1.5 + 1.0, took
    finally:
        hung.close()
        for c in a.cluster_node.peer_clients.values():
            c.close()
        a.shutdown()
        for p in pools_l:
            close_pools(p)
