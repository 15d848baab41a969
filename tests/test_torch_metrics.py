"""The port's metrics registry (minio_tpu_torch/observe/metrics.py) held
to the JAX package's: the same families with the same TYPE, HELP and
labels at /minio/v2/metrics/node, equal deterministic counters after the
same seeded requests, `merge_prom` and `label_sample` on the same
inputs, `ApiWindow` percentiles on a seeded latency stream, and the
port's one-counter-per-quantity rendering of its modules' counts."""

import re

import numpy as np
import pytest

import minio_tpu.observe.lastminute as jlm
import minio_tpu.observe.metrics as jmetrics
import minio_tpu_torch.observe.lastminute as plm
import minio_tpu_torch.observe.metrics as pmetrics
from minio_tpu.observe.metrics import DATA_PATH as JAX_DATA_PATH
from minio_tpu_torch.ops import coalesce, devcache, selftest
from minio_tpu_torch.ops import zerocopy as zc
from minio_tpu_torch.storage import drive as pdrive

from test_torch_server import JAX, PORT, close_pools

ACCESS, SECRET = "metricsadmin", "metricsadmin-secret"

#: Families whose samples are times (or ratios of times): never compared.
TIME_VALUED = ("mtpu_s3_ttfb_seconds", "mtpu_api_last_minute_p50",
               "mtpu_api_last_minute_p99")
#: Families of the front door's own registry compared sample for sample
#: after the same requests (the scrape request itself is counted after
#: its render in both packages); TIME_VALUED families are left out.
COMPARED = ("mtpu_s3_requests_total", "mtpu_s3_errors_total",
            "mtpu_s3_requests_inflight", "mtpu_s3_rx_bytes_total",
            "mtpu_s3_tx_bytes_total", "mtpu_api_last_minute_count",
            "mtpu_api_last_minute_errors", "mtpu_api_last_minute_sheds",
            "mtpu_trace_api_requests_total", "mtpu_trace_api_errors_total")


@pytest.fixture(autouse=True)
def cold_planes(monkeypatch):
    """Both packages' span tracers off and empty (they are
    process-global: an earlier test's per-API aggregates would show in
    the scrape), the port's coalescer and device cache cold."""
    import minio_tpu.observe.span as jspan
    import minio_tpu_torch.observe.span as pspan
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


def parse(text: str):
    """(families {name: (type, help)}, samples {series: value})."""
    fams, helps, samples = {}, {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(None, 3)
            assert name not in fams, f"TYPE of {name} written twice"
            fams[name] = typ
        elif line.startswith("# HELP "):
            _, _, name, *rest = line.split(None, 3)
            assert name not in helps, f"HELP of {name} written twice"
            helps[name] = rest[0] if rest else ""
        elif line and not line.startswith("#"):
            series, _, value = line.rpartition(" ")
            samples[series] = float(value)
    assert set(fams) == set(helps)
    return {n: (fams[n], helps[n]) for n in fams}, samples


def _script(cli, rng):
    """The seeded request sequence both servers take."""
    cli.make_bucket("mbk")
    bodies = {f"o{i}": rng.integers(0, 256, int(n), dtype=np.uint8
                                    ).tobytes()
              for i, n in enumerate((1000, 200_000, (1 << 20) + 7,
                                     3 << 20))}
    for key, body in bodies.items():
        cli.request("PUT", f"/mbk/{key}", body=body)
    for key in bodies:
        cli.request("GET", f"/mbk/{key}")
        cli.request("HEAD", f"/mbk/{key}")
    cli.request("GET", "/mbk/o3", headers={"Range": "bytes=100-70000"})
    cli.request("GET", "/mbk/missing")
    cli.request("GET", "/nobucket/x")
    cli.request("GET", "/mbk", query={"list-type": "2"})
    cli.request("DELETE", "/mbk/o0")


def _scrape(pkg, tmp_path, tag):
    pools = pkg.pools(tmp_path, tag)
    srv = pkg.S3Server(pools, pkg.sigv4.Credentials(ACCESS, SECRET)).start()
    try:
        cli = pkg.S3Client(srv.endpoint, ACCESS, SECRET, **pkg.client_kw)
        _script(cli, np.random.default_rng(7))
        st, _, text = cli.request("GET", "/minio/v2/metrics/node")
        assert st == 200
        return text.decode(), srv
    finally:
        srv.shutdown()
        close_pools(pools)


def test_node_scrape_matches_the_jax_package(tmp_path):
    """Same families (TYPE and HELP), same declared labels, equal
    deterministic samples after the same requests; the port's extra
    families are exactly PORT_FAMILIES."""
    jtext, jsrv = _scrape(JAX, tmp_path, "j")
    ptext, psrv = _scrape(PORT, tmp_path, "p")
    jfams, jsamples = parse(jtext)
    pfams, psamples = parse(ptext)
    assert set(pfams) - set(jfams) == set(pmetrics.PORT_FAMILIES)
    assert set(jfams) <= set(pfams)
    for name, (typ, help_) in jfams.items():
        assert pfams[name] == (typ, help_), name
    jlabels = {m.name: tuple(getattr(m, "label_names", ()))
               for m in jsrv.metrics.families()}
    plabels = {m.name: tuple(getattr(m, "label_names", ()))
               for m in psrv.metrics.families()}
    for name, labels in jlabels.items():
        assert plabels[name] == labels, name
    for name in COMPARED:
        assert name not in TIME_VALUED
        j = {k: v for k, v in jsamples.items()
             if re.match(rf"{name}(\{{|$)", k)}
        p = {k: v for k, v in psamples.items()
             if re.match(rf"{name}(\{{|$)", k)}
        assert p == j, name
    assert psamples['mtpu_s3_requests_total{api="PUT",status="200"}'] == 5
    assert psamples['mtpu_s3_errors_total{code="404"}'] == 2
    # The ttfb histogram counts the same requests (its sums are times).
    assert psamples["mtpu_s3_ttfb_seconds_count"] == \
        jsamples["mtpu_s3_ttfb_seconds_count"]


def test_coalesced_items_match(tmp_path):
    """The same PUTs through both engines put the same items through the
    coalescer.  The objects are whole 1 MiB blocks: a ragged tail block
    is one more device batch in the port, where the JAX package encodes
    it on the host (its inline objects likewise)."""
    from minio_tpu.ops import coalesce as jco
    jco.reset()
    j0 = JAX_DATA_PATH.snapshot()["co_items"]
    counts = {}
    for pkg, tag in ((JAX, "j"), (PORT, "p")):
        pools = pkg.pools(tmp_path, tag)
        try:
            es = pools.pools[0].sets[0]
            es.make_bucket("b")
            rng = np.random.default_rng(11)
            for i, n in enumerate((1 << 20, 3 << 20, 2 << 20)):
                es.put_object("b", f"o{i}", rng.integers(
                    0, 256, n, dtype=np.uint8).tobytes())
            if pkg is JAX:
                counts["jax"] = JAX_DATA_PATH.snapshot()["co_items"] - j0
            else:
                reg = pmetrics.MetricsRegistry()
                _, samples = parse(reg.render())
                counts["port"] = samples["mtpu_coalesce_items_total"]
        finally:
            close_pools(pools)
    jco.reset()
    assert counts["port"] == counts["jax"] > 0


def test_merge_prom_and_label_sample_match():
    """Both packages' merge_prom and label_sample give the same output
    on the same inputs, and the merge writes each family's HELP and
    TYPE once."""
    reg = pmetrics.MetricsRegistry()
    reg.observe_request("PUT", 200, 0.01, 100, 0, bucket="b")
    a = reg.render()
    reg.observe_request("GET", 404, 0.02, 0, 50)
    b = reg.render()
    sections = [("127.0.0.1:9001", a), ("127.0.0.1:9002", b),
                ("n3", "bare_sample 1\n# just a comment\n")]
    merged = pmetrics.merge_prom(sections)
    assert merged == jmetrics.merge_prom(sections)
    parse(merged)
    for line, key, value in (('x{a="b"} 1', "node", "n"), ("x 2", "k", "v"),
                             ('y_bucket{le="+Inf"} 3', "node", "h:1")):
        assert pmetrics.label_sample(line, key, value) == \
            jmetrics.label_sample(line, key, value)


def test_api_window_percentiles_match():
    """ApiWindow of both packages on one seeded latency stream (a pinned
    clock walking through two windows) gives the same snapshot, and
    `percentile` the same bucket bounds."""
    rng = np.random.default_rng(5)
    t = [1000.0]
    jw = jlm.ApiWindow(window_s=10, clock=lambda: t[0])
    pw = plm.ApiWindow(window_s=10, clock=lambda: t[0])
    for i in range(3000):
        api = ("api.GetObject", "api.PutObject")[int(rng.integers(0, 2))]
        dur = float(rng.lognormal(-4.0, 1.5))
        err, shed = bool(rng.random() < 0.05), bool(rng.random() < 0.02)
        n = int(rng.integers(0, 1 << 20))
        for w in (jw, pw):
            w.observe(api, dur, error=err, nbytes=n, shed=shed)
        t[0] += float(rng.random() * 0.02)
        if i % 500 == 499:
            assert pw.snapshot() == jw.snapshot()
    assert pw.snapshot() == jw.snapshot()
    for q in (0.5, 0.9, 0.99):
        buckets = [int(x) for x in rng.integers(0, 50, len(plm.BOUNDS_MS))]
        assert plm.percentile(buckets, sum(buckets), q) == \
            jlm.percentile(buckets, sum(buckets), q)


def test_registry_renders_the_modules_counts(tmp_path):
    """One counter per quantity: the registry's zero-copy, metadata and
    coalescer families are the modules' own counts, read at scrape."""
    pools = PORT.pools(tmp_path, "c")
    try:
        es = pools.pools[0].sets[0]
        es.make_bucket("b")
        es.put_object("b", "o", b"x" * ((1 << 20) + 9))
        es.put_object("b", "s", b"y" * 500)
        zc.record("sendmsg", 123)
        reg = pmetrics.MetricsRegistry()
        _, s = parse(reg.render())
        # The rendered values are %g (six digits): read the families.
        ds, zs = pdrive.stats(), zc.stats()
        assert reg.zerocopy_sendmsg.get() == zs["sendmsg"]
        assert reg.zerocopy_sendmsg_bytes.get() == zs["sendmsg_bytes"]
        assert reg.zerocopy_vectored_writes.get() == ds["vectored_writes"]
        assert reg.meta_publishes.get() == ds["meta_publishes"]
        lanes = coalesce.get().stats()
        assert reg.co_dispatches.get() == lanes["dispatches"]
        assert reg.device_lane_dispatches.get(device="0") == \
            lanes["dispatches"] > 0
        assert s['mtpu_kernel_items_total{kernel="gf_matmul"}'] >= 2
        assert s["mtpu_heal_objects_healed_total"] == 0
    finally:
        close_pools(pools)


def test_metrics_registry_self_test_walks_every_family():
    """The boot self-test passes, and a family without docs fails it."""
    selftest.metrics_registry_self_test()
    names = [m.name for m in pmetrics.MetricsRegistry().families()]
    assert len(names) == len(set(names))
    assert "mtpu_kernel_launches_total" in names
    assert "mtpu_kernel_launches_total" not in [
        m.name for m in pmetrics.MetricsRegistry(kernels=False).families()]
    orig = pmetrics.MetricsRegistry.__init__

    def with_stray(self, kernels=True):
        orig(self, kernels)
        self.stray = pmetrics.Gauge("mtpu_undocumented_family", "x")
    try:
        pmetrics.MetricsRegistry.__init__ = with_stray
        with pytest.raises(selftest.SelfTestError, match="undocumented"):
            selftest.metrics_registry_self_test()
    finally:
        pmetrics.MetricsRegistry.__init__ = orig
