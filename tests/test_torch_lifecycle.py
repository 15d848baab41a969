"""Lifecycle expiry in the port (minio_tpu_torch/bucket/lifecycle.py, the
scanner's pass in background/scanner.py and the server's ?lifecycle;
device="cpu") held to the JAX package.  Tolerance: exact (equal actions,
equal stats, equal surviving version lists).

- Rule parsing and `eval` on seeded configs, names, tags and ages.
- `apply_lifecycle` on both packages' stacks over the same seeded
  versions (pinned ids and mod times, some under retention or a legal
  hold): equal stats and equal surviving versions.
- A scanner cycle expires by date and by noncurrent age and skips a
  locked version; rules that cannot fire cost no pass.
- tests/test_bucket_features.py's TestLifecycle on both servers, the
  served 404 of a bucket without a config, and a Transition rule, which
  both servers store (tests/test_torch_tier.py runs the transitions).
"""

import datetime
import time

import numpy as np
import pytest

import minio_tpu.bucket.lifecycle as jax_lc
import minio_tpu_torch.bucket.lifecycle as port_lc
from minio_tpu.engine.pools import ServerPools as JaxServerPools
from minio_tpu.engine.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage.drive import LocalDrive as JaxLocalDrive
from minio_tpu_torch.background.scanner import DataScanner
from minio_tpu_torch.background.usage import DirtyTracker
from minio_tpu_torch.bucket.metadata import BucketMetadataSys
from minio_tpu_torch.engine.pools import ServerPools
from minio_tpu_torch.engine.sets import ErasureSets
from minio_tpu_torch.storage.drive import LocalDrive
from test_torch_server import ACCESS, JAX, PORT, SECRET, close_pools

DAY = 86400
#: The passes' clock; retention is judged by the wall clock (as both
#: packages do), so the lock dates below are relative to it too.
NOW = float(int(time.time()))
MODE, UNTIL, HOLD = ("x-amz-object-lock-mode",
                     "x-amz-object-lock-retain-until-date",
                     "x-amz-object-lock-legal-hold")


@pytest.fixture(autouse=True)
def unbound_tracker():
    yield
    DirtyTracker.shared().bind(None)


def _iso(ts: float) -> str:
    return datetime.datetime.fromtimestamp(
        ts, datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def _rule(rng, i) -> str:
    prefix = rng.choice(["", "logs/", "tmp/", "a"])
    flt = rng.choice(["filter", "and", "legacy"])
    tag = rng.integers(3) == 0
    tag_xml = "<Tag><Key>k</Key><Value>v</Value></Tag>" if tag else ""
    if flt == "and":
        f = f"<Filter><And><Prefix>{prefix}</Prefix>{tag_xml}</And></Filter>"
    elif flt == "legacy":
        f = f"<Prefix>{prefix}</Prefix>"
    else:
        f = f"<Filter><Prefix>{prefix}</Prefix>{tag_xml}</Filter>"
    body = ""
    if rng.integers(2):
        body += f"<Expiration><Days>{int(rng.integers(1, 60))}</Days>" \
                "</Expiration>"
    elif rng.integers(2):
        body += f"<Expiration><Date>{_iso(NOW + float(rng.integers(-90, 90)) * DAY)}" \
                "</Date></Expiration>"
    if rng.integers(2):
        body += "<NoncurrentVersionExpiration><NoncurrentDays>" \
                f"{int(rng.integers(1, 30))}</NoncurrentDays>" \
                "</NoncurrentVersionExpiration>"
    if rng.integers(3) == 0:
        body += f"<Transition><Days>{int(rng.integers(1, 30))}</Days>" \
                "<StorageClass>WARM</StorageClass></Transition>"
    status = "Enabled" if rng.integers(5) else "Disabled"
    return (f"<Rule><ID>r{i}</ID><Status>{status}</Status>{f}{body}"
            "</Rule>")


def _config(rng) -> bytes:
    rules = "".join(_rule(rng, i) for i in range(int(rng.integers(1, 4))))
    return f"<LifecycleConfiguration>{rules}</LifecycleConfiguration>" \
        .encode()


def test_parse_and_eval_match_jax():
    rng = np.random.default_rng(21)
    for _ in range(150):
        xml = _config(rng)
        port, jax = port_lc.Lifecycle.parse(xml), jax_lc.Lifecycle.parse(xml)
        assert [vars(r) for r in port.rules] == \
            [vars(r) for r in jax.rules], xml
        for _ in range(20):
            name = rng.choice(["logs/x", "tmp/y", "abc", "zzz"])
            mt = int((NOW - float(rng.integers(0, 120)) * DAY) * 1e9)
            tags = {"k": "v"} if rng.integers(2) else {}
            latest, deleted = bool(rng.integers(2)), bool(rng.integers(4) == 0)
            assert port.eval(name, mt, tags=tags, is_latest=latest,
                             deleted=deleted, now=NOW) == \
                jax.eval(name, mt, tags=tags, is_latest=latest,
                         deleted=deleted, now=NOW)


#: (key, version id or "", age in days, metadata) in write order: each
#: key's versions oldest first.
def _plan():
    lock_future = {MODE: "GOVERNANCE", UNTIL: _iso(NOW + 30 * DAY)}
    lock_past = {MODE: "COMPLIANCE", UNTIL: _iso(NOW - 30 * DAY)}
    v = "00000000-0000-4000-8000-{:012d}".format
    return [
        ("logs/old", v(1), 50, {}),
        ("logs/old", v(2), 45, {}),
        ("logs/old", v(3), 40, {}),
        ("logs/new", v(4), 2, {}),
        ("logs/held", v(5), 90, {HOLD: "ON"}),
        ("logs/locked", v(6), 70, lock_future),
        ("logs/lapsed", v(7), 70, lock_past),
        ("tmp/scratch", v(8), 20, {}),
        ("tmp/scratch", v(9), 15, lock_future),
        ("tmp/scratch", v(10), 1, {}),
        ("keep/me", v(11), 400, {}),
        ("tagged/t", v(12), 100, {"x-amz-tagging": "k=v"}),
        # Null versions: a pass's DELETE names no version, so in either
        # package only these expire (a versioned latest is left alone).
        ("logs/plain", "", 35, {}),
        ("tagged/u", "", 5, {"x-amz-tagging": "k=v"}),
        ("tagged/w", "", 5, {"x-amz-tagging": "k=w"}),
    ]


LC_DIFF = (b"<LifecycleConfiguration>"
           b"<Rule><ID>a</ID><Status>Enabled</Status><Filter><Prefix>logs/"
           b"</Prefix></Filter><Expiration><Days>30</Days></Expiration>"
           b"<NoncurrentVersionExpiration><NoncurrentDays>7"
           b"</NoncurrentDays></NoncurrentVersionExpiration></Rule>"
           b"<Rule><ID>b</ID><Status>Enabled</Status><Filter><Prefix>tmp/"
           b"</Prefix></Filter><NoncurrentVersionExpiration><NoncurrentDays>"
           b"3</NoncurrentDays></NoncurrentVersionExpiration></Rule>"
           b"<Rule><ID>c</ID><Status>Enabled</Status><Filter><And><Prefix>"
           b"tagged/</Prefix><Tag><Key>k</Key><Value>v</Value></Tag></And>"
           b"</Filter><Expiration><Date>2026-01-01T00:00:00Z</Date>"
           b"</Expiration></Rule></LifecycleConfiguration>")


def _stack(kind, root):
    if kind == "jax":
        pools = JaxServerPools([JaxErasureSets(
            [JaxLocalDrive(f"{root}/j{i}") for i in range(4)],
            set_drive_count=4)])
    else:
        pools = ServerPools([ErasureSets(
            [LocalDrive(f"{root}/p{i}") for i in range(4)],
            set_drive_count=4, device="cpu")])
    pools.make_bucket("lcb")
    rng = np.random.default_rng(22)
    for key, vid, age, meta in _plan():
        pools.put_object("lcb", key, rng.bytes(int(rng.integers(1, 3000))),
                         metadata=dict(meta), versioned=bool(vid),
                         version_id=vid or None,
                         mod_time_ns=int((NOW - age * DAY) * 1e9))
    return pools


def _survivors(pools):
    out = {}
    for key in sorted({k for k, *_ in _plan()}):
        try:
            out[key] = [(v.version_id, v.mod_time_ns, v.deleted)
                        for v in pools.list_object_versions("lcb", key)]
        except Exception:  # noqa: BLE001 — either package's not-found
            out[key] = []
    return out


def test_apply_lifecycle_matches_jax(tmp_path):
    got = {}
    for kind, lc_mod in (("jax", jax_lc), ("port", port_lc)):
        pools = _stack(kind, tmp_path)
        try:
            stats = lc_mod.apply_lifecycle(
                pools, "lcb", lc_mod.Lifecycle.parse(LC_DIFF), now=NOW)
            got[kind] = (stats, _survivors(pools))
        finally:
            close_pools(pools)
    assert got["port"] == got["jax"]
    stats, surv = got["port"]
    assert stats == {"expired": 2, "expired_noncurrent": 3,
                     "transitioned": 0, "skipped_locked": 3}, stats
    assert surv["logs/plain"] == surv["tagged/u"] == []
    assert len(surv["tagged/w"]) == len(surv["keep/me"]) == 1
    assert [v[0][-2:] for v in surv["tmp/scratch"]] == ["10", "09"]


def test_a_scanner_cycle_expires_and_skips_the_locked(tmp_path):
    pools = ServerPools([ErasureSets(
        [LocalDrive(f"{tmp_path}/d{i}") for i in range(4)],
        set_drive_count=4, device="cpu")])
    sc = None
    try:
        meta = BucketMetadataSys(pools)
        now = time.time()
        pools.make_bucket("scb")
        old = int((now - 10 * DAY) * 1e9)
        lock = {MODE: "COMPLIANCE", UNTIL: _iso(now + 30 * DAY)}
        pools.put_object("scb", "tmp/a", b"a")
        pools.put_object("scb", "tmp/locked", b"l", metadata=lock)
        pools.put_object("scb", "keep/b", b"b")
        v = "11111111-1111-4111-8111-{:012d}".format
        pools.put_object("scb", "hist", b"h1", versioned=True,
                         version_id=v(1), mod_time_ns=old)
        pools.put_object("scb", "hist", b"h2", versioned=True,
                         version_id=v(2), mod_time_ns=old + 10**9)
        pools.put_object("scb", "hist", b"h3", versioned=True)
        meta.put("scb", "lifecycle", (
            b"<LifecycleConfiguration><Rule><Status>Enabled</Status>"
            b"<Filter><Prefix>tmp/</Prefix></Filter><Expiration><Date>"
            + _iso(now - DAY).encode()
            + b"</Date></Expiration></Rule><Rule><Status>Enabled</Status>"
            b"<Filter/><NoncurrentVersionExpiration><NoncurrentDays>1"
            b"</NoncurrentDays></NoncurrentVersionExpiration></Rule>"
            b"</LifecycleConfiguration>"))
        sc = DataScanner(pools).attach_config(meta)
        usage = sc.scan_cycle()
        assert sc.stats.lifecycle == {"expired": 1, "expired_noncurrent": 2,
                                      "transitioned": 0,
                                      "skipped_locked": 1}
        names = sorted(fi.name for fi in pools.list_objects("scb"))
        assert names == ["hist", "keep/b", "tmp/locked"]
        assert [bytes(pools.get_object("scb", "hist")[1])] == [b"h3"]
        assert len(pools.list_object_versions("scb", "hist")) == 1
        assert usage.buckets["scb"].objects == 3
        # A config whose rules cannot fire costs no pass.
        meta.put("scb", "lifecycle", (
            b"<LifecycleConfiguration><Rule><Status>Enabled</Status>"
            b"<Filter/><AbortIncompleteMultipartUpload><DaysAfterInitiation>"
            b"1</DaysAfterInitiation></AbortIncompleteMultipartUpload>"
            b"</Rule></LifecycleConfiguration>"))
        calls = []
        real = port_lc.apply_lifecycle
        import minio_tpu_torch.background.scanner as scanner_mod
        scanner_mod.apply_lifecycle = \
            lambda *a, **k: calls.append(a) or real(*a, **k)
        try:
            sc.scan_cycle()
        finally:
            scanner_mod.apply_lifecycle = real
        assert calls == []
    finally:
        if sc is not None:
            sc.stop()
        pools.close()


LC_XML = b"""<LifecycleConfiguration>
 <Rule><ID>old</ID><Status>Enabled</Status>
  <Filter><Prefix>logs/</Prefix></Filter>
  <Expiration><Days>30</Days></Expiration>
 </Rule>
</LifecycleConfiguration>"""


@pytest.fixture(params=[JAX, PORT], ids=lambda p: p.name)
def stack(request, tmp_path):
    pkg = request.param
    pools = pkg.pools(tmp_path, "d")
    srv = pkg.S3Server(pools, pkg.sigv4.Credentials(ACCESS, SECRET)).start()
    cli = pkg.S3Client(srv.endpoint, ACCESS, SECRET, **pkg.client_kw)
    yield pkg, pools, cli
    srv.shutdown()
    close_pools(pools)


@pytest.mark.parametrize("lc", [jax_lc, port_lc], ids=["jax", "port"])
class TestLifecycleUnits:
    def test_parse_and_eval(self, lc):
        rules = lc.Lifecycle.parse(LC_XML)
        now = time.time()
        old = int((now - 40 * DAY) * 1e9)
        fresh = int((now - 5 * DAY) * 1e9)
        assert rules.eval("logs/a", old) == "expire"
        assert rules.eval("logs/a", fresh) == ""
        assert rules.eval("data/a", old) == ""

    def test_noncurrent_expiry(self, lc):
        rules = lc.Lifecycle.parse(b"""<LifecycleConfiguration><Rule>
            <Status>Enabled</Status><Filter/>
            <NoncurrentVersionExpiration><NoncurrentDays>7
            </NoncurrentDays></NoncurrentVersionExpiration>
            </Rule></LifecycleConfiguration>""")
        old = int((time.time() - 10 * DAY) * 1e9)
        assert rules.eval("k", old, is_latest=False) == "expire-noncurrent"
        assert rules.eval("k", old, is_latest=True) == ""


class TestLifecycleServer:
    def test_apply_expires_objects(self, stack):
        pkg, pools, _ = stack
        lc = port_lc if pkg is PORT else jax_lc
        pools.make_bucket("lcb")
        pools.put_object("lcb", "logs/old", b"x")
        pools.put_object("lcb", "keep/me", b"y")
        stats = lc.apply_lifecycle(pools, "lcb", lc.Lifecycle.parse(LC_XML),
                                   now=time.time() + 40 * DAY)
        assert stats["expired"] == 1
        assert [fi.name for fi in pools.list_objects("lcb")] == ["keep/me"]

    def test_config_endpoint_roundtrip(self, stack):
        _, _, cli = stack
        cli.make_bucket("lcfg")
        st, _, body = cli.request("GET", "/lcfg", query={"lifecycle": ""})
        assert st == 404 and b"NoSuchLifecycleConfiguration" in body
        cli._check(*cli.request("PUT", "/lcfg", query={"lifecycle": ""},
                                body=LC_XML))
        _, _, data = cli._check(*cli.request(
            "GET", "/lcfg", query={"lifecycle": ""}))
        assert data == LC_XML
        cli._check(*cli.request("DELETE", "/lcfg",
                                query={"lifecycle": ""}))
        st, _, _ = cli.request("GET", "/lcfg", query={"lifecycle": ""})
        assert st == 404

    def test_bad_config_rejected(self, stack):
        _, _, cli = stack
        cli.make_bucket("lbad")
        st, _, body = cli.request("PUT", "/lbad", query={"lifecycle": ""},
                                  body=b"<not-xml")
        assert st == 400 and b"MalformedXML" in body

    def test_a_transition_rule(self, stack):
        """Both servers store a Transition rule and read it back."""
        pkg, _, cli = stack
        cli.make_bucket("ltr")
        xml = (b"<LifecycleConfiguration><Rule><Status>Enabled</Status>"
               b"<Filter/><Transition><Days>30</Days><StorageClass>WARM"
               b"</StorageClass></Transition></Rule>"
               b"</LifecycleConfiguration>")
        st, _, body = cli.request("PUT", "/ltr", query={"lifecycle": ""},
                                  body=xml)
        assert st == 200, body
        st, _, got = cli.request("GET", "/ltr", query={"lifecycle": ""})
        assert (st, got) == (200, xml)
