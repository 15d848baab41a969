"""Object lock in the port (minio_tpu_torch/bucket/object_lock.py and the
server's object-lock, ?retention and ?legal-hold answers; device="cpu")
held to the JAX package.  Tolerance: exact (equal dicts, equal bytes,
equal status codes and error codes).

- The config parse, the default retention, the retention and legal-hold
  checks, the delete verdicts (with and without the GOVERNANCE bypass)
  and the retention XML, on seeded inputs through both packages.
- tests/test_bucket_features.py's TestObjectLock on both servers: a
  default GOVERNANCE retention refuses a DELETE and the bypass header
  lifts it; a legal hold refuses even the bypass; COMPLIANCE retention
  cannot be shortened; a multipart upload takes the default retention
  and cannot complete over a protected version.
- The served answers of a bucket and an object without a lock.
- The port's repair: a copy onto a protected unversioned object is
  refused (the JAX package's copy overwrites it).
"""

import datetime

import numpy as np
import pytest

import minio_tpu.bucket.object_lock as jax_ol
import minio_tpu_torch.bucket.object_lock as port_ol
from test_torch_server import (ACCESS, JAX, PORT, SECRET, close_pools)

UTC = datetime.timezone.utc
NOW = datetime.datetime(2026, 3, 1, 12, 0, 0, tzinfo=UTC)


def _lock_xml(rng) -> bytes:
    mode = rng.choice(["GOVERNANCE", "COMPLIANCE", ""])
    days, years = int(rng.integers(0, 400)), int(rng.integers(0, 3))
    enabled = rng.choice(["Enabled", "Disabled"])
    ns = ' xmlns="http://s3.amazonaws.com/doc/2006-03-01/"' \
        if rng.integers(2) else ""
    rule = "" if not mode else (
        f"<Rule><DefaultRetention><Mode>{mode}</Mode>"
        + (f"<Days>{days}</Days>" if days else "")
        + (f"<Years>{years}</Years>" if years else "")
        + "</DefaultRetention></Rule>")
    return (f"<ObjectLockConfiguration{ns}><ObjectLockEnabled>{enabled}"
            f"</ObjectLockEnabled>{rule}</ObjectLockConfiguration>").encode()


def _metadata(rng) -> dict:
    meta = {}
    mode = rng.choice(["GOVERNANCE", "COMPLIANCE", "governance", ""])
    if mode:
        meta[port_ol.RET_MODE_KEY] = mode
    offset = int(rng.integers(-400, 400))
    date = rng.choice(["iso", "bad", "none"])
    if date == "iso":
        meta[port_ol.RET_DATE_KEY] = (
            NOW + datetime.timedelta(days=offset)).strftime(
                "%Y-%m-%dT%H:%M:%SZ")
    elif date == "bad":
        meta[port_ol.RET_DATE_KEY] = "not-a-date"
    hold = rng.choice(["ON", "on", "OFF", ""])
    if hold:
        meta[port_ol.LEGAL_HOLD_KEY] = hold
    return meta


def test_config_parse_and_default_retention_match_jax():
    rng = np.random.default_rng(19)
    for _ in range(200):
        xml = _lock_xml(rng)
        cfg = port_ol.parse_lock_config(xml)
        assert cfg == jax_ol.parse_lock_config(xml), xml
        assert port_ol.default_retention_metadata(cfg, NOW) == \
            jax_ol.default_retention_metadata(cfg, NOW)


def test_checks_and_retention_xml_match_jax():
    rng = np.random.default_rng(20)
    for _ in range(400):
        meta = _metadata(rng)
        for fn in ("is_retention_active", "check_delete_allowed"):
            assert getattr(port_ol, fn)(meta, now=NOW) == \
                getattr(jax_ol, fn)(meta, now=NOW), (fn, meta)
        assert port_ol.check_delete_allowed(
            meta, bypass_governance=True, now=NOW) == \
            jax_ol.check_delete_allowed(meta, bypass_governance=True,
                                        now=NOW)
        assert port_ol.is_legal_hold_on(meta) == \
            jax_ol.is_legal_hold_on(meta)
        xml = port_ol.retention_xml(meta)
        assert xml == jax_ol.retention_xml(meta)
        assert port_ol.parse_retention_xml(xml) == \
            jax_ol.parse_retention_xml(xml)


LOCK_XML = b"""<ObjectLockConfiguration>
 <ObjectLockEnabled>Enabled</ObjectLockEnabled>
 <Rule><DefaultRetention><Mode>GOVERNANCE</Mode><Days>1</Days>
 </DefaultRetention></Rule>
</ObjectLockConfiguration>"""


@pytest.fixture(params=[JAX, PORT], ids=lambda p: p.name)
def stack(request, tmp_path):
    pkg = request.param
    pools = pkg.pools(tmp_path, "d")
    srv = pkg.S3Server(pools, pkg.sigv4.Credentials(ACCESS, SECRET)).start()
    cli = pkg.S3Client(srv.endpoint, ACCESS, SECRET, **pkg.client_kw)
    yield pkg, cli
    srv.shutdown()
    close_pools(pools)


class TestObjectLock:
    def test_worm_protects_and_governance_bypass(self, stack):
        pkg, cli = stack
        cli.make_bucket("worm")
        cli._check(*cli.request("PUT", "/worm",
                                query={"object-lock": ""}, body=LOCK_XML))
        _, _, got = cli._check(*cli.request("GET", "/worm",
                                            query={"object-lock": ""}))
        assert got == LOCK_XML
        cli.put_object("worm", "doc", b"protected")
        with pytest.raises(pkg.S3ClientError) as ei:
            cli.delete_object("worm", "doc")
        assert (ei.value.status, ei.value.code) == (400, "ObjectLocked")
        # An unversioned overwrite would destroy the version too.
        with pytest.raises(pkg.S3ClientError) as ei:
            cli.put_object("worm", "doc", b"replaced")
        assert ei.value.code == "ObjectLocked"
        status, _, _ = cli.request(
            "DELETE", "/worm/doc",
            headers={"x-amz-bypass-governance-retention": "true"})
        assert status == 204

    def test_legal_hold_blocks_even_bypass(self, stack):
        _, cli = stack
        cli.make_bucket("hold")
        cli.put_object("hold", "doc", b"x")
        _, _, data = cli._check(*cli.request(
            "GET", "/hold/doc", query={"legal-hold": ""}))
        assert b"<Status>OFF</Status>" in data
        cli._check(*cli.request(
            "PUT", "/hold/doc", query={"legal-hold": ""},
            body=b"<LegalHold><Status>ON</Status></LegalHold>"))
        _, _, data = cli._check(*cli.request(
            "GET", "/hold/doc", query={"legal-hold": ""}))
        assert b"<Status>ON</Status>" in data
        status, _, _ = cli.request(
            "DELETE", "/hold/doc",
            headers={"x-amz-bypass-governance-retention": "true"})
        assert status == 400
        cli._check(*cli.request(
            "PUT", "/hold/doc", query={"legal-hold": ""},
            body=b"<LegalHold><Status>OFF</Status></LegalHold>"))
        cli.delete_object("hold", "doc")

    def test_retention_endpoint(self, stack):
        pkg, cli = stack
        cli.make_bucket("ret")
        cli.put_object("ret", "doc", b"x")
        # No retention yet: the served answer the port gave as 501.
        st, _, body = cli.request("GET", "/ret/doc", query={"retention": ""})
        assert st == 404 and b"NoSuchObjectLockConfiguration" in body
        body = (b"<Retention><Mode>GOVERNANCE</Mode>"
                b"<RetainUntilDate>2030-01-01T00:00:00Z"
                b"</RetainUntilDate></Retention>")
        cli._check(*cli.request("PUT", "/ret/doc",
                                query={"retention": ""}, body=body))
        _, _, data = cli._check(*cli.request(
            "GET", "/ret/doc", query={"retention": ""}))
        assert data == port_ol.retention_xml({
            port_ol.RET_MODE_KEY: "GOVERNANCE",
            port_ol.RET_DATE_KEY: "2030-01-01T00:00:00Z"})
        body2 = (b"<Retention><Mode>COMPLIANCE</Mode>"
                 b"<RetainUntilDate>2031-01-01T00:00:00Z"
                 b"</RetainUntilDate></Retention>")
        cli._check(*cli.request(
            "PUT", "/ret/doc", query={"retention": ""}, body=body2,
            headers={"x-amz-bypass-governance-retention": "true"}))
        shorter = (b"<Retention><Mode>COMPLIANCE</Mode>"
                   b"<RetainUntilDate>2030-06-01T00:00:00Z"
                   b"</RetainUntilDate></Retention>")
        status, _, _ = cli.request("PUT", "/ret/doc",
                                   query={"retention": ""}, body=shorter)
        assert status == 400
        st, _, body = cli.request(
            "PUT", "/ret/doc", query={"retention": ""},
            body=b"<Retention><Mode>GOVERNANCE</Mode>"
                 b"<RetainUntilDate>soon</RetainUntilDate></Retention>")
        assert st == 400 and b"InvalidRetentionDate" in body

    def test_a_multipart_upload_over_a_protected_version(self, stack):
        """The upload takes the default retention at create; its
        complete may not replace a protected unversioned object."""
        pkg, cli = stack
        cli.make_bucket("mpl")
        cli._check(*cli.request("PUT", "/mpl", query={"object-lock": ""},
                                body=LOCK_XML))
        cli.put_object("mpl", "doc", b"protected")
        uid = cli.create_multipart("mpl", "doc")
        etag = cli.upload_part("mpl", "doc", uid, 1, b"part" * 100)
        with pytest.raises(pkg.S3ClientError) as ei:
            cli.complete_multipart("mpl", "doc", uid, [(1, etag)])
        assert ei.value.code == "ObjectLocked"
        uid = cli.create_multipart("mpl", "fresh")
        etag = cli.upload_part("mpl", "fresh", uid, 1, b"part" * 100)
        cli.complete_multipart("mpl", "fresh", uid, [(1, etag)])
        _, _, ret = cli._check(*cli.request("GET", "/mpl/fresh",
                                            query={"retention": ""}))
        assert b"<Mode>GOVERNANCE</Mode>" in ret

    def test_bucket_without_lock_config(self, stack):
        _, cli = stack
        cli.make_bucket("nolock")
        st, _, body = cli.request("GET", "/nolock",
                                  query={"object-lock": ""})
        assert st == 404 and b"NoSuchObjectLockConfiguration" in body
        st, _, body = cli.request("PUT", "/nolock",
                                  query={"object-lock": ""},
                                  body=b"<not-xml")
        assert st == 400 and b"MalformedXML" in body


def test_copy_onto_a_protected_version_is_refused(stack):
    """The port's repair: its copy runs the PUT's lock gate, so a copy
    cannot replace a protected unversioned object; the JAX package's copy
    overwrites it."""
    pkg, cli = stack
    cli.make_bucket("cpw")
    cli.put_object("cpw", "src", b"new bytes")
    cli._check(*cli.request("PUT", "/cpw", query={"object-lock": ""},
                            body=LOCK_XML))
    cli.put_object("cpw", "doc", b"protected")
    st, _, _ = cli.request("PUT", "/cpw/doc",
                           headers={"x-amz-copy-source": "/cpw/src"})
    if pkg is PORT:
        assert st == 400
        assert cli.get_object("cpw", "doc") == b"protected"
    else:
        assert st == 200
        assert cli.get_object("cpw", "doc") == b"new bytes"
