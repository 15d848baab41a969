"""The port's identity planes held to the JAX package's (device="cpu").
Tolerance: exact.

- A seeded request script (numpy default_rng) drives a JAX S3Server and
  the port's, each over its own drives, IAM and an HS256 OIDC provider,
  through every handler of the identity slice and its errors: the admin
  API's users, groups, policies and service accounts, SigV2 header and
  presigned requests, STS actions, identity-policy refusals, POST-policy
  uploads, snowball and zip extract, bucket policies and anonymous
  requests.  Per request: the status, the S3 error Code, the compared
  headers and the body (XML with request ids normalised, JSON parsed,
  anything else by SHA-256).  Keys, secrets and session tokens come from
  a seeded stand-in for `secrets` and expirations from a fixed clock,
  pinned in both packages' iam modules.  The one listed divergence is
  held in `_DIVERGES`.
- IAM state (users, groups, policies, service accounts) and a bucket
  policy written by either package load in the other.
- string_to_sign, sign_header_v2, presign_v2, make_post_form,
  check_post_policy, make_hs256_token with validate and the LDAP BER
  encoders give the same strings and bytes in both packages for seeded
  inputs and a fixed clock.
- Hypothesis draws policy documents, actions, resources and condition
  contexts; Policy.is_allowed and merge_allowed agree across packages.
"""

import base64
import datetime
import hashlib
import http.client
import io
import json
import re
import tarfile
import urllib.parse
import zipfile

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import minio_tpu.iam.iam as jax_iam
import minio_tpu.iam.ldap as jax_ldap
import minio_tpu.iam.oidc as jax_oidc
import minio_tpu.iam.policy as jax_policy
import minio_tpu.server.api_errors as jax_api_errors
import minio_tpu.server.postpolicy as jax_postpolicy
import minio_tpu.server.sigv2 as jax_sigv2
import minio_tpu.server.sigv4 as jax_sigv4
import minio_tpu_torch.iam.iam as port_iam
import minio_tpu_torch.iam.ldap as port_ldap
import minio_tpu_torch.iam.oidc as port_oidc
import minio_tpu_torch.iam.policy as port_policy
import minio_tpu_torch.server.api_errors as port_api_errors
import minio_tpu_torch.server.postpolicy as port_postpolicy
import minio_tpu_torch.server.sigv2 as port_sigv2
import minio_tpu_torch.server.sigv4 as port_sigv4
from test_torch_auth import JAX_AUTH, PORT_AUTH
from test_torch_server import TIMEOUT, _jax_pools, _port_pools, close_pools

ACCESS, SECRET = "authdiffadmin", "authdiffadmin-secret"
SEED = 20261017
OIDC_SECRET = b"diff-oidc-secret"
CLOCK = 1_800_000_000.0          # the pinned clock of both iam modules
MIB = 1 << 20
_COMPARED = ("ETag", "Content-Length", "Content-Type",
             "x-mtpu-extracted-objects")
_NORMALISED = ("RequestId", "LastModified")


class _SeededSecrets:
    """Stand-in for the `secrets` module of both iam modules: the same
    keys, secrets and tokens in the same order for both packages."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def token_hex(self, n: int = 32) -> str:
        return self.rng.bytes(n).hex()

    def token_urlsafe(self, n: int = 32) -> str:
        return self.rng.bytes(n).hex()[:n + n // 3]


class _Clock:
    @staticmethod
    def time() -> float:
        return CLOCK


@pytest.fixture()
def pinned(monkeypatch):
    """Pin `secrets` and `time` in both iam modules; returns a function
    that restarts the seeded secrets (call it before each package)."""
    def restart():
        for mod in (jax_iam, port_iam):
            monkeypatch.setattr(mod, "secrets", _SeededSecrets(SEED))
    for mod in (jax_iam, port_iam):
        monkeypatch.setattr(mod, "time", _Clock)
    restart()
    return restart


def _normalise(data: bytes, ctype: str):
    if ctype == "application/json":
        return json.loads(data)
    if ctype == "application/xml" or data.startswith(b"<?xml"):
        for tag in _NORMALISED:
            data = re.sub(rb"<%s>[^<]*</%s>" % (tag.encode(), tag.encode()),
                          b"<%s>*</%s>" % (tag.encode(), tag.encode()),
                          data)
        return data
    return hashlib.sha256(data).hexdigest()


class Recorder:
    """Sends the script's requests to one server, signed with that
    package's own SigV4 and SigV2 modules as one of the named
    identities, and records what the comparison reads of each
    response."""

    def __init__(self, pkg, srv):
        self.pkg, self.srv = pkg, srv
        self.ids = {"root": (pkg.sigv4.Credentials(ACCESS, SECRET), "")}
        self.records = []

    def login(self, name, ak, sk, token=""):
        self.ids[name] = (self.pkg.sigv4.Credentials(ak, sk), token)

    def __call__(self, method, path, query=None, headers=None, body=b"",
                 who="root", auth="v4", label=None):
        creds, token = self.ids.get(who, (None, ""))
        q = {k: [v] for k, v in (query or {}).items()}
        headers = dict(headers or {})
        headers["Host"] = f"{self.srv.host}:{self.srv.port}"
        if token and auth != "v2-presigned":
            headers["x-amz-security-token"] = token
        if auth == "v4":
            headers.update(self.pkg.sigv4.sign_request(
                creds, method, path, q, headers, body))
        elif auth == "v2":
            headers = self.pkg.sigv2.sign_header_v2(creds, method, path, q,
                                                    headers)
        elif auth == "v2-presigned":
            if token:
                q["X-Amz-Security-Token"] = [token]
            q = self.pkg.sigv2.presign_v2(creds, method, path, query=q)
        qs = urllib.parse.urlencode({k: v[0] for k, v in q.items()})
        url = urllib.parse.quote(path, safe="/~-._") + (f"?{qs}" if qs
                                                        else "")
        conn = http.client.HTTPConnection(self.srv.host, self.srv.port,
                                          timeout=TIMEOUT)
        try:
            try:
                conn.request(method, url, body=body, headers=headers)
            except (BrokenPipeError, ConnectionResetError):
                pass
            resp = conn.getresponse()
            st_, h, data = resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()
        code = b""
        if st_ >= 400 and data.startswith(b"<?xml"):
            code = re.search(rb"<Code>([^<]*)</Code>", data).group(1)
        self.records.append({
            "request": (method, label or path, sorted(query or {}), who,
                        auth),
            "status": st_, "code": code,
            "headers": {k: h.get(k) for k in _COMPARED},
            "body": _normalise(data, h.get("Content-Type", "")),
        })
        return st_, h, data


#: Requests the port answers differently from the JAX server, each with
#: the check both answers must pass.  A POST-policy file whose last
#: bytes are CR LF: the JAX package's form parser strips every CR and
#: LF at both ends of a part, so it stores the file short; the port
#: strips only the CRLF that frames the part.
_DIVERGES = {
    "post:crlf-tail": lambda j, p: (j["status"], p["status"]) == (204, 204),
    "/pbk/up/crlf#get": lambda j, p: (
        (j["status"], p["status"]) == (200, 200)
        and int(p["headers"]["Content-Length"])
        == int(j["headers"]["Content-Length"]) + 2),
}


def _creds_of(data: bytes) -> tuple[str, str, str]:
    return tuple(re.search(rb"<%s>([^<]*)</%s>" % (t, t), data).group(1)
                 .decode() for t in (b"AccessKeyId", b"SecretAccessKey",
                                     b"SessionToken"))


def _form_body(fields: dict, data: bytes, boundary: str) -> bytes:
    parts = [f'Content-Disposition: form-data; name="{k}"\r\n\r\n{v}'
             .encode() for k, v in fields.items()]
    parts.append(b'Content-Disposition: form-data; name="file"; '
                 b'filename="f.bin"\r\n\r\n' + data)
    delim = f"--{boundary}".encode()
    return (b"".join(delim + b"\r\n" + p + b"\r\n" for p in parts)
            + delim + b"--\r\n")


POSTPOLICY = {"jax": jax_postpolicy, "port": port_postpolicy}


def _range_form(creds, now, lo: int, hi: int) -> dict[str, str]:
    """Signed form fields of a POST policy that holds the file to
    [lo, hi] bytes under the key prefix up/ (one client for both
    servers)."""
    return port_postpolicy.sign_post_policy(
        creds, "pbk", [["starts-with", "$key", "up/"],
                       ["content-length-range", lo, hi]], now=now)


def script(do, pkg, seed: int) -> None:
    """Every handler of the identity slice and its errors."""
    rng = np.random.default_rng(seed)

    def body(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def admin(method, endpoint, doc=None, query=None, who="root"):
        return do(method, f"/minio/admin/v3/{endpoint}", query=query,
                  body=json.dumps(doc).encode() if doc is not None else b"",
                  who=who)

    do("PUT", "/pbk")
    do("PUT", "/obk")
    # -- admin: policies, users, groups, service accounts -------------------
    scoped = {"Version": "2012-10-17", "Statement": [
        {"Effect": "Allow", "Action": ["s3:PutObject", "s3:GetObject"],
         "Resource": ["arn:aws:s3:::pbk/team/*"]},
        {"Effect": "Allow", "Action": "s3:ListBucket",
         "Resource": "arn:aws:s3:::pbk",
         "Condition": {"StringLike": {"s3:prefix": ["team/*"]}}}]}
    admin("POST", "policies", {"name": "scoped", "policy": scoped})
    admin("POST", "policies", {"name": "bad", "policy": {"Statement": [
        {"Effect": "Maybe", "Action": "s3:*"}]}})       # InvalidArgument
    admin("GET", "policies")
    admin("GET", "policies", query={"name": "scoped"})
    admin("GET", "policies", query={"name": "nosuch"})  # 404
    admin("DELETE", "policies", query={"name": "readonly"})   # 409
    users = {"alice": ["readwrite"], "bob": ["readonly"],
             "carol": ["scoped"]}
    secrets_ = {}
    for name, pols in users.items():
        secrets_[name] = f"{name}-{body(6).hex()}"
        admin("POST", "users", {"accessKey": name,
                                "secretKey": secrets_[name],
                                "policies": pols})
        do.login(name, name, secrets_[name])
    admin("POST", "users", {"accessKey": "dan"})          # no secretKey
    admin("POST", "users", {"accessKey": "x", "secretKey": "short"})
    admin("GET", "users")
    admin("GET", "users", who="bob")                       # AccessDenied
    do("GET", "/minio/admin/v3/users", auth="anonymous")   # AccessDenied
    admin("POST", "groups", {"name": "team", "members": ["bob", "carol"],
                             "policies": ["readonly"]})
    admin("GET", "groups")
    admin("GET", "groups", query={"name": "team"})
    admin("GET", "groups", query={"name": "nosuch"})       # 404
    admin("DELETE", "groups", query={"name": "team"})      # 409 not empty
    admin("POST", "groups", {"name": "team", "removeMembers": ["bob"]})
    admin("POST", "groups", {"name": "team", "setPolicies": ["scoped"]})
    admin("GET", "groups", query={"name": "team"})
    _, _, out = admin("POST", "service-accounts", {"parent": "alice"})
    svc = json.loads(out)
    do.login("svc", svc["accessKey"], svc["secretKey"])
    admin("POST", "service-accounts", {"parent": "nosuch"})  # 400
    admin("GET", "service-accounts")
    admin("GET", "service-accounts", query={"parent": "alice"})
    admin("PUT", "users", {})                              # MethodNotAllowed
    # -- SigV4 and SigV2 under identity policies ------------------------------
    small, mid = body(int(rng.integers(1000, 90_000))), \
        body(MIB + int(rng.integers(1, 100_000)))
    do("PUT", "/pbk/rw/v4", body=small, who="alice")
    do("PUT", "/pbk/rw/v2", body=mid, who="alice", auth="v2",
       headers={"Content-Type": "text/plain", "x-amz-meta-via": "v2"})
    do("GET", "/pbk/rw/v2", who="alice", auth="v2")
    do("GET", "/pbk/rw/v2", who="bob", auth="v2-presigned")
    do("HEAD", "/pbk/rw/v4", who="bob", auth="v2")
    do("PUT", "/pbk/rw/nope", body=mid, who="bob")          # AccessDenied
    do("PUT", "/pbk/rw/nope2", body=small, who="bob", auth="v2")
    do("GET", "/pbk", {"list-type": "2"}, who="bob", auth="v2")
    do("PUT", "/pbk/team/c1", body=small, who="carol")
    do("PUT", "/pbk/other/c1", body=small, who="carol")     # AccessDenied
    do("GET", "/pbk", {"list-type": "2", "prefix": "team/"}, who="carol")
    do("GET", "/pbk", {"list-type": "2", "prefix": "rw/"}, who="carol")
    do("PUT", "/pbk/svc/s1", body=small, who="svc", auth="v2")
    do("GET", "/pbk/svc/s1", who="svc")
    do("POST", "/pbk", {"delete": ""}, who="carol",
       body=b"<Delete><Object><Key>team/c1</Key></Object><Object><Key>"
            b"rw/v4</Key></Object></Delete>")
    do.login("mallory", "alice", "wrong-secret-1234")
    do("GET", "/pbk/rw/v4", who="mallory", auth="v2")   # SignatureDoesNot…
    do("GET", "/pbk/rw/v4", who="mallory", auth="v2-presigned")
    do.login("ghost", "nosuchuser", "nosuchuser-secret")
    do("GET", "/pbk/rw/v4", who="ghost", auth="v2")     # InvalidAccessKeyId
    # -- STS -------------------------------------------------------------------
    get_only = {"Statement": [{"Effect": "Allow", "Action": "s3:GetObject",
                               "Resource": "arn:aws:s3:::*"}]}
    form = urllib.parse.urlencode({
        "Action": "AssumeRole", "Version": "2011-06-15",
        "DurationSeconds": "1800", "Policy": json.dumps(get_only)}).encode()
    _, _, out = do("POST", "/", body=form, who="alice")
    do.login("sts", *_creds_of(out))
    do("GET", "/pbk/rw/v4", who="sts")
    do("GET", "/pbk/rw/v2", who="sts", auth="v2-presigned")
    do("PUT", "/pbk/rw/sts", body=small, who="sts")      # AccessDenied
    do("POST", "/", body=b"Action=AssumeRole&Version=2011-06-15",
       who="sts")                                        # no re-assume
    sts_creds = do.ids["sts"][0]
    do.login("sts-notoken", sts_creds.access_key, sts_creds.secret_key)
    do("GET", "/pbk/rw/v4", who="sts-notoken")           # InvalidAccessKeyId
    do("GET", "/pbk/rw/v4", who="sts-notoken", auth="v2-presigned")
    do("POST", "/", body=b"Action=AssumeRole&DurationSeconds=soon",
       who="alice")                                      # InvalidArgument
    do("POST", "/", body=b"Action=AssumeRole", auth="anonymous")
    do("POST", "/", body=b"Action=Frobnicate", who="alice")
    do("POST", "/", body=b"Action=AssumeRoleWithLDAPIdentity&LDAPUsername=a"
                         b"&LDAPPassword=b", auth="anonymous")
    do("POST", "/", body=b"Action=AssumeRoleWithCertificate",
       auth="anonymous")
    token = pkg.oidc.make_hs256_token(OIDC_SECRET, {
        "sub": "web-app", "aud": "mtpu", "policy": "readonly,scoped"})
    _, _, out = do("POST", "/", auth="anonymous", body=urllib.parse.urlencode(
        {"Action": "AssumeRoleWithWebIdentity",
         "WebIdentityToken": token}).encode())
    do.login("web", *_creds_of(out))
    do("GET", "/pbk/rw/v2", who="web")
    do("PUT", "/pbk/team/web", body=small, who="web")
    do("POST", "/", auth="anonymous", body=urllib.parse.urlencode(
        {"Action": "AssumeRoleWithClientGrants", "Token": token}).encode())
    do("POST", "/", auth="anonymous", body=urllib.parse.urlencode(
        {"Action": "AssumeRoleWithWebIdentity",
         "WebIdentityToken": token[:-4] + "AAAA"}).encode())
    do("POST", "/", auth="anonymous",
       body=b"Action=AssumeRoleWithWebIdentity")         # missing token
    # -- POST-policy uploads ----------------------------------------------------
    pp = POSTPOLICY[pkg.name]
    alice = do.ids["alice"][0]
    now = datetime.datetime.now(datetime.timezone.utc)
    fields = pp.make_post_form(alice, "pbk", "up/", now=now)
    boundary = "diffboundary" + body(4).hex()
    ctype = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
    upload = body(200_000)
    do("POST", "/pbk", auth="anonymous", headers=ctype,
       body=_form_body({"key": "up/${filename}", **fields}, upload,
                       boundary))
    do("GET", "/pbk/up/f.bin", who="alice")
    do("POST", "/pbk", auth="anonymous", headers=ctype,
       body=_form_body({"key": "down/x", **fields}, upload, boundary))
    do("POST", "/pbk", auth="anonymous", headers=ctype,
       body=_form_body({"key": "up/y", **fields, "x-amz-signature": "0" * 64},
                       upload, boundary))
    do("POST", "/pbk", auth="anonymous", headers=ctype,
       body=_form_body({"key": "up/z", **fields, "x-amz-meta-extra": "1"},
                       upload, boundary))
    old = pp.make_post_form(
        alice, "pbk", "up/", expires_s=60,
        now=now - datetime.timedelta(hours=1))
    do("POST", "/pbk", auth="anonymous", headers=ctype,
       body=_form_body({"key": "up/old", **old}, upload, boundary))
    bobs = pp.make_post_form(do.ids["bob"][0], "pbk", "up/", now=now)
    do("POST", "/pbk", auth="anonymous", headers=ctype,
       body=_form_body({"key": "up/bob", **bobs}, upload, boundary))
    do("POST", "/pbk", auth="anonymous", headers=ctype, label="post:crlf-tail",
       body=_form_body({"key": "up/crlf", **fields}, upload + b"\r\n",
                       boundary))
    do("GET", "/pbk/up/crlf", who="alice", label="/pbk/up/crlf#get")
    ranged = _range_form(alice, now, 1000, 150_000)
    do("POST", "/pbk", auth="anonymous", headers=ctype,
       body=_form_body({"key": "up/r1", **ranged}, upload[:150_000],
                       boundary))
    do("POST", "/pbk", auth="anonymous", headers=ctype,
       body=_form_body({"key": "up/r2", **ranged}, upload, boundary))
    do("POST", "/pbk", auth="anonymous", headers=ctype,
       body=_form_body({"key": "up/r3", **ranged}, upload[:999], boundary))
    # -- snowball and zip extract ----------------------------------------------
    tar = io.BytesIO()
    members = {}
    with tarfile.open(fileobj=tar, mode="w") as tf:
        for i in range(6):
            data = body(int(rng.integers(1, 200_000)))
            name = f"./m{i}" if i == 0 else f"dir/m{i}"
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
            members[name.lstrip("./")] = data
        esc = tarfile.TarInfo("../escape")
        esc.size = 1
        tf.addfile(esc, io.BytesIO(b"!"))
        d = tarfile.TarInfo("emptydir")
        d.type = tarfile.DIRTYPE
        tf.addfile(d)
    snow = {"x-amz-meta-snowball-auto-extract": "true"}
    do("PUT", "/obk/snow/batch.tar", headers=snow, body=tar.getvalue(),
       who="alice")
    for name in members:
        do("GET", f"/obk/snow/batch.tar/{name}", who="alice")
    do("GET", "/obk", {"list-type": "2", "prefix": "snow/"})
    do("PUT", "/obk/snow/bad.tar", headers=snow, body=b"not a tar",
       who="alice")                                      # MalformedXML
    do("PUT", "/obk/snow/ro.tar", headers=snow, body=tar.getvalue(),
       who="bob")                                        # AccessDenied
    zb = io.BytesIO()
    with zipfile.ZipFile(zb, "w", zipfile.ZIP_STORED) as zf:
        for i in range(4):
            zf.writestr(zipfile.ZipInfo(f"in/z{i}.bin",
                                        date_time=(2026, 1, 2, 3, 4, 6)),
                        body(int(rng.integers(1, 50_000))))
    do("PUT", "/obk/arc.zip", body=zb.getvalue(), who="alice")
    zx = {"x-minio-extract": "true"}
    do("GET", "/obk/arc.zip/in/z2.bin", headers=zx, who="bob")
    do("HEAD", "/obk/arc.zip/in/z3.bin", headers=zx, who="bob")
    do("GET", "/obk/arc.zip/in/nosuch", headers=zx, who="bob")  # NoSuchKey
    do("GET", "/obk/rw.zip/x", headers=zx, who="bob")          # NoSuchKey
    do("PUT", "/obk/fake.zip", body=small, who="alice")
    do("GET", "/obk/fake.zip/x", headers=zx, who="bob")    # InvalidRequest
    do("GET", "/obk/arc.zip/in/z1.bin", who="bob")         # no header
    # -- bucket policies and anonymous requests --------------------------------
    do("GET", "/pbk", {"policy": ""})                      # NoSuchBucketPolicy
    do("PUT", "/pbk", {"policy": ""}, body=b"{not json")   # MalformedXML
    public = {"Version": "2012-10-17", "Statement": [
        {"Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
         "Resource": "arn:aws:s3:::pbk/public/*"},
        {"Effect": "Allow", "Principal": {"AWS": ["*"]},
         "Action": "s3:DeleteObject",
         "Resource": ["arn:aws:s3:::pbk", "arn:aws:s3:::pbk/public/tmp*"]},
        {"Effect": "Allow", "Principal": "*", "Action": "s3:ListBucket",
         "Resource": "arn:aws:s3:::pbk",
         "Condition": {"StringLike": {"s3:prefix": "public/*"}}}]}
    do("PUT", "/pbk", {"policy": ""}, body=json.dumps(public).encode())
    do("PUT", "/pbk", {"policy": ""}, who="bob",
       body=json.dumps(public).encode())                   # AccessDenied
    do("GET", "/pbk", {"policy": ""})
    do("PUT", "/pbk/public/a", body=mid)
    do("PUT", "/pbk/public/tmp1", body=small)
    do("GET", "/pbk/public/a", auth="anonymous")
    do("HEAD", "/pbk/public/a", auth="anonymous")
    do("GET", "/pbk/rw/v4", auth="anonymous")              # AccessDenied
    do("PUT", "/pbk/public/b", body=small, auth="anonymous")
    do("GET", "/pbk", {"list-type": "2", "prefix": "public/"},
       auth="anonymous")
    do("GET", "/pbk", {"list-type": "2"}, auth="anonymous")
    do("POST", "/pbk", {"delete": ""}, auth="anonymous",
       body=b"<Delete><Object><Key>public/tmp1</Key></Object><Object><Key>"
            b"public/a</Key></Object></Delete>")
    do("GET", "/", auth="anonymous")
    do("GET", "/obk/arc.zip", auth="anonymous")
    do("DELETE", "/pbk", {"policy": ""})
    do("GET", "/pbk/public/a", auth="anonymous")           # AccessDenied
    do("GET", "/pbk", {"policy": ""})
    # -- cleanup through the admin API -------------------------------------------
    admin("DELETE", "service-accounts", query={"accessKey":
                                               svc["accessKey"]})
    do("GET", "/pbk/rw/v4", who="svc")                  # InvalidAccessKeyId
    admin("DELETE", "users", query={"accessKey": "carol"})
    admin("POST", "groups", {"name": "team", "removeMembers": ["carol"]})
    admin("DELETE", "groups", query={"name": "team"})
    admin("DELETE", "policies", query={"name": "scoped"})
    admin("GET", "users")
    admin("GET", "groups")


def _serve(pkg, pools):
    iam = pkg.iam.IAMSys(pools)
    oidc = pkg.oidc.OpenIDConfig(hs256_secret=OIDC_SECRET, audience="mtpu")
    return pkg.S3Server(pools, pkg.sigv4.Credentials(ACCESS, SECRET),
                        iam=iam, oidc=oidc).start()


def test_request_script_matches_jax(tmp_path, pinned):
    records = {}
    for pkg, make in ((JAX_AUTH, _jax_pools), (PORT_AUTH, _port_pools)):
        pinned()
        pools = make(tmp_path / pkg.name, "d")
        srv = _serve(pkg, pools)
        try:
            rec = Recorder(pkg, srv)
            script(rec, pkg, SEED)
            records[pkg.name] = rec.records
        finally:
            srv.shutdown()
            close_pools(pools)
    jax_recs, port_recs = records["jax"], records["port"]
    assert len(jax_recs) == len(port_recs) >= 100
    codes = {r["code"] for r in jax_recs}
    for code in (b"AccessDenied", b"InvalidAccessKeyId",
                 b"SignatureDoesNotMatch", b"InvalidArgument",
                 b"NotImplemented", b"MalformedXML", b"EntityTooLarge",
                 b"NoSuchBucketPolicy", b"NoSuchKey", b"InvalidRequest",
                 b"MethodNotAllowed"):
        assert code in codes, code
    statuses = {r["status"] for r in jax_recs}
    assert {200, 204, 400, 403, 404, 405, 409, 501} <= statuses
    for j, p in zip(jax_recs, port_recs):
        label = j["request"][1]
        if label in _DIVERGES:
            assert _DIVERGES[label](j, p), (j, p)
            continue
        assert p == j, j["request"]


# -- IAM state across packages ---------------------------------------------------

def _write_iam(pkg, pools, meta):
    iam = pkg.iam.IAMSys(pools)
    iam.set_policy("scoped", {"Statement": [{
        "Effect": "Allow", "Action": "s3:GetObject",
        "Resource": "arn:aws:s3:::x/pre/*"}]})
    for i in range(12):
        iam.add_user(f"user{i:02d}", f"user{i:02d}-secret",
                     [("readonly", "readwrite", "scoped")[i % 3]])
    iam.add_group("g1", [f"user{i:02d}" for i in range(0, 12, 2)],
                  ["writeonly"])
    iam.add_group("g2", ["user01"], None)
    iam.set_user_status("user11", "disabled")
    svc = iam.add_service_account("user00", access_key="svc-fixed-key1",
                                  secret_key="svc-fixed-secret1")
    iam.remove_user("user10")
    meta.put("x", "policy", json.dumps({"Statement": [{
        "Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
        "Resource": "arn:aws:s3:::x/*"}]}).encode())
    return svc


def _iam_view(pkg, pools):
    iam = pkg.iam.IAMSys(pools)
    users = {ak: (u.secret_key, u.kind, u.status, u.parent,
                  sorted(u.policies), sorted(u.groups))
             for ak, u in iam._users.items()}
    verdicts = []
    for ak in sorted(users):
        ident = iam.lookup(ak)
        for action, res in (("s3:GetObject", "x/pre/k"),
                            ("s3:PutObject", "b/k"),
                            ("s3:GetObject", "y/k")):
            verdicts.append(ident is not None
                            and iam.is_allowed(ident, action, res))
    return (users, {g: iam.group_info(g) for g in iam.list_groups()},
            {p: iam.get_policy_doc(p) for p in iam.list_policies()},
            iam.list_service_accounts(), verdicts)


@pytest.mark.parametrize("writer,reader", [(PORT_AUTH, JAX_AUTH),
                                           (JAX_AUTH, PORT_AUTH)],
                         ids=["port-to-jax", "jax-to-port"])
def test_iam_state_cross_packages(tmp_path, writer, reader):
    import minio_tpu.bucket.metadata as jax_meta
    import minio_tpu_torch.bucket.metadata as port_meta
    makers = {"jax": _jax_pools, "port": _port_pools}
    metas = {"jax": jax_meta.BucketMetadataSys,
             "port": port_meta.BucketMetadataSys}
    pools = makers[writer.name](tmp_path, "d")
    try:
        pools.make_bucket("x")
        _write_iam(writer, pools, metas[writer.name](pools))
        want = _iam_view(writer, pools)
    finally:
        close_pools(pools)
    pools = makers[reader.name](tmp_path, "d")
    try:
        got = _iam_view(reader, pools)
        policy = metas[reader.name](pools).get("x", "policy")
    finally:
        close_pools(pools)
    assert got == want
    assert len(want[0]) == 12 and "user10" not in want[0]
    assert reader.policy.Policy(policy.decode()).is_allowed(
        "s3:GetObject", "x/k", principal="*")


# -- the strings and bytes of the copied modules ---------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sigv2_strings_match_jax(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    secret = rng.bytes(10).hex()
    creds = [m.Credentials(f"ak{seed}", secret)
             for m in (jax_sigv4, port_sigv4)]
    path = f"/b{seed}/key with space/ü{seed}"
    query = {"uploadId": [str(rng.integers(0, 1000))], "x-id": ["skip"],
             "versioning": [""], "partNumber": ["3"]}
    headers = {"Content-Type": "text/plain", "Content-MD5": "abc==",
               "x-amz-meta-b": f" v{seed} ", "X-Amz-Meta-A": "1",
               "x-amz-meta-b ": "2",
               "Date": "Tue, 27 Mar 2007 19:36:42 +0000"}
    for method in ("GET", "PUT", "POST"):
        assert port_sigv2.string_to_sign(method, path, query, headers,
                                         headers["Date"]) == \
            jax_sigv2.string_to_sign(method, path, query, headers,
                                     headers["Date"])
        assert port_sigv2.sign_header_v2(creds[1], method, path, query,
                                         headers) == \
            jax_sigv2.sign_header_v2(creds[0], method, path, query, headers)
    for mod in (jax_sigv2, port_sigv2):
        monkeypatch.setattr(mod, "time", _Clock)
    assert port_sigv2.presign_v2(creds[1], "GET", path, 900, query) == \
        jax_sigv2.presign_v2(creds[0], "GET", path, 900, query)
    # the port's verifiers accept what the JAX signer made
    lookup = (lambda ak: creds[1] if ak == creds[1].access_key else None)
    signed = jax_sigv2.sign_header_v2(creds[0], "PUT", path, query, headers)
    assert port_sigv2.verify_header_v2(lookup, "PUT", path, query,
                                       signed) == creds[1].access_key
    q = jax_sigv2.presign_v2(creds[0], "GET", path, 900, query)
    assert port_sigv2.verify_presigned_v2(lookup, "GET", path, q, {},
                                          now=CLOCK) == creds[1].access_key


def _outcome(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except (jax_api_errors.S3Error, port_api_errors.S3Error) as e:
        return ("error", e.api.code)
    except (jax_oidc.OIDCError, port_oidc.OIDCError) as e:
        return ("error", str(e))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_post_policy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    now = datetime.datetime(2026, 5, 1, 12, int(rng.integers(0, 60)),
                            tzinfo=datetime.timezone.utc)
    secret = rng.bytes(9).hex()
    creds = [m.Credentials(f"post{seed}", secret)
             for m in (jax_sigv4, port_sigv4)]
    forms = [m.make_post_form(c, f"bk{seed}", f"p{seed}/", expires_s=600,
                              now=now)
             for m, c in ((jax_postpolicy, creds[0]),
                          (port_postpolicy, creds[1]))]
    assert forms[1] == forms[0]
    size = int(rng.integers(0, 5000))
    cases = []
    for key, extra, at in ((f"p{seed}/k", {}, now),
                           (f"q{seed}/k", {}, now),
                           (f"p{seed}/k", {"x-amz-meta-x": "1"}, now),
                           (f"p{seed}/k", {}, now + datetime.timedelta(
                               seconds=601))):
        fields = {k: (v.encode(), "") for k, v in
                  {**forms[0], "key": key, **extra}.items()}
        cases.append((fields, at))
    for fields, at in cases:
        assert _outcome(port_postpolicy.check_post_policy,
                        fields["policy"][0], fields, size,
                        bucket=f"bk{seed}", now=at) == \
            _outcome(jax_postpolicy.check_post_policy,
                     fields["policy"][0], fields, size,
                     bucket=f"bk{seed}", now=at)
    lookup = [lambda ak, c=c: c if ak == c.access_key else None
              for c in creds]
    fields = {k: (v.encode(), "") for k, v in forms[0].items()}
    assert _outcome(port_postpolicy.verify_post_signature, lookup[1],
                    fields) == _outcome(jax_postpolicy.verify_post_signature,
                                        lookup[0], fields)
    # a content-length-range policy, over and under its range
    doc = {"expiration": "2030-01-01T00:00:00.000Z", "conditions": [
        ["content-length-range", 10, 100 + seed], {"bucket": "b"}]}
    pol_b64 = base64.b64encode(json.dumps(doc).encode())
    for n in (5, 10, 100 + seed, 101 + seed):
        assert _outcome(port_postpolicy.check_post_policy, pol_b64, {}, n,
                        bucket="b", now=now) == \
            _outcome(jax_postpolicy.check_post_policy, pol_b64, {}, n,
                     bucket="b", now=now)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oidc_tokens_match_jax(seed):
    rng = np.random.default_rng(seed)
    secret = rng.bytes(16)
    claims = {"sub": f"s{seed}", "aud": ["mtpu", "x"][seed % 2],
              "policy": "readonly, scoped", "exp": CLOCK + 100 * seed,
              "nbf": CLOCK - 10}
    tokens = [m.make_hs256_token(secret, claims)
              for m in (jax_oidc, port_oidc)]
    assert tokens[1] == tokens[0]
    cfgs = [m.OpenIDConfig(hs256_secret=secret, audience="mtpu")
            for m in (jax_oidc, port_oidc)]
    for token in (tokens[0], tokens[0][:-2] + "xx", "a.b", "x.y.z"):
        for now in (CLOCK, CLOCK + 100 * seed + 1, CLOCK - 20):
            j = _outcome(cfgs[0].validate, token, now=now)
            assert _outcome(cfgs[1].validate, token, now=now) == j
            if j[0] == "ok":
                assert cfgs[1].policies_from(j[1]) == \
                    cfgs[0].policies_from(j[1]) == ["readonly", "scoped"]


@pytest.mark.parametrize("seed", [0, 1])
def test_ldap_ber_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 127, 128, 255, 256, 65535, 65536,
              int(rng.integers(0, 1 << 24))):
        assert port_ldap.ber_len(n) == jax_ldap.ber_len(n)
    for v in (0, 1, 127, 128, 255, 256, int(rng.integers(0, 1 << 31))):
        for tag in (0x02, 0x0A):
            assert port_ldap.ber_int(v, tag) == jax_ldap.ber_int(v, tag)
    for s in ("", "cn=lookup,dc=corp", "ü" * int(rng.integers(1, 200))):
        assert port_ldap.ber_str(s) == jax_ldap.ber_str(s)
    content = rng.bytes(int(rng.integers(0, 400)))
    msg = jax_ldap.ber(0x30, jax_ldap.ber_int(7) + jax_ldap.ber(
        jax_ldap.BIND_REQ, jax_ldap.ber_int(3) + jax_ldap.ber_str("dn")
        + jax_ldap.ber(0x80, content)))
    assert port_ldap.ber(0x30, port_ldap.ber_int(7) + port_ldap.ber(
        port_ldap.BIND_REQ, port_ldap.ber_int(3) + port_ldap.ber_str("dn")
        + port_ldap.ber(0x80, content))) == msg
    assert port_ldap.ber_parse(msg) == jax_ldap.ber_parse(msg)
    body = jax_ldap.ber_parse(msg)[1]
    assert port_ldap.ber_children(body) == jax_ldap.ber_children(body)


# -- the policy engine, drawn ----------------------------------------------------

_ACTIONS = ("s3:*", "s3:Get*", "s3:GetObject", "s3:PutObject",
            "s3:ListBucket", "s3:Delete*", "s3:?etObject")
_RESOURCES = ("arn:aws:s3:::*", "arn:aws:s3:::b", "arn:aws:s3:::b/*",
              "arn:aws:s3:::b/p?/*", "b/pub/*", "*")
_CONDITIONS = st.one_of(
    st.fixed_dictionaries({"StringLike": st.fixed_dictionaries(
        {"s3:prefix": st.lists(st.sampled_from(("pub/*", "a*", "x")),
                               min_size=1, max_size=2)})}),
    st.fixed_dictionaries({"StringNotEquals": st.fixed_dictionaries(
        {"s3:prefix": st.sampled_from(("pub/", ""))})}),
    st.fixed_dictionaries({"IpAddress": st.fixed_dictionaries(
        {"aws:SourceIp": st.sampled_from(("10.0.0.0/8", "10.1.2.3/32"))})}),
    st.fixed_dictionaries({"NumericLessThanIfExists": st.fixed_dictionaries(
        {"s3:max-keys": st.sampled_from(("10", "1000"))})}),
    st.fixed_dictionaries({"Bool": st.fixed_dictionaries(
        {"aws:SecureTransport": st.sampled_from(("true", "false"))})}),
    st.fixed_dictionaries({"Null": st.fixed_dictionaries(
        {"s3:prefix": st.sampled_from(("true", "false"))})}))


@st.composite
def _statement(draw):
    s = {"Effect": draw(st.sampled_from(("Allow", "Deny"))),
         draw(st.sampled_from(("Action", "NotAction"))):
         draw(st.lists(st.sampled_from(_ACTIONS), min_size=1, max_size=3)),
         "Resource": draw(st.lists(st.sampled_from(_RESOURCES),
                                   min_size=1, max_size=2))}
    principal = draw(st.sampled_from((None, "*", {"AWS": "*"},
                                      {"AWS": ["alice"]})))
    if principal is not None:
        s["Principal"] = principal
    if draw(st.booleans()):
        s["Condition"] = draw(_CONDITIONS)
    return s


_CTX = st.fixed_dictionaries({}, optional={
    "s3:prefix": st.sampled_from(("pub/x", "a1", "", "x")),
    "aws:SourceIp": st.sampled_from(("10.1.2.3", "192.168.0.1")),
    "s3:max-keys": st.sampled_from(("5", "500", "5000")),
    "aws:SecureTransport": st.sampled_from(("true", "false"))})


def _verdicts(mod, docs, requests):
    try:
        pols = [mod.Policy(d) for d in docs]
    except mod.PolicyError:
        return "PolicyError"
    return ([[p.is_allowed(a, r, ctx, principal=who) for p in pols]
             for a, r, ctx, who in requests],
            [mod.merge_allowed(pols, a, r, ctx) for a, r, ctx, _ in requests])


@settings(max_examples=150, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(docs=st.lists(st.lists(_statement(), min_size=1, max_size=3)
                     .map(lambda ss: {"Statement": ss}),
                     min_size=1, max_size=3),
       requests=st.lists(st.tuples(
           st.sampled_from(("s3:GetObject", "s3:PutObject", "s3:ListBucket",
                            "s3:DeleteObject", "s3:GetBucketPolicy")),
           st.sampled_from(("b", "b/k", "b/pub/x", "b/pq/z", "c/k")),
           _CTX, st.sampled_from((None, "*", "alice"))),
           min_size=1, max_size=6))
def test_policy_verdicts_match_jax(docs, requests):
    assert _verdicts(port_policy, docs, requests) == \
        _verdicts(jax_policy, docs, requests)
