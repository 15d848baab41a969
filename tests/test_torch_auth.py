"""The front door's identity planes, run against the JAX package's server
and the port's (device="cpu"): the tests of tests/test_sigv2_sts.py,
tests/test_iam.py and the TestLDAPSTS and TestCertificateSTS classes of
tests/test_sts_ldap_kes.py, each parametrised by package as
tests/test_torch_server.py runs its probes.  SigV2 header and presigned
auth, STS (AssumeRole, ClientGrants, LDAPIdentity, Certificate over
mTLS), IAM users, groups, service accounts and policies, identity policy
enforcement, multi-delete per-key authorization and the policy engine's
evaluator."""

import http.client
import re
import ssl
import urllib.parse
from types import SimpleNamespace

import pytest

import minio_tpu.iam.iam as jax_iam
import minio_tpu.iam.ldap as jax_ldap
import minio_tpu.iam.oidc as jax_oidc
import minio_tpu.iam.policy as jax_policy
import minio_tpu.server.sigv2 as jax_sigv2
import minio_tpu_torch.iam.iam as port_iam
import minio_tpu_torch.iam.ldap as port_ldap
import minio_tpu_torch.iam.oidc as port_oidc
import minio_tpu_torch.iam.policy as port_policy
import minio_tpu_torch.server.sigv2 as port_sigv2
import test_sts_ldap_kes as jax_sts_tests
from test_sts_ldap_kes import READONLY, FakeLDAP
from test_torch_server import JAX, PORT, close_pools

JAX_AUTH = SimpleNamespace(**vars(JAX), iam=jax_iam, ldap=jax_ldap,
                           oidc=jax_oidc, policy=jax_policy,
                           sigv2=jax_sigv2)
PORT_AUTH = SimpleNamespace(**vars(PORT), iam=port_iam, ldap=port_ldap,
                            oidc=port_oidc, policy=port_policy,
                            sigv2=port_sigv2)

V2_ROOT, V2_SECRET = "v2admin", "v2admin-secret1"
ROOT, ROOT_SECRET = "rootadmin", "rootadmin-secret"
STS_ROOT, STS_SECRET = "stsadmin", "stsadmin-secret"


@pytest.fixture(params=[JAX_AUTH, PORT_AUTH], ids=lambda p: p.name)
def pkg(request):
    return request.param


@pytest.fixture()
def pol(pkg):
    return pkg.policy


def _stack(pkg, tmp_path, root, secret, **srv_kw):
    pools = pkg.pools(tmp_path, "d")
    iam = pkg.iam.IAMSys(pools)
    srv = pkg.S3Server(pools, pkg.sigv4.Credentials(root, secret), iam=iam,
                       **srv_kw).start()
    return srv, iam, pools


@pytest.fixture()
def v2stack(pkg, tmp_path):
    """The server of tests/test_sigv2_sts.py: IAM and an HS256 OIDC."""
    oidc = pkg.oidc.OpenIDConfig(hs256_secret=b"sts-secret",
                                 audience="mtpu")
    srv, _, pools = _stack(pkg, tmp_path, V2_ROOT, V2_SECRET, oidc=oidc)
    yield srv, pkg.S3Client(srv.endpoint, V2_ROOT, V2_SECRET,
                            **pkg.client_kw)
    srv.shutdown()
    close_pools(pools)


@pytest.fixture()
def stack(pkg, tmp_path):
    """The server of tests/test_iam.py."""
    srv, iam, pools = _stack(pkg, tmp_path, ROOT, ROOT_SECRET)
    yield srv, iam, pkg.S3Client(srv.endpoint, ROOT, ROOT_SECRET,
                                 **pkg.client_kw)
    srv.shutdown()
    close_pools(pools)


def _client(pkg, srv, ak, sk):
    return pkg.S3Client(srv.endpoint, ak, sk, **pkg.client_kw)


# -- tests/test_sigv2_sts.py -----------------------------------------------------

def _v2_request(pkg, srv, creds, method, path, query=None, body=b"",
                headers=None, presigned=False):
    headers = dict(headers or {})
    q = {k: [v] for k, v in (query or {}).items()}
    wire_path = urllib.parse.quote(path, safe="/~-._")
    if presigned:
        q = pkg.sigv2.presign_v2(creds, method, path, query=q)
        url = wire_path + "?" + urllib.parse.urlencode(
            {k: v[0] for k, v in q.items()})
    else:
        headers = pkg.sigv2.sign_header_v2(creds, method, path, q, headers)
        qs = urllib.parse.urlencode({k: v[0] for k, v in q.items()})
        url = wire_path + ("?" + qs if qs else "")
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
    try:
        conn.request(method, url, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class TestSigV2:
    def test_header_signed_roundtrip(self, pkg, v2stack):
        srv, cli = v2stack
        cli.make_bucket("v2b")
        creds = pkg.sigv4.Credentials(V2_ROOT, V2_SECRET)
        st, out = _v2_request(pkg, srv, creds, "PUT", "/v2b/obj",
                              body=b"v2 signed",
                              headers={"Content-Type": "text/plain",
                                       "x-amz-meta-via": "v2"})
        assert st == 200, out
        st, out = _v2_request(pkg, srv, creds, "GET", "/v2b/obj")
        assert st == 200 and out == b"v2 signed"
        assert cli.head_object("v2b", "obj").get("x-amz-meta-via") == "v2"

    def test_wrong_secret_rejected(self, pkg, v2stack):
        srv, cli = v2stack
        cli.make_bucket("v2c")
        bad = pkg.sigv4.Credentials(V2_ROOT, "wrong-secret-123")
        st, out = _v2_request(pkg, srv, bad, "GET", "/v2c")
        assert st == 403 and b"SignatureDoesNotMatch" in out

    def test_tampered_amz_header_rejected(self, pkg, v2stack):
        srv, cli = v2stack
        cli.make_bucket("v2d")
        creds = pkg.sigv4.Credentials(V2_ROOT, V2_SECRET)
        headers = pkg.sigv2.sign_header_v2(creds, "PUT", "/v2d/k",
                                           {}, {"x-amz-meta-a": "1"})
        headers["x-amz-meta-a"] = "2"        # tamper after signing
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        conn.request("PUT", "/v2d/k", body=b"x", headers=headers)
        resp = conn.getresponse()
        out = resp.read()
        conn.close()
        assert resp.status == 403, out

    def test_presigned_get(self, pkg, v2stack):
        srv, cli = v2stack
        cli.make_bucket("v2e")
        cli.put_object("v2e", "pre", b"presigned v2")
        creds = pkg.sigv4.Credentials(V2_ROOT, V2_SECRET)
        st, out = _v2_request(pkg, srv, creds, "GET", "/v2e/pre",
                              presigned=True)
        assert st == 200 and out == b"presigned v2"

    def test_presigned_expired(self, pkg, v2stack):
        srv, cli = v2stack
        cli.make_bucket("v2f")
        cli.put_object("v2f", "pre", b"x")
        creds = pkg.sigv4.Credentials(V2_ROOT, V2_SECRET)
        q = pkg.sigv2.presign_v2(creds, "GET", "/v2f/pre", expires_in=-10)
        url = "/v2f/pre?" + urllib.parse.urlencode(
            {k: v[0] for k, v in q.items()})
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        conn.request("GET", url)
        resp = conn.getresponse()
        out = resp.read()
        conn.close()
        assert resp.status == 403, out

    def test_subresource_in_signature(self, pkg, v2stack):
        srv, cli = v2stack
        cli.make_bucket("v2g")
        creds = pkg.sigv4.Credentials(V2_ROOT, V2_SECRET)
        st, out = _v2_request(pkg, srv, creds, "POST", "/v2g/mp",
                              query={"uploads": ""})
        assert st == 200, out
        uid = re.search(rb"<UploadId>([^<]+)</UploadId>", out).group(1)
        assert uid


class TestClientGrants:
    def test_assume_role_with_client_grants(self, pkg, v2stack):
        srv, cli = v2stack
        cli.make_bucket("cgb")
        cli.put_object("cgb", "k", b"cg data")
        token = pkg.oidc.make_hs256_token(
            b"sts-secret",
            {"iss": "test-idp", "aud": "mtpu", "sub": "cg-app",
             "policy": "readonly"})
        body = urllib.parse.urlencode({
            "Action": "AssumeRoleWithClientGrants",
            "Version": "2011-06-15", "Token": token}).encode()
        st, _, data = cli.request("POST", "/", body=body)
        assert st == 200, data
        txt = data.decode()
        assert "<AssumeRoleWithClientGrantsResponse" in txt
        ak = re.search(r"<AccessKeyId>([^<]+)", txt).group(1)
        sk = re.search(r"<SecretAccessKey>([^<]+)", txt).group(1)
        tok = re.search(r"<SessionToken>([^<]+)", txt).group(1)
        sts_cli = _client(pkg, srv, ak, sk)
        st, _, out = sts_cli.request(
            "GET", "/cgb/k", headers={"x-amz-security-token": tok})
        assert st == 200 and out == b"cg data"
        st, _, _ = sts_cli.request(
            "PUT", "/cgb/new", body=b"x",
            headers={"x-amz-security-token": tok})
        assert st == 403

    def test_bad_token_rejected(self, v2stack):
        srv, cli = v2stack
        body = urllib.parse.urlencode({
            "Action": "AssumeRoleWithClientGrants",
            "Version": "2011-06-15", "Token": "garbage.token.here"}
        ).encode()
        st, _, data = cli.request("POST", "/", body=body)
        assert st == 403, data


class TestV2StsToken:
    def test_v2_presigned_sts_requires_token(self, pkg, v2stack):
        srv, cli = v2stack
        cli.make_bucket("v2sts")
        cli.put_object("v2sts", "k", b"x")
        srv.iam.add_user("parent2", "parent2-secret1", ["readwrite"])
        ident = srv.iam.assume_role(srv.iam.lookup("parent2"), 3600)
        creds = pkg.sigv4.Credentials(ident.access_key, ident.secret_key)
        st, out = _v2_request(pkg, srv, creds, "GET", "/v2sts/k",
                              presigned=True)
        assert st == 403, out           # token missing -> rejected


class TestV2Encoding:
    def test_key_with_spaces_and_unicode(self, pkg, v2stack):
        srv, cli = v2stack
        cli.make_bucket("v2enc")
        creds = pkg.sigv4.Credentials(V2_ROOT, V2_SECRET)
        for key in ("a b.txt", "sp+plus", "uni-éé.bin"):
            st, out = _v2_request(pkg, srv, creds, "PUT", f"/v2enc/{key}",
                                  body=b"enc")
            assert st == 200, (key, out)
            st, out = _v2_request(pkg, srv, creds, "GET", f"/v2enc/{key}")
            assert st == 200 and out == b"enc", key


# -- tests/test_iam.py -----------------------------------------------------------

class TestPolicyEval:
    def test_wildcard_allow(self, pol):
        p = pol.Policy({"Statement": [{"Effect": "Allow",
                                       "Action": "s3:Get*",
                                       "Resource": "arn:aws:s3:::bkt/*"}]})
        assert p.is_allowed("s3:GetObject", "bkt/a/b")
        assert not p.is_allowed("s3:PutObject", "bkt/a")
        assert not p.is_allowed("s3:GetObject", "other/a")

    def test_explicit_deny_wins(self, pol):
        p = pol.Policy({"Statement": [
            {"Effect": "Allow", "Action": "s3:*",
             "Resource": "arn:aws:s3:::*"},
            {"Effect": "Deny", "Action": "s3:DeleteObject",
             "Resource": "arn:aws:s3:::protected/*"}]})
        assert p.is_allowed("s3:DeleteObject", "open/x")
        assert not p.is_allowed("s3:DeleteObject", "protected/x")

    def test_condition_prefix(self, pol):
        p = pol.Policy({"Statement": [{
            "Effect": "Allow", "Action": "s3:ListBucket",
            "Resource": "arn:aws:s3:::bkt",
            "Condition": {"StringLike": {"s3:prefix": ["public/*"]}}}]})
        assert p.is_allowed("s3:ListBucket", "bkt",
                            {"s3:prefix": "public/x"})
        assert not p.is_allowed("s3:ListBucket", "bkt",
                                {"s3:prefix": "private/x"})

    def test_default_deny_and_merge(self, pol):
        assert not pol.READ_ONLY.is_allowed("s3:PutObject", "b/k")
        assert pol.merge_allowed([pol.READ_ONLY, pol.WRITE_ONLY],
                                 "s3:PutObject", "b/k")

    def test_bad_policy_rejected(self, pol):
        with pytest.raises(pol.PolicyError):
            pol.Policy({"Statement": [{"Effect": "Maybe", "Action": "x"}]})


class TestIAMSys:
    def test_user_lifecycle_and_persistence(self, pkg, stack):
        srv, iam, _ = stack
        iam.add_user("alice", "alice-secret-123", ["readwrite"])
        assert iam.lookup("alice") is not None
        iam2 = pkg.iam.IAMSys(srv.pools)
        ident = iam2.lookup("alice")
        assert ident is not None and ident.policies == ["readwrite"]
        iam.remove_user("alice")
        assert iam.lookup("alice") is None

    def test_group_policy_attachment(self, stack):
        _, iam, _ = stack
        iam.add_user("bob", "bob-secret-123")
        iam.add_group("readers", ["bob"], ["readonly"])
        ident = iam.lookup("bob")
        assert iam.is_allowed(ident, "s3:GetObject", "any/key")
        assert not iam.is_allowed(ident, "s3:PutObject", "any/key")

    def test_service_account_inherits(self, stack):
        _, iam, _ = stack
        iam.add_user("carol", "carol-secret-1", ["readwrite"])
        svc = iam.add_service_account("carol")
        ident = iam.lookup(svc.access_key)
        assert ident.kind == "service"
        assert iam.is_allowed(ident, "s3:PutObject", "b/k")

    def test_disabled_user_rejected(self, stack):
        _, iam, _ = stack
        iam.add_user("dave", "dave-secret-12", ["readwrite"])
        iam.set_user_status("dave", "disabled")
        assert iam.lookup("dave") is None


class TestEndToEndEnforcement:
    def test_readonly_user_cannot_write(self, pkg, stack):
        srv, iam, root_cli = stack
        root_cli.make_bucket("iam-bkt")
        root_cli.put_object("iam-bkt", "k", b"data")
        iam.add_user("reader", "reader-secret-1", ["readonly"])
        cli = _client(pkg, srv, "reader", "reader-secret-1")
        assert cli.get_object("iam-bkt", "k") == b"data"
        with pytest.raises(pkg.S3ClientError) as ei:
            cli.put_object("iam-bkt", "k2", b"nope")
        assert ei.value.code == "AccessDenied"

    def test_wrong_secret_rejected(self, pkg, stack):
        srv, iam, _ = stack
        iam.add_user("eve", "eve-secret-123", ["readwrite"])
        cli = _client(pkg, srv, "eve", "wrong-secret")
        with pytest.raises(pkg.S3ClientError) as ei:
            cli.list_buckets()
        assert ei.value.code == "SignatureDoesNotMatch"

    def test_custom_policy_scopes_bucket(self, pkg, stack):
        srv, iam, root_cli = stack
        root_cli.make_bucket("allowed")
        root_cli.make_bucket("forbidden")
        iam.set_policy("only-allowed", {
            "Statement": [{"Effect": "Allow", "Action": "s3:*",
                           "Resource": ["arn:aws:s3:::allowed",
                                        "arn:aws:s3:::allowed/*"]}]})
        iam.add_user("frank", "frank-secret-1", ["only-allowed"])
        cli = _client(pkg, srv, "frank", "frank-secret-1")
        cli.put_object("allowed", "x", b"ok")
        with pytest.raises(pkg.S3ClientError) as ei:
            cli.put_object("forbidden", "x", b"no")
        assert ei.value.code == "AccessDenied"


def _assume_role(cli, duration=3600):
    body = f"Action=AssumeRole&Version=2011-06-15&DurationSeconds={duration}"
    status, _, data = cli.request("POST", "/", body=body.encode())
    assert status == 200, data

    def field(tag):
        return re.search(f"<{tag}>([^<]+)</{tag}>", data.decode()).group(1)
    return field("AccessKeyId"), field("SecretAccessKey"), \
        field("SessionToken")


class TestSTS:
    def test_assume_role_roundtrip(self, pkg, stack):
        srv, iam, root_cli = stack
        root_cli.make_bucket("sts-bkt")
        iam.add_user("grace", "grace-secret-1", ["readwrite"])
        user_cli = _client(pkg, srv, "grace", "grace-secret-1")
        ak, sk, token = _assume_role(user_cli)
        assert ak.startswith("sts-")
        sts_cli = _client(pkg, srv, ak, sk)
        with pytest.raises(pkg.S3ClientError):
            sts_cli.list_buckets()
        status, _, _ = sts_cli.request(
            "PUT", "/sts-bkt/obj", body=b"x",
            headers={"x-amz-security-token": token})
        assert status == 200
        status, _, data = sts_cli.request(
            "GET", "/sts-bkt/obj",
            headers={"x-amz-security-token": token})
        assert status == 200 and data == b"x"

    def test_sts_cannot_reassume(self, pkg, stack):
        srv, iam, root_cli = stack
        iam.add_user("henry", "henry-secret-1", ["readwrite"])
        cli = _client(pkg, srv, "henry", "henry-secret-1")
        ak, sk, token = _assume_role(cli)
        sts_cli = _client(pkg, srv, ak, sk)
        status, _, data = sts_cli.request(
            "POST", "/", body=b"Action=AssumeRole&Version=2011-06-15",
            headers={"x-amz-security-token": token})
        assert status == 403


class TestSecurityRegressions:
    def test_sts_inline_policy_cannot_escalate(self, stack):
        srv, iam, root_cli = stack
        root_cli.make_bucket("esc")
        iam.add_user("low", "low-secret-1234", ["readonly"])
        allow_all = {"Statement": [{"Effect": "Allow", "Action": "s3:*",
                                    "Resource": "arn:aws:s3:::*"}]}
        ident = iam.assume_role(iam.lookup("low"), 3600, allow_all)
        assert iam.is_allowed(ident, "s3:GetObject", "esc/k")
        assert not iam.is_allowed(ident, "s3:PutObject", "esc/k")

    def test_sts_survives_iam_reload(self, stack):
        _, iam, _ = stack
        iam.add_user("rel", "rel-secret-1234", ["readwrite"])
        restrict = {"Statement": [{"Effect": "Allow",
                                   "Action": "s3:GetObject",
                                   "Resource": "arn:aws:s3:::*"}]}
        ident = iam.assume_role(iam.lookup("rel"), 3600, restrict)
        iam.load()
        assert iam.is_allowed(ident, "s3:GetObject", "b/k")
        assert not iam.is_allowed(ident, "s3:PutObject", "b/k")

    def test_multi_delete_respects_object_deny(self, pkg, stack):
        srv, iam, root_cli = stack
        root_cli.make_bucket("mdel")
        root_cli.put_object("mdel", "open/x", b"1")
        root_cli.put_object("mdel", "protected/x", b"2")
        iam.set_policy("deny-protected", {"Statement": [
            {"Effect": "Allow", "Action": "s3:*",
             "Resource": ["arn:aws:s3:::mdel", "arn:aws:s3:::mdel/*"]},
            {"Effect": "Deny", "Action": "s3:DeleteObject",
             "Resource": "arn:aws:s3:::mdel/protected/*"}]})
        iam.add_user("ivan", "ivan-secret-123", ["deny-protected"])
        cli = _client(pkg, srv, "ivan", "ivan-secret-123")
        body = cli.delete_objects("mdel", ["open/x", "protected/x"])
        assert b"<Deleted><Key>open/x</Key>" in body.replace(b"\n", b"")
        assert b"AccessDenied" in body
        assert root_cli.get_object("mdel", "protected/x") == b"2"

    def test_ip_condition_cidr(self, pol):
        p = pol.Policy({"Statement": [{
            "Effect": "Allow", "Action": "s3:GetObject",
            "Resource": "arn:aws:s3:::b/*",
            "Condition": {"IpAddress":
                          {"aws:SourceIp": ["10.1.12.0/24"]}}}]})
        assert p.is_allowed("s3:GetObject", "b/k",
                            {"aws:SourceIp": "10.1.12.55"})
        assert not p.is_allowed("s3:GetObject", "b/k",
                                {"aws:SourceIp": "10.1.120.55"})
        assert not p.is_allowed("s3:GetObject", "b/k", {})


class TestAdviceR2Policy:
    def test_anonymous_requires_principal_star(self, pol):
        p = pol.Policy({"Statement": [{
            "Effect": "Allow", "Action": "s3:GetObject",
            "Resource": "arn:aws:s3:::b/*"}]})
        assert not p.is_allowed("s3:GetObject", "b/k", principal="*")
        assert p.is_allowed("s3:GetObject", "b/k")

    def test_principal_star_grants_anonymous(self, pol):
        for principal_elem in ("*", {"AWS": "*"}, {"AWS": ["*"]}):
            p = pol.Policy({"Statement": [{
                "Effect": "Allow", "Principal": principal_elem,
                "Action": "s3:GetObject",
                "Resource": "arn:aws:s3:::b/*"}]})
            assert p.is_allowed("s3:GetObject", "b/k", principal="*")

    def test_principal_named_user_not_anonymous(self, pol):
        p = pol.Policy({"Statement": [{
            "Effect": "Allow",
            "Principal": {"AWS": "arn:aws:iam:::user/alice"},
            "Action": "s3:GetObject", "Resource": "arn:aws:s3:::b/*"}]})
        assert not p.is_allowed("s3:GetObject", "b/k", principal="*")
        assert p.is_allowed("s3:GetObject", "b/k", principal="alice")
        assert not p.is_allowed("s3:GetObject", "b/k", principal="bob")

    def test_unknown_condition_operator_rejected_at_parse(self, pol):
        with pytest.raises(pol.PolicyError):
            pol.Policy({"Statement": [{
                "Effect": "Deny", "Action": "s3:*",
                "Resource": "arn:aws:s3:::*",
                "Condition": {"BinaryEquals":
                              {"aws:PrincipalArn": "arn:aws:iam::*"}}}]})

    def test_arn_operators(self, pol):
        p = pol.Policy({"Statement": [{
            "Effect": "Deny", "Action": "s3:*",
            "Resource": "arn:aws:s3:::*",
            "Condition": {"ArnNotLike":
                          {"aws:PrincipalArn": "arn:aws:iam::1:*"}}}]})
        assert not p.is_allowed(
            "s3:GetObject", "b/k",
            {"aws:PrincipalArn": "arn:aws:iam::2:user/eve"})
        assert not p.is_allowed(
            "s3:GetObject", "b/k",
            {"aws:PrincipalArn": "arn:aws:iam::1:user/me"})

    def test_null_operator(self, pol):
        p = pol.Policy({"Statement": [{
            "Effect": "Allow", "Action": "s3:ListBucket",
            "Resource": "arn:aws:s3:::b",
            "Condition": {"Null": {"s3:prefix": "true"}}}]})
        assert p.is_allowed("s3:ListBucket", "b", {})
        assert not p.is_allowed("s3:ListBucket", "b",
                                {"s3:prefix": "x/"})

    def test_null_if_exists_rejected(self, pol):
        with pytest.raises(pol.PolicyError):
            pol.Policy({"Statement": [{
                "Effect": "Allow", "Action": "s3:ListBucket",
                "Resource": "arn:aws:s3:::b",
                "Condition": {"NullIfExists": {"s3:prefix": "false"}}}]})

    def test_if_exists_suffix(self, pol):
        p = pol.Policy({"Statement": [{
            "Effect": "Allow", "Action": "s3:ListBucket",
            "Resource": "arn:aws:s3:::b",
            "Condition": {"StringEqualsIfExists":
                          {"s3:prefix": ["pub/"]}}}]})
        assert p.is_allowed("s3:ListBucket", "b", {})
        assert p.is_allowed("s3:ListBucket", "b", {"s3:prefix": "pub/"})
        assert not p.is_allowed("s3:ListBucket", "b",
                                {"s3:prefix": "priv/"})

    def test_deny_all_fallback_policy(self, pol):
        p = pol.deny_all_policy()
        assert not p.is_allowed("s3:GetObject", "b/k")
        allow = pol.Policy({"Statement": [{
            "Effect": "Allow", "Action": "s3:*",
            "Resource": "arn:aws:s3:::*"}]})
        assert not pol.merge_allowed([allow, p], "s3:GetObject", "b/k")

    def test_string_not_like(self, pol):
        p = pol.Policy({"Statement": [{
            "Effect": "Allow", "Action": "s3:ListBucket",
            "Resource": "arn:aws:s3:::b",
            "Condition": {"StringNotLike": {"s3:prefix": ["secret/*"]}}}]})
        assert p.is_allowed("s3:ListBucket", "b", {"s3:prefix": "pub/x"})
        assert not p.is_allowed("s3:ListBucket", "b",
                                {"s3:prefix": "secret/x"})

    def test_bad_principal_kind_rejected(self, pol):
        with pytest.raises(pol.PolicyError):
            pol.Policy({"Statement": [{
                "Effect": "Allow", "Principal": {"Service": "ec2"},
                "Action": "s3:GetObject", "Resource": "arn:aws:s3:::b/*"}]})

    def test_principalless_deny_still_binds_anonymous(self, pol):
        p = pol.Policy({"Statement": [
            {"Effect": "Allow", "Principal": "*", "Action": "s3:*",
             "Resource": "arn:aws:s3:::b/*"},
            {"Effect": "Deny", "Action": "s3:DeleteObject",
             "Resource": "arn:aws:s3:::b/*"}]})
        assert p.is_allowed("s3:GetObject", "b/k", principal="*")
        assert not p.is_allowed("s3:DeleteObject", "b/k", principal="*")

    def test_not_principal_rejected(self, pol):
        with pytest.raises(pol.PolicyError):
            pol.Policy({"Statement": [{
                "Effect": "Deny", "NotPrincipal": {"AWS": "alice"},
                "Action": "s3:*", "Resource": "arn:aws:s3:::b/*"}]})

    def test_bool_numeric_date_conditions(self, pol):
        p = pol.Policy({"Statement": [{
            "Effect": "Allow", "Action": "s3:GetObject",
            "Resource": "arn:aws:s3:::b/*",
            "Condition": {
                "Bool": {"aws:SecureTransport": "true"},
                "NumericLessThanEquals": {"s3:max-keys": "100"},
                "DateGreaterThan":
                    {"aws:CurrentTime": "2020-01-01T00:00:00Z"}}}]})
        ok = {"aws:SecureTransport": "true", "s3:max-keys": "50",
              "aws:CurrentTime": "2024-06-01T00:00:00Z"}
        assert p.is_allowed("s3:GetObject", "b/k", ok)
        assert not p.is_allowed("s3:GetObject", "b/k",
                                {**ok, "aws:SecureTransport": "false"})
        assert not p.is_allowed("s3:GetObject", "b/k",
                                {**ok, "s3:max-keys": "500"})
        assert not p.is_allowed(
            "s3:GetObject", "b/k",
            {**ok, "aws:CurrentTime": "2019-01-01T00:00:00Z"})

    def test_empty_condition_values_rejected_at_parse(self, pol):
        for cond in ({"Bool": {"aws:SecureTransport": []}},
                     {"NumericLessThan": {"s3:max-keys": []}},
                     {"StringEquals": "notadict"}):
            with pytest.raises(pol.PolicyError):
                pol.Policy({"Statement": [{
                    "Effect": "Allow", "Action": "s3:*",
                    "Resource": "arn:aws:s3:::b/*", "Condition": cond}]})

    def test_numeric_ordering_any_value_matches(self, pol):
        p = pol.Policy({"Statement": [{
            "Effect": "Allow", "Action": "s3:ListBucket",
            "Resource": "arn:aws:s3:::b",
            "Condition": {"NumericLessThan":
                          {"s3:max-keys": ["10", "1000"]}}}]})
        assert p.is_allowed("s3:ListBucket", "b", {"s3:max-keys": "500"})
        assert not p.is_allowed("s3:ListBucket", "b",
                                {"s3:max-keys": "5000"})


# -- tests/test_sts_ldap_kes.py: TestLDAPSTS and TestCertificateSTS --------------

def _ldap(pkg, tmp_path):
    sock = str(tmp_path / "ldap.sock")
    fake = FakeLDAP(
        sock,
        binds={"cn=lookup,dc=corp": "lookuppw",
               "uid=alice,ou=people,dc=corp": "alicepw"},
        entries=[
            ("uid=alice,ou=people,dc=corp", {"uid": ["alice"]}),
            ("cn=devs,ou=groups,dc=corp",
             {"member": ["uid=alice,ou=people,dc=corp"]}),
        ])
    cfg = pkg.ldap.LDAPConfig(
        host=sock, lookup_bind_dn="cn=lookup,dc=corp",
        lookup_bind_password="lookuppw",
        user_base_dn="ou=people,dc=corp",
        group_base_dn="ou=groups,dc=corp",
        group_policies={"cn=devs,ou=groups,dc=corp": ["readonly"]})
    return fake, cfg


class TestLDAPSTS:
    def test_ldap_client_wire_flow(self, pkg, tmp_path):
        fake, cfg = _ldap(pkg, tmp_path)
        try:
            dn, policies = cfg.authenticate("alice", "alicepw")
            assert dn == "uid=alice,ou=people,dc=corp"
            assert policies == ["readonly"]
            assert "uid=alice,ou=people,dc=corp" in fake.bound_as
            with pytest.raises(pkg.ldap.LDAPError):
                cfg.authenticate("alice", "wrong")
            with pytest.raises(pkg.ldap.LDAPError):
                cfg.authenticate("nobody", "x")
            with pytest.raises(pkg.ldap.LDAPError):
                cfg.authenticate("alice", "")
        finally:
            fake.stop()

    def test_assume_role_with_ldap_identity_e2e(self, pkg, tmp_path):
        fake, cfg = _ldap(pkg, tmp_path)
        srv, iam, pools = _stack(pkg, tmp_path, STS_ROOT, STS_SECRET,
                                 ldap=cfg)
        try:
            iam.set_policy("readonly", READONLY)
            root_cli = _client(pkg, srv, STS_ROOT, STS_SECRET)
            root_cli.make_bucket("lbkt")
            root_cli.put_object("lbkt", "obj", b"ldap data")
            conn = http.client.HTTPConnection(srv.host, srv.port)
            body = ("Action=AssumeRoleWithLDAPIdentity&Version=2011-06-15"
                    "&LDAPUsername=alice&LDAPPassword=alicepw")
            conn.request("POST", "/", body=body, headers={
                "Content-Type": "application/x-www-form-urlencoded"})
            resp = conn.getresponse()
            out = resp.read().decode()
            assert resp.status == 200, out
            ak = re.search(r"<AccessKeyId>([^<]+)", out).group(1)
            sk = re.search(r"<SecretAccessKey>([^<]+)", out).group(1)
            tok = re.search(r"<SessionToken>([^<]+)", out).group(1)
            sts_cli = _client(pkg, srv, ak, sk)
            st, _, got = sts_cli.request(
                "GET", "/lbkt/obj", headers={"x-amz-security-token": tok})
            assert st == 200 and got == b"ldap data"
            st, _, _ = sts_cli.request(
                "PUT", "/lbkt/nope", body=b"x",
                headers={"x-amz-security-token": tok})
            assert st == 403
            conn.request("POST", "/", body=body.replace(
                "alicepw", "wrongpw"), headers={
                "Content-Type": "application/x-www-form-urlencoded"})
            resp = conn.getresponse()
            out2 = resp.read().decode()
            assert resp.status == 403, out2
        finally:
            srv.shutdown()
            close_pools(pools)
            fake.stop()


class TestCertificateSTS:
    def test_assume_role_with_certificate(self, pkg, tmp_path):
        ca, server_certs, client_pem = \
            jax_sts_tests.TestCertificateSTS()._make_ca_and_client(
                tmp_path, cn="certpolicy")
        srv, iam, pools = _stack(pkg, tmp_path, STS_ROOT, STS_SECRET,
                                 certs=server_certs, client_ca=ca)
        try:
            iam.set_policy("certpolicy", READONLY)
            ctx = ssl.create_default_context(cafile=ca)
            ctx.check_hostname = False
            ctx.load_cert_chain(client_pem)
            conn = http.client.HTTPSConnection("127.0.0.1", srv.port,
                                               context=ctx)
            conn.request("POST", "/",
                         body="Action=AssumeRoleWithCertificate"
                              "&Version=2011-06-15",
                         headers={"Content-Type":
                                  "application/x-www-form-urlencoded"})
            resp = conn.getresponse()
            out = resp.read().decode()
            assert resp.status == 200, out
            assert "<AssumeRoleWithCertificateResult>" in out
            assert re.search(r"<AccessKeyId>([^<]+)", out).group(1)
            # Without a client certificate: denied, and the TLS front
            # door still serves every other endpoint.
            ctx2 = ssl.create_default_context(cafile=ca)
            ctx2.check_hostname = False
            conn2 = http.client.HTTPSConnection("127.0.0.1", srv.port,
                                                context=ctx2)
            conn2.request("POST", "/",
                          body="Action=AssumeRoleWithCertificate"
                               "&Version=2011-06-15",
                          headers={"Content-Type":
                                   "application/x-www-form-urlencoded"})
            resp2 = conn2.getresponse()
            assert resp2.status == 403, resp2.read()[:300]
            conn3 = http.client.HTTPSConnection("127.0.0.1", srv.port,
                                                context=ctx2)
            conn3.request("GET", "/minio/health/live")
            assert conn3.getresponse().status == 200
        finally:
            srv.shutdown()
            close_pools(pools)
