"""Minimal signed S3 client — the test harness's `mc` analogue (the
port's copy of minio_tpu/server/client.py; `timeout` bounds every
socket operation, and a streamed body goes out in 1 MiB sends, not
http.client's 8 KiB ones).  Beside SigV4 it signs SigV2 headers and
presigns SigV2 URLs (`auth=`), carries an STS session token
(`session_token`), calls the admin API's IAM endpoints and STS, and
builds browser POST-policy forms.  A server that refuses a request
before reading its body answers and closes the connection; the client
then reads that answer instead of failing on the unsent rest.

Signs every request with the same sigv4 module the server verifies with
is NOT circular: the signer follows the public SigV4 spec from the client
side (canonicalizing real HTTP bytes on the wire), so a mismatch in either
direction fails the round-trip tests. Used by tests and (later) internal
tooling.
"""

from __future__ import annotations

import datetime
import http.client
import json
import re
import secrets
import urllib.parse
import xml.etree.ElementTree as ET

from . import postpolicy, sigv2
from .sigv4 import Credentials, sign_request

#: Bytes per send of a streamed request body.  Each send takes the GIL
#: back; in a process whose handler and engine threads hold it, 8 KiB
#: sends (http.client's default) make a 64 MiB body 8192 waits.
SEND_BLOCK = 1 << 20


class S3ClientError(Exception):
    def __init__(self, status: int, code: str, message: str):
        self.status = status
        self.code = code
        self.message = message
        super().__init__(f"{status} {code}: {message}")


#: How the client authenticates a request: SigV4 header, SigV2 header,
#: a SigV2 presigned URL, or not at all.
AUTH_KINDS = ("v4", "v2", "v2-presigned", "anonymous")


def _send(conn, method: str, url: str, body, headers: dict):
    """Send a request and read its response.  A server that refuses a
    request from its headers answers and closes without reading the
    body: the send then fails, and the answer is read all the same."""
    try:
        conn.request(method, url, body=body, headers=headers)
    except (BrokenPipeError, ConnectionResetError):
        pass
    resp = conn.getresponse()
    return resp, resp.read()


class S3Client:
    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 region: str = "us-east-1", verify_tls: bool = True,
                 timeout: float = 60, session_token: str = ""):
        u = urllib.parse.urlsplit(endpoint)
        self.host = u.hostname
        self.tls = u.scheme == "https"
        self.port = u.port or (443 if self.tls else 80)
        self.verify_tls = verify_tls
        self.timeout = timeout
        self.creds = Credentials(access_key, secret_key, region)
        self.session_token = session_token   # STS credentials carry one
        self._ssl_ctx = None             # built once, lazily

    def _connect(self):
        timeout = self.timeout
        if not self.tls:
            return http.client.HTTPConnection(self.host, self.port,
                                              timeout=timeout,
                                              blocksize=SEND_BLOCK)
        if self._ssl_ctx is None:
            import ssl
            ctx = ssl.create_default_context()
            if not self.verify_tls:
                # explicit opt-out only (tests with self-signed certs)
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self._ssl_ctx = ctx
        return http.client.HTTPSConnection(self.host, self.port,
                                           timeout=timeout,
                                           context=self._ssl_ctx,
                                           blocksize=SEND_BLOCK)

    # -- core ----------------------------------------------------------------

    def request(self, method: str, path: str,
                query: dict[str, str] | None = None,
                body: bytes = b"", headers: dict[str, str] | None = None,
                raw_query: str | None = None, auth: str = "v4",
                expires_in: int = 600):
        """One request, signed as `auth` (one of AUTH_KINDS; a SigV2
        presigned URL is valid for `expires_in` seconds): (status,
        headers, body)."""
        if auth not in AUTH_KINDS:
            raise ValueError(f"auth must be one of {AUTH_KINDS}")
        q = {k: [v] for k, v in (query or {}).items()}
        headers = dict(headers or {})
        headers["Host"] = f"{self.host}:{self.port}"
        if self.session_token and auth in ("v4", "v2"):
            headers["x-amz-security-token"] = self.session_token
        # Sign over the DECODED path; send the percent-encoded form on the
        # wire (keys with spaces/non-ASCII would otherwise break the
        # request line and the signature).
        wire_path = urllib.parse.quote(path, safe="/~-._")
        if raw_query is None:
            if auth == "v4":
                headers.update(sign_request(self.creds, method, path, q,
                                            headers, body))
            elif auth == "v2":
                headers = sigv2.sign_header_v2(self.creds, method, path, q,
                                               headers)
            elif auth == "v2-presigned":
                if self.session_token:
                    q["X-Amz-Security-Token"] = [self.session_token]
                q = sigv2.presign_v2(self.creds, method, path, expires_in,
                                     query=q)
            qs = urllib.parse.urlencode({k: v[0] for k, v in q.items()})
            url = wire_path + ("?" + qs if qs else "")
        else:
            url = wire_path + "?" + raw_query
        conn = self._connect()
        try:
            resp, data = _send(conn, method, url, body, headers)
            return resp.status, dict(resp.getheaders()), data
        finally:
            conn.close()

    def put_object_stream(self, bucket: str, key: str, reader, size: int,
                          headers: dict[str, str] | None = None) -> dict:
        """Streamed PUT: body is a .read(n) reader sent with
        Content-Length and an UNSIGNED-PAYLOAD signature — the body
        never materializes client- or server-side."""
        path = f"/{bucket}/{key}"
        headers = dict(headers or {})
        headers["Host"] = f"{self.host}:{self.port}"
        headers["Content-Length"] = str(size)
        if self.session_token:
            headers["x-amz-security-token"] = self.session_token
        auth = sign_request(self.creds, "PUT", path, {}, headers,
                            "UNSIGNED-PAYLOAD")
        headers.update(auth)
        wire_path = urllib.parse.quote(path, safe="/~-._")
        conn = self._connect()
        try:
            resp, data = _send(conn, "PUT", wire_path, reader, headers)
            _, h, _ = self._check(resp.status, dict(resp.getheaders()),
                                  data)
            return h
        finally:
            conn.close()

    def get_object_stream(self, bucket: str, key: str,
                          chunk_size: int = 1 << 20):
        """Streamed GET: yields body chunks as they arrive."""
        path = f"/{bucket}/{key}"
        headers = {"Host": f"{self.host}:{self.port}"}
        if self.session_token:
            headers["x-amz-security-token"] = self.session_token
        auth = sign_request(self.creds, "GET", path, {}, headers, b"")
        headers.update(auth)
        wire_path = urllib.parse.quote(path, safe="/~-._")
        conn = self._connect()
        try:
            conn.request("GET", wire_path, headers=headers)
            resp = conn.getresponse()
            if resp.status not in (200, 206):
                body = resp.read()
                self._check(resp.status, dict(resp.getheaders()), body)
            while True:
                piece = resp.read(chunk_size)
                if not piece:
                    return
                yield piece
        finally:
            conn.close()

    def _check(self, status, headers, data, ok=(200, 204, 206)):
        if status in ok:
            return status, headers, data
        code, msg = "Unknown", ""
        try:
            root = ET.fromstring(data)
            code = root.findtext("Code", "Unknown")
            msg = root.findtext("Message", "")
        except ET.ParseError:
            pass
        raise S3ClientError(status, code, msg)

    # -- buckets -------------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        self._check(*self.request("PUT", f"/{bucket}"))

    def delete_bucket(self, bucket: str) -> None:
        self._check(*self.request("DELETE", f"/{bucket}"))

    def bucket_exists(self, bucket: str) -> bool:
        status, _, _ = self.request("HEAD", f"/{bucket}")
        return status == 200

    def list_buckets(self) -> list[str]:
        _, _, data = self._check(*self.request("GET", "/"))
        root = ET.fromstring(data)
        ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
        return [b.findtext(f"{ns}Name") or b.findtext("Name")
                for b in root.iter(f"{ns}Bucket")] or \
               [b.findtext("Name") for b in root.iter("Bucket")]

    def set_versioning(self, bucket: str, enabled: bool) -> None:
        status = "Enabled" if enabled else "Suspended"
        body = (f'<VersioningConfiguration><Status>{status}</Status>'
                f'</VersioningConfiguration>').encode()
        self._check(*self.request("PUT", f"/{bucket}",
                                  query={"versioning": ""}, body=body))

    # -- objects -------------------------------------------------------------

    def put_object(self, bucket: str, key: str, data: bytes,
                   headers: dict | None = None) -> dict:
        _, h, _ = self._check(
            *self.request("PUT", f"/{bucket}/{key}", body=data,
                          headers=headers))
        return h

    def get_object(self, bucket: str, key: str,
                   range_: tuple[int, int] | None = None,
                   version_id: str = "") -> bytes:
        headers = {}
        if range_:
            headers["Range"] = f"bytes={range_[0]}-{range_[1]}"
        q = {"versionId": version_id} if version_id else None
        _, _, data = self._check(
            *self.request("GET", f"/{bucket}/{key}", query=q,
                          headers=headers))
        return data

    def head_object(self, bucket: str, key: str) -> dict:
        status, h, data = self.request("HEAD", f"/{bucket}/{key}")
        if status != 200:
            raise S3ClientError(status, "HeadFailed", "")
        return h

    def delete_object(self, bucket: str, key: str,
                      version_id: str = "") -> dict:
        q = {"versionId": version_id} if version_id else None
        _, h, _ = self._check(
            *self.request("DELETE", f"/{bucket}/{key}", query=q))
        return h

    def copy_object(self, src_bucket: str, src_key: str, dst_bucket: str,
                    dst_key: str) -> None:
        self._check(*self.request(
            "PUT", f"/{dst_bucket}/{dst_key}",
            headers={"x-amz-copy-source": f"/{src_bucket}/{src_key}"}))

    def list_objects(self, bucket: str, prefix: str = "",
                     delimiter: str = "", v2: bool = True,
                     start_after: str = "", max_keys: int = 0):
        """Listing that follows truncation markers (v2 continuation
        tokens, v1 NextMarker/last-key) so a remote capping responses
        at 1000 keys still yields every key. max_keys > 0 bounds the
        result AND is pushed to the remote, stopping the pagination
        loop as soon as enough keys arrived (paged gateway walks must
        not refetch the whole remainder per page)."""
        ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
        keys: list[str] = []
        prefixes: list[str] = []
        token = ""
        marker = ""
        while True:
            q = {"prefix": prefix}
            if v2:
                q["list-type"] = "2"
            if delimiter:
                q["delimiter"] = delimiter
            if max_keys > 0:
                q["max-keys"] = str(max_keys - len(keys))
            if v2 and start_after:
                q["start-after"] = start_after
            if not v2 and (marker or start_after):
                q["marker"] = marker or start_after
            if token:
                q["continuation-token"] = token
            _, _, data = self._check(*self.request("GET", f"/{bucket}",
                                                   query=q))
            root = ET.fromstring(data)
            page = [c.findtext(f"{ns}Key")
                    for c in root.iter(f"{ns}Contents")]
            keys += page
            prefixes += [c.findtext(f"{ns}Prefix")
                         for c in root.iter(f"{ns}CommonPrefixes")]
            truncated = root.findtext(f"{ns}IsTruncated") == "true"
            token = root.findtext(f"{ns}NextContinuationToken") or ""
            marker = (root.findtext(f"{ns}NextMarker")
                      or (page[-1] if page else ""))
            if max_keys > 0 and len(keys) >= max_keys:
                return keys[:max_keys], prefixes
            if not truncated or not (token if v2 else marker):
                return keys, prefixes

    def delete_objects(self, bucket: str, keys: list[str]):
        objs = "".join(f"<Object><Key>{k}</Key></Object>" for k in keys)
        body = f"<Delete>{objs}</Delete>".encode()
        _, _, data = self._check(*self.request(
            "POST", f"/{bucket}", query={"delete": ""}, body=body))
        return data

    # -- multipart -----------------------------------------------------------

    def create_multipart(self, bucket: str, key: str) -> str:
        _, _, data = self._check(*self.request(
            "POST", f"/{bucket}/{key}", query={"uploads": ""}))
        root = ET.fromstring(data)
        ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
        return root.findtext(f"{ns}UploadId") or root.findtext("UploadId")

    def upload_part(self, bucket: str, key: str, upload_id: str,
                    part_number: int, data: bytes) -> str:
        _, h, _ = self._check(*self.request(
            "PUT", f"/{bucket}/{key}",
            query={"partNumber": str(part_number), "uploadId": upload_id},
            body=data))
        return h.get("ETag", "").strip('"')

    def complete_multipart(self, bucket: str, key: str, upload_id: str,
                           parts: list[tuple[int, str]]) -> None:
        inner = "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>\"{e}\"</ETag></Part>"
            for n, e in parts)
        body = f"<CompleteMultipartUpload>{inner}</CompleteMultipartUpload>" \
            .encode()
        self._check(*self.request(
            "POST", f"/{bucket}/{key}", query={"uploadId": upload_id},
            body=body))

    def abort_multipart(self, bucket: str, key: str, upload_id: str) -> None:
        self._check(*self.request(
            "DELETE", f"/{bucket}/{key}", query={"uploadId": upload_id}))

    # -- admin API: IAM (cf. madmin-go's user/group/policy calls) -------------

    def admin(self, method: str, endpoint: str,
              query: dict[str, str] | None = None,
              doc: dict | None = None):
        """One admin API call, SigV4-signed: (status, decoded JSON or
        the raw body when it is not JSON)."""
        body = json.dumps(doc).encode() if doc is not None else b""
        st, _, data = self.request(method, f"/minio/admin/v3/{endpoint}",
                                   query=query, body=body)
        try:
            return st, json.loads(data)
        except ValueError:
            return st, data

    def _admin_ok(self, method, endpoint, query=None, doc=None) -> dict:
        st, out = self.admin(method, endpoint, query, doc)
        if st != 200:
            if isinstance(out, bytes):
                self._check(st, {}, out)
            raise S3ClientError(st, "AdminError", str(out))
        return out

    def add_user(self, access_key: str, secret_key: str,
                 policies: list[str] | None = None) -> None:
        self._admin_ok("POST", "users", doc={
            "accessKey": access_key, "secretKey": secret_key,
            "policies": list(policies or [])})

    def list_users(self) -> list[str]:
        return self._admin_ok("GET", "users")["users"]

    def set_policy(self, name: str, policy: dict) -> None:
        self._admin_ok("POST", "policies", doc={"name": name,
                                                "policy": policy})

    def add_group(self, name: str, members: list[str],
                  policies: list[str] | None = None) -> None:
        doc = {"name": name, "members": list(members)}
        if policies is not None:
            doc["policies"] = list(policies)
        self._admin_ok("POST", "groups", doc=doc)

    def add_service_account(self, parent: str,
                            policies: list[str] | None = None
                            ) -> tuple[str, str]:
        out = self._admin_ok("POST", "service-accounts", doc={
            "parent": parent, "policies": list(policies or [])})
        return out["accessKey"], out["secretKey"]

    # -- STS (cf. cmd/sts-handlers.go) ----------------------------------------

    def sts(self, form: dict[str, str], signed: bool = True) -> dict:
        """POST one STS action (a form body); the issued credentials as
        {"AccessKeyId", "SecretAccessKey", "SessionToken",
        "Expiration"}.  The identity-provider actions go unsigned."""
        body = urllib.parse.urlencode(
            {"Version": "2011-06-15", **form}).encode()
        headers = {"Content-Type": "application/x-www-form-urlencoded"}
        st, h, data = self.request("POST", "/", body=body, headers=headers,
                                   auth="v4" if signed else "anonymous")
        self._check(st, h, data)
        return {tag: re.search(f"<{tag}>([^<]*)</{tag}>".encode(),
                               data).group(1).decode()
                for tag in ("AccessKeyId", "SecretAccessKey",
                            "SessionToken", "Expiration")}

    def assume_role(self, duration_s: int = 3600,
                    policy: dict | None = None) -> dict:
        form = {"Action": "AssumeRole", "DurationSeconds": str(duration_s)}
        if policy is not None:
            form["Policy"] = json.dumps(policy)
        return self.sts(form)

    def assume_role_with_web_identity(self, token: str,
                                      duration_s: int = 3600) -> dict:
        return self.sts({"Action": "AssumeRoleWithWebIdentity",
                         "WebIdentityToken": token,
                         "DurationSeconds": str(duration_s)}, signed=False)

    def with_credentials(self, creds: dict) -> "S3Client":
        """A client of the same endpoint on credentials STS issued."""
        scheme = "https" if self.tls else "http"
        return S3Client(f"{scheme}://{self.host}:{self.port}",
                        creds["AccessKeyId"], creds["SecretAccessKey"],
                        self.creds.region, self.verify_tls, self.timeout,
                        session_token=creds["SessionToken"])

    # -- browser POST uploads (cf. cmd/postpolicyform.go) ---------------------

    def post_form(self, bucket: str, conditions: list,
                  expires_s: int = 3600,
                  now: datetime.datetime | None = None) -> dict[str, str]:
        """The signed form fields of a POST policy: `conditions` beside
        the bucket, credential and date the signature needs."""
        return postpolicy.sign_post_policy(self.creds, bucket, conditions,
                                           expires_s, now)

    def post_object(self, bucket: str, key: str, data: bytes,
                    fields: dict[str, str]):
        """POST `data` as the form's file under `key` with the signed
        `fields` (post_form): (status, headers, body), unsigned as a
        browser sends it."""
        boundary = secrets.token_hex(16)
        parts = [b""]
        for name, value in {"key": key, **fields}.items():
            parts.append(f'Content-Disposition: form-data; name="{name}"'
                         f'\r\n\r\n{value}'.encode())
        parts.append(b'Content-Disposition: form-data; name="file"; '
                     b'filename="upload"\r\n'
                     b'Content-Type: application/octet-stream\r\n\r\n'
                     + data)
        delim = b"--" + boundary.encode()
        body = (b"\r\n".join(delim + b"\r\n" + p for p in parts[1:])
                + b"\r\n" + delim + b"--\r\n")
        return self.request(
            "POST", f"/{bucket}", body=body, auth="anonymous",
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
