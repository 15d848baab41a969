"""Minimal signed S3 client — the test harness's `mc` analogue (the
port's copy of minio_tpu/server/client.py; `timeout` bounds every
socket operation, and a streamed body goes out in 1 MiB sends, not
http.client's 8 KiB ones).

Signs every request with the same sigv4 module the server verifies with
is NOT circular: the signer follows the public SigV4 spec from the client
side (canonicalizing real HTTP bytes on the wire), so a mismatch in either
direction fails the round-trip tests. Used by tests and (later) internal
tooling.
"""

from __future__ import annotations

import http.client
import urllib.parse
import xml.etree.ElementTree as ET

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


class S3Client:
    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 region: str = "us-east-1", verify_tls: bool = True,
                 timeout: float = 60):
        u = urllib.parse.urlsplit(endpoint)
        self.host = u.hostname
        self.tls = u.scheme == "https"
        self.port = u.port or (443 if self.tls else 80)
        self.verify_tls = verify_tls
        self.timeout = timeout
        self.creds = Credentials(access_key, secret_key, region)
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
                raw_query: str | None = None):
        q = {k: [v] for k, v in (query or {}).items()}
        headers = dict(headers or {})
        headers["Host"] = f"{self.host}:{self.port}"
        # Sign over the DECODED path; send the percent-encoded form on the
        # wire (keys with spaces/non-ASCII would otherwise break the
        # request line and the signature).
        wire_path = urllib.parse.quote(path, safe="/~-._")
        if raw_query is None:
            auth = sign_request(self.creds, method, path, q, headers, body)
            headers.update(auth)
            qs = urllib.parse.urlencode({k: v[0] for k, v in q.items()})
            url = wire_path + ("?" + qs if qs else "")
        else:
            url = wire_path + "?" + raw_query
        conn = self._connect()
        try:
            conn.request(method, url, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
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
        auth = sign_request(self.creds, "PUT", path, {}, headers,
                            "UNSIGNED-PAYLOAD")
        headers.update(auth)
        wire_path = urllib.parse.quote(path, safe="/~-._")
        conn = self._connect()
        try:
            conn.request("PUT", wire_path, body=reader, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
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
