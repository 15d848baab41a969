"""KES-shaped KMS client: the external key server's protocol.

The port of minio_tpu/crypto/kes.py (the internal/kms KES client role,
cf. internal/kms/kms.go:29 and github.com/minio/kes-go): data keys are
generated and unsealed by a key server over its REST API,

    POST /v1/key/generate/{name}   {"context": b64} ->
         {"plaintext": b64, "ciphertext": b64}
    POST /v1/key/decrypt/{name}    {"ciphertext": b64, "context": b64} ->
         {"plaintext": b64}
    POST /v1/key/create/{name}, GET /v1/key/list/*, GET /v1/status

`KESKMS` implements crypto/kms.py's interface, so SSE, the tier's config
sealing and the KMS admin API work unchanged against it.  A production
KES wants mTLS: pass an `ssl.SSLContext` as `tls_context`.
"""

from __future__ import annotations

import base64
import http.client
import json

from .kms import KMS, KMSError, _key_status


class KESKMS(KMS):
    """KMS backed by a KES server."""

    def __init__(self, host: str, port: int, default_key: str = "minio-key",
                 tls_context=None, timeout: float = 5.0):
        self.host, self.port = host, port
        self.key_id = default_key
        self._tls = tls_context
        self.timeout = timeout

    def _conn(self):
        if self._tls is not None:
            return http.client.HTTPSConnection(
                self.host, self.port, timeout=self.timeout,
                context=self._tls)
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def _call(self, method: str, path: str, payload: dict | None) -> dict:
        conn = self._conn()
        try:
            body = json.dumps(payload).encode() if payload is not None \
                else None
            conn.request(method, path, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
        except (OSError, http.client.HTTPException) as e:
            # Every transport failure is a KMSError: a malformed answer
            # must not turn an SSE request into a 500.
            raise KMSError(f"kes: {e}") from None
        finally:
            conn.close()
        if resp.status != 200:
            try:
                msg = json.loads(data).get("message", data[:200])
            except ValueError:
                msg = data[:200]
            raise KMSError(f"kes: {resp.status} {msg}")
        try:
            return json.loads(data) if data else {}
        except ValueError as e:
            raise KMSError(f"kes: bad response: {e}") from None

    # -- KMS interface -------------------------------------------------------

    def generate_data_key(self, context: bytes = b"",
                          key_id: str | None = None):
        key_id = key_id or self.key_id
        out = self._call(
            "POST", f"/v1/key/generate/{key_id}",
            {"context": base64.b64encode(context).decode()})
        try:
            plaintext = base64.b64decode(out["plaintext"])
            sealed = base64.b64decode(out["ciphertext"])
        except (KeyError, ValueError) as e:
            raise KMSError(f"kes: malformed generate reply: {e}") from None
        return key_id, plaintext, sealed

    def decrypt_data_key(self, key_id: str, sealed: bytes,
                         context: bytes = b"") -> bytes:
        out = self._call(
            "POST", f"/v1/key/decrypt/{key_id}",
            {"ciphertext": base64.b64encode(sealed).decode(),
             "context": base64.b64encode(context).decode()})
        try:
            return base64.b64decode(out["plaintext"])
        except (KeyError, ValueError) as e:
            raise KMSError(f"kes: malformed decrypt reply: {e}") from None

    # -- the admin surface of StaticKMS --------------------------------------

    def create_key(self, key_id: str) -> None:
        if not key_id or "/" in key_id:
            raise KMSError(f"invalid key id {key_id!r}")
        self._call("POST", f"/v1/key/create/{key_id}", {})

    def list_keys(self) -> list[str]:
        out = self._call("GET", "/v1/key/list/*", None)
        return sorted(out.get("keys", []))

    def key_status(self, key_id: str) -> dict:
        return _key_status(self, key_id)

    def status(self) -> dict:
        return self._call("GET", "/v1/status", None)
