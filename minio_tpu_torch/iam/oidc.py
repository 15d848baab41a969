"""Copy of minio_tpu/iam/oidc.py: the port keeps its own, so that it imports
nothing of the JAX package.

OIDC identity provider: JWT validation for AssumeRoleWithWebIdentity.

The internal/config/identity/openid equivalent: an external IdP issues
JWTs; STS validates signature (HS256 shared secret or RS256 public key),
expiry and audience, then mints temporary credentials whose policies
come from the token's policy claim (cf. cmd/sts-handlers.go
AssumeRoleWithWebIdentity). Keys are configured statically (the role the
reference's JWKS fetch plays, without network egress).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time


class OIDCError(Exception):
    pass


def _b64url_decode(s: str) -> bytes:
    s += "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s)


def b64url_encode(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


class OpenIDConfig:
    def __init__(self, *, hs256_secret: bytes | None = None,
                 rs256_public_keys: dict | None = None,
                 audience: str = "", claim_name: str = "policy"):
        self.hs256_secret = hs256_secret
        self.rs256_keys = rs256_public_keys or {}   # kid -> PEM bytes
        self.audience = audience
        self.claim_name = claim_name

    # -- validation ----------------------------------------------------------

    def validate(self, token: str, now: float | None = None) -> dict:
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
            header = json.loads(_b64url_decode(header_b64))
            payload = json.loads(_b64url_decode(payload_b64))
            sig = _b64url_decode(sig_b64)
        except (ValueError, TypeError):
            raise OIDCError("malformed JWT") from None
        signing_input = f"{header_b64}.{payload_b64}".encode()
        alg = header.get("alg", "")
        if alg == "HS256":
            if self.hs256_secret is None:
                raise OIDCError("HS256 not configured")
            want = hmac.new(self.hs256_secret, signing_input,
                            hashlib.sha256).digest()
            if not hmac.compare_digest(want, sig):
                raise OIDCError("bad signature")
        elif alg == "RS256":
            pem = self.rs256_keys.get(header.get("kid", ""))
            if pem is None:
                raise OIDCError(f"unknown kid {header.get('kid')!r}")
            from cryptography.hazmat.primitives import hashes, serialization
            from cryptography.hazmat.primitives.asymmetric import padding
            pub = serialization.load_pem_public_key(pem)
            try:
                pub.verify(sig, signing_input, padding.PKCS1v15(),
                           hashes.SHA256())
            except Exception:  # noqa: BLE001
                raise OIDCError("bad signature") from None
        else:
            raise OIDCError(f"unsupported alg {alg!r}")

        now = time.time() if now is None else now
        if "exp" in payload and now > float(payload["exp"]):
            raise OIDCError("token expired")
        if "nbf" in payload and now < float(payload["nbf"]):
            raise OIDCError("token not yet valid")
        if self.audience:
            aud = payload.get("aud", "")
            auds = aud if isinstance(aud, list) else [aud]
            if self.audience not in auds:
                raise OIDCError("audience mismatch")
        return payload

    def policies_from(self, claims: dict) -> list[str]:
        v = claims.get(self.claim_name, [])
        if isinstance(v, str):
            return [p.strip() for p in v.split(",") if p.strip()]
        return [str(p) for p in v]


def make_hs256_token(secret: bytes, claims: dict) -> str:
    """Test/tool helper: mint an HS256 JWT."""
    header = b64url_encode(json.dumps({"alg": "HS256",
                                       "typ": "JWT"}).encode())
    payload = b64url_encode(json.dumps(claims).encode())
    sig = hmac.new(secret, f"{header}.{payload}".encode(),
                   hashlib.sha256).digest()
    return f"{header}.{payload}.{b64url_encode(sig)}"
