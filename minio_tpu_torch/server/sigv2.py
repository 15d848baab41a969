"""Copy of minio_tpu/server/sigv2.py: the port keeps its own, so that it imports
nothing of the JAX package.

AWS Signature Version 2: legacy request signing.

The cmd/signature-v2.go equivalent: header auth
(`Authorization: AWS AccessKeyId:Signature`) and presigned query auth
(`?AWSAccessKeyId=..&Expires=..&Signature=..`), both HMAC-SHA1 over

    StringToSign = Method \n Content-MD5 \n Content-Type \n Date \n
                   CanonicalizedAmzHeaders + CanonicalizedResource

Old SDKs and tools still emit V2; the reference accepts both (auth
classification in cmd/auth-handler.go).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time
import urllib.parse

from .api_errors import S3Error

# Subresources included in CanonicalizedResource, in sorted order
# (cf. resourceList, cmd/signature-v2.go).
RESOURCE_LIST = (
    "acl", "delete", "lifecycle", "location", "logging", "notification",
    "partNumber", "policy", "requestPayment", "response-cache-control",
    "response-content-disposition", "response-content-encoding",
    "response-content-language", "response-content-type",
    "response-expires", "retention", "select", "select-type", "tagging",
    "torrent", "uploadId", "uploads", "versionId", "versioning",
    "versions", "website",
)


def canonicalized_resource(path: str, query: dict[str, list[str]]) -> str:
    # V2 clients sign the PERCENT-ENCODED resource (the reference uses
    # the escaped path); callers pass the decoded path and we re-encode
    # canonically so both sides agree for keys with spaces/unicode.
    from .sigv4 import uri_encode
    out = uri_encode(path or "/", encode_slash=False)
    parts = []
    for k in sorted(query):
        if k not in RESOURCE_LIST:
            continue
        v = query[k][0] if query[k] else ""
        parts.append(f"{k}={v}" if v else k)
    if parts:
        out += "?" + "&".join(parts)
    return out


def canonicalized_amz_headers(headers: dict[str, str]) -> str:
    h: dict[str, str] = {}
    for k, v in headers.items():
        lk = k.lower().strip()
        if lk.startswith("x-amz-"):
            h[lk] = (h[lk] + "," + v.strip()) if lk in h else v.strip()
    return "".join(f"{k}:{h[k]}\n" for k in sorted(h))


def string_to_sign(method: str, path: str, query: dict,
                   headers: dict[str, str], date_value: str) -> str:
    h = {k.lower(): v for k, v in headers.items()}
    return "\n".join([
        method,
        h.get("content-md5", ""),
        h.get("content-type", ""),
        date_value,
    ]) + "\n" + canonicalized_amz_headers(headers) \
        + canonicalized_resource(path, query)


def _sign(secret: str, sts: str) -> str:
    return base64.b64encode(
        hmac.new(secret.encode(), sts.encode(), hashlib.sha1)
        .digest()).decode()


def is_v2_header(auth: str) -> bool:
    return auth.startswith("AWS ") and ":" in auth


def is_v2_presigned(query: dict) -> bool:
    return "AWSAccessKeyId" in query and "Signature" in query


def verify_header_v2(creds_lookup, method: str, path: str, query: dict,
                     headers: dict[str, str]) -> str:
    """Verify `Authorization: AWS AK:Sig`; returns the access key."""
    h = {k.lower(): v for k, v in headers.items()}
    auth = h.get("authorization", "")
    try:
        access_key, got_sig = auth[len("AWS "):].split(":", 1)
    except ValueError:
        raise S3Error("AuthorizationHeaderMalformed") from None
    creds = creds_lookup(access_key)
    if creds is None:
        raise S3Error("InvalidAccessKeyId")
    # x-amz-date wins over Date when present (then Date slot is empty
    # in StringToSign only if x-amz-date is a signed amz header).
    date_value = "" if "x-amz-date" in h else h.get("date", "")
    sts = string_to_sign(method, path, query, headers, date_value)
    want = _sign(creds.secret_key, sts)
    if not hmac.compare_digest(want, got_sig):
        raise S3Error("SignatureDoesNotMatch")
    return access_key


def verify_presigned_v2(creds_lookup, method: str, path: str,
                        query: dict, headers: dict[str, str],
                        now: float | None = None) -> str:
    """?AWSAccessKeyId=..&Expires=..&Signature=.. -> access key."""
    access_key = query.get("AWSAccessKeyId", [""])[0]
    expires = query.get("Expires", [""])[0]
    got_sig = query.get("Signature", [""])[0]
    creds = creds_lookup(access_key)
    if creds is None:
        raise S3Error("InvalidAccessKeyId")
    try:
        exp = int(expires)
    except ValueError:
        raise S3Error("AuthorizationQueryParametersError") from None
    if (now if now is not None else time.time()) > exp:
        raise S3Error("AccessDenied", "presigned URL expired")
    sts = string_to_sign(method, path, query, headers, expires)
    want = _sign(creds.secret_key, sts)
    # S3 V2 signatures arrive URL-encoded in practice; compare decoded
    if not (hmac.compare_digest(want, got_sig)
            or hmac.compare_digest(want,
                                   urllib.parse.unquote(got_sig))):
        raise S3Error("SignatureDoesNotMatch")
    return access_key


# -- client-side helpers (tests/tools) ---------------------------------------

def sign_header_v2(creds, method: str, path: str, query: dict | None,
                   headers: dict[str, str]) -> dict[str, str]:
    query = query or {}
    h = dict(headers)
    if "date" not in {k.lower() for k in h}:
        h["Date"] = time.strftime("%a, %d %b %Y %H:%M:%S GMT",
                                  time.gmtime())
    date_value = "" if any(k.lower() == "x-amz-date" for k in h) \
        else next(v for k, v in h.items() if k.lower() == "date")
    sts = string_to_sign(method, path, query, h, date_value)
    sig = _sign(creds.secret_key, sts)
    h["Authorization"] = f"AWS {creds.access_key}:{sig}"
    return h


def presign_v2(creds, method: str, path: str, expires_in: int = 600,
               query: dict | None = None) -> dict[str, list[str]]:
    q = dict(query or {})
    exp = str(int(time.time()) + expires_in)
    q.setdefault("AWSAccessKeyId", [creds.access_key])
    q["Expires"] = [exp]
    sts = string_to_sign(method, path, q, {}, exp)
    q["Signature"] = [_sign(creds.secret_key, sts)]
    return q
