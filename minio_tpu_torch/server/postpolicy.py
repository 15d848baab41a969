"""Copy of minio_tpu/server/postpolicy.py: the port keeps its own, so that it imports
nothing of the JAX package.  One repair: a form part loses exactly the
CRLF that frames it, so a file whose first or last bytes are CR or LF is
stored whole (the JAX module strips every CR and LF at both ends).

Browser POST uploads: multipart/form-data + POST policy.

The cmd/postpolicyform.go + PostPolicyBucketHandler equivalent: an HTML
form POSTs a file with a base64 policy document (expiration + conditions)
signed with SigV4 (signature over the base64 policy itself); the server
checks expiry, condition matches (eq / starts-with / content-length-range)
and the signature before accepting the object.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import json

from .api_errors import S3Error
from .sigv4 import signing_key


def parse_multipart_form(content_type: str,
                         body: bytes) -> dict[str, tuple[bytes, str]]:
    """-> {field_name: (value_bytes, filename)}."""
    if "boundary=" not in content_type:
        raise S3Error("MalformedXML", "missing multipart boundary")
    boundary = content_type.split("boundary=")[1].strip().strip('"')
    delim = b"--" + boundary.encode()
    fields: dict[str, tuple[bytes, str]] = {}
    for part in body.split(delim):
        if part.startswith(b"--"):
            continue                         # the closing delimiter
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part:
            continue
        head, _, value = part.partition(b"\r\n\r\n")
        name, filename = "", ""
        for line in head.split(b"\r\n"):
            low = line.lower()
            if low.startswith(b"content-disposition"):
                for piece in line.decode("utf-8", "replace").split(";"):
                    piece = piece.strip()
                    if piece.startswith("name="):
                        name = piece[5:].strip('"')
                    elif piece.startswith("filename="):
                        filename = piece[9:].strip('"')
        if name:
            fields[name] = (value, filename)
    return fields


def check_post_policy(policy_b64: bytes, fields: dict,
                      file_size: int, bucket: str = "",
                      now: datetime.datetime | None = None) -> None:
    """Validate the policy document against the submitted form fields
    (cf. checkPostPolicy, cmd/postpolicyform.go)."""
    try:
        doc = json.loads(base64.b64decode(policy_b64))
    except (ValueError, TypeError):
        raise S3Error("MalformedXML", "bad policy document") from None
    now = now or datetime.datetime.now(datetime.timezone.utc)
    exp = doc.get("expiration", "")
    try:
        exp_dt = datetime.datetime.fromisoformat(
            exp.replace("Z", "+00:00"))
    except ValueError:
        raise S3Error("MalformedXML", "bad policy expiration") from None
    if now > exp_dt:
        raise S3Error("AccessDenied", "policy has expired")

    def field_value(name: str) -> str:
        if name.lower() == "bucket":
            return bucket                    # from the URL, not the form
        v = fields.get(name.lower())
        return v[0].decode("utf-8", "replace") if v else ""

    for cond in doc.get("conditions", []):
        if isinstance(cond, dict):
            for k, want in cond.items():
                if field_value(k) != str(want):
                    raise S3Error(
                        "AccessDenied",
                        f"policy condition failed: {k} == {want!r}")
        elif isinstance(cond, list) and len(cond) == 3:
            op, key, want = cond
            op = str(op).lower()
            key = str(key).lstrip("$").lower()
            if op == "eq":
                if field_value(key) != str(want):
                    raise S3Error("AccessDenied",
                                  f"policy condition failed: {key}")
            elif op == "starts-with":
                if not field_value(key).startswith(str(want)):
                    raise S3Error("AccessDenied",
                                  f"policy condition failed: {key}")
            elif op == "content-length-range":
                lo, hi = int(key) if isinstance(key, int) else int(cond[1]), \
                    int(cond[2])
                if not lo <= file_size <= hi:
                    raise S3Error("EntityTooLarge"
                                  if file_size > hi else "EntityTooSmall")

    # Every x-amz-* form field the client submitted must be covered by a
    # policy condition — otherwise a signed policy could be replayed with
    # extra metadata the signer never approved (cf. checkPostPolicy,
    # cmd/postpolicyform.go: unknown x-amz-* input rejected).
    declared: set[str] = set()
    for cond in doc.get("conditions", []):
        if isinstance(cond, dict):
            declared.update(k.lower() for k in cond)
        elif isinstance(cond, list) and len(cond) == 3:
            declared.add(str(cond[1]).lstrip("$").lower())
    exempt = {"x-amz-signature", "x-amz-algorithm"}
    for name in fields:
        low = name.lower()
        if low.startswith("x-amz-") and low not in declared \
                and low not in exempt:
            raise S3Error("AccessDenied",
                          f"form field {name} not declared in policy")


def verify_post_signature(creds_lookup, fields: dict) -> str:
    """SigV4 POST signature: HMAC chain over the base64 policy.
    Returns the access key."""
    cred = fields.get("x-amz-credential", (b"",))[0].decode()
    amz_date = fields.get("x-amz-date", (b"",))[0].decode()
    got_sig = fields.get("x-amz-signature", (b"",))[0].decode()
    policy = fields.get("policy", (b"",))[0]
    if not (cred and amz_date and got_sig and policy):
        raise S3Error("AccessDenied", "incomplete POST form")
    access_key, _, scope = cred.partition("/")
    creds = creds_lookup(access_key)
    if creds is None:
        raise S3Error("InvalidAccessKeyId")
    parts = scope.split("/")
    if len(parts) != 4:
        raise S3Error("AuthorizationHeaderMalformed")
    date, region = parts[0], parts[1]
    key = signing_key(creds.secret_key, date, region)
    want = hmac.new(key, policy, hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, got_sig):
        raise S3Error("SignatureDoesNotMatch")
    return access_key


def sign_post_policy(creds, bucket: str, conditions: list,
                     expires_s: int = 3600,
                     now: datetime.datetime | None = None) -> dict[str, str]:
    """Client-side helper: the signed form fields of a POST policy that
    holds `conditions` beside the bucket, credential and date the
    signature needs."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    scope = f"{amz_date[:8]}/{creds.region}/s3/aws4_request"
    credential = f"{creds.access_key}/{scope}"
    exp = (now + datetime.timedelta(seconds=expires_s)).strftime(
        "%Y-%m-%dT%H:%M:%S.000Z")
    doc = {"expiration": exp, "conditions": [
        {"bucket": bucket}, *conditions,
        {"x-amz-credential": credential}, {"x-amz-date": amz_date}]}
    policy = base64.b64encode(json.dumps(doc).encode()).decode()
    sig = hmac.new(signing_key(creds.secret_key, amz_date[:8],
                               creds.region),
                   policy.encode(), hashlib.sha256).hexdigest()
    return {"policy": policy, "x-amz-credential": credential,
            "x-amz-date": amz_date, "x-amz-signature": sig}


def make_post_form(creds, bucket: str, key_prefix: str,
                   expires_s: int = 3600,
                   now: datetime.datetime | None = None) -> dict[str, str]:
    """Client-side helper (tests/tools): form fields for a browser POST."""
    return sign_post_policy(creds, bucket,
                            [["starts-with", "$key", key_prefix]],
                            expires_s, now)
