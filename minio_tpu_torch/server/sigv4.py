"""AWS Signature V4 verification (+ presigned URLs + streaming chunks),
the port's copy of minio_tpu/server/sigv4.py.

Server-side verification equivalent of the reference's
cmd/signature-v4.go:208 (presigned) / :334 (header auth) and the
aws-chunked reader of cmd/streaming-signature-v4.go. Implemented from the
public SigV4 spec; validated by signing requests with our own signer in
tests (the reference does the same — its test harness signs with its own
client code).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse

from ..utils import streams
from .api_errors import S3Error

ALGORITHM = "AWS4-HMAC-SHA256"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
MAX_SKEW = datetime.timedelta(minutes=15)
# Largest accepted aws-chunked chunk: bounds per-connection buffering of
# unverified payload (SDKs emit <=1 MiB chunks).
MAX_CHUNK_SIZE = 16 * 1024 * 1024


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-._~" if encode_slash else "-._~/"
    return urllib.parse.quote(s, safe=safe)


def signing_key(secret: str, date: str, region: str, service: str = "s3") -> bytes:
    k = _hmac(f"AWS4{secret}".encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def canonical_query(query: dict[str, list[str]],
                    drop: tuple[str, ...] = ()) -> str:
    items = []
    for k in sorted(query):
        if k in drop:
            continue
        for v in sorted(query[k]):
            items.append(f"{uri_encode(k)}={uri_encode(v)}")
    return "&".join(items)


def canonical_request(method: str, path: str, query: dict[str, list[str]],
                      headers: dict[str, str], signed_headers: list[str],
                      payload_hash: str, drop_query: tuple[str, ...] = ()) -> str:
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n" for h in signed_headers)
    return "\n".join([
        method,
        uri_encode(path, encode_slash=False) or "/",
        canonical_query(query, drop_query),
        canon_headers,
        ";".join(signed_headers),
        payload_hash,
    ])


def string_to_sign(amz_date: str, scope: str, canon_req: str) -> str:
    return "\n".join([ALGORITHM, amz_date, scope,
                      _sha256(canon_req.encode())])


class Credentials:
    def __init__(self, access_key: str, secret_key: str,
                 region: str = "us-east-1"):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region


def _as_lookup(creds):
    """Accept either a Credentials (single principal) or a callable
    access_key -> Credentials | None (IAM multi-principal)."""
    if callable(creds):
        return creds
    return lambda ak: creds if ak == creds.access_key else None


def _parse_amz_date(s: str) -> datetime.datetime:
    try:
        return datetime.datetime.strptime(s, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=datetime.timezone.utc)
    except ValueError:
        raise S3Error("AuthorizationHeaderMalformed",
                      f"bad x-amz-date {s!r}") from None


def sign_request(creds: Credentials, method: str, path: str,
                 query: dict[str, list[str]], headers: dict[str, str],
                 payload: bytes | str = b"",
                 now: datetime.datetime | None = None) -> dict[str, str]:
    """Client-side signer (tests + internal RPC). Mutates nothing; returns
    the headers to add (Authorization, x-amz-date, x-amz-content-sha256)."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    if isinstance(payload, str):       # pre-computed hash (e.g. streaming)
        payload_hash = payload
    else:
        payload_hash = _sha256(payload)
    h = {k.lower(): v for k, v in headers.items()}
    h["x-amz-date"] = amz_date
    h["x-amz-content-sha256"] = payload_hash
    signed = sorted(set(list(h.keys()) + ["host"]))
    scope = f"{date}/{creds.region}/s3/aws4_request"
    canon = canonical_request(method, path, query, h, signed, payload_hash)
    sts = string_to_sign(amz_date, scope, canon)
    sig = hmac.new(signing_key(creds.secret_key, date, creds.region),
                   sts.encode(), hashlib.sha256).hexdigest()
    auth = (f"{ALGORITHM} Credential={creds.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return {"Authorization": auth, "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_hash}


def _parse_auth_header(auth: str) -> tuple[str, str, list[str], str]:
    """-> (access_key, scope, signed_headers, signature)."""
    if not auth.startswith(ALGORITHM):
        raise S3Error("SignatureDoesNotMatch", "unsupported algorithm")
    fields = {}
    for part in auth[len(ALGORITHM):].split(","):
        k, _, v = part.strip().partition("=")
        fields[k] = v
    try:
        cred = fields["Credential"]
        signed = fields["SignedHeaders"].split(";")
        sig = fields["Signature"]
    except KeyError as e:
        raise S3Error("AuthorizationHeaderMalformed", str(e)) from None
    access_key, _, scope = cred.partition("/")
    return access_key, scope, signed, sig


def verify_header_signature(creds, method: str, path: str,
                            query: dict[str, list[str]],
                            headers: dict[str, str], body: bytes,
                            now: datetime.datetime | None = None
                            ) -> tuple[str, str]:
    """Verify an Authorization-header SigV4 request.

    `creds` is a Credentials or an access_key->Credentials lookup (IAM).
    Returns (payload-hash declaration, access_key) so the caller can pick
    the body-decoding path and authorize the principal.
    cf. doesSignatureMatch, cmd/signature-v4.go:334.
    """
    lookup = _as_lookup(creds)
    h = {k.lower(): v for k, v in headers.items()}
    auth = h.get("authorization", "")
    access_key, scope, signed_headers, got_sig = _parse_auth_header(auth)
    creds = lookup(access_key)
    if creds is None:
        raise S3Error("InvalidAccessKeyId")
    if "host" not in signed_headers:
        raise S3Error("AuthorizationHeaderMalformed", "host not signed")

    amz_date = h.get("x-amz-date") or h.get("date", "")
    ts = _parse_amz_date(amz_date)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    if abs(now - ts) > MAX_SKEW:
        raise S3Error("RequestTimeTooSkewed")

    date = amz_date[:8]
    want_scope = f"{date}/{creds.region}/s3/aws4_request"
    if scope != want_scope:
        raise S3Error("AuthorizationHeaderMalformed",
                      f"scope {scope!r} != {want_scope!r}")

    payload_hash = h.get("x-amz-content-sha256", UNSIGNED_PAYLOAD)
    if payload_hash not in (UNSIGNED_PAYLOAD, STREAMING_PAYLOAD):
        if body is not None and _sha256(body) != payload_hash:
            raise S3Error("XAmzContentSHA256Mismatch")

    canon = canonical_request(method, path, query, h, signed_headers,
                              payload_hash)
    sts = string_to_sign(amz_date, want_scope, canon)
    want = hmac.new(signing_key(creds.secret_key, date, creds.region),
                    sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, got_sig):
        raise S3Error("SignatureDoesNotMatch")
    return payload_hash, access_key


def presign_url(creds: Credentials, method: str, path: str,
                query: dict[str, list[str]], host: str, expires: int = 3600,
                now: datetime.datetime | None = None) -> str:
    """Generate a presigned URL (client side, for tests/tools)."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    scope = f"{date}/{creds.region}/s3/aws4_request"
    q = {k: list(v) for k, v in query.items()}
    q["X-Amz-Algorithm"] = [ALGORITHM]
    q["X-Amz-Credential"] = [f"{creds.access_key}/{scope}"]
    q["X-Amz-Date"] = [amz_date]
    q["X-Amz-Expires"] = [str(expires)]
    q["X-Amz-SignedHeaders"] = ["host"]
    canon = canonical_request(method, path, q, {"host": host}, ["host"],
                              UNSIGNED_PAYLOAD)
    sts = string_to_sign(amz_date, scope, canon)
    sig = hmac.new(signing_key(creds.secret_key, date, creds.region),
                   sts.encode(), hashlib.sha256).hexdigest()
    q["X-Amz-Signature"] = [sig]
    qs = "&".join(f"{uri_encode(k)}={uri_encode(v[0])}" for k, v in q.items())
    return f"{path}?{qs}"


def verify_presigned(creds, method: str, path: str,
                     query: dict[str, list[str]], headers: dict[str, str],
                     now: datetime.datetime | None = None) -> str:
    """Verify a presigned (query-auth) request; returns the access key.
    cf. doesPresignedSignatureMatch, cmd/signature-v4.go:208."""
    lookup = _as_lookup(creds)
    q = {k: list(v) for k, v in query.items()}
    try:
        if q["X-Amz-Algorithm"][0] != ALGORITHM:
            raise S3Error("AuthorizationQueryParametersError")
        cred = q["X-Amz-Credential"][0]
        amz_date = q["X-Amz-Date"][0]
        expires = int(q["X-Amz-Expires"][0])
        signed_headers = q["X-Amz-SignedHeaders"][0].split(";")
        got_sig = q["X-Amz-Signature"][0]
    except (KeyError, IndexError, ValueError):
        raise S3Error("AuthorizationQueryParametersError") from None

    access_key, _, scope = cred.partition("/")
    creds = lookup(access_key)
    if creds is None:
        raise S3Error("InvalidAccessKeyId")
    ts = _parse_amz_date(amz_date)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    if now < ts - MAX_SKEW:
        raise S3Error("RequestTimeTooSkewed")
    if now > ts + datetime.timedelta(seconds=expires):
        raise S3Error("ExpiredToken", "Request has expired")

    date = amz_date[:8]
    want_scope = f"{date}/{creds.region}/s3/aws4_request"
    if scope != want_scope:
        raise S3Error("AuthorizationQueryParametersError")
    h = {k.lower(): v for k, v in headers.items()}
    canon = canonical_request(method, path, q, h, signed_headers,
                              UNSIGNED_PAYLOAD, drop_query=("X-Amz-Signature",))
    sts = string_to_sign(amz_date, want_scope, canon)
    want = hmac.new(signing_key(creds.secret_key, date, creds.region),
                    sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, got_sig):
        raise S3Error("SignatureDoesNotMatch")
    return access_key


# -- aws-chunked streaming payload -------------------------------------------

def decode_streaming_body(creds, headers: dict[str, str],
                          raw: bytes) -> bytes:
    """Decode + verify a STREAMING-AWS4-HMAC-SHA256-PAYLOAD body.

    Chunk framing: hex-size;chunk-signature=<sig>\r\n<data>\r\n ... with a
    rolling signature chain seeded from the request signature
    (cf. cmd/streaming-signature-v4.go).

    Buffered-path wrapper over StreamingSigV4Reader: one parser and one
    verifier for both the buffered and the streamed PUT paths, including
    the MAX_CHUNK_SIZE bound.
    """
    return StreamingSigV4Reader(creds, headers,
                                streams.BytesReader(raw)).read(-1)


#: Largest accepted chunk-header line (hex size + extensions): a header
#: that long is garbage, not framing — bound it so a malformed stream
#: can't make the parser buffer forever hunting for CRLF.
_MAX_CHUNK_HEADER = 16 * 1024


class StreamingSigV4Reader:
    """Streaming decoder+verifier for aws-chunked request bodies — the
    reader counterpart the buffered path also rides, so a signed
    streaming PUT flows to the erasure engine in O(chunk) memory
    (cf. newSignV4ChunkedReader, cmd/streaming-signature-v4.go).

    Each read() parses EVERY complete frame already buffered, hashes
    their payloads with hashlib (the JAX package's MTPU_NATIVE_DIGEST=0
    path), then walks the rolling HMAC chain over the digests.

    Raises S3Error("SignatureDoesNotMatch") on a bad chunk signature,
    S3Error("IncompleteBody") on truncation — at the read() where the
    bad chunk surfaces, before any of its data is returned."""

    def __init__(self, creds, headers: dict[str, str], raw):
        lookup = _as_lookup(creds)
        h = {k.lower(): v for k, v in headers.items()}
        access_key, scope, _, seed_sig = _parse_auth_header(
            h.get("authorization", ""))
        c = lookup(access_key)
        if c is None:
            raise S3Error("InvalidAccessKeyId")
        self._amz_date = h.get("x-amz-date", "")
        self._scope = scope
        region = scope.split("/")[1] if scope.count("/") >= 3 else c.region
        self._key = signing_key(c.secret_key, self._amz_date[:8], region)
        self._prev_sig = seed_sig
        self._raw = raw
        self._buf = bytearray()
        self._out = bytearray()
        self._eof = False
        self._need_crlf = False      # data CRLF still to consume
        self._saw_final = False      # zero-length chunk parsed
        self._empty_hash = _sha256(b"")

    def _fill_some(self) -> bool:
        """Pull one more piece from the raw stream; False at its EOF."""
        piece = self._raw.read(1 << 20)
        if not piece:
            return False
        self._buf += piece
        return True

    def _parse_ready(self) -> list[tuple[bytes, str]]:
        """Consume every complete frame currently buffered.  Framing
        errors raise here; signatures are checked in _verify_frames."""
        frames: list[tuple[bytes, str]] = []
        while not self._saw_final:
            if self._need_crlf:
                if len(self._buf) < 2:
                    break
                # tolerate a missing data CRLF (matches the pre-reader
                # decoder; some clients omit it on the final frame)
                if self._buf[:2] == b"\r\n":
                    del self._buf[:2]
                self._need_crlf = False
            # bounded find: a valid header line is tiny, and an
            # unbounded scan would rescan a partially-buffered chunk's
            # data on every fill (quadratic on large chunks)
            nl = self._buf.find(b"\r\n", 0, _MAX_CHUNK_HEADER + 2)
            if nl < 0:
                if len(self._buf) > _MAX_CHUNK_HEADER:
                    raise S3Error("IncompleteBody", "chunk header too long")
                break
            header = bytes(self._buf[:nl]).decode("ascii", "replace")
            size_hex, _, ext = header.partition(";")
            # strict hex only: int(x, 16) also accepts '-'/'+' signs and
            # '_' separators, and a negative size would slip past the
            # chunk-size/incomplete-frame checks and desync framing
            if not size_hex or any(c not in "0123456789abcdefABCDEF"
                                   for c in size_hex):
                raise S3Error("IncompleteBody", "bad chunk size")
            size = int(size_hex, 16)
            # Bound per-chunk buffering: the declared chunk size is
            # untrusted, and the whole chunk is buffered before its
            # signature verifies — without a cap one authenticated PUT
            # declaring a multi-GiB chunk defeats the O(batch) memory
            # bound (the reference's signV4ChunkedReader hashes into
            # the caller's bounded buffer). AWS SDKs emit <=1 MiB
            # chunks; 16 MiB leaves generous headroom.
            if size > MAX_CHUNK_SIZE:
                raise S3Error("EntityTooLarge",
                              f"chunk of {size} bytes exceeds the "
                              f"{MAX_CHUNK_SIZE}-byte chunk limit")
            if len(self._buf) - (nl + 2) < size:
                break                # frame incomplete; wait for more
            chunk_sig = ""
            if ext.startswith("chunk-signature="):
                chunk_sig = ext[len("chunk-signature="):]
            data = bytes(self._buf[nl + 2:nl + 2 + size])
            del self._buf[:nl + 2 + size]
            self._need_crlf = True
            frames.append((data, chunk_sig))
            if size == 0:
                self._saw_final = True
        return frames

    def _verify_frames(self, frames: list[tuple[bytes, str]]) -> None:
        """Hash every frame payload, then walk the rolling HMAC chain.  A
        mismatch raises before ANY frame of this batch (the bad one or
        later) reaches the output buffer."""
        hashes = [hashlib.sha256(d).digest() for d, _ in frames]
        for (data, sig), dg in zip(frames, hashes):
            sts = "\n".join([
                "AWS4-HMAC-SHA256-PAYLOAD", self._amz_date, self._scope,
                self._prev_sig, self._empty_hash, dg.hex()])
            want = hmac.new(self._key, sts.encode(),
                            hashlib.sha256).hexdigest()
            if not hmac.compare_digest(want, sig):
                raise S3Error("SignatureDoesNotMatch",
                              "chunk signature mismatch")
            self._prev_sig = want
            if data:
                self._out += data
            else:
                self._eof = True     # verified zero-length final chunk

    def read(self, n: int = -1) -> bytes:
        if n < 0 and not self._eof:
            # Drain-all (the buffered PUT path): slurp the source
            # first, then parse and verify every frame in one pass.
            while self._fill_some():
                pass
        while not self._eof and (n < 0 or len(self._out) < n):
            frames = self._parse_ready()
            if frames:
                self._verify_frames(frames)
            elif not self._fill_some():
                raise S3Error("IncompleteBody")
        if n < 0 or n >= len(self._out):
            out = bytes(self._out)
            self._out.clear()
            return out
        out = bytes(self._out[:n])
        del self._out[:n]
        return out


def encode_streaming_body(creds: Credentials, scope: str, amz_date: str,
                          seed_sig: str, payload: bytes,
                          chunk_size: int = 64 * 1024) -> bytes:
    """Client-side aws-chunked encoder (tests)."""
    date = amz_date[:8]
    region = scope.split("/")[1]
    key = signing_key(creds.secret_key, date, region)
    empty_hash = _sha256(b"")
    out = bytearray()
    prev = seed_sig
    chunks = [payload[i:i + chunk_size]
              for i in range(0, len(payload), chunk_size)] + [b""]
    for data in chunks:
        sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev,
                         empty_hash, _sha256(data)])
        sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        out += f"{len(data):x};chunk-signature={sig}\r\n".encode()
        out += data + b"\r\n"
        prev = sig
    return bytes(out)
