"""Server-side encryption: packetized AES-256-GCM streaming AEAD.

The port of minio_tpu/crypto/sse.py (the cmd/encryption-v1.go + DARE
(sio) role): object data is sealed in 64 KiB packets, each AES-GCM under
a per-object data key with a nonce of the packet's counter and an 8-byte
random base, the final packet's counter flagged, so packets cannot be
reordered or truncated unseen.  Three modes, as in the reference:
  - SSE-S3: a data key from the KMS, its sealed form in the metadata,
  - SSE-C: the client sends the 256-bit key with each request (never
    stored, only its MD5); each object seals under a key derived from
    it, a random IV and the object's path,
  - SSE-KMS: SSE-S3 by another name (`aws:kms`).
The metadata keys, the packet framing and the key derivation are the
JAX package's: either package reads what the other sealed, and with the
same random bytes both seal to the same bytes.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import secrets
import struct

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:                       # gated optional dep (see kms)
    AESGCM = None

from .kms import KMS, KMSError, _require_aesgcm

PACKET_SIZE = 64 * 1024

# metadata keys (internal; never returned to clients as-is)
META_ALGO = "x-mtpu-internal-sse-algo"          # "SSE-S3" | "SSE-C"
META_SEALED_KEY = "x-mtpu-internal-sse-sealed-key"
META_KMS_KEY_ID = "x-mtpu-internal-sse-kms-id"
META_KEY_MD5 = "x-mtpu-internal-sse-c-key-md5"
META_SSEC_IV = "x-mtpu-internal-sse-c-iv"
META_ACTUAL_SIZE = "x-mtpu-internal-actual-size"

# request headers
H_SSE = "x-amz-server-side-encryption"
H_SSEC_ALGO = "x-amz-server-side-encryption-customer-algorithm"
H_SSEC_KEY = "x-amz-server-side-encryption-customer-key"
H_SSEC_MD5 = "x-amz-server-side-encryption-customer-key-md5"


class SSEError(Exception):
    pass


def _nonce(base: bytes, seq: int, final: bool) -> bytes:
    # 12-byte nonce: 4-byte packet counter (MSB marks the final packet,
    # preventing truncation) + 8 random base bytes.
    flag = 0x80000000 if final else 0
    return struct.pack(">I", seq | flag) + base


def seal(data: bytes, key: bytes) -> bytes:
    """Plaintext -> [8B nonce-base][packets: 4B len + ct+tag]..."""
    _require_aesgcm()
    aes = AESGCM(key)
    base = secrets.token_bytes(8)
    out = bytearray(base)
    n_packets = max(1, -(-len(data) // PACKET_SIZE))
    for i in range(n_packets):
        chunk = data[i * PACKET_SIZE:(i + 1) * PACKET_SIZE]
        ct = aes.encrypt(_nonce(base, i, i == n_packets - 1), chunk, b"")
        out += struct.pack(">I", len(ct)) + ct
    return bytes(out)


def unseal(blob: bytes, key: bytes) -> bytes:
    _require_aesgcm()
    aes = AESGCM(key)
    if len(blob) < 8:
        raise SSEError("ciphertext too short")
    base = blob[:8]
    pos = 8
    out = bytearray()
    seq = 0
    while pos < len(blob):
        if pos + 4 > len(blob):
            raise SSEError("truncated packet header")
        (clen,) = struct.unpack(">I", blob[pos:pos + 4])
        pos += 4
        ct = blob[pos:pos + clen]
        if len(ct) != clen:
            raise SSEError("truncated packet")
        pos += clen
        final = pos >= len(blob)
        try:
            out += aes.decrypt(_nonce(base, seq, final), ct, b"")
        except Exception:  # noqa: BLE001
            raise SSEError("decryption failed (wrong key or corrupt "
                           "data)") from None
        seq += 1
    return bytes(out)


# -- mode handling -----------------------------------------------------------

def parse_ssec_key(headers: dict) -> bytes | None:
    """Extract + verify an SSE-C customer key from request headers."""
    h = {k.lower(): v for k, v in headers.items()}
    if h.get(H_SSEC_ALGO, "") == "":
        return None
    if h[H_SSEC_ALGO] != "AES256":
        raise SSEError("SSE-C algorithm must be AES256")
    try:
        key = base64.b64decode(h.get(H_SSEC_KEY, ""))
    except ValueError:
        raise SSEError("bad SSE-C key encoding") from None
    if len(key) != 32:
        raise SSEError("SSE-C key must be 256 bits")
    md5 = base64.b64encode(hashlib.md5(key).digest()).decode()
    if h.get(H_SSEC_MD5, "") not in ("", md5):
        raise SSEError("SSE-C key MD5 mismatch")
    return key


def derive_object_key(customer_key: bytes, iv: bytes, bucket: str,
                      object_key: str) -> bytes:
    """Per-object sealing key from the customer key: never seal with the
    raw client key directly — one key reused across many objects with a
    64-bit random nonce base risks GCM nonce reuse.  The reference
    derives a unique ObjectKey per object the same way
    (internal/crypto/key.go GenerateKey: HMAC over a random IV and the
    bucket/object path)."""
    return hmac.new(customer_key,
                    iv + b"\x00" + f"{bucket}/{object_key}".encode(),
                    hashlib.sha256).digest()


def encrypt_for_put(data: bytes, headers: dict, kms: KMS | None,
                    bucket: str = "", object_key: str = ""):
    """-> (stored_bytes, metadata_updates) or (data, {}) when no SSE."""
    h = {k.lower(): v for k, v in headers.items()}
    ssec_key = parse_ssec_key(headers)
    if ssec_key is not None:
        iv = secrets.token_bytes(32)
        obj_key = derive_object_key(ssec_key, iv, bucket, object_key)
        sealed = seal(data, obj_key)
        return sealed, {
            META_ALGO: "SSE-C",
            META_KEY_MD5: base64.b64encode(
                hashlib.md5(ssec_key).digest()).decode(),
            META_SSEC_IV: base64.b64encode(iv).decode(),
            META_ACTUAL_SIZE: str(len(data)),
        }
    if h.get(H_SSE, "") in ("AES256", "aws:kms"):
        if kms is None:
            raise SSEError("SSE-S3 requested but no KMS configured")
        key_id, data_key, sealed_key = kms.generate_data_key()
        sealed = seal(data, data_key)
        return sealed, {
            META_ALGO: "SSE-S3",
            META_KMS_KEY_ID: key_id,
            META_SEALED_KEY: base64.b64encode(sealed_key).decode(),
            META_ACTUAL_SIZE: str(len(data)),
        }
    return data, {}


def decrypt_for_get(stored: bytes, metadata: dict, headers: dict,
                    kms: KMS | None, bucket: str = "",
                    object_key: str = "") -> bytes:
    algo = metadata.get(META_ALGO, "")
    if not algo:
        return stored
    if algo == "SSE-C":
        key = parse_ssec_key(headers)
        if key is None:
            raise SSEError("object is SSE-C encrypted; key required")
        md5 = base64.b64encode(hashlib.md5(key).digest()).decode()
        if md5 != metadata.get(META_KEY_MD5, ""):
            raise SSEError("SSE-C key does not match object key")
        iv_b64 = metadata.get(META_SSEC_IV, "")
        if iv_b64:
            key = derive_object_key(key, base64.b64decode(iv_b64),
                                    bucket, object_key)
        # else: legacy object sealed directly with the customer key
        return unseal(stored, key)
    if algo == "SSE-S3":
        if kms is None:
            raise SSEError("object is KMS encrypted; no KMS configured")
        try:
            data_key = kms.decrypt_data_key(
                metadata.get(META_KMS_KEY_ID, ""),
                base64.b64decode(metadata.get(META_SEALED_KEY, "")))
        except (KMSError, ValueError) as e:
            raise SSEError(str(e)) from None
        return unseal(stored, data_key)
    raise SSEError(f"unknown SSE algorithm {algo!r}")


def response_headers(metadata: dict) -> dict:
    algo = metadata.get(META_ALGO, "")
    if algo == "SSE-C":
        return {H_SSEC_ALGO: "AES256",
                H_SSEC_MD5: metadata.get(META_KEY_MD5, "")}
    if algo == "SSE-S3":
        return {H_SSE: "AES256"}
    return {}


def is_encrypted(metadata: dict) -> bool:
    return bool(metadata.get(META_ALGO))
