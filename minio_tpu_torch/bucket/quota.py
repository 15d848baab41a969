"""Bucket quota: hard-limit enforcement at write time.

The port of minio_tpu/bucket/quota.py (the port keeps its own code, so
that it imports nothing of the JAX package), the cmd/bucket-quota.go
equivalent: a JSON config {"quota": N, "quotatype": "hard"} per bucket;
PUTs and multipart completes that would push usage past the limit are
refused. Usage comes from the scanner's last cycle (cheap; it lags by
up to one cycle, as in the JAX package) with a live fallback listing
when no scan has run yet or no scanner is given (the server's
`scanner`: background/scanner.py).

The config also carries an optional "bandwidth" field (bytes/s, 0 =
unlimited) enforced by the QoS plane (server/qos.py) as a per-bucket
token bucket rather than at write time here.
"""

from __future__ import annotations

import json

from ..storage.errors import StorageError


def parse_quota_config(data: bytes) -> dict:
    obj = json.loads(data)
    return {"quota": int(obj.get("quota", 0)),
            "quotatype": obj.get("quotatype", "hard"),
            "bandwidth": int(obj.get("bandwidth", 0))}


def current_bucket_bytes(pools, bucket: str, scanner=None) -> int:
    if scanner is not None:
        usage = scanner.latest_usage()
        if usage is not None and bucket in usage.buckets:
            return usage.buckets[bucket].bytes
    try:
        return sum(fi.size
                   for fi in pools.list_objects(bucket, max_keys=100000))
    except StorageError:
        return 0


def check_quota(pools, bucket: str, incoming_size: int,
                config: dict | None, scanner=None) -> str:
    """"" if allowed, else the refusal reason."""
    if not config or config.get("quota", 0) <= 0:
        return ""
    used = current_bucket_bytes(pools, bucket, scanner)
    if used + incoming_size > config["quota"]:
        return (f"bucket quota exceeded: {used} + {incoming_size} "
                f"> {config['quota']}")
    return ""
