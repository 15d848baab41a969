"""Copy of minio_tpu/observe/health.py: the port keeps its own, so that it
imports nothing of the JAX package (the rest of observe/ is ROADMAP
Queue A item 10).

Health checks: liveness, readiness, maintenance-aware cluster quorum.

The cmd/healthcheck-handler.go:32 equivalent: /minio/health/live answers
whenever the process serves; /minio/health/cluster checks that every
erasure set still has write quorum (optionally pretending `maintenance`
drives are gone, for safe rolling restarts).
"""

from __future__ import annotations


def cluster_health(pools, maintenance_drives: int = 0) -> tuple[bool, dict]:
    """-> (healthy, detail). Healthy = every set keeps write quorum."""
    detail = {"sets": []}
    healthy = True
    for pi, pool in enumerate(pools.pools):
        for si, es in enumerate(getattr(pool, "sets", [pool])):
            online = sum(
                1 for d in es.drives
                if d is not None and
                (not hasattr(d, "is_online") or d.is_online()))
            required = es.n // 2 + 1
            ok = online - maintenance_drives >= required
            detail["sets"].append({"pool": pi, "set": si,
                                   "online": online, "total": es.n,
                                   "write_quorum": required, "ok": ok})
            healthy = healthy and ok
    return healthy, detail
