"""Bucket lifecycle (ILM): rule parsing, evaluation and the expiry pass.

The port's copy of minio_tpu/bucket/lifecycle.py (the
internal/bucket/lifecycle and cmd/bucket-lifecycle.go role): XML rules
with prefix and tag filters, current-version Expiration (days or date),
NoncurrentVersionExpiration and AbortIncompleteMultipartUpload, and the
pass the data scanner runs per bucket (background/scanner.py).  Rules
that transition to a tier parse and evaluate here; the scanner hands
them to bucket/tier.py's `run_transitions`, and the expiry pass frees
the tier copy of an expired transitioned version.
"""

from __future__ import annotations

import datetime
import time
import urllib.parse as up
import xml.etree.ElementTree as ET

from ..storage.errors import StorageError
from . import object_lock as ol


def _text(el, tag, default=""):
    if el is None:
        return default
    v = el.findtext(tag)
    return default if v is None else v


class Rule:
    def __init__(self, el: ET.Element):
        self.id = _text(el, "ID")
        self.status = _text(el, "Status", "Enabled")
        flt = el.find("Filter")
        # S3 nests combined prefix+tag filters under <And>; a direct
        # Prefix (or the legacy top-level one) also counts. Missing the
        # And-prefix would silently widen the rule to the whole bucket.
        and_el = flt.find("And") if flt is not None else None
        self.prefix = (_text(flt, "Prefix")
                       or _text(and_el, "Prefix")
                       or _text(el, "Prefix"))
        self.tags: dict[str, str] = {}
        if flt is not None:
            for tag_el in flt.iter("Tag"):
                self.tags[_text(tag_el, "Key")] = _text(tag_el, "Value")
        exp = el.find("Expiration")
        self.expire_days = int(_text(exp, "Days", "0") or 0)
        self.expire_date = _text(exp, "Date")
        self.expire_delete_marker = \
            _text(exp, "ExpiredObjectDeleteMarker") == "true"
        nce = el.find("NoncurrentVersionExpiration")
        self.noncurrent_days = int(_text(nce, "NoncurrentDays", "0") or 0)
        abort = el.find("AbortIncompleteMultipartUpload")
        self.abort_mpu_days = int(_text(abort, "DaysAfterInitiation",
                                        "0") or 0)
        trans = el.find("Transition")
        self.transition_days = int(_text(trans, "Days", "0") or 0)
        self.transition_tier = _text(trans, "StorageClass")

    def matches(self, name: str, tags: dict[str, str]) -> bool:
        if self.status != "Enabled":
            return False
        if self.prefix and not name.startswith(self.prefix):
            return False
        for k, v in self.tags.items():
            if tags.get(k) != v:
                return False
        return True


class Lifecycle:
    def __init__(self, rules: list[Rule]):
        self.rules = rules

    @classmethod
    def parse(cls, xml_bytes: bytes) -> "Lifecycle":
        root = ET.fromstring(xml_bytes)
        # strip namespaces for uniform lookup
        for el in root.iter():
            if "}" in el.tag:
                el.tag = el.tag.split("}", 1)[1]
        return cls([Rule(r) for r in root.iter("Rule")])

    def eval(self, name: str, mod_time_ns: int, *,
             tags: dict[str, str] | None = None,
             is_latest: bool = True, deleted: bool = False,
             now: float | None = None) -> str:
        """-> "" | "expire" | "expire-noncurrent" | "transition:<tier>"
        (cf. lifecycle.Eval / ComputeAction)."""
        now = time.time() if now is None else now
        age_days = (now - mod_time_ns / 1e9) / 86400.0
        for r in self.rules:
            if not r.matches(name, tags or {}):
                continue
            if not is_latest and r.noncurrent_days and \
                    age_days >= r.noncurrent_days:
                return "expire-noncurrent"
            if is_latest and not deleted:
                if r.expire_days and age_days >= r.expire_days:
                    return "expire"
                if r.expire_date:
                    try:
                        d = datetime.datetime.fromisoformat(
                            r.expire_date.replace("Z", "+00:00"))
                        if now >= d.timestamp():
                            return "expire"
                    except ValueError:
                        pass
                if r.transition_tier and r.transition_days and \
                        age_days >= r.transition_days:
                    return f"transition:{r.transition_tier}"
        return ""


def _object_tags(fi) -> dict[str, str]:
    raw = fi.metadata.get("x-amz-tagging", "")
    out = {}
    for pair in raw.split("&"):
        if not pair:
            continue
        k, _, v = pair.partition("=")
        out[up.unquote(k)] = up.unquote(v)
    return out


def apply_lifecycle(pools, bucket: str, lc: Lifecycle,
                    now: float | None = None, tier_mgr=None) -> dict:
    """One expiry pass over a bucket (the expiry worker,
    cmd/bucket-lifecycle.go:213).  Versions under retention or a legal
    hold are skipped (`skipped_locked`), and noncurrent-expiry rules walk
    each key's versions.  Transitions are counted here and moved by the
    tier module (`tier.run_transitions`).

    `tier_mgr`: expiring a transitioned version also frees its tier
    object (the free-version role, cmd/xl-storage-free-version.go); the
    tier journal retries until the remote delete succeeds."""
    stats = {"expired": 0, "expired_noncurrent": 0, "transitioned": 0,
             "skipped_locked": 0}
    try:
        infos = pools.list_objects(bucket, max_keys=1000000)
    except StorageError:
        return stats
    has_noncurrent = any(r.noncurrent_days for r in lc.rules)
    for fi in infos:
        tags = _object_tags(fi)
        action = lc.eval(fi.name, fi.mod_time_ns, tags=tags, now=now)
        if action == "expire":
            if ol.check_delete_allowed(fi.metadata):
                stats["skipped_locked"] += 1
            else:
                try:
                    pools.delete_object(bucket, fi.name)
                    stats["expired"] += 1
                    if tier_mgr is not None:
                        tier_mgr.on_version_deleted(fi)
                except StorageError:
                    pass
        elif action.startswith("transition:"):
            stats["transitioned"] += 1
        if not has_noncurrent:
            continue
        try:
            versions = pools.list_object_versions(bucket, fi.name)
        except StorageError:
            continue
        for v in versions:
            if v.is_latest or not v.version_id:
                continue
            if lc.eval(fi.name, v.mod_time_ns, tags=tags,
                       is_latest=False, now=now) != "expire-noncurrent":
                continue
            if ol.check_delete_allowed(v.metadata):
                stats["skipped_locked"] += 1
                continue
            try:
                pools.delete_object(bucket, fi.name, v.version_id)
                stats["expired_noncurrent"] += 1
                if tier_mgr is not None:
                    tier_mgr.on_version_deleted(v)
            except StorageError:
                pass
    return stats
