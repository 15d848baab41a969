"""Object lock (WORM): retention modes and legal hold.

The port's copy of minio_tpu/bucket/object_lock.py (the
cmd/bucket-object-lock.go and internal/bucket/object/lock role): a
bucket whose object-lock config is enabled stores a default retention;
objects carry retention (GOVERNANCE, which a caller with the bypass
header may lift, or COMPLIANCE, immutable until it lapses) and a legal
hold in their metadata, and a client's delete or unversioned overwrite
of a protected version is refused.  The engine's own moves (a drain's
mover, heal) are not clients: they never pass this check.
"""

from __future__ import annotations

import datetime
import xml.etree.ElementTree as ET

RET_MODE_KEY = "x-amz-object-lock-mode"
RET_DATE_KEY = "x-amz-object-lock-retain-until-date"
LEGAL_HOLD_KEY = "x-amz-object-lock-legal-hold"


def parse_lock_config(xml_bytes: bytes) -> dict:
    """ObjectLockConfiguration XML -> {enabled, mode, days/years}."""
    root = ET.fromstring(xml_bytes)
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    out = {"enabled": root.findtext("ObjectLockEnabled") == "Enabled",
           "mode": "", "days": 0, "years": 0}
    rule = root.find("Rule")
    if rule is not None:
        ret = rule.find("DefaultRetention")
        if ret is not None:
            out["mode"] = ret.findtext("Mode") or ""
            out["days"] = int(ret.findtext("Days") or 0)
            out["years"] = int(ret.findtext("Years") or 0)
    return out


def default_retention_metadata(cfg: dict,
                               now: datetime.datetime | None = None) -> dict:
    if not cfg.get("enabled") or not cfg.get("mode"):
        return {}
    now = now or datetime.datetime.now(datetime.timezone.utc)
    days = cfg.get("days", 0) + 365 * cfg.get("years", 0)
    until = now + datetime.timedelta(days=days)
    return {RET_MODE_KEY: cfg["mode"],
            RET_DATE_KEY: until.strftime("%Y-%m-%dT%H:%M:%SZ")}


def _parse_date(s: str) -> datetime.datetime | None:
    try:
        return datetime.datetime.fromisoformat(
            s.replace("Z", "+00:00"))
    except (ValueError, AttributeError):
        return None


def is_retention_active(metadata: dict,
                        now: datetime.datetime | None = None) -> bool:
    mode = metadata.get(RET_MODE_KEY, "")
    if not mode:
        return False
    until = _parse_date(metadata.get(RET_DATE_KEY, ""))
    if until is None:
        return False
    now = now or datetime.datetime.now(datetime.timezone.utc)
    return now < until


def is_legal_hold_on(metadata: dict) -> bool:
    return metadata.get(LEGAL_HOLD_KEY, "").upper() == "ON"


def check_delete_allowed(metadata: dict, *, bypass_governance: bool = False,
                         now: datetime.datetime | None = None) -> str:
    """"" if allowed; else the reason string
    (cf. enforceRetentionForDeletion, cmd/bucket-object-lock.go)."""
    if is_legal_hold_on(metadata):
        return "object is under legal hold"
    if is_retention_active(metadata, now):
        mode = metadata.get(RET_MODE_KEY, "").upper()
        if mode == "COMPLIANCE":
            return "object is WORM protected (compliance mode)"
        if mode == "GOVERNANCE" and not bypass_governance:
            return "object is WORM protected (governance mode)"
    return ""


def retention_xml(metadata: dict) -> bytes:
    root = ET.Element("Retention",
                      xmlns="http://s3.amazonaws.com/doc/2006-03-01/")
    m = ET.SubElement(root, "Mode")
    m.text = metadata.get(RET_MODE_KEY, "")
    d = ET.SubElement(root, "RetainUntilDate")
    d.text = metadata.get(RET_DATE_KEY, "")
    return ET.tostring(root, encoding="unicode").encode()


def parse_retention_xml(body: bytes) -> dict:
    root = ET.fromstring(body)
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    return {RET_MODE_KEY: root.findtext("Mode") or "",
            RET_DATE_KEY: root.findtext("RetainUntilDate") or ""}
