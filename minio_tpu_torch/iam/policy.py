"""Copy of minio_tpu/iam/policy.py: the port keeps its own, so that it imports
nothing of the JAX package.

AWS-style policy documents + evaluation.

The policy-engine role of github.com/minio/pkg/iam/policy in the
reference (used by IAMSys.IsAllowed, cmd/iam.go:206): JSON documents of
Statements with Effect/Action/Resource/Condition, wildcard matching, and
explicit-deny-wins evaluation. Canned policies mirror the reference's
readonly/readwrite/writeonly/diagnostics set.
"""

from __future__ import annotations

import fnmatch
import json


class PolicyError(ValueError):
    pass


def _as_list(v) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _match(pattern: str, value: str) -> bool:
    """AWS wildcard match: * and ? (case-sensitive)."""
    return fnmatch.fnmatchcase(value, pattern)


#: Condition operators the evaluator implements.  Anything else is
#: rejected at parse time: an unknown operator must not silently void a
#: Deny statement (fail-open); the reference's condition parser is
#: equally strict (github.com/minio/pkg/condition newFunctions).
SUPPORTED_CONDITION_OPS = frozenset({
    "StringEquals", "StringNotEquals", "StringLike", "StringNotLike",
    "StringEqualsIgnoreCase", "StringNotEqualsIgnoreCase",
    "IpAddress", "NotIpAddress", "Bool",
    "NumericEquals", "NumericNotEquals",
    "NumericLessThan", "NumericLessThanEquals",
    "NumericGreaterThan", "NumericGreaterThanEquals",
    "DateEquals", "DateNotEquals",
    "DateLessThan", "DateLessThanEquals",
    "DateGreaterThan", "DateGreaterThanEquals",
    "ArnEquals", "ArnNotEquals", "ArnLike", "ArnNotLike",
    "Null",
})


def _base_op(op: str) -> str:
    """Strip the AWS `IfExists` suffix (valid on everything but Null —
    `NullIfExists` is NOT stripped, so it fails the supported-ops check
    at parse time exactly as AWS rejects it)."""
    if op.endswith("IfExists") and op[:-len("IfExists")] != "Null":
        return op[:-len("IfExists")]
    return op


def _compare(suffix: str, got: float, want: list[float]) -> bool:
    """Shared Numeric*/Date* comparison; AWS OR-semantics — the
    condition passes if ANY listed value satisfies the operator."""
    if suffix == "Equals":
        return got in want
    if suffix == "NotEquals":
        return got not in want
    op = {"LessThan": lambda w: got < w,
          "LessThanEquals": lambda w: got <= w,
          "GreaterThan": lambda w: got > w,
          "GreaterThanEquals": lambda w: got >= w}[suffix]
    return any(op(w) for w in want)


def _to_epoch(s: str) -> float:
    """ISO-8601 (or epoch-seconds) condition value -> epoch seconds.
    Timezone-naive timestamps are UTC (AWS semantics), not host-local."""
    import datetime
    try:
        return float(s)
    except ValueError:
        pass
    dt = datetime.datetime.fromisoformat(str(s).replace("Z", "+00:00"))
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return dt.timestamp()


def _parse_principal(v) -> list[str] | None:
    """Principal element -> list of principal patterns, or None if the
    statement carries no Principal (identity-policy style).

    Accepts "*", {"AWS": "*"}, {"AWS": [...]} like the reference's
    policy.Principal (github.com/minio/pkg/iam/policy)."""
    if v is None:
        return None
    if isinstance(v, str):
        return [v]
    if isinstance(v, dict):
        out: list[str] = []
        for k, pv in v.items():
            if k not in ("AWS", "*"):
                raise PolicyError(f"unsupported Principal kind {k!r}")
            out.extend(str(p) for p in _as_list(pv))
        return out
    raise PolicyError("bad Principal element")


class Statement:
    def __init__(self, d: dict):
        self.effect = d.get("Effect", "")
        if self.effect not in ("Allow", "Deny"):
            raise PolicyError(f"bad Effect {self.effect!r}")
        self.actions = [a for a in _as_list(d.get("Action"))]
        self.not_actions = [a for a in _as_list(d.get("NotAction"))]
        self.resources = [r.removeprefix("arn:aws:s3:::")
                          for r in _as_list(d.get("Resource"))]
        self.conditions = d.get("Condition", {}) or {}
        for op, kv in self.conditions.items():
            if _base_op(op) not in SUPPORTED_CONDITION_OPS:
                raise PolicyError(f"unsupported condition operator {op!r}")
            if not isinstance(kv, dict):
                raise PolicyError(f"condition {op!r} must map keys to "
                                  "values")
            for ck, cv in kv.items():
                if not _as_list(cv):
                    raise PolicyError(
                        f"condition {op}/{ck} has no values")
        if "NotPrincipal" in d:
            # NotPrincipal inverts matching in subtle ways; silently
            # ignoring it would mis-scope the statement.
            raise PolicyError("NotPrincipal is not supported")
        self.principals = _parse_principal(d.get("Principal"))
        if not self.actions and not self.not_actions:
            raise PolicyError("statement without Action")

    def matches_action(self, action: str) -> bool:
        if self.not_actions:
            return not any(_match(p, action) for p in self.not_actions)
        return any(_match(p, action) for p in self.actions)

    def matches_resource(self, resource: str) -> bool:
        if not self.resources:
            return True       # bucket-less actions (ListAllMyBuckets)
        return any(_match(p, resource) for p in self.resources)

    def matches_principal(self, principal: str | None) -> bool:
        """principal=None means identity-policy evaluation (the attached
        user IS the principal; a Principal element is ignored there, as
        AWS does).  For resource policies the caller passes "*" for
        anonymous or the requesting access key: anonymous matches ONLY a
        literal "*" entry (cf. the reference requiring AWS:"*" for
        anonymous grants); authenticated principals match "*" or an
        entry naming them."""
        if principal is None:
            return True
        if self.principals is None:
            # Resource policy without Principal: an Allow grants no one,
            # but a Deny must still bind everyone — skipping it would
            # fail OPEN (void a previously-enforced Deny).
            return self.effect == "Deny"
        if principal == "*":
            return "*" in self.principals
        for p in self.principals:
            if p == "*":
                return True
            # accept either a bare access key or an IAM user ARN form
            name = p.rsplit("/", 1)[-1] if p.startswith("arn:") else p
            if _match(name, principal):
                return True
        return False

    def matches_conditions(self, ctx: dict) -> bool:
        """Subset of AWS condition operators over request context keys
        (e.g. {"StringEquals": {"s3:prefix": ["a/"]}})."""
        for op, kv in self.conditions.items():
            if_exists = _base_op(op) != op
            op = _base_op(op)
            # Arn* operators are String*/StringLike over the ARN text
            # (cf. github.com/minio/pkg/condition newFunctions).
            op = {"ArnEquals": "StringEquals",
                  "ArnNotEquals": "StringNotEquals",
                  "ArnLike": "StringLike",
                  "ArnNotLike": "StringNotLike"}.get(op, op)
            for key, want in kv.items():
                got = ctx.get(key)
                want = [str(w) for w in _as_list(want)]
                if got is None and if_exists:
                    continue    # IfExists: absent key passes
                if op == "Null":
                    # "true" ⇒ key must be absent; "false" ⇒ present.
                    want_null = str(want[0]).lower() == "true"
                    if (got is None) != want_null:
                        return False
                elif op == "StringEquals":
                    if got is None or str(got) not in want:
                        return False
                elif op == "StringNotEquals":
                    if got is not None and str(got) in want:
                        return False
                elif op == "StringLike":
                    if got is None or not any(_match(w, str(got))
                                              for w in want):
                        return False
                elif op == "StringNotLike":
                    if got is not None and any(_match(w, str(got))
                                               for w in want):
                        return False
                elif op == "StringEqualsIgnoreCase":
                    if got is None or str(got).lower() not in \
                            [w.lower() for w in want]:
                        return False
                elif op == "StringNotEqualsIgnoreCase":
                    if got is not None and str(got).lower() in \
                            [w.lower() for w in want]:
                        return False
                elif op == "Bool":
                    if got is None or str(got).lower() != \
                            str(want[0]).lower():
                        return False
                elif op.startswith(("Numeric", "Date")):
                    conv = float if op.startswith("Numeric") else \
                        (lambda s: _to_epoch(str(s)))
                    suffix = op.removeprefix("Numeric").removeprefix("Date")
                    if got is None:
                        # AWS negated-operator semantics: an absent key
                        # MATCHES NotEquals (else a Deny written with it
                        # silently stops applying — fail-open).
                        if suffix != "NotEquals":
                            return False
                        continue
                    try:
                        g = conv(got)
                        ws = [conv(w) for w in want]
                    except (TypeError, ValueError):
                        return False
                    if not _compare(suffix, g, ws):
                        return False
                elif op in ("IpAddress", "NotIpAddress"):
                    import ipaddress
                    if got is None:
                        return False
                    try:
                        ip = ipaddress.ip_address(str(got))
                        hit = any(ip in ipaddress.ip_network(w, strict=False)
                                  for w in want)
                    except ValueError:
                        return False
                    if op == "IpAddress" and not hit:
                        return False
                    if op == "NotIpAddress" and hit:
                        return False
                else:
                    # unreachable: parse rejects unsupported operators
                    raise PolicyError(f"unsupported operator {op!r}")
        return True


class Policy:
    def __init__(self, doc: dict | str):
        if isinstance(doc, str):
            doc = json.loads(doc)
        self.version = doc.get("Version", "2012-10-17")
        self.statements = [Statement(s)
                           for s in _as_list(doc.get("Statement"))]
        self.doc = doc

    def is_allowed(self, action: str, resource: str,
                   ctx: dict | None = None,
                   principal: str | None = None) -> bool:
        """Explicit Deny wins; else any Allow; default deny.

        principal: None for identity-policy evaluation; "*" for
        anonymous resource-policy evaluation; else the access key."""
        ctx = ctx or {}
        allowed = False
        for st in self.statements:
            if not (st.matches_action(action)
                    and st.matches_resource(resource)
                    and st.matches_conditions(ctx)
                    and st.matches_principal(principal)):
                continue
            if st.effect == "Deny":
                return False
            allowed = True
        return allowed

    def to_json(self) -> str:
        return json.dumps(self.doc)


def deny_all_policy() -> Policy:
    """Fail-closed stand-in for a stored policy that no longer parses:
    attached identities lose access entirely rather than losing the
    broken policy's Deny statements (dropping a policy wholesale would
    be fail-open for its Denies)."""
    return Policy({"Version": "2012-10-17",
                   "Statement": [{"Effect": "Deny", "Action": ["s3:*"],
                                  "Resource": ["*"]}]})


def merge_allowed(policies: list[Policy], action: str, resource: str,
                  ctx: dict | None = None) -> bool:
    """Multiple attached policies: any explicit deny in any policy wins."""
    ctx = ctx or {}
    allowed = False
    for p in policies:
        for st in p.statements:
            if not (st.matches_action(action)
                    and st.matches_resource(resource)
                    and st.matches_conditions(ctx)):
                continue
            if st.effect == "Deny":
                return False
            allowed = True
    return allowed


# -- canned policies (cf. the reference's built-in policy set) ---------------

READ_WRITE = Policy({
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow", "Action": ["s3:*"],
                   "Resource": ["arn:aws:s3:::*"]}]})

READ_ONLY = Policy({
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow",
                   "Action": ["s3:GetObject", "s3:GetObjectVersion",
                              "s3:ListBucket", "s3:ListBucketVersions",
                              "s3:GetBucketLocation",
                              "s3:ListAllMyBuckets"],
                   "Resource": ["arn:aws:s3:::*"]}]})

WRITE_ONLY = Policy({
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow",
                   "Action": ["s3:PutObject", "s3:DeleteObject",
                              "s3:AbortMultipartUpload",
                              "s3:ListMultipartUploadParts"],
                   "Resource": ["arn:aws:s3:::*"]}]})

CANNED = {"readwrite": READ_WRITE, "readonly": READ_ONLY,
          "writeonly": WRITE_ONLY}
