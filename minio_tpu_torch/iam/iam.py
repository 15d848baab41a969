"""IAMSys: users, groups, service accounts, policy attachment, STS creds.

The port of minio_tpu/iam/iam.py (the cmd/iam.go:206 role with the
object-store backend, cmd/iam-object-store.go): identities and policy
docs persist as objects under the internal meta bucket
(`.mtpu.sys/config/iam/...`), at the JAX package's paths and in its
bytes, are loaded into in-memory maps at startup, and every mutation
writes through.  Each write is a small inline PUT and each load one GET
per identity, so both run through the erasure engine on the card.
Peer nodes would get a `reload` ping via a notification system; the
port has none yet (`notify=None` makes it a no-op).

Credential kinds (all verified by SigV4 or SigV2 with their own secret):
  - root: bypasses policy,
  - static user: policies from user + group attachments,
  - service account: inherits its parent user's policies,
  - STS/temporary: policies fixed at AssumeRole time, expiring.
"""

from __future__ import annotations

import json
import secrets
import threading
import time
from dataclasses import dataclass, field

from ..bucket.metadata import META_BUCKET
from ..storage.errors import StorageError
from . import policy as pol

_LOGGER = None


def _logger():
    """The IAM plane's logger (observe/logger.py), made on first use."""
    global _LOGGER
    if _LOGGER is None:
        from ..observe.logger import Logger
        _LOGGER = Logger()
    return _LOGGER


IAM_PREFIX = "config/iam"


@dataclass
class Identity:
    access_key: str
    secret_key: str
    kind: str = "user"                 # user | service | sts | root
    status: str = "enabled"
    parent: str = ""                   # service/sts: owning user
    policies: list[str] = field(default_factory=list)
    groups: list[str] = field(default_factory=list)
    session_token: str = ""
    expiration: float = 0.0            # sts only (epoch seconds)
    inline_policy: str = ""            # sts session policy (INTERSECTS)

    def expired(self) -> bool:
        return self.expiration > 0 and time.time() > self.expiration


class IAMSys:
    def __init__(self, pools, notify=None):
        self.pools = pools
        self.notify = notify           # NotificationSys | None
        self._mu = threading.RLock()
        self._users: dict[str, Identity] = {}
        self._groups: dict[str, dict] = {}     # name -> {members, policies}
        self._policies: dict[str, pol.Policy] = dict(pol.CANNED)
        self._sts: dict[str, Identity] = {}
        # STS inline session policies live OUTSIDE _policies so a
        # load()/reload can't strand active temporary credentials.
        self._sts_policies: dict[str, pol.Policy] = {}
        self.load()

    # -- persistence ---------------------------------------------------------

    def _put(self, path: str, obj) -> None:
        self.pools.put_object(META_BUCKET, f"{IAM_PREFIX}/{path}",
                              json.dumps(obj).encode())

    def _del(self, path: str) -> None:
        try:
            self.pools.delete_object(META_BUCKET,
                                     f"{IAM_PREFIX}/{path}")
        except StorageError:
            pass

    def load(self) -> None:
        """(Re)load all identities/groups/policies from the store."""
        with self._mu:
            users, groups, policies = {}, {}, dict(pol.CANNED)
            try:
                entries = self.pools.list_objects(
                    META_BUCKET, prefix=f"{IAM_PREFIX}/")
            except StorageError:
                entries = []
            for fi in entries:
                rel = fi.name[len(IAM_PREFIX) + 1:]
                try:
                    _, data = self.pools.get_object(META_BUCKET,
                                                    fi.name)
                    obj = json.loads(data)
                except (StorageError, ValueError):
                    continue
                if rel.startswith("users/"):
                    ident = Identity(**obj)
                    users[ident.access_key] = ident
                elif rel.startswith("groups/"):
                    groups[rel[len("groups/"):-len(".json")]] = obj
                elif rel.startswith("policies/"):
                    name = rel[len("policies/"):-len(".json")]
                    try:
                        policies[name] = pol.Policy(obj)
                    except pol.PolicyError as e:
                        # An unloadable policy must not silently vanish:
                        # dropping it voids its Deny statements
                        # (fail-open). Degrade to deny-all so attached
                        # identities fail closed, and say so (deduped —
                        # this loop re-runs on every reload).
                        _logger().log_once(
                            "error",
                            f"IAM: policy {name!r} failed to parse "
                            f"({e}); degrading it to deny-all for "
                            f"attached identities",
                            key=f"iam-bad-policy:{name}")
                        policies[name] = pol.deny_all_policy()
                        continue
            self._users, self._groups, self._policies = \
                users, groups, policies

    def _broadcast_reload(self) -> None:
        if self.notify is not None:
            self.notify.reload_subsystem("iam")

    # -- user management (cf. cmd/admin-handlers-users.go) ------------------

    def add_user(self, access_key: str, secret_key: str,
                 policies: list[str] | None = None,
                 status: str = "enabled") -> Identity:
        if len(access_key) < 3 or len(secret_key) < 8:
            raise ValueError("access key >= 3 chars, secret >= 8 chars")
        ident = Identity(access_key=access_key, secret_key=secret_key,
                         policies=list(policies or []), status=status)
        with self._mu:
            self._users[access_key] = ident
        self._put(f"users/{access_key}.json", ident.__dict__)
        self._broadcast_reload()
        return ident

    def remove_user(self, access_key: str) -> None:
        with self._mu:
            self._users.pop(access_key, None)
            # drop dependent service accounts + group memberships
            for ak, ident in list(self._users.items()):
                if ident.parent == access_key:
                    del self._users[ak]
                    self._del(f"users/{ak}.json")
            for g in self._groups.values():
                if access_key in g.get("members", []):
                    g["members"].remove(access_key)
        self._del(f"users/{access_key}.json")
        self._broadcast_reload()

    def set_user_status(self, access_key: str, status: str) -> None:
        with self._mu:
            ident = self._users[access_key]
            ident.status = status
        self._put(f"users/{access_key}.json", ident.__dict__)
        self._broadcast_reload()

    def add_service_account(self, parent: str,
                            policies: list[str] | None = None,
                            access_key: str = "",
                            secret_key: str = "") -> Identity:
        """Create a service account under `parent`. Explicit credentials
        are the site-replication import path (a mirrored svc account
        must keep its keys, cf. PeerSvcAccChangeHandler,
        cmd/site-replication.go:991); omitted -> minted fresh."""
        with self._mu:
            if parent not in self._users:
                raise KeyError(f"no such user {parent}")
        ident = Identity(
            access_key=access_key or f"svc-{secrets.token_hex(8)}",
            secret_key=secret_key or secrets.token_urlsafe(24),
            kind="service", parent=parent, policies=list(policies or []))
        with self._mu:
            self._users[ident.access_key] = ident
        self._put(f"users/{ident.access_key}.json", ident.__dict__)
        self._broadcast_reload()
        return ident

    # -- groups --------------------------------------------------------------

    def add_group(self, name: str, members: list[str],
                  policies: list[str] | None = None) -> None:
        with self._mu:
            g = self._groups.setdefault(name,
                                        {"members": [], "policies": []})
            g["members"] = sorted(set(g["members"]) | set(members))
            if policies is not None:
                g["policies"] = list(policies)
            for m in members:
                u = self._users.get(m)
                if u is not None and name not in u.groups:
                    u.groups.append(name)
                    self._put(f"users/{m}.json", u.__dict__)
        self._put(f"groups/{name}.json", g)
        self._broadcast_reload()

    def remove_group_members(self, name: str,
                             members: list[str]) -> None:
        with self._mu:
            g = self._groups.get(name)
            if g is None:
                raise KeyError(name)
            g["members"] = sorted(set(g["members"]) - set(members))
            for m in members:
                u = self._users.get(m)
                if u is not None and name in u.groups:
                    u.groups.remove(name)
                    self._put(f"users/{m}.json", u.__dict__)
        self._put(f"groups/{name}.json", g)
        self._broadcast_reload()

    def remove_group(self, name: str) -> None:
        """Delete a group; refuses while it still has members
        (cf. RemoveGroup, cmd/admin-handlers-users.go)."""
        with self._mu:
            g = self._groups.get(name)
            if g is None:
                raise KeyError(name)
            if g["members"]:
                raise ValueError(f"group {name!r} is not empty")
            del self._groups[name]
        self._del(f"groups/{name}.json")
        self._broadcast_reload()

    def set_group_policy(self, name: str, policies: list[str]) -> None:
        with self._mu:
            g = self._groups.get(name)
            if g is None:
                raise KeyError(name)
            g["policies"] = list(policies)
        self._put(f"groups/{name}.json", g)
        self._broadcast_reload()

    def list_groups(self) -> list[str]:
        with self._mu:
            return sorted(self._groups)

    def group_info(self, name: str) -> dict:
        with self._mu:
            g = self._groups.get(name)
            if g is None:
                raise KeyError(name)
            return {"name": name, "members": list(g["members"]),
                    "policies": list(g["policies"])}

    # -- policies ------------------------------------------------------------

    def set_policy(self, name: str, doc: dict | str) -> None:
        p = pol.Policy(doc)
        with self._mu:
            self._policies[name] = p
        self._put(f"policies/{name}.json", p.doc)
        self._broadcast_reload()

    def remove_policy(self, name: str) -> None:
        if name in pol.CANNED:
            # Built-ins always reappear on reload; refusing beats a
            # deletion that silently reverts (the reference also
            # refuses, cmd/admin-handlers-users.go RemoveCannedPolicy).
            raise ValueError(f"cannot delete built-in policy {name!r}")
        with self._mu:
            if name not in self._policies:
                raise KeyError(name)
            del self._policies[name]
        self._del(f"policies/{name}.json")
        self._broadcast_reload()

    def list_policies(self) -> list[str]:
        with self._mu:
            return sorted(self._policies)

    def get_policy_doc(self, name: str) -> dict:
        # _policies is seeded with the canned set at load(), so one
        # lookup covers both built-in and stored policies.
        with self._mu:
            p = self._policies.get(name)
        if p is None:
            raise KeyError(name)
        return p.doc

    def attach_policy(self, access_key: str, names: list[str]) -> None:
        with self._mu:
            ident = self._users[access_key]
            ident.policies = sorted(set(ident.policies) | set(names))
        self._put(f"users/{access_key}.json", ident.__dict__)
        self._broadcast_reload()

    def list_service_accounts(self, parent: str = "",
                              include_secrets: bool = False
                              ) -> list[dict]:
        """Service accounts (optionally for one parent) with their
        policies. Secrets stay OUT of the listing unless the caller is
        an in-process replicator — the admin API must never hand a
        list-level grant every credential in the cluster (the
        reference's ListServiceAccounts omits secrets too)."""
        with self._mu:
            out = []
            for u in sorted(self._users.values(),
                            key=lambda x: x.access_key):
                if u.kind != "service" or (parent
                                           and u.parent != parent):
                    continue
                d = {"accessKey": u.access_key, "parent": u.parent,
                     "policies": list(u.policies)}
                if include_secrets:
                    d["secretKey"] = u.secret_key
                out.append(d)
            return out

    def list_users(self) -> list[str]:
        with self._mu:
            return sorted(ak for ak, u in self._users.items()
                          if u.kind == "user")

    # -- STS -----------------------------------------------------------------

    def assume_role(self, parent_ident: Identity,
                    duration_s: int = 3600,
                    policy_doc: dict | None = None) -> Identity:
        """Temporary credentials inheriting (or restricting) the parent's
        permissions (cf. AssumeRole, cmd/sts-handlers.go:99)."""
        duration_s = max(900, min(duration_s, 7 * 24 * 3600))
        parent_policies = list(parent_ident.policies)
        if parent_ident.kind == "root" and not parent_policies:
            parent_policies = ["readwrite"]
        ident = Identity(
            access_key=f"sts-{secrets.token_hex(8)}",
            secret_key=secrets.token_urlsafe(24),
            kind="sts", parent=parent_ident.access_key,
            policies=parent_policies,
            groups=list(parent_ident.groups),
            session_token=secrets.token_urlsafe(32),
            expiration=time.time() + duration_s)
        if policy_doc is not None:
            # AWS semantics: a session policy can only RESTRICT — the
            # effective permission is parent ∩ inline (never replaces).
            name = f"sts-inline-{ident.access_key}"
            with self._mu:
                self._sts_policies[name] = pol.Policy(policy_doc)
            ident.inline_policy = name
        with self._mu:
            self._sts[ident.access_key] = ident
        return ident

    # -- auth resolution -----------------------------------------------------

    def lookup(self, access_key: str) -> Identity | None:
        with self._mu:
            ident = self._users.get(access_key) or \
                self._sts.get(access_key)
            if ident is None:
                return None
            if ident.kind == "sts" and ident.expired():
                del self._sts[access_key]
                return None
            if ident.status != "enabled":
                return None
            return ident

    def policies_for(self, ident: Identity) -> list[pol.Policy]:
        with self._mu:
            names = list(ident.policies)
            if ident.kind == "service" and not names:
                parent = self._users.get(ident.parent)
                if parent is not None:
                    names = list(parent.policies)
                    for g in (parent.groups if parent else []):
                        names += self._groups.get(g, {}).get("policies", [])
            for g in ident.groups:
                names += self._groups.get(g, {}).get("policies", [])
            return [self._policies[n] for n in names
                    if n in self._policies]

    def is_allowed(self, ident: Identity, action: str, resource: str,
                   ctx: dict | None = None) -> bool:
        """cf. IAMSys.IsAllowed, cmd/iam.go."""
        if ident.kind == "root":
            return True
        base = pol.merge_allowed(self.policies_for(ident), action,
                                 resource, ctx)
        if ident.kind == "sts" and ident.inline_policy:
            with self._mu:
                inline = self._sts_policies.get(ident.inline_policy)
            if inline is None:
                return False                 # fail closed
            return base and inline.is_allowed(action, resource, ctx)
        return base
