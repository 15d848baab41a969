"""Copy of minio_tpu/iam/ldap.py: the port keeps its own, so that it imports
nothing of the JAX package.

LDAP identity provider: the AssumeRoleWithLDAPIdentity backend.

The internal/config/identity/ldap role (cf. cmd/sts-handlers.go LDAP
flow): STS exchanges an LDAP username+password for temporary S3
credentials. The client speaks LDAP v3 on the wire — BER-encoded
Bind/Search/Unbind — using the reference's lookup-bind mode:

  1. bind as the lookup DN (service account),
  2. search the user base for the username -> the user's DN,
  3. bind AS the user with the presented password (the actual
     credential check),
  4. search the group base for groups whose member is the user DN.

Group DNs map to IAM policies via a configured dict (the policy-DB
role). The env has no live directory (zero egress); tests run this
client against an in-process fake LDAP server speaking the same BER
messages — which is exactly how the wire encoding is validated.
"""

from __future__ import annotations

import socket
import threading


class LDAPError(Exception):
    pass


# -- minimal BER (shared with the in-test fake server) ----------------------

def ber_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    while n:
        out.append(n & 0xFF)
        n >>= 8
    return bytes([0x80 | len(out)]) + bytes(reversed(out))


def ber(tag: int, content: bytes) -> bytes:
    return bytes([tag]) + ber_len(len(content)) + content


def ber_int(v: int, tag: int = 0x02) -> bytes:
    out = []
    while True:
        out.append(v & 0xFF)
        v >>= 8
        if v == 0 and not out[-1] & 0x80:
            break
    return ber(tag, bytes(reversed(out)))


def ber_str(s: str, tag: int = 0x04) -> bytes:
    return ber(tag, s.encode())


def ber_parse(buf: bytes, pos: int = 0):
    """-> (tag, content, next_pos)."""
    if pos + 2 > len(buf):
        raise LDAPError("truncated BER element")
    tag = buf[pos]
    ln = buf[pos + 1]
    pos += 2
    if ln & 0x80:
        nb = ln & 0x7F
        ln = int.from_bytes(buf[pos:pos + nb], "big")
        pos += nb
    if pos + ln > len(buf):
        raise LDAPError("truncated BER content")
    return tag, buf[pos:pos + ln], pos + ln


def ber_children(content: bytes) -> list[tuple[int, bytes]]:
    out, pos = [], 0
    while pos < len(content):
        tag, inner, pos = ber_parse(content, pos)
        out.append((tag, inner))
    return out


# LDAP application tags
BIND_REQ, BIND_RESP = 0x60, 0x61
UNBIND_REQ = 0x42
SEARCH_REQ, SEARCH_ENTRY, SEARCH_DONE = 0x63, 0x64, 0x65


class LDAPClient:
    """One connection's worth of LDAP operations."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        if host.startswith("/"):
            self._sock = socket.socket(socket.AF_UNIX)
            self._sock.settimeout(timeout)
            self._sock.connect(host)
        else:
            self._sock = socket.create_connection((host, port),
                                                  timeout=timeout)
            self._sock.settimeout(timeout)
        self._msgid = 0

    def close(self) -> None:
        try:
            self._sock.sendall(ber(0x30, ber_int(self._msgid + 1)
                                   + ber(UNBIND_REQ, b"")))
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def _send(self, op: bytes) -> None:
        self._msgid += 1
        self._sock.sendall(ber(0x30, ber_int(self._msgid) + op))

    def _recv_msg(self) -> tuple[int, bytes]:
        """-> (op tag, op content) of the next LDAPMessage."""
        head = b""
        while len(head) < 2:
            piece = self._sock.recv(2 - len(head))
            if not piece:
                raise LDAPError("connection closed")
            head += piece
        ln = head[1]
        extra = b""
        if ln & 0x80:
            nb = ln & 0x7F
            while len(extra) < nb:
                piece = self._sock.recv(nb - len(extra))
                if not piece:
                    raise LDAPError("connection closed")
                extra += piece
            ln = int.from_bytes(extra, "big")
        body = b""
        while len(body) < ln:
            piece = self._sock.recv(ln - len(body))
            if not piece:
                raise LDAPError("connection closed")
            body += piece
        kids = ber_children(body)
        if len(kids) < 2 or kids[0][0] != 0x02:
            raise LDAPError("malformed LDAPMessage")
        return kids[1][0], kids[1][1]

    def bind(self, dn: str, password: str) -> None:
        """Simple bind; raises LDAPError on non-zero resultCode
        (49 = invalidCredentials)."""
        op = ber(BIND_REQ, ber_int(3) + ber_str(dn)
                 + ber(0x80, password.encode()))
        self._send(op)
        tag, content = self._recv_msg()
        if tag != BIND_RESP:
            raise LDAPError(f"expected BindResponse, got {tag:#x}")
        code = int.from_bytes(ber_children(content)[0][1], "big")
        if code != 0:
            raise LDAPError(f"bind failed for {dn!r} (resultCode {code})")

    def search_eq(self, base: str, attr: str, value: str,
                  want_attrs: list[str]) -> list[tuple[str, dict]]:
        """Subtree search with an equalityMatch filter ->
        [(dn, {attr: [values]})]."""
        filt = ber(0xA3, ber_str(attr) + ber_str(value))
        attrs = ber(0x30, b"".join(ber_str(a) for a in want_attrs))
        op = ber(SEARCH_REQ,
                 ber_str(base) + ber_int(2, 0x0A)      # wholeSubtree
                 + ber_int(0, 0x0A)                    # neverDeref
                 + ber_int(0) + ber_int(0)
                 + ber(0x01, b"\x00")                  # typesOnly false
                 + filt + attrs)
        self._send(op)
        out = []
        while True:
            tag, content = self._recv_msg()
            if tag == SEARCH_DONE:
                code = int.from_bytes(ber_children(content)[0][1], "big")
                if code != 0:
                    raise LDAPError(f"search failed (resultCode {code})")
                return out
            if tag != SEARCH_ENTRY:
                raise LDAPError(f"unexpected op {tag:#x} in search")
            kids = ber_children(content)
            dn = kids[0][1].decode()
            attrs_out: dict[str, list[str]] = {}
            for atag, acontent in ber_children(kids[1][1]):
                akids = ber_children(acontent)
                name = akids[0][1].decode()
                vals = [v.decode() for _, v in ber_children(akids[1][1])]
                attrs_out[name] = vals
            out.append((dn, attrs_out))


class LDAPConfig:
    """Directory + policy-mapping configuration (the
    identity/ldap.Config role)."""

    def __init__(self, *, host: str, port: int = 389,
                 lookup_bind_dn: str, lookup_bind_password: str,
                 user_base_dn: str, user_attr: str = "uid",
                 group_base_dn: str = "", group_member_attr: str = "member",
                 group_policies: dict[str, list[str]] | None = None,
                 timeout: float = 5.0):
        self.host, self.port = host, port
        self.lookup_bind_dn = lookup_bind_dn
        self.lookup_bind_password = lookup_bind_password
        self.user_base_dn = user_base_dn
        self.user_attr = user_attr
        self.group_base_dn = group_base_dn
        self.group_member_attr = group_member_attr
        self.group_policies = group_policies or {}
        self.timeout = timeout
        self._mu = threading.Lock()

    def authenticate(self, username: str, password: str
                     ) -> tuple[str, list[str]]:
        """-> (user DN, policies). Raises LDAPError on bad credentials
        or an unknown user."""
        if not username or not password:
            # an empty password would be an LDAP unauthenticated bind,
            # which SUCCEEDS on most servers — never forward one
            raise LDAPError("username and password required")
        cli = LDAPClient(self.host, self.port, self.timeout)
        try:
            cli.bind(self.lookup_bind_dn, self.lookup_bind_password)
            hits = cli.search_eq(self.user_base_dn, self.user_attr,
                                 username, [self.user_attr])
            if len(hits) != 1:
                raise LDAPError(
                    f"user {username!r}: {len(hits)} directory matches")
            user_dn = hits[0][0]
            cli.bind(user_dn, password)       # the credential check
            groups: list[str] = []
            if self.group_base_dn:
                for dn, _ in cli.search_eq(self.group_base_dn,
                                           self.group_member_attr,
                                           user_dn, ["cn"]):
                    groups.append(dn)
        finally:
            cli.close()
        policies: list[str] = []
        for g in groups:
            policies.extend(self.group_policies.get(g, []))
        return user_dn, sorted(set(policies))
