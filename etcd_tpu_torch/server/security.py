"""v2 auth ("security"): users, roles, and prefix ACLs stored through the
server's own consensus path.

Behavioral equivalent of reference etcdserver/security/security.go +
security_requests.go: state lives in the replicated v2 store under
StorePermsPrefix "/2" (`/2/users/<name>`, `/2/roles/<name>`, `/2/enabled`)
and every mutation is an ordinary consensus write through a `doer`
(security.go:66-68), so auth state is consistent cluster-wide. Root role is
virtual and almighty (security.go:29-37); the guest role governs
unauthenticated access and is auto-created permissive on enable
(security.go:39-46, 368-375); ACLs are glob-free prefix patterns where a
trailing '*' matches any suffix (simpleMatch/prefixMatch
security.go:546-557).

Passwords: the reference uses bcrypt (security.go:170-175). bcrypt isn't in
this environment, so hashes use PBKDF2-HMAC-SHA256 (stdlib) in a tagged
"pbkdf2$<iters>$<salt>$<hex>" format — same role in the design: slow, salted,
one-way.
"""
from __future__ import annotations

import hashlib
import hmac
import json
import logging
import os
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from etcd_tpu_torch import errors
from etcd_tpu_torch.server.request import Request

log = logging.getLogger("security")

STORE_PERMS_PREFIX = "/2"       # reference security.go:21
ROOT_ROLE = "root"
GUEST_ROLE = "guest"

# pbkdf2 is the bcrypt stand-in (no bcrypt in the image); the iteration
# count is tagged into each stored hash so existing hashes keep verifying
# when the default changes. 600k matches current OWASP guidance for
# pbkdf2-sha256; tests override via ETCD_PBKDF2_ITERS to stay fast.
_PBKDF2_ITERS = int(os.environ.get("ETCD_PBKDF2_ITERS", "600000"))


def hash_password(password: str, iters: Optional[int] = None) -> str:
    if iters is None:
        iters = _PBKDF2_ITERS
    salt = os.urandom(16).hex()
    h = hashlib.pbkdf2_hmac("sha256", password.encode(), salt.encode(),
                            iters).hex()
    return f"pbkdf2${iters}${salt}${h}"


# Verification cache: basic-auth re-verifies on EVERY request (the
# reference runs bcrypt per request too, security.go usersEqual), and at
# 600k iterations an uncached check is hundreds of ms of CPU per request
# on a small host. The cache key is itself a SMALL pbkdf2 of
# (stored-hash, password) — ~1k iterations, ~1 ms — NOT a bare sha256:
# a process-memory disclosure of the key must not hand an attacker a
# GPU-speed fingerprint of an in-use password (bare sha256 would undo
# the 600k-iteration hardening by ~10^6x for recently-auth'd accounts).
# Only successful verifications are cached, and a full cache evicts its
# oldest entry: a spray of wrong passwords adds no entry, so it cannot
# flush the legitimate users' entries (each wrong guess still pays the
# full PBKDF2).
_VERIFY_CACHE: dict = {}
_VERIFY_LOCK = threading.Lock()   # handler threads evict and insert
_VERIFY_CACHE_MAX = 1024
_CACHE_KEY_ITERS = 1000


def check_password(stored: str, password: str) -> bool:
    try:
        tag, iters, salt, want = stored.split("$")
        if tag != "pbkdf2":
            return False
        ck = hashlib.pbkdf2_hmac("sha256", password.encode(),
                                 f"cache\x00{stored}".encode(),
                                 _CACHE_KEY_ITERS)
        if ck in _VERIFY_CACHE:
            return True
        got = hashlib.pbkdf2_hmac("sha256", password.encode(), salt.encode(),
                                  int(iters)).hex()
        ok = hmac.compare_digest(got, want)
        if ok:
            with _VERIFY_LOCK:
                if len(_VERIFY_CACHE) >= _VERIFY_CACHE_MAX:
                    _VERIFY_CACHE.pop(next(iter(_VERIFY_CACHE)), None)
                _VERIFY_CACHE[ck] = True
        return ok
    except (ValueError, AttributeError):
        return False


class SecurityError(Exception):
    """reference security.Error — surfaced as HTTP 400/401 by the API."""


def simple_match(pattern: str, key: str) -> bool:
    if pattern.endswith("*"):
        return key.startswith(pattern[:-1])
    return key == pattern


def prefix_match(pattern: str, key: str) -> bool:
    if not pattern.endswith("*"):
        return False
    return key.startswith(pattern[:-1])


@dataclass
class RWPermission:
    read: List[str] = field(default_factory=list)
    write: List[str] = field(default_factory=list)

    @staticmethod
    def from_dict(d: dict) -> "RWPermission":
        return RWPermission(list(d.get("read") or []),
                            list(d.get("write") or []))

    def to_dict(self) -> dict:
        return {"read": sorted(self.read), "write": sorted(self.write)}

    def grant(self, n: "RWPermission") -> "RWPermission":
        read, write = set(self.read), set(self.write)
        for r in n.read:
            if r in read:
                raise SecurityError(
                    f"security-merging: Granting duplicate read permission "
                    f"{r}")
            read.add(r)
        for w in n.write:
            if w in write:
                raise SecurityError(
                    f"security-merging: Granting duplicate write permission "
                    f"{w}")
            write.add(w)
        return RWPermission(sorted(read), sorted(write))

    def revoke(self, n: "RWPermission") -> "RWPermission":
        read, write = set(self.read), set(self.write)
        for r in n.read:
            if r not in read:
                log.info("revoking ungranted read permission %s", r)
                continue
            read.remove(r)
        for w in n.write:
            if w not in write:
                log.info("revoking ungranted write permission %s", w)
                continue
            write.remove(w)
        return RWPermission(sorted(read), sorted(write))

    def has_access(self, key: str, write: bool) -> bool:
        pats = self.write if write else self.read
        return any(simple_match(p, key) for p in pats)

    def has_recursive_access(self, key: str, write: bool) -> bool:
        pats = self.write if write else self.read
        return any(prefix_match(p, key) for p in pats)


@dataclass
class Role:
    role: str
    kv: RWPermission = field(default_factory=RWPermission)

    @staticmethod
    def from_dict(d: dict) -> "Role":
        perms = d.get("permissions") or {}
        return Role(d.get("role", ""),
                    RWPermission.from_dict(perms.get("kv") or {}))

    def to_dict(self) -> dict:
        return {"role": self.role, "permissions": {"kv": self.kv.to_dict()}}

    def merge(self, grant: Optional[dict], revoke: Optional[dict]) -> "Role":
        out = Role(self.role, RWPermission(list(self.kv.read),
                                           list(self.kv.write)))
        if grant is not None:
            out.kv = out.kv.grant(
                RWPermission.from_dict((grant.get("kv") or {})))
        if revoke is not None:
            out.kv = out.kv.revoke(
                RWPermission.from_dict((revoke.get("kv") or {})))
        return out

    def has_key_access(self, key: str, write: bool) -> bool:
        if self.role == ROOT_ROLE:
            return True
        return self.kv.has_access(key, write)

    def has_recursive_access(self, key: str, write: bool) -> bool:
        if self.role == ROOT_ROLE:
            return True
        return self.kv.has_recursive_access(key, write)


ROOT_ROLE_OBJ = Role(ROOT_ROLE, RWPermission(["*"], ["*"]))
GUEST_ROLE_OBJ = Role(GUEST_ROLE, RWPermission(["*"], ["*"]))


@dataclass
class User:
    user: str
    password: str = ""          # stored hashed
    roles: List[str] = field(default_factory=list)

    @staticmethod
    def from_dict(d: dict) -> "User":
        return User(d.get("user", ""), d.get("password", ""),
                    sorted(d.get("roles") or []))

    def to_dict(self, with_password: bool = True) -> dict:
        d = {"user": self.user, "roles": sorted(self.roles)}
        if with_password:
            d["password"] = self.password
        return d

    def merge(self, password: str, grant: List[str],
              revoke: List[str]) -> "User":
        """reference User.Merge security.go:405-430."""
        out = User(self.user, self.password, [])
        if password:
            out.password = hash_password(password)
        roles = set(self.roles)
        for g in grant or []:
            if g in roles:
                log.info("granting duplicate role %s for user %s", g,
                         self.user)
                continue
            roles.add(g)
        for r in revoke or []:
            if r not in roles:
                log.info("revoking ungranted role %s for user %s", r,
                         self.user)
                continue
            roles.remove(r)
        out.roles = sorted(roles)
        return out

    def check_password(self, password: str) -> bool:
        return check_password(self.password, password)


class SecurityStore:
    """Users/roles/enabled flag via the server's consensus path (the `doer`
    seam, reference security.go:66-68, 98-103)."""

    def __init__(self, server) -> None:
        self.server = server
        self._ensured = False

    # -- raw resource plumbing (security_requests.go) -----------------------

    def _do(self, method: str, path: str, val: str = "",
            prev_exist: Optional[bool] = None, dir: bool = False):
        return self.server.do(Request(
            method=method, path=STORE_PERMS_PREFIX + path, val=val, dir=dir,
            prev_exist=prev_exist))

    def _get(self, path: str):
        # Local (non-quorum) read, like the reference's requestResource
        # plain GETs (security_requests.go:86-97): auth state is served from
        # the local replica, so the gate costs no consensus round-trip and
        # keeps working during leader loss.
        return self.server.do(Request(method="GET",
                                      path=STORE_PERMS_PREFIX + path))

    def ensure_dirs(self) -> None:
        """Create /2, /2/users/, /2/roles/, /2/enabled=false once
        (reference ensureSecurityDirectories security_requests.go:28-73)."""
        if self._ensured:
            return
        for res in ("", "/users", "/roles"):
            try:
                self._do("PUT", res or "/", dir=True, prev_exist=False)
            except errors.EtcdError as e:
                if e.code != errors.ECODE_NODE_EXIST:
                    raise
        try:
            self._do("PUT", "/enabled", val="false", prev_exist=False)
        except errors.EtcdError as e:
            if e.code != errors.ECODE_NODE_EXIST:
                raise
        self._ensured = True

    # -- users --------------------------------------------------------------

    def all_users(self) -> List[str]:
        try:
            ev = self._get("/users")
        except errors.EtcdError as e:
            if e.code == errors.ECODE_KEY_NOT_FOUND:
                return []
            raise
        return sorted(n.key.rsplit("/", 1)[-1]
                      for n in (ev.node.nodes or []))

    def get_user(self, name: str) -> User:
        try:
            ev = self._get(f"/users/{name}")
        except errors.EtcdError as e:
            if e.code == errors.ECODE_KEY_NOT_FOUND:
                raise SecurityError(f"User {name} does not exist.")
            raise
        u = User.from_dict(json.loads(ev.node.value))
        if u.user == "root" and ROOT_ROLE not in u.roles:
            # root always carries the root role (security.go:155-157)
            u.roles = sorted(u.roles + [ROOT_ROLE])
        return u

    def create_user(self, name: str, password: str,
                    roles: Optional[List[str]] = None) -> User:
        if not password:
            raise SecurityError(
                f"Cannot create user {name} with an empty password")
        self.ensure_dirs()
        u = User(name, hash_password(password), sorted(roles or []))
        try:
            self._do("PUT", f"/users/{name}",
                     val=json.dumps(u.to_dict()), prev_exist=False)
        except errors.EtcdError as e:
            if e.code == errors.ECODE_NODE_EXIST:
                raise SecurityError(f"User {name} already exists.")
            raise
        log.info("security: created user %s", name)
        return u

    def update_user(self, name: str, password: str = "",
                    grant: Optional[List[str]] = None,
                    revoke: Optional[List[str]] = None) -> User:
        old = self.get_user(name)  # raises if missing
        new = old.merge(password, grant or [], revoke or [])
        if new.to_dict() == old.to_dict():
            if grant or revoke:
                raise SecurityError(
                    "User not updated. Grant/Revoke lists didn't match any "
                    "current roles.")
            raise SecurityError(
                "User not updated. Use Grant/Revoke/Password to update the "
                "user.")
        self._do("PUT", f"/users/{name}", val=json.dumps(new.to_dict()),
                 prev_exist=True)
        log.info("security: updated user %s", name)
        return new

    def create_or_update_user(self, name: str, password: str = "",
                              roles: Optional[List[str]] = None,
                              grant=None, revoke=None) -> Tuple[User, bool]:
        """reference CreateOrUpdateUser security.go:161-169: a fresh user
        takes the literal roles list; an existing one only moves via
        grant/revoke (Roles is nil'd on the update path)."""
        try:
            self.get_user(name)
        except SecurityError:
            return self.create_user(name, password, roles), True
        return self.update_user(name, password, grant, revoke), False

    def delete_user(self, name: str) -> None:
        if self.enabled() and name == "root":
            raise SecurityError(
                "Cannot delete root user while security is enabled.")
        try:
            self._do("DELETE", f"/users/{name}")
        except errors.EtcdError as e:
            if e.code == errors.ECODE_KEY_NOT_FOUND:
                raise SecurityError(f"User {name} doesn't exist.")
            raise
        log.info("security: deleted user %s", name)

    # -- roles --------------------------------------------------------------

    def all_roles(self) -> List[str]:
        names = [GUEST_ROLE, ROOT_ROLE]
        try:
            ev = self._get("/roles")
        except errors.EtcdError as e:
            if e.code == errors.ECODE_KEY_NOT_FOUND:
                return sorted(names)
            raise
        names.extend(n.key.rsplit("/", 1)[-1] for n in (ev.node.nodes or []))
        return sorted(set(names))

    def get_role(self, name: str) -> Role:
        if name == ROOT_ROLE:
            return ROOT_ROLE_OBJ
        try:
            ev = self._get(f"/roles/{name}")
        except errors.EtcdError as e:
            if e.code == errors.ECODE_KEY_NOT_FOUND:
                raise SecurityError(f"Role {name} does not exist.")
            raise
        return Role.from_dict(json.loads(ev.node.value))

    def create_role(self, role: Role) -> None:
        if role.role == ROOT_ROLE:
            raise SecurityError(
                f"Cannot modify role {role.role}: is root role.")
        self.ensure_dirs()
        try:
            self._do("PUT", f"/roles/{role.role}",
                     val=json.dumps(role.to_dict()), prev_exist=False)
        except errors.EtcdError as e:
            if e.code == errors.ECODE_NODE_EXIST:
                raise SecurityError(f"Role {role.role} already exists.")
            raise
        log.info("security: created new role %s", role.role)

    def update_role(self, name: str, grant: Optional[dict],
                    revoke: Optional[dict]) -> Role:
        if name == ROOT_ROLE:
            raise SecurityError(f"Cannot modify role {name}: is root role.")
        old = self.get_role(name)
        new = old.merge(grant, revoke)
        if new.to_dict() == old.to_dict():
            if grant or revoke:
                raise SecurityError(
                    "Role not updated. Grant/Revoke lists didn't match any "
                    "current permissions.")
            raise SecurityError(
                "Role not updated. Use Grant/Revoke to update the role.")
        self._do("PUT", f"/roles/{name}", val=json.dumps(new.to_dict()),
                 prev_exist=True)
        log.info("security: updated role %s", name)
        return new

    def create_or_update_role(self, name: str, permissions: Optional[dict],
                              grant: Optional[dict],
                              revoke: Optional[dict]) -> Tuple[Role, bool]:
        try:
            self.get_role(name)
        except SecurityError:
            r = Role.from_dict({"role": name,
                                "permissions": permissions or {}})
            self.create_role(r)
            return r, True
        return self.update_role(name, grant, revoke), False

    def delete_role(self, name: str) -> None:
        if name == ROOT_ROLE:
            raise SecurityError(
                f"Cannot modify role {name}: is superuser role.")
        try:
            self._do("DELETE", f"/roles/{name}")
        except errors.EtcdError as e:
            if e.code == errors.ECODE_KEY_NOT_FOUND:
                raise SecurityError(f"Role {name} doesn't exist.")
            raise
        log.info("security: deleted role %s", name)

    # -- enable/disable ------------------------------------------------------

    def enabled(self) -> bool:
        try:
            ev = self._get("/enabled")
        except errors.EtcdError as e:
            if e.code == errors.ECODE_KEY_NOT_FOUND:
                return False  # never configured
            raise  # anything else must DENY upstream, not fail open
        return ev.node.value == "true"

    def enable(self) -> None:
        """reference EnableSecurity security.go:358-381: needs a root user;
        auto-creates a permissive guest role if absent."""
        if self.enabled():
            raise SecurityError("already enabled")
        self.ensure_dirs()
        try:
            self.get_user("root")
        except SecurityError:
            raise SecurityError("No root user available, please create one")
        try:
            self.get_role(GUEST_ROLE)
        except SecurityError:
            log.info("security: no guest role access found, creating default")
            self.create_role(GUEST_ROLE_OBJ)
        self._do("PUT", "/enabled", val="true", prev_exist=True)
        log.info("security: enabled security")

    def disable(self) -> None:
        if not self.enabled():
            raise SecurityError("already disabled")
        self._do("PUT", "/enabled", val="false", prev_exist=True)
        log.info("security: disabled security")
