"""tests/test_security.py's cases on the port's v2 auth, on the CPU: the
permission algebra of `etcd_tpu_torch/server/security.py` (etcd's
security_test.go) and the live HTTP enforcement over a member of the
port's `embed.Etcd` (etcd's client_security.go handlers), restart
included.

The JAX module runs compiled against the port (tests/port_tests.py,
`on_the_port`), with its `from test_http import ...` taking the port's
copy of tests/test_http.py (`helpers=("test_http",)`), so its `member`
and `base` fixtures build and serve the port's `Etcd`. Its eight tests
and two fixtures are taken into this namespace as they are.

Beyond the rerun: the verify cache keeps a legitimate user's entry
through a spray of wrong passwords. The JAX package's `check_password`
caches failures too and clears the whole cache at 1,024 entries, so
such a spray flushed every user's entry and each of their requests paid
the full PBKDF2 again; the port caches only successes and evicts its
oldest entry when full (tests/test_torch_imports.py pins the departure).
"""
import hashlib

import etcd_tpu_torch.embed as port_embed
import etcd_tpu_torch.server.security as port_security
from port_tests import on_the_port

_sec = on_the_port("test_security", helpers=("test_http",))

member, base = _sec.member, _sec.base
test_password_hash_roundtrip = _sec.test_password_hash_roundtrip
test_simple_and_prefix_match = _sec.test_simple_and_prefix_match
test_grant_revoke = _sec.test_grant_revoke
test_user_merge = _sec.test_user_merge
test_root_role_almighty = _sec.test_root_role_almighty
test_security_lifecycle = _sec.test_security_lifecycle
test_role_crud_and_errors = _sec.test_role_crud_and_errors
test_auth_survives_restart = _sec.test_auth_survives_restart


def test_the_security_reruns_build_the_ports_modules():
    assert _sec.Etcd is port_embed.Etcd
    assert _sec.check_password is port_security.check_password
    assert _sec.User is port_security.User
    assert _sec.free_ports.__module__ == "test_http__on_the_port"


def test_a_password_spray_leaves_a_users_verify_cache_entry(monkeypatch):
    """1,100 wrong passwords against one stored hash (more than the
    cache's 1,024 entries) cache nothing, and the legitimate user's
    cached verification survives them: verifying the right password
    again takes one PBKDF2 call (the cache key), not two."""
    calls = []
    real = hashlib.pbkdf2_hmac

    def counted(*a, **kw):
        calls.append(a[3])
        return real(*a, **kw)

    monkeypatch.setattr(port_security, "_VERIFY_CACHE", {})
    cache = port_security._VERIFY_CACHE
    stored = port_security.hash_password("right")
    assert port_security.check_password(stored, "right")
    assert len(cache) == 1
    spray = port_security._VERIFY_CACHE_MAX + 76
    for i in range(spray):
        assert not port_security.check_password(stored, f"wrong{i}")
    assert len(cache) == 1       # no failure was cached
    monkeypatch.setattr(port_security.hashlib, "pbkdf2_hmac", counted)
    assert port_security.check_password(stored, "right")
    assert calls == [port_security._CACHE_KEY_ITERS]
    assert not port_security.check_password(stored, "wrong0")
    assert len(calls) == 3       # a failure still pays the full PBKDF2


def test_a_full_verify_cache_evicts_its_oldest_entry(monkeypatch):
    """At 1,024 entries a new success evicts one entry, the oldest; the
    rest stay cached."""
    monkeypatch.setattr(port_security, "_VERIFY_CACHE", {})
    monkeypatch.setattr(port_security, "_VERIFY_CACHE_MAX", 4)
    cache = port_security._VERIFY_CACHE
    stored = [port_security.hash_password(f"pw{i}", iters=2)
              for i in range(5)]
    for i in range(4):
        assert port_security.check_password(stored[i], f"pw{i}")
    keys = list(cache)
    assert port_security.check_password(stored[4], "pw4")
    assert len(cache) == 4 and list(cache)[:3] == keys[1:]
