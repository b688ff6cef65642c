"""The port's served v3 KV (`/v3/kv/*`, etcd_tpu_torch.etcdhttp.v3 over
server/v3.py and storage/): every test of tests/test_v3_api.py, compiled
against the port (tests/port_tests.py), so its cluster fixture and the
members its tests build are the port's `embed.Etcd`. Tolerance: exact,
as there; test_lease_expiry_deletes_keys is a hand mirror (below)."""
import time

from port_tests import on_the_port

_v3 = on_the_port("test_v3_api")
cluster = _v3.cluster
globals().update({name: fn for name, fn in vars(_v3).items()
                  if name.startswith("test_")
                  and name != "test_lease_expiry_deletes_keys"})


def test_the_v3_cases_build_the_ports_members():
    assert _v3.Etcd.__module__ == "etcd_tpu_torch.embed"
    assert len([n for n in vars(_v3) if n.startswith("test_")]) == 27


def test_lease_expiry_deletes_keys(cluster):
    """Mirror of the JAX test of this name: the leader's tick monitor
    revokes an expired lease through consensus and its key goes on every
    member. The reference, once a linearizable range through member 0
    sees the key gone, reads each member at once with a serializable
    range, which that member serves from its own store before it need
    have applied the revoke (tests/test_torch_bootstrap.py::
    test_a_follower_serves_a_plain_read_from_its_own_store). Here each
    member's serializable range must show the key gone once it has
    applied the revoke (polled, 10 s), and a linearizable range through
    it at once after."""
    v3, e, lease_call = _v3.v3, _v3.e, _v3.lease_call
    st, _, b = lease_call(cluster, "grant", {"ttl": 1})
    lid = b["lease_id"]
    v3(cluster, "put", {"key": e("expire/me"), "value": e("x")})
    st, _, b = lease_call(cluster, "attach", {"lease_id": lid,
                                              "key": e("expire/me")})
    assert st == 200
    deadline = time.time() + 15
    while time.time() < deadline:
        st, _, b = v3(cluster, "range", {"key": e("expire/me")})
        if b["count"] == 0:
            break
        time.sleep(0.2)
    assert b["count"] == 0, "lease expiry never deleted the key"
    for m in range(3):
        deadline = time.monotonic() + 10
        while True:
            st, _, b = v3(cluster, "range", {"key": e("expire/me"),
                                             "serializable": True}, member=m)
            assert st == 200, (st, b)
            if b["count"] == 0 or time.monotonic() >= deadline:
                break
            time.sleep(0.05)
        assert b["count"] == 0, f"member {m} still has the key"
        st, _, b = v3(cluster, "range", {"key": e("expire/me")}, member=m)
        assert st == 200 and b["count"] == 0, (m, st, b)
