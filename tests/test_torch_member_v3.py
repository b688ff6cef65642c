"""The port's served v3 KV (`/v3/kv/*`, etcd_tpu_torch.etcdhttp.v3 over
server/v3.py and storage/): every test of tests/test_v3_api.py, compiled
against the port (tests/port_tests.py), so its cluster fixture and the
members its tests build are the port's `embed.Etcd`. Tolerance: exact,
as there."""
from port_tests import on_the_port

_v3 = on_the_port("test_v3_api")
cluster = _v3.cluster
globals().update({name: fn for name, fn in vars(_v3).items()
                  if name.startswith("test_")})


def test_the_v3_cases_build_the_ports_members():
    assert _v3.Etcd.__module__ == "etcd_tpu_torch.embed"
    assert len([n for n in vars(_v3) if n.startswith("test_")]) == 27
