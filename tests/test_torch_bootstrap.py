"""The port's members grown, rebuilt and secured through the port's SDK:
tests/test_bootstrap.py (member add and join, membership validation,
--force-new-cluster, a full member rotation) and tests/test_tls.py
(HTTPS client listeners, mutual-TLS peer links, the SDK with CA pinning,
client-certificate auth), compiled against the port
(tests/port_tests.py), so their members are `etcd_tpu_torch.embed.Etcd`
and their clients `etcd_tpu_torch.client`. Tolerance: exact, as
there."""
from port_tests import on_the_port

_boot = on_the_port("test_bootstrap")
_tls = on_the_port("test_tls")
pki = _tls.pki
globals().update({name: obj for mod in (_boot, _tls)
                  for name, obj in vars(mod).items()
                  if name.startswith("test_")})


def test_the_bootstrap_cases_build_the_ports_modules():
    assert _boot.Etcd.__module__ == "etcd_tpu_torch.embed"
    assert _boot.MembersAPI.__module__ == "etcd_tpu_torch.client.members"
    assert _tls.Client.__module__ == "etcd_tpu_torch.client.client"
    assert _tls.TLSInfo.__module__ == "etcd_tpu_torch.utils.tlsutil"
