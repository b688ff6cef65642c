"""The port's v3 storage (etcd_tpu_torch/storage: revisions, the sqlite
backend, the key index, the MVCC kvstore) and its v0.4 data-dir upgrade
(etcd_tpu_torch/migrate), which every member runs at boot, under the
tests of tests/test_storage_v3.py and tests/test_migrate.py compiled
against the port (tests/port_tests.py); test_migrate.py's standby case
boots the port's proxy from the converted data dir. Tolerance: exact, as
there."""
from port_tests import on_the_port

_v3 = on_the_port("test_storage_v3")
_mig = on_the_port("test_migrate")
kv = _v3.kv
globals().update({name: obj for mod in (_v3, _mig)
                  for name, obj in vars(mod).items()
                  if name.startswith(("test_", "Test"))})


def test_the_storage_cases_build_the_ports_modules():
    assert _v3.KVStore.__module__ == "etcd_tpu_torch.storage.kvstore"
    assert _mig.Etcd.__module__ == "etcd_tpu_torch.embed"
