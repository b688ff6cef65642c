"""The port's WAL and snapshotter (etcd_tpu_torch/wal, etcd_tpu_torch/snap)
under every test of tests/test_wal.py, compiled against the port
(tests/port_tests.py): records, segment cuts, the crc chain, torn tails
and repair, snapshot markers, lock release, snapshot files. The port's
WAL encodes through its C codec (`etcd_tpu_torch.native`), which the
JAX package's tier-1 runs never load. Tolerance: exact, as there."""
from etcd_tpu_torch import native
from port_tests import on_the_port

_wal = on_the_port("test_wal")
globals().update({name: obj for name, obj in vars(_wal).items()
                  if name.startswith(("test_", "Test"))})


def test_the_wal_cases_run_on_the_ports_c_codec():
    assert native.HAVE_NATIVE and native._c_encode is not None
    assert _wal.WAL.__module__ == "etcd_tpu_torch.wal.wal"
