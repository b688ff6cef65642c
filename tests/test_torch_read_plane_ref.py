"""tests/test_read_plane.py's cases on the port's MultiEngine, on the CPU
(`on_the_port(..., cpu=True)`): a quorum GET appends nothing to the log
or the WAL, serves what the propose-path QGET serves, sees the reader's
own acked write, and the lease fast path is off by default and still
fresh when on. The file's other two tests
(test_parked_read_fails_on_leadership_loss and
test_engine_stop_fails_parked_reads) are mirrored in
tests/test_torch_engine_crash.py."""
from port_tests import on_the_port

_rp = on_the_port("test_read_plane", cpu=True)

test_quorum_read_appends_nothing = _rp.test_quorum_read_appends_nothing
test_quorum_read_differential_vs_qget = \
    _rp.test_quorum_read_differential_vs_qget
test_quorum_read_sees_own_write = _rp.test_quorum_read_sees_own_write
test_read_lease_off_by_default = _rp.test_read_lease_off_by_default
test_read_lease_fast_path_still_fresh = \
    _rp.test_read_lease_fast_path_still_fresh
