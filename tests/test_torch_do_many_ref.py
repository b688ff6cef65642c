"""tests/test_do_many.py's cases on the port's MultiEngine and tenant
HTTP front, on the CPU (`on_the_port(..., cpu=True)`): do_many refuses
read methods, its WAL replays to exactly what the same writes sent one
by one replay to, each batch slot is authorised under its own
credentials, and the batchframe channel answers bad input with error
frames and refuses a request without Upgrade. The file's other five
tests are mirrored in tests/test_torch_ingress.py."""
from port_tests import on_the_port

_dm = on_the_port("test_do_many", cpu=True)

test_do_many_rejects_read_methods = _dm.test_do_many_rejects_read_methods
test_wal_replay_do_many_matches_singles = \
    _dm.test_wal_replay_do_many_matches_singles
test_batch_per_slot_auth = _dm.test_batch_per_slot_auth
test_batchframe_error_frame_and_handshake_refusals = \
    _dm.test_batchframe_error_frame_and_handshake_refusals
