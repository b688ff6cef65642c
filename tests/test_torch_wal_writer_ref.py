"""tests/test_wal_writer.py's cases that tests/test_torch_engine_crash.py
does not mirror, on the port on the CPU.

The JAX module runs compiled against the port and bound to the CPU
(tests/port_tests.py, `on_the_port(..., cpu=True)`). Taken into this
namespace as they are:
- the writer layer's unit tests, on the port's `server/walwriter.py`
  and `server/enginewal.py`: a record split over shard streams and
  reassembled, one fsync covering queued rounds, `append_sync` durable
  on return, a cut at a mid-parallel fsync boundary, torn tails
  truncated per stream;
- the engine's `wal_shards`: wal_shards=4 observably identical to the
  single stream after replay (waiter results, stores, event history,
  watch replay), and the pinned geometry (1 -> S once; any other change
  refused).

test_writer_failure_is_fail_stop, test_sigkill_mid_commit_loses_no_
acked_write and test_engine_restart_sharded_wal_with_torn_tails are
mirrored in tests/test_torch_engine_crash.py."""
from etcd_tpu_torch.server import engine as port_engine
from etcd_tpu_torch.server import walwriter as port_walwriter
from port_tests import on_the_port

_ww = on_the_port("test_wal_writer", cpu=True)

test_split_record_partitions_and_reassembles = \
    _ww.test_split_record_partitions_and_reassembles
test_group_commit_one_fsync_covers_queued_rounds = \
    _ww.test_group_commit_one_fsync_covers_queued_rounds
test_append_sync_is_durable_on_return_and_phase_in_writer = \
    _ww.test_append_sync_is_durable_on_return_and_phase_in_writer
test_mid_parallel_fsync_boundary_cut = _ww.test_mid_parallel_fsync_boundary_cut
test_torn_tails_truncate_per_stream = _ww.test_torn_tails_truncate_per_stream
test_differential_wal_shards_1_vs_4 = _ww.test_differential_wal_shards_1_vs_4
test_geometry_pins_wal_shards = _ww.test_geometry_pins_wal_shards


def test_the_wal_writer_reruns_build_the_ports_modules():
    assert _ww.WALWriter is port_walwriter.WALWriter
    assert _ww.split_record is port_walwriter.split_record
    assert _ww.MultiEngine is port_engine.MultiEngine
    assert issubclass(_ww.EngineConfig, port_engine.EngineConfig)
    assert _ww.EngineConfig(groups=1, peers=1,
                            data_dir="unused").device == "cpu"
