"""tests/test_engine.py::test_engine_chaos_soak_acked_writes_survive on
the port's MultiEngine, on the CPU (`on_the_port(..., cpu=True)`, with
`partition_mask` rebound to its torch version as in
tests/test_torch_engine_ref.py). Random slot partitions every epoch,
writers on every group and two crash-restarts: every acked write must
read back. It has a file of its own because the port's eager rounds on
the CPU take several times JAX's jitted ones, and this schedule runs
thousands of them."""
import test_torch_engine_ref as _ref

test_engine_chaos_soak_acked_writes_survive = \
    _ref._eng.test_engine_chaos_soak_acked_writes_survive
