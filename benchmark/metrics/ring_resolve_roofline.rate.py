"""`ring_resolve_roofline` read the same way, as a per-layer metric of the cells whose
end-to-end metric besides set-up is `acked_writes_per_s`."""
from benchmark.metrics.ring_resolve_roofline import read  # noqa: F401
