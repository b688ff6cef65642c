"""`fused_hop_share` read the same way, as a per-layer metric of the
cells whose end-to-end metric besides set-up is `acked_writes_per_s`."""
from benchmark.metrics.fused_hop_share import read  # noqa: F401
