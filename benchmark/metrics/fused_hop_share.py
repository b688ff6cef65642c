"""Percent of the window's hops that ran as the fused quiet-hop passes
(`MultiEngine.phase_s` counts `hop.fused`, `hop.quiet` and `hop.full`,
the advance of ops/kernel.py's `hop_counts`): 100 x fused over all hops.
None where the program counts no hops."""

KINDS = ("fused", "quiet", "full")


def read(obs):
    ph = obs["phase_s"]
    n = {k: ph.get(f"hop.{k}", 0.0) for k in KINDS}
    total = sum(n.values())
    return 100.0 * n["fused"] / total if total else None
