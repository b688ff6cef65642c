"""Process launchers and operator tools: the multi-host engine's
`multihost_engine` (one rank, or a local demo of N ranks) and
`multihost_supervisor`; the single-host engine's `pool_serve` (K engine
processes behind one router) and `ingress_serve` (N ingress processes in
front of one upstream); `scale_curve`, `profile_engine`, `etcd_top` and
`tsan_check`; etcd's own tools `dump_logs` (a data dir's snapshot and
WAL, an engine's WAL, a member's v3 backend) and `functional_tester`
(the chaos harness over member processes); and the card tools
`latency_hops` (the round's propose->commit time against G), `soak`
(seeded fault campaigns), `multihost_bench` (multi-host against
single-host engines) and `frames_kill_loop` (the frames plane's kill
step in a loop, each write's time from the kill to its ack)."""
