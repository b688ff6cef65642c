"""Process launchers and operator tools: the multi-host engine's
`multihost_engine` (one rank, or a local demo of N ranks) and
`multihost_supervisor`; the single-host engine's `pool_serve` (K engine
processes behind one router) and `ingress_serve` (N ingress processes in
front of one upstream); `scale_curve`, `profile_engine`, `etcd_top` and
`tsan_check`."""
