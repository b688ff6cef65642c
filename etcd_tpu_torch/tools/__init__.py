"""Process launchers of the multi-host engine: `multihost_engine` (one
rank, or a local demo of N ranks) and `multihost_supervisor`."""
