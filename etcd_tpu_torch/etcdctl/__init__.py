"""etcdctl — the command-line client (reference etcdctl/)."""
