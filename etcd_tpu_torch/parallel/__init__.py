"""Device-mesh parallelism and host-to-host transport of the port:
`mesh` (the ("groups", "peers") mesh and the sharded layout), `comm`
(the cross-shard operations of the sharded round, in process or on
torch.distributed) and `frames` (the multi-host engine's frame
transport)."""
