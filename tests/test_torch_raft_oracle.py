"""The port's batched round against the port's scalar Raft (the oracle,
etcd_tpu_torch/ops/oracle.py), on the CPU with the plain resolve.

1. The twelve schedules of tests/test_equivalence.py, with the same seeds
   and parameters: the port's `kernel.step` and one port `raft.core.Raft`
   per (group, slot) consume the same faulted inbox, and must agree on
   term, vote, state, lead, commit, last index and the ring's terms after
   every round; `need_host` never fires.
2. One schedule run three ways: the JAX package's `kernel.step`, the
   port's, and the port's scalar Raft, the two kernels' whole states
   equal after every round.
3. `run_sampled`, the chip smoke's driver (faults drawn from a
   torch.Generator, a sample of groups mirrored), at a small width.

Tolerance: exact (int32 state)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from etcd_tpu.ops import kernel as jax_kernel
from etcd_tpu.ops.state import KernelConfig as JaxKernelConfig
from etcd_tpu.ops.state import init_state as jax_init_state
from etcd_tpu_torch.ops import oracle
from etcd_tpu_torch.ops.ring_resolve import TILE_ROWS, ring_resolve_ref
from etcd_tpu_torch.ops.state import KernelConfig

# (id, run_equivalence kwargs): tests/test_equivalence.py's schedules.
SCHEDULES = [
    ("random_1", dict(seed=1)),
    ("random_2", dict(seed=2)),
    ("random_3", dict(seed=3)),
    ("five_peers", dict(seed=7, peers=5, groups=3, rounds=120)),
    ("heavy_loss", dict(seed=11, drop_p=0.45, delay_p=0.2, rounds=160,
                        partition_every=60)),
    ("demoted_leader_commit", dict(seed=304, drop_p=0.45, delay_p=0.2,
                                   rounds=200, partition_every=60)),
    ("seven_peers", dict(seed=402, peers=7, groups=2, rounds=150,
                         drop_p=0.25)),
    ("even_peers", dict(seed=501, peers=4, groups=4, rounds=260,
                        drop_p=0.3, min_live_groups=2)),
    ("two_peers", dict(seed=800, peers=2, groups=6, rounds=160, drop_p=0.3,
                       min_live_groups=4)),
    ("tight_window_pressure", dict(seed=600, window=16, max_ents=4,
                                   prop_p=0.95, rounds=160)),
    ("mixed_ticks", dict(seed=1000, tick_p=0.6, rounds=220)),
    ("padded_slots", dict(seed=900, peers=5, n_peers=3, groups=4,
                          rounds=150)),
]


@pytest.mark.parametrize("kw", [k for _, k in SCHEDULES],
                         ids=[n for n, _ in SCHEDULES])
def test_port_round_equals_the_scalar_raft(kw):
    oracle.run_equivalence(resolve=ring_resolve_ref, device="cpu", **kw)


def test_three_ways_jax_round_port_round_and_scalar_raft():
    """The five-peer schedule: the JAX round steps the same faulted
    inputs as the port's, and every field of the two states is equal
    after every round (the port's is also equal to the scalar Raft)."""
    kw = dict(seed=7, peers=5, groups=3, rounds=120)
    jcfg = JaxKernelConfig(groups=3, peers=5, window=32, max_ents=3)
    jst = [jax_init_state(jcfg)]
    seen = []

    def on_round(i, faulted, pc, ps, tick, st):
        jst[0], _ = jax_kernel.step(jcfg, jst[0], jnp.asarray(faulted),
                                    jnp.asarray(pc), jnp.asarray(ps),
                                    jnp.asarray(tick))
        for f in st._fields:
            want = np.asarray(getattr(jst[0], f))
            got = getattr(st, f).numpy()
            if f == "prng":
                got = got.astype(np.uint32)
            np.testing.assert_array_equal(got, want, err_msg=f"{i}: {f}")
        seen.append(i)

    oracle.run_equivalence(resolve=ring_resolve_ref, on_round=on_round,
                            device="cpu", **kw)
    assert seen == list(range(120))


def test_sample_holds_the_edge_groups():
    """The sample holds group 0, the last group and groups whose rows
    straddle a tile edge of ring_resolve's launch plan."""
    G, P = 100_000, 5
    s = oracle.sample_groups(G, P)
    assert len(s) >= 128 and s == sorted(set(s))
    assert s[0] == 0 and s[-1] == G - 1
    straddling = [g for g in s
                  if (g * P) // TILE_ROWS != (g * P + P - 1) // TILE_ROWS]
    assert len(straddling) >= 100
    assert straddling[0] < G // 100 and straddling[-1] > G - G // 100


def test_sampled_driver_on_the_cpu():
    """The smoke's driver at G=300 (1,500 rows: four of its five tile
    edges fall inside a group): the tight-window schedule with a twin on
    the plain resolve. One intra-op thread: at this size torch's thread
    pool only contends with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = KernelConfig(groups=300, peers=5, window=16, max_ents=4)
        out = oracle.run_sampled(cfg, seed=1234, rounds=50, drop_p=0.2,
                                 delay_p=0.1, prop_p=0.95, device="cpu",
                                 twin_resolve=ring_resolve_ref)
    finally:
        torch.set_num_threads(threads)
    assert out["rounds"] == 50 and out["sampled_groups"] == 128
    assert out["groups_committed"] > 150
    assert out["twin"] == "ring_resolve_ref"
