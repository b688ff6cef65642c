"""The slots round split over processes: three gloo CPU processes, one per
peer column, each step its (G, 1) block of the multi-host slots round
(kernel.step_routed_slots_auto with c0 = its rank and a ProcessComm on
torch.distributed) for 30 rounds, with seeded per-slot proposal counts, a
tick on most rounds and 10% message drops. Every column's state and
routed inbox, after every round, must equal that column of the JAX
package's unsharded step_routed_slots_auto on the same inputs: the round
is integer arithmetic, so the tolerance is zero.

Run as a script, this file is one worker process (it imports torch and
the port only)."""
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, P, W, E = 16, 3, 16, 4
ROUNDS = 30


def _inputs():
    rng = np.random.RandomState(11)
    cnt = rng.randint(0, E + 2, (ROUNDS, G, P)).astype(np.int32)
    tick = rng.rand(ROUNDS) < 0.85
    drop = (rng.rand(ROUNDS, G, P, P, 1) >= 0.10).astype(np.int32)
    return cnt, tick, drop


def worker(rank: int, port: int, out_dir: str) -> None:
    """One peer column: step the block with a ProcessComm, save every
    round's block state and inbox."""
    import torch
    import torch.distributed as dist

    from etcd_tpu_torch.ops import kernel, state
    from etcd_tpu_torch.parallel.comm import ProcessComm
    from etcd_tpu_torch.parallel.mesh import state_block

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=P)
    comm = ProcessComm()
    cfg = state.KernelConfig(groups=G, peers=P, window=W, max_ents=E)
    st = state_block(state.init_state(cfg, stagger=True, device="cpu"),
                     0, None, rank, rank + 1)
    inbox = torch.zeros((G, 1, P, cfg.fields), dtype=torch.int32)
    cnt, tick, drop = _inputs()
    saved = {}
    for r in range(ROUNDS):
        st, inbox = kernel.step_routed_slots_auto(
            cfg, st, inbox, torch.from_numpy(cnt[r][:, rank:rank + 1]),
            bool(tick[r]), torch.from_numpy(drop[r][:, rank:rank + 1]), 1,
            c0=rank, comm=comm)
        for k, v in state.state_to_numpy(st).items():
            saved[f"{r}/{k}"] = v
        saved[f"{r}/inbox"] = inbox.numpy()
    np.savez(os.path.join(out_dir, f"col{rank}.npz"), **saved)
    stats = comm.stats.as_dict()
    assert stats["all_to_all"]["calls"] == ROUNDS, stats
    dist.destroy_process_group()


def test_slots_round_over_gloo_processes_equals_jax(tmp_path):
    import jax.numpy as jnp

    from etcd_tpu.ops import kernel as jk
    from etcd_tpu.ops import state as js
    from tests.test_torch_multihost import _free_port

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port),
         str(tmp_path)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(P)]
    outs = [p.communicate(timeout=240)[0].decode(errors="replace")
            for p in procs]
    assert [p.returncode for p in procs] == [0] * P, outs

    cfg = js.KernelConfig(groups=G, peers=P, window=W, max_ents=E)
    st = js.init_state(cfg, stagger=True)
    inbox = jnp.zeros((G, P, P, cfg.fields), jnp.int32)
    cnt, tick, drop = _inputs()
    cols = [np.load(os.path.join(tmp_path, f"col{r}.npz")) for r in range(P)]
    for r in range(ROUNDS):
        st, inbox = jk.step_routed_slots_auto(
            cfg, st, inbox, jnp.asarray(cnt[r]), jnp.asarray(bool(tick[r])),
            jnp.asarray(drop[r]), 1)
        for name in js.GroupState._fields:
            want = np.asarray(getattr(st, name))
            got = np.concatenate([c[f"{r}/{name}"] for c in cols], axis=1)
            assert got.dtype == want.dtype, (r, name)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"round {r}: {name}")
        got = np.concatenate([c[f"{r}/inbox"] for c in cols], axis=1)
        np.testing.assert_array_equal(got, np.asarray(inbox),
                                      err_msg=f"round {r}: routed inbox")
    assert np.asarray(st.commit).max() > 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
