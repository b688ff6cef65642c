"""The port's bench (`python -m etcd_tpu_torch.bench`) against the JAX
package's `bench.py`, on the CPU.

- The masks and rates: `lag_mask`, `churn_mask` and `zipf_rates` equal a
  mirror of bench.py's closures (its lines 196-226) drawing from one
  `default_rng(0)` in the bench's scenario order (zipf, lag, churn).
- The kernel scenarios' rounds: uniform, lag, churn (7 peers, across a
  churn boundary and the heal) and zipf's admission, N rounds at G=64
  through the JAX `step_routed_auto` and the port's `bench_round` with
  the same masks and proposals; every state field and the bench's
  readback (last_index and commit at the slots, the max commit) equal
  after every round (exact: int32).
- Both benches end to end at tiny sizes in one environment (run at once,
  the JAX bench as its child, the port through its parent): for every
  scenario the port's result carries every key the JAX bench's carries,
  and the invariants that `chip_smoke.py`'s bench phase holds on the card
  hold on both. The JAX bench runs with a larger budget than the port's
  (`JAX_BUDGET_S`), and neither may skip a scenario ("budget
  exhausted").
- Without a card and without BENCH_PLATFORM=cpu the bench exits 1 at
  once and measures nothing (tests/test_torch_imports.py holds its
  message with the other card tools')."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from etcd_tpu.ops import kernel as jk
from etcd_tpu.ops import state as js
from etcd_tpu_torch import bench
from etcd_tpu_torch.ops import state as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the masks and rates ------------------------------------------------------

def _jax_bench_draws(G, P, max_ents, slots, churns):
    """bench.py:196-226 (closures over G, P, cfg.max_ents and one rng),
    called in the JAX bench's scenario order: zipf, lag, then churn
    `churns` times (numpy results of its jnp ones)."""
    rng = np.random.default_rng(0)

    def lag_mask(slots_np):
        lag_groups = rng.choice(G, size=max(1, G // 20), replace=False)
        mask_to = np.ones((G, P, 1, 1), np.int32)
        mask_from = np.ones((G, 1, P, 1), np.int32)
        lag_slot = (slots_np[lag_groups] + 1) % P
        mask_to[lag_groups, lag_slot] = 0
        mask_from[lag_groups, 0, lag_slot] = 0
        return np.asarray(jnp.asarray(mask_to * mask_from)), len(lag_groups)

    def churn_mask(slots_np):
        churned = rng.choice(G, size=max(1, G // 10), replace=False)
        mask_to = np.ones((G, P, 1, 1), np.int32)
        mask_from = np.ones((G, 1, P, 1), np.int32)
        mask_to[churned, slots_np[churned]] = 0
        mask_from[churned, 0, slots_np[churned]] = 0
        return np.asarray(jnp.asarray(mask_to * mask_from)), churned

    def zipf_rates():
        w = 1.0 / np.arange(1, G + 1, dtype=np.float64) ** 1.1
        rng.shuffle(w)
        return w * (G * max_ents) / w.sum()

    return (zipf_rates(), lag_mask(slots),
            [churn_mask(slots) for _ in range(churns)])


@pytest.mark.parametrize("G,P", [(64, 5), (1000, 7), (100_000, 5)])
def test_masks_and_rates_equal_the_jax_bench(G, P):
    slots = np.random.default_rng(G).integers(0, P, G).astype(np.int32)
    want_z, (want_lag, want_n), want_churn = _jax_bench_draws(
        G, P, 4, slots, churns=3)
    rng = np.random.default_rng(0)
    got_z = bench.zipf_rates(rng, G, 4)
    got_lag, got_n = bench.lag_mask(rng, G, P, slots)
    got_churn = [bench.churn_mask(rng, G, P, slots) for _ in range(3)]
    np.testing.assert_array_equal(got_z, want_z)
    np.testing.assert_array_equal(got_lag, want_lag)
    assert got_lag.dtype == want_lag.dtype == np.int32
    assert got_n == want_n == max(1, G // 20)
    for (gm, gc), (wm, wc) in zip(got_churn, want_churn):
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gc, wc)


# -- the kernel scenarios' rounds ---------------------------------------------

G_ROUNDS = 64


def _np_state(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


class _Twin:
    """The JAX round and the port's bench_round stepped on the same
    inputs, held equal after every round."""

    def __init__(self, peers):
        self.cfg = js.KernelConfig(groups=G_ROUNDS, peers=peers, window=16,
                                   max_ents=4, election_tick=10,
                                   heartbeat_tick=3)
        self.tcfg = ts.KernelConfig(*self.cfg)
        G, P, F = G_ROUNDS, peers, self.cfg.fields
        self.st_j = js.init_state(self.cfg, stagger=True)
        self.in_j = jnp.zeros((G, P, P, F), jnp.int32)
        self.st_t = ts.init_state(self.tcfg, stagger=True, device="cpu")
        self.in_t = torch.zeros((G, P, P, F), dtype=torch.int32)
        self.rounds = 0
        self.check("init")
        zero = np.zeros(G, np.int32)
        for _ in range(8):          # bench.py's staggered elections
            self.step(zero, zero)
            if (np.asarray(self.st_j.state) == js.LEADER).any(axis=1).all():
                break
        assert (np.asarray(self.st_j.state) == js.LEADER).any(axis=1).all()

    def slots(self):
        want = (np.asarray(self.st_j.state) == js.LEADER).argmax(
            axis=1).astype(np.int32)
        got = bench.current_slots(self.st_t)
        np.testing.assert_array_equal(got, want)
        return got

    def step(self, props, slots, drop=None):
        """One round on both sides; returns the port's readback
        (last_index, commit at slots; max commit) as numpy."""
        self.st_j, self.in_j = jk.step_routed_auto(
            self.cfg, self.st_j, self.in_j, jnp.asarray(props),
            jnp.asarray(slots), jnp.asarray(True))
        if drop is not None:
            self.in_j = self.in_j * jnp.asarray(drop)
        self.st_t, self.in_t = bench.bench_round(
            self.tcfg, self.st_t, self.in_t, torch.from_numpy(props),
            torch.from_numpy(slots),
            None if drop is None else torch.from_numpy(drop))
        self.rounds += 1
        self.check(f"round {self.rounds}")
        li, ci, cm = (x.numpy() for x in bench.extract(
            self.st_t, torch.from_numpy(slots)))
        g = np.arange(G_ROUNDS)
        li_j = np.asarray(self.st_j.last_index)[g, slots]
        ci_j = np.asarray(self.st_j.commit)[g, slots]
        cm_j = np.asarray(self.st_j.commit).max(axis=1)
        for a, b, what in ((li, li_j, "last_index"), (ci, ci_j, "commit"),
                           (cm, cm_j, "max commit")):
            np.testing.assert_array_equal(a, b, err_msg=f"{self.rounds}: "
                                                        f"{what}")
        return li, ci, cm

    def check(self, where):
        a, b = _np_state(self.st_j), ts.state_to_numpy(self.st_t)
        for name in js.GroupState._fields:
            assert a[name].dtype == b[name].dtype, (where, name)
            np.testing.assert_array_equal(a[name], b[name],
                                          err_msg=f"{where}: {name}")
        np.testing.assert_array_equal(np.asarray(self.in_j),
                                      self.in_t.numpy(),
                                      err_msg=f"{where}: inbox")


def _full(twin):
    return np.full(G_ROUNDS, twin.cfg.max_ents, np.int32)


def test_uniform_rounds_equal_the_jax_round():
    twin = _Twin(5)
    slots = twin.slots()
    cm0 = None
    for _ in range(16):
        _, _, cm = twin.step(_full(twin), slots)
        cm0 = cm if cm0 is None else cm0
    assert (cm > cm0).all()


def test_lag_rounds_equal_the_jax_round():
    twin = _Twin(5)
    slots = twin.slots()
    drop, n = bench.lag_mask(np.random.default_rng(0), G_ROUNDS, 5, slots)
    assert n == G_ROUNDS // 20
    for _ in range(24):
        _, _, cm = twin.step(_full(twin), slots, drop)
    assert (cm > 0).all()


def test_churn_rounds_equal_the_jax_round_across_a_boundary_and_heal():
    """7 peers, the bench's schedule (a partition of 10% of the leaders
    at round 0 of a period, healed at round CHURN_LEN) into the next
    period's partition, then the liveness heal's proposal rounds."""
    twin = _Twin(7)
    rng = np.random.default_rng(0)
    slots = twin.slots()
    drop = None
    churned = set()
    for r in range(bench.CHURN_PERIOD + 5):
        ph = r % bench.CHURN_PERIOD
        if ph == 0:
            drop, c = bench.churn_mask(rng, G_ROUNDS, 7, twin.slots())
            churned |= set(c.tolist())
        elif ph == bench.CHURN_LEN:
            drop = None
        twin.step(_full(twin), slots, drop)
    assert churned
    for _ in range(30):
        twin.step(_full(twin), slots)
    led = (np.asarray(twin.st_j.state) == js.LEADER).any(axis=1)
    assert led.all()


def test_zipf_admission_rounds_equal_the_jax_round():
    """zipf's admission loop: the queue, the staged entries and the
    admitted writes follow the readback, round by round, then the
    proposal-free drain."""
    twin = _Twin(5)
    slots = twin.slots()
    B = bench.ZIPF_BATCH
    EB = twin.cfg.max_ents * B
    zr = bench.zipf_rates(np.random.default_rng(0), G_ROUNDS,
                          twin.cfg.max_ents)
    queue = np.zeros(G_ROUNDS)
    li_prev = np.asarray(twin.st_j.last_index)[np.arange(G_ROUNDS), slots]
    admitted = 0.0
    for _ in range(20):
        queue += zr
        a_w, pc = bench.zipf_staged(queue, B, EB)
        li, _, _ = twin.step(pc, slots)
        adm_w = np.minimum(a_w, (li - li_prev) * B)
        queue -= adm_w
        admitted += adm_w.sum()
        li_prev = li
    for _ in range(6):
        twin.step(np.zeros(G_ROUNDS, np.int32), slots)
    assert admitted > 0


# -- both benches end to end --------------------------------------------------

TINY = {"BENCH_PLATFORM": "cpu", "BENCH_GROUPS": "64", "BENCH_ROUNDS": "12",
        "BENCH_WARM_ROUNDS": "3", "BENCH_ENGINE_GROUPS": "16",
        "BENCH_LAT_GROUPS": "16", "BENCH_QREAD_GROUPS": "16",
        "BENCH_EXPIRY_GROUPS": "16", "BENCH_TTL_KEYS": "4",
        "BENCH_WATCHERS": "200", "BENCH_WATCH_KEYS": "8",
        "BENCH_SHALLOW_CONNS": "40", "BENCH_SHALLOW_TENANTS": "4",
        "BENCH_HUB_WATCHERS": "20", "BENCH_SHALLOW_LEG_S": "1",
        "BENCH_BUDGET_S": "150"}
# The JAX bench's own budget. Its time-boxed scenarios fill their shares
# of the budget while the others have fixed costs that grow with the
# box's load, so under a loaded box 150 s ran out before its last
# scenarios and it skipped them ("budget exhausted"). A larger budget
# gives the tail room; the port's bench keeps TINY's.
JAX_BUDGET_S = "210"


def _bench_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_") and k != "PYTHONPATH"}
    env.update(TINY, **extra)
    return env


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Both benches at once in one environment: {"jax"|"port": (result
    line, stderr)}."""
    d = tmp_path_factory.mktemp("bench")
    runs = {"jax": ([sys.executable, os.path.join(ROOT, "bench.py")],
                    _bench_env(BENCH_CHILD="1", JAX_PLATFORMS="cpu",
                               BENCH_BUDGET_S=JAX_BUDGET_S)),
            "port": ([sys.executable, "-m", "etcd_tpu_torch.bench"],
                     _bench_env())}
    procs = {}
    for name, (cmd, env) in runs.items():
        with open(d / f"{name}.out", "w") as out, \
                open(d / f"{name}.err", "w") as err:
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                           stdout=out, stderr=err)
    got = {}
    try:
        for name, p in procs.items():
            rc = p.wait(timeout=400)
            err = (d / f"{name}.err").read_text()
            assert rc == 0, (name, err[-3000:])
            skipped = [ln for ln in err.splitlines()
                       if "budget exhausted" in ln]
            assert not skipped, (name, skipped)
            lines = [ln for ln in (d / f"{name}.out").read_text()
                     .splitlines() if ln.startswith("{")]
            got[name] = (json.loads(lines[-1]), err)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return got


def _scenario(line, sc):
    """A scenario's result; the primary's is the line itself, its
    commits/s the line's value."""
    if line["scenario"] == sc:
        return dict(line, commits_per_sec=line["value"])
    return line["scenarios"][sc]


def _port_scenario_lines(err):
    return {d["scenario"]: d for d in
            (json.loads(ln.split(bench.SCENARIO_LINE, 1)[1])
             for ln in err.splitlines() if ln.startswith(bench.SCENARIO_LINE))}


def _jax_phase_a_acked(err, sc):
    """The JAX bench's saturated-phase acks of `sc` from its log line
    (it reports no total)."""
    ln = next(ln for ln in err.splitlines() if ln.startswith(f"[{sc}] G="))
    return int(ln.split(": ", 1)[1].split(" acked writes")[0])


@pytest.mark.parametrize("sc", bench.ORDER)
def test_bench_scenario_keys_and_invariants_on_both(both, sc):
    (jline, jerr), (pline, perr) = both["jax"], both["port"]
    assert jline["platform"] == pline["platform"] == "cpu"
    assert pline["device"] == "cpu" and pline["power_limit_w"] is None
    assert set(jline) <= set(pline)
    assert jline["metric"] == pline["metric"] \
        == "aggregate_commits_per_sec_64_groups_5_peers"
    j, p = _scenario(jline, sc), _scenario(pline, sc)
    assert set(j) <= set(p), set(j) - set(p)
    port_lines = _port_scenario_lines(perr)
    assert set(port_lines) == set(bench.ORDER)
    for res in (j, p):
        if sc in ("uniform", "zipf", "lag", "churn"):
            assert res["commits_per_sec"] > 0
        if sc == "lag":
            assert res["lagged_groups"] == 64 // 20
        if sc == "churn":
            assert res["peers"] == 7
            assert res["liveness_floor_ok"] is True
            assert res["groups_with_leader_after_heal"] == 64
        if sc in ("engine", "latency"):
            assert res["groups"] == 16
            assert res["metrics_delta"][
                "etcd_engine_acked_requests_total"] > 0
        if sc == "qread":
            assert res["qread_wal_bytes_delta"] == 0
            assert res["qread_log_delta"] == 0
        if sc == "expiry_wave":
            assert res["unswept_tenants"] == 0 and res["ttl_keys"] == 64
        if sc == "shallow_clients":
            assert res["lost_acked_writes"] == 0
            assert res["hub_deliveries"] == 20 * 8
    if sc in ("engine", "latency"):
        # The port's own count of acks equals the registry's movement;
        # the JAX bench logs only its saturated phase's acks, a part.
        moved = p["metrics_delta"]["etcd_engine_acked_requests_total"]
        assert moved == port_lines[sc]["engine_acked"]
        assert j["metrics_delta"]["etcd_engine_acked_requests_total"] \
            >= _jax_phase_a_acked(jerr, sc)


def test_bench_without_a_card_exits_1_and_measures_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_") and k != "PYTHONPATH"}
    env["TMPDIR"] = str(tmp_path)
    res = subprocess.run([sys.executable, "-m", "etcd_tpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 1, res
    assert res.stdout == ""
    assert "no CUDA device" in res.stderr
    assert "BENCH_PLATFORM=cpu" in res.stderr
    assert "elections converged" not in res.stderr
    assert os.listdir(tmp_path) == []
