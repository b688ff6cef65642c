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
- Both benches end to end at tiny sizes in one environment: each side
  runs every scenario alone, one run after another in one process of
  its own (a lane: the bench's measuring child with
  BENCH_SCENARIO=<scenario> and a budget of its own, `BUDGET_S`), the
  two lanes at once. For every scenario the port's result carries every
  key the JAX bench's carries, the invariants that `chip_smoke.py`'s
  bench phase holds on the card hold on both, no run logs "budget
  exhausted" and each run's line names its scenario. A bench gives each
  scenario of a run a share of one budget and skips the scenarios left
  once it runs out; the serving scenarios' fixed costs (boots, ten-round
  floors, drains) grow with the box's load, so with all ten in one run
  a loaded box skipped the last ones, whatever the budget (150 s, then
  210 s). Alone in its run a scenario has nothing after it to skip. The
  port's bench also runs once as a user runs it, through its parent.
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
        "BENCH_HUB_WATCHERS": "20", "BENCH_SHALLOW_LEG_S": "1"}
# Each scenario's budget (BENCH_BUDGET_S of its own run): its share
# (bench.WEIGHTS) of the 150 s the port's bench had for all ten, but for
# two kinds. Engine's and latency's paced phases fill what they get, and
# their floors (ten saturated rounds, a 5 s paced phase) ack writes at
# 6 s. expiry_wave's wave runs from its keys' expiry (3-8 s after its
# engine's boot) to its deadline: 60 s. At these sizes the others end
# at their own floors (BENCH_ROUNDS, their 15-20 s windows) whatever
# their budgets.
BUDGET_S = {sc: 150 * w for sc, w in bench.WEIGHTS.items()} \
    | {"engine": 6, "latency": 6, "expiry_wave": 60}
# A lane runs one side's bench once for each scenario, one after
# another in one process: the bench's measuring child (`child_main`, as
# BENCH_CHILD=1 runs it) with BENCH_SCENARIO=<scenario> and the
# scenario's own budget, from LANE_BUDGETS. One process a side keeps the
# file's load at two busy cores, as when each bench ran all ten at once,
# and pays each side's imports once. `print` is seen through a hook:
# where the bench's `emit` prints its result line, the hook first prints
# the `results` it was given ("results " and their JSON), as the line
# keeps only the headline columns of its first scenario, here its only
# one.
_LANE = """
import builtins, json, os, sys
{imp} as b


def _print(*args, **kw):
    f = sys._getframe(1)
    if f.f_code.co_name == "emit" and "results" in f.f_locals:
        builtins.print("results " + json.dumps(f.f_locals["results"]),
                       flush=True)
    builtins.print(*args, **kw)


b.print = _print
for sc, budget in json.loads(os.environ["LANE_BUDGETS"]).items():
    os.environ.update(BENCH_SCENARIO=sc, BENCH_BUDGET_S=str(budget))
    rc = b.child_main()
    if rc:
        sys.exit(f"{{sc}}: rc {{rc}}")
"""
_IMPORT = {"jax": "import bench", "port": "from etcd_tpu_torch import bench"}


def _bench_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_") and k != "PYTHONPATH"}
    env.update(TINY, **extra)
    return env


def _start_lane(d, side):
    env = _bench_env(BENCH_CHILD="1", LANE_BUDGETS=json.dumps(
        {sc: BUDGET_S[sc] for sc in bench.ORDER}))
    if side == "jax":
        env["JAX_PLATFORMS"] = "cpu"
    with open(d / f"{side}.out", "w") as o, open(d / f"{side}.err",
                                                  "w") as e:
        return subprocess.Popen(
            [sys.executable, "-c", _LANE.format(imp=_IMPORT[side])],
            cwd=ROOT, env=env, stdout=o, stderr=e)


def _lane_results(d, side, proc):
    """A lane's ({scenario: its result line}, {scenario: its full
    result}, its stderr), once it has run every scenario."""
    rc = proc.wait(timeout=600)
    text = (d / f"{side}.err").read_text()
    assert rc == 0, (side, text[-3000:])
    skipped = [ln for ln in text.splitlines() if "budget exhausted" in ln]
    assert not skipped, (side, skipped)
    lines, results, res = {}, {}, None
    for ln in (d / f"{side}.out").read_text().splitlines():
        if ln.startswith("results "):
            res = json.loads(ln[8:])
        elif ln.startswith("{"):
            line = json.loads(ln)
            sc = line["scenario"]
            assert res is not None and set(res) == {sc}, (side, sc, res)
            lines[sc], results[sc], res = line, res[sc], None
    # The k-th run's line names the k-th scenario asked for.
    assert list(lines) == list(bench.ORDER), (side, list(lines))
    return lines, results, text


def _parent(d):
    """The port's bench as a user runs it (its parent streams the child's
    line), at one scenario: (rc, its standard output)."""
    env = _bench_env(BENCH_SCENARIO="uniform",
                     BENCH_BUDGET_S=str(BUDGET_S["uniform"]))
    res = subprocess.run([sys.executable, "-m", "etcd_tpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=400)
    (d / "parent.err").write_text(res.stderr)
    return res.returncode, res.stdout


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Both sides' lanes at once, then the port's bench through its
    parent once the port's lane is done: {"jax"|"port": ({scenario:
    result line}, {scenario: its full result}, the lane's stderr),
    "parent": (rc, stdout)}."""
    d = tmp_path_factory.mktemp("bench")
    procs = {}
    try:
        for side in ("jax", "port"):
            procs[side] = _start_lane(d, side)
        got = {"port": _lane_results(d, "port", procs["port"])}
        got["parent"] = _parent(d)
        got["jax"] = _lane_results(d, "jax", procs["jax"])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return got


def _scenario(line, results, sc):
    """A scenario's result: the child's full result, whose commits/s its
    line carries as the primary's value."""
    assert line["scenario"] == sc and line["value"] == \
        results[sc]["commits_per_sec"]
    return results[sc]


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
    (jlines, jres, jerr), (plines, pres, perr) = both["jax"], both["port"]
    jline, pline = jlines[sc], plines[sc]
    assert jline["platform"] == pline["platform"] == "cpu"
    assert pline["device"] == "cpu" and pline["power_limit_w"] is None
    assert set(jline) <= set(pline)
    assert jline["metric"] == pline["metric"] \
        == "aggregate_commits_per_sec_64_groups_5_peers"
    j, p = _scenario(jline, jres, sc), _scenario(pline, pres, sc)
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


def test_bench_parent_streams_its_childs_line(both):
    """`python -m etcd_tpu_torch.bench` as a user runs it: the parent
    starts the measuring child, passes the child's result line on to its
    own standard output and exits 0 (the lanes run the measuring child
    directly)."""
    rc, stdout = both["parent"]
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    assert rc == 0 and lines, (rc, stdout[-2000:])
    line = json.loads(lines[-1])
    assert line["scenario"] == "uniform" and line["scenarios"] == {}
    assert line["platform"] == "cpu" and line["value"] > 0


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
