"""The port's multi-host engine on the frames data plane
(etcd_tpu_torch.server.hostengine, device="cpu"), in process.

The first three tests mirror tests/test_frames_plane.py against the
port: hosts fail independently, a host that lost its disk rejoins behind
the supervisor's term floor, and a partitioned pair leaves every group
serving through the connected majority.

Two differentials hold the port against the JAX package's HostEngine:

- a mixed cluster: two JAX engines and one port engine exchange real
  frames (the frame protocol is host code both packages share verbatim);
  every write acked by any rank reads back from every rank, and after
  convergence the ranks' store dumps are equal;
- data dirs: a rank's dir written by one package restores in the other
  (geometry.json, the WAL and checkpoints), with the same keys, terms,
  votes, commits and log rings.

The JAX package's chaos soak (marked slow there) is not mirrored."""
import json
import os
import shutil
import time

import numpy as np
import pytest

from etcd_tpu.server import hostengine as jhe
from etcd_tpu.tools.functional_tester import _free_ports
from etcd_tpu_torch import errors
from etcd_tpu_torch.server import hostengine as the
from etcd_tpu_torch.server.request import Request
from etcd_tpu_torch.tools import multihost_supervisor

G = 6
N = 3


def _kw(rank, ports, data, **kw):
    kw.setdefault("fsync", False)
    return dict(
        groups=G, peers=N,
        data_dir=os.path.join(data, f"host{rank}"),
        host_id=rank,
        frame_listen=("127.0.0.1", ports[rank]),
        frame_peers={h: ("127.0.0.1", ports[h]) for h in range(N)},
        window=8, max_ents=2, stagger=True,
        round_interval=0.005, request_timeout=6.0,
        data_plane="frames", **kw)


def _mk(rank, ports, data, **kw):
    """A port engine on the CPU."""
    return the.HostEngine(the.HostEngineConfig(
        **_kw(rank, ports, data, **kw), device="cpu"))


def _mk_jax(rank, ports, data, **kw):
    """A JAX package engine (JAX_PLATFORMS=cpu)."""
    return jhe.HostEngine(jhe.HostEngineConfig(**_kw(rank, ports, data,
                                                     **kw)))


def _put(eng, g, key, val, timeout=6.0):
    return eng.do(g, Request(method="PUT", path=key, val=val),
                  timeout=timeout)


def _put_retry(eng, g, key, val, deadline, tag=""):
    """Client-style retry loop; returns the first-ack wall time."""
    while time.time() < deadline:
        try:
            _put(eng, g, key, val, timeout=2.0)
            return time.time()
        except errors.EtcdError:
            time.sleep(0.05)
        except Exception as e:  # noqa: BLE001 — the JAX engine's errors
            if type(e).__name__ != "EtcdError":
                raise
            time.sleep(0.05)
    raise AssertionError(f"write {key} ({tag}) never acked")


def _wait_all_leaders(engines, timeout=90.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(any(e.leader_slot(g) >= 0 for e in engines)
               for g in range(G)):
            return
        time.sleep(0.05)
    raise AssertionError("elections did not converge")


def _value(eng, g, key):
    """The value of `key` in eng's store of group g, or None."""
    try:
        return eng.store(g).get(key, False, False).node.value
    except Exception as e:  # noqa: BLE001 — key not applied here yet
        if type(e).__name__ != "EtcdError":
            raise
        return None


def _wait_values(engines, want, timeout=120.0):
    """Every (g, key) -> value of `want` readable from every engine."""
    deadline = time.time() + timeout
    left = {(i, g, k) for i in range(len(engines)) for g, k in want}
    while left and time.time() < deadline:
        for i, g, k in list(left):
            if _value(engines[i], g, k) == want[(g, k)]:
                left.discard((i, g, k))
        if left:
            time.sleep(0.2)
    assert not left, f"{len(left)} (rank, group, key) never converged: " \
                     f"{sorted(left)[:6]}"


def _stop_all(engines):
    for e in engines:
        try:
            e.stop()
        except Exception:  # noqa: BLE001
            pass


def test_survives_host_death_and_rejoin(tmp_path):
    ports = _free_ports(N)
    engines = [_mk(r, ports, str(tmp_path)) for r in range(N)]
    for e in engines:
        e.start()
    try:
        _wait_all_leaders(engines)
        for g in range(G):
            _put_retry(engines[g % N], g, f"/1/base{g}", "v0",
                       time.time() + 60, "baseline")

        # SIGKILL analogue: hard-stop host 2 (round loop + transport).
        victim = engines[2]
        victim.stop()
        t_kill = time.time()

        # Survivors keep (or resume) acking every group — including the
        # groups host 2 led — with the victim still absent.
        worst_gap = 0.0
        for g in range(G):
            t_ack = _put_retry(engines[g % 2], g, f"/1/degraded{g}", "v1",
                               t_kill + 60, "degraded")
            worst_gap = max(worst_gap, t_ack - t_kill)
        assert worst_gap < 30.0, worst_gap

        # Rejoin: restart host 2 on its own data dir; it catches up and
        # serves the writes it missed from its own store.
        engines[2] = _mk(2, ports, str(tmp_path))
        engines[2].start()
        _wait_values([engines[2]], {(g, f"/1/degraded{g}"): "v1"
                                    for g in range(G)}, timeout=90)
        assert all(engines[2].store(g).get(f"/1/base{g}", False, False)
                   .node.value == "v0" for g in range(G))
    finally:
        _stop_all(engines)


def test_disk_loss_rejoin_with_term_floor(tmp_path):
    """Host death with disk loss, survivors never stop: the respawned
    host boots from an empty dir fenced by the port supervisor's term
    floor (prepare_dirs) and catches up through snapshot installs —
    entries pushed beyond the ring window rule out append repair."""
    ports = _free_ports(N)
    engines = [_mk(r, ports, str(tmp_path), fsync=True) for r in range(N)]
    for e in engines:
        e.start()
    try:
        _wait_all_leaders(engines)
        for g in range(G):
            _put_retry(engines[0], g, f"/1/seed{g}", "s",
                       time.time() + 60, "seed")

        engines[2].stop()
        t_kill = time.time()
        shutil.rmtree(os.path.join(str(tmp_path), "host2"))

        W = 8
        for i in range(W + 4):
            for g in range(G):
                _put_retry(engines[i % 2], g, f"/1/deep{g}_{i}", "d",
                           t_kill + 120, "deep")

        sup = multihost_supervisor.Supervisor(
            N, G, str(tmp_path), os.path.join(str(tmp_path), "s.json"),
            stall_s=5.0, poll_s=0.5)
        sup.prepare_dirs()
        floor_path = os.path.join(str(tmp_path), "host2", "term_floor.json")
        with open(floor_path) as f:
            floor = np.asarray(json.load(f)["term"])
        assert floor.shape == (G,) and (floor >= 1).all()

        engines[2] = _mk(2, ports, str(tmp_path), fsync=True)
        assert (engines[2].l_term >= floor).all()
        engines[2].start()
        _wait_values([engines[2]], {(g, f"/1/deep{g}_{W + 3}"): "d"
                                    for g in range(G)}, timeout=120)
        assert engines[2].snaps_installed >= G, engines[2].snaps_installed
        for g in range(G):
            _put_retry(engines[2], g, f"/1/fresh{g}", "f",
                       time.time() + 60, "post-rejoin")
    finally:
        _stop_all(engines)


def test_partition_isolated_majority_keeps_serving(tmp_path):
    """Block frames 0<->1 both directions: every group keeps a connected
    majority through host 2, so writes at host 2 keep acking; healing
    reconverges the cut pair."""
    ports = _free_ports(N)
    engines = [_mk(r, ports, str(tmp_path)) for r in range(N)]
    for e in engines:
        e.start()
    try:
        _wait_all_leaders(engines)
        for g in range(G):
            _put_retry(engines[2], g, f"/1/pre{g}", "v0",
                       time.time() + 60, "pre-partition")

        engines[0].frames.blocked.add(1)
        engines[1].frames.blocked.add(0)
        t_part = time.time()
        for g in range(G):
            _put_retry(engines[2], g, f"/1/part{g}", "v1",
                       t_part + 150, "partitioned")
        assert (engines[0].frames.blocked_dropped
                + engines[1].frames.blocked_dropped) > 0

        engines[0].frames.blocked.clear()
        engines[1].frames.blocked.clear()
        _wait_values(engines[:2], {(g, f"/1/part{g}"): "v1"
                                   for g in range(G)}, timeout=150)
    finally:
        _stop_all(engines)


def _dump(eng, g):
    """A group's store as JSON, its per-host read counters aside."""
    d = json.loads(eng.store(g).save())
    d.pop("stats")
    return d


def test_mixed_cluster_jax_and_port_ranks(tmp_path):
    """Ranks 0 and 1 are the JAX package's engines, rank 2 the port's,
    over real frames in one process. Writes go to every rank for every
    group (most forward to the leader's host); every acked write reads
    back from every rank, and the store dumps converge.

    Election and heartbeat timers count rounds, so the JAX ranks (a
    jitted round) are paced to the port's eager CPU round: ranks of
    unequal pace depose the slower one's leaders over and over."""
    import threading
    ports = _free_ports(N)
    engines = [_mk_jax(0, ports, str(tmp_path)),
               _mk_jax(1, ports, str(tmp_path)),
               _mk(2, ports, str(tmp_path))]
    done = threading.Event()
    port_led = set()

    def pace():
        while not done.wait(0.1):
            port_ms = engines[2].round_ms_ewma
            for e in engines[:2]:
                e.cfg.round_interval = max(
                    0.005, (port_ms - e.round_ms_ewma) / 1e3 + 0.005)
            port_led.update(np.nonzero(engines[2].l_state == 2)[0].tolist())

    pacer = threading.Thread(target=pace, daemon=True)
    for e in engines:
        e.start()
    pacer.start()
    try:
        _wait_all_leaders(engines)
        acked = {}
        for i in range(3 * G):
            g, r = i % G, (i // G) % N
            _put_retry(engines[r], g, f"/1/k{i}", f"r{r}",
                       time.time() + 60, "mixed")
            acked[(g, f"/1/k{i}")] = f"r{r}"
        _wait_values(engines, acked)
        deadline = time.time() + 60
        while time.time() < deadline:
            if all(_dump(e, g) == _dump(engines[0], g)
                   for e in engines[1:] for g in range(G)):
                break
            time.sleep(0.2)
        for g in range(G):
            assert _dump(engines[2], g) == _dump(engines[0], g), g
            assert _dump(engines[1], g) == _dump(engines[0], g), g
        assert all(e.failed is None for e in engines)
        # The port's rank led groups with JAX followers, not only voted.
        assert port_led, "the port's rank never led a group"
    finally:
        done.set()
        pacer.join(timeout=5)
        _stop_all(engines)


_MIRRORS = ("l_term", "l_vote", "l_commit", "l_last", "l_ring", "applied")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_data_dirs_restore_across_packages(tmp_path, writer):
    """Three ranks of one package write (checkpoints every 30 rounds),
    stop, and every rank's dir is reopened by the other package: the
    same geometry.json, the same column mirrors (term, vote, commit,
    last, ring, applied) and the same stores."""
    make, other = ((_mk_jax, _mk) if writer == "jax" else (_mk, _mk_jax))
    ports = _free_ports(N)
    engines = [make(r, ports, str(tmp_path), checkpoint_rounds=30)
               for r in range(N)]
    for e in engines:
        e.start()
    try:
        _wait_all_leaders(engines)
        want = {}
        for i in range(2 * G):
            g = i % G
            _put_retry(engines[i % N], g, f"/1/x{i}", f"v{i}",
                       time.time() + 60, writer)
            want[(g, f"/1/x{i}")] = f"v{i}"
        _wait_values(engines, want)
    finally:
        _stop_all(engines)
    saw_ckpt = False
    for r, e in enumerate(engines):
        d = os.path.join(str(tmp_path), f"host{r}")
        saw_ckpt |= any(n.startswith("checkpoint-") for n in os.listdir(d))
        with open(os.path.join(d, "geometry.json")) as f:
            assert json.load(f) == {"groups": G, "peers": N, "window": 8,
                                    "host": r}
        re = other(r, ports, str(tmp_path), checkpoint_rounds=30)
        try:
            for name in _MIRRORS:
                np.testing.assert_array_equal(
                    np.asarray(getattr(re, name)),
                    np.asarray(getattr(e, name)), err_msg=f"{r}: {name}")
            for (g, k), v in want.items():
                assert _value(re, g, k) == v, (r, g, k)
            for g in range(G):
                assert _dump(re, g) == _dump(e, g), (r, g)
        finally:
            re.stop()
    assert saw_ckpt, "no rank wrote a checkpoint"
