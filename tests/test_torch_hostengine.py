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

test_chaos_soak_kill_partition_cycles mirrors the JAX package's seeded
soak of the frames plane (`slow`, as there): seed 11, two stop-and-
restart cycles and one partition window, every engine alive and every
group serving after each step. Its schedule is tools/frames_soak.py's,
which chip_smoke.py's frames_soak leg runs with five engines on the
card.

test_a_leader_killed_once_its_append_is_out_leaves_its_group_serving
kills a leader at the worst point of the round that admits a write
(each follower has that round's frames up to its append, nothing
after; and once more with the payloads lost on the way), a repair of
the port's (ROADMAP §C): a follower that holds an entry must hold its
payload, or no live host can apply it."""
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
from etcd_tpu_torch.tools import frames_soak, multihost_supervisor

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


@pytest.mark.slow
def test_chaos_soak_kill_partition_cycles(tmp_path):
    """Mirror of tests/test_frames_plane.py's seeded mini-soak on the
    port: repeated host kills (with restart) and a partition window,
    liveness asserted after every injection (etcd-tester's failure rounds
    in a loop, etcd-tester/tester.go). The schedule is
    tools/frames_soak.py's, which chip_smoke.py runs too: the JAX soak's
    seed, steps, deadlines, sequential writes and 2 s attempts."""
    ports = _free_ports(N)
    engines = [_mk(r, ports, str(tmp_path)) for r in range(N)]
    for e in engines:
        e.start()
    try:
        _wait_all_leaders(engines)
        frames_soak.run(engines, lambda r: _mk(r, ports, str(tmp_path)),
                        range(G))
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


def test_meta_frames_from_a_bad_sender_are_dropped(tmp_path, monkeypatch,
                                                   caplog):
    """The sender id of a frame comes from the unauthenticated handshake
    and keys the inbox column its meta frames fill. Meta frames from a
    sender claiming `peers` (past the last column), -1 (another peer's
    column from the end) or the host's own slot are dropped, with one
    warning per sender: the host keeps serving, its next write acks and
    reads back everywhere, and only the real peers' columns are fed."""
    import logging
    import socket
    import struct

    ports = _free_ports(N)
    engines = [_mk(r, ports, str(tmp_path)) for r in range(N)]
    host = engines[0]
    fields = host.kcfg.fields
    # A frame whose every field is a marker: it must never be unpacked
    # into the inbox.
    marker = 0x7BAD
    bad = the._pack_meta(np.arange(G, dtype=np.int64),
                         np.full((G, fields), marker, np.int32))
    unpacked = []
    real_unpack = the._unpack_meta

    def spy(blob, fields):
        idx, vals = real_unpack(blob, fields)
        unpacked.append(bool((vals == marker).all()) and len(idx) == G)
        return idx, vals

    monkeypatch.setattr(the, "_unpack_meta", spy)
    for e in engines:
        e.start()
    try:
        _wait_all_leaders(engines)
        caplog.set_level(logging.WARNING, logger=the.log.name)
        hdr = json.dumps({"t": "meta"}).encode()
        frame = struct.pack("<II", len(hdr), len(bad)) + hdr + bad
        socks = []
        for frm in (N, 0):           # `peers`, and the host's own slot
            s = socket.create_connection(("127.0.0.1", ports[0]))
            s.sendall(struct.pack("<I", frm) + frame + frame)
            socks.append(s)
        host._on_frame(-1, {"t": "meta"}, bad)   # not sayable on the wire
        host._on_frame(-1, {"t": "meta"}, bad)
        deadline = time.time() + 10
        while host._bad_meta_senders != {N, 0, -1}:
            assert time.time() < deadline, host._bad_meta_senders
            time.sleep(0.02)
        r0 = host.round_no
        while host.round_no < r0 + 20:
            assert host.failed is None, host.failed
            assert time.time() < deadline + 30, "the host stopped its rounds"
            time.sleep(0.02)
        for s in socks:
            s.close()
        assert host.failed is None
        assert set(host._meta_rx) <= {1, 2}
        assert not any(unpacked) and unpacked   # real frames still flow
        warned = [r.getMessage() for r in caplog.records
                  if "not a peer slot" in r.getMessage()]
        assert sorted(warned) == sorted(
            f"meta frames from host {f} dropped: not a peer slot of host 0"
            for f in (N, 0, -1))
        want = {}
        for g in range(G):
            _put_retry(host, g, f"/1/after{g}", "ok", time.time() + 60,
                       "after bad frames")
            want[(g, f"/1/after{g}")] = "ok"
        _wait_values(engines, want)
        assert all(e.failed is None for e in engines)
    finally:
        _stop_all(engines)


class _DiesOnceItsAppendIsOut:
    """A host that is SIGKILLed at the worst moment of the round that
    admits a marked write: every peer has just received that round's
    frames up to and including its meta frame (the append), and nothing
    after it; then the host does nothing more and answers nothing. A
    frame stream to one peer is ordered, so that is a crash the wire
    allows whatever the host's send order. With `lose="pay"` the round's
    payload frames are lost on the way as well (a full send queue drops
    its oldest frame, a reset connection the frame in flight); with
    `lose="all"` none of the round's frames leaves the host (it dies
    before its sends). The frames sent are only queued: the host's
    transport must run on until they are delivered, as `stop()` drops
    what is still queued."""

    def __init__(self, eng, g, marker, lose="nothing"):
        self.eng, self.g, self.marker = eng, g, marker.encode()
        self.lose = lose
        self.armed = self.dead = False
        self.entry = None          # (index, term) of the marked write
        self._buf = None
        self._send = eng.frames.send
        self._round = eng.run_round
        eng.frames.send = self.send
        eng.run_round = self.run_round

    def send(self, to, header, blob=b""):
        if self.dead:
            return
        if self._buf is not None:
            self._buf.append((to, header, blob))
        else:
            self._send(to, header, blob)

    def run_round(self):
        if self.dead:
            time.sleep(0.01)
            return
        if not self.armed:
            return self._round()
        self._buf = []
        try:
            self._round()
        finally:
            buf, self._buf = self._buf, None
        for _, header, blob in buf:
            if header.get("t") == "pay":
                for g, i, t, p in the._unpack_payloads(blob):
                    if g == self.g and self.marker in p:
                        self.entry = (i, t)
        if self.entry is None:
            for frame in buf:
                self._send(*frame)
            return
        for to in {f[0] for f in buf}:
            mine = [f for f in buf if f[0] == to]
            metas = [k for k, f in enumerate(mine) if f[1].get("t") == "meta"]
            for frame in mine[:metas[-1] + 1] if metas else []:
                if self.lose == "nothing" or (
                        self.lose == "pay" and frame[1].get("t") != "pay"):
                    self._send(*frame)
        self.dead = True


@pytest.mark.parametrize("pay", ["sent", "lost"])
def test_a_leader_killed_once_its_append_is_out_leaves_its_group_serving(
        tmp_path, pay):
    """The leader of a group admits a write, its append reaches both
    followers, and it dies before anything else of that round leaves it
    (the crash point above). Each host applies a committed entry from
    its payload, which only the admitting host sends. If a follower took
    the append without the payload, the new leader commits the entry,
    no live host holds its payload, every pull goes unanswered, and the
    group's apply cursor stops there: no later write to the group acks
    until the dead host comes back (the multihost_frames stall of
    chip_smoke.py's kill step).

    - pay "sent": the host sends a round's payloads to each peer before
      that round's meta frame, so the followers hold the entry with its
      payload and the new leader commits and applies it;
    - pay "lost": the payloads never arrive. A follower cuts an append
      back to the entries whose payloads it holds, so neither takes the
      entry; the new leader overwrites it and the group goes on.

    The dead host is stopped only once both followers hold the append
    (the entry's index and term) or have cut it: stopped before, it
    dropped the frames still queued, and a new leader's own entries then
    passed the index (test_a_leader_killed_before_its_append_is_out_
    loses_that_write)."""
    engines, lead, cut, survivors, cut0 = _kill_once_the_append_is_out(
        tmp_path, "nothing" if pay == "sent" else "pay")
    g = cut.g
    i, t = cut.entry
    try:
        deadline = time.time() + 30
        if pay == "sent":
            while not all(int(e.l_last[g]) >= i and _term_at(e, g, i) == t
                          for e in survivors):
                assert time.time() < deadline, "the append did not reach both"
                time.sleep(0.01)
        else:
            while not all(s.appends_cut > c for s, c in zip(survivors, cut0)):
                assert time.time() < deadline, "the append was not cut by both"
                time.sleep(0.01)
        engines[lead].stop()
        try:
            t_ack = _put_retry(survivors[0], g, "/1/after", "v1",
                               time.time() + 60, "after the leader's death")
        except AssertionError as e:
            raise AssertionError(
                f"{e}; entry {cut.entry}, status by host "
                f"{[s.status(g) for s in survivors]}, pulls sent "
                f"{[s.pulls_sent for s in survivors]}") from None
        assert survivors[0].leader_slot(g) != lead
        want = {(g, "/1/after"): "v1"}
        if pay == "sent":
            want[(g, "/1/cut")] = "cut-marker"
        _wait_values(survivors, want, timeout=60)
        assert all(int(e.applied[g]) >= i for e in survivors), t_ack
        if pay == "lost":
            assert [_value(s, g, "/1/cut") for s in survivors] == [None] * 2
    finally:
        _stop_all(engines)


def test_a_leader_killed_before_its_append_is_out_loses_that_write(
        tmp_path):
    """The crash point above with none of the round's frames delivered
    (what `stop()` of the dead host's transport did to frames it still
    had queued). No follower holds the write, so it is not committed and
    is lost, as Raft allows for a write never acked. A write through a
    survivor acks, and both survivors' logs pass the lost entry's index:
    the index alone does not tell that a follower holds the entry; its
    term there is the new leader's."""
    engines, lead, cut, survivors, _ = _kill_once_the_append_is_out(
        tmp_path, "all")
    g = cut.g
    i, t = cut.entry
    try:
        engines[lead].stop()
        _put_retry(survivors[0], g, "/1/after", "v1", time.time() + 60,
                   "after the leader's death")
        _wait_values(survivors, {(g, "/1/after"): "v1"}, timeout=60)
        for e in survivors:
            assert int(e.l_last[g]) >= i
            assert _term_at(e, g, i) > t
            assert _value(e, g, "/1/cut") is None
    finally:
        _stop_all(engines)


def _term_at(eng, g, i):
    """The term of entry i in eng's log ring of group g (i in its
    window)."""
    return int(eng.l_ring[g, i % eng.l_ring.shape[1]])


def _kill_once_the_append_is_out(tmp_path, lose):
    """Three engines on the frames plane; the leader of group 1 dies at
    the crash point of `_DiesOnceItsAppendIsOut`, its transport still
    running. Returns (engines, the dead rank, its cut, the survivors,
    their `appends_cut` before the crash)."""
    import threading

    ports = _free_ports(N)
    engines = [_mk(r, ports, str(tmp_path)) for r in range(N)]
    g = 1
    cuts = [_DiesOnceItsAppendIsOut(e, g, "cut-marker", lose)
            for e in engines]
    for e in engines:
        e.start()
    try:
        _wait_all_leaders(engines)
        for k in range(G):
            _put_retry(engines[k % N], k, f"/1/base{k}", "v0",
                       time.time() + 60, "baseline")
        lead = next((r for r, e in enumerate(engines)
                     if e.leader_slot(g) == r), -1)
        assert lead >= 0
        survivors = [e for r, e in enumerate(engines) if r != lead]
        cut0 = [s.appends_cut for s in survivors]
        cut = cuts[lead]
        cut.armed = True
        threading.Thread(target=lambda: _put_or_none(
            engines[lead], g, "/1/cut", "cut-marker"), daemon=True).start()
        deadline = time.time() + 30
        while not cut.dead:
            assert time.time() < deadline, "the marked write was not admitted"
            time.sleep(0.01)
    except BaseException:
        _stop_all(engines)
        raise
    return engines, lead, cut, survivors, cut0


def _put_or_none(eng, g, key, val):
    try:
        _put(eng, g, key, val, timeout=5.0)
    except errors.EtcdError:
        pass
