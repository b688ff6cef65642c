"""The frames plane's seeded chaos soak as one schedule: repeated host
stops (with restart on the host's own data dir) and a partition window,
every engine alive and every written group serving after each step (the
reference etcd-tester runs such failure rounds in a loop,
etcd-tester/tester.go).

tests/test_torch_hostengine.py::test_chaos_soak_kill_partition_cycles
runs it on the CPU at the JAX package's soak shape (3 engines, 6 groups,
one write at a time, 2 s an attempt); chip_smoke.py's frames_soak leg
runs it with five engines on the card, writing a fixed sample of their
groups from 100 threads. Both call `run`.
"""
import random
import time
from concurrent.futures import ThreadPoolExecutor

from etcd_tpu_torch import errors
from etcd_tpu_torch.server.request import Request

SEED = 11


def put_retry(eng, g, key, val, deadline, tag="", attempt_s=2.0):
    """A client's retry loop until `deadline`, `attempt_s` an attempt;
    the wall time of the first ack and the attempts it took."""
    n = 0
    while time.time() < deadline:
        n += 1
        try:
            eng.do(g, Request(method="PUT", path=key, val=val),
                   timeout=attempt_s)
            return time.time(), n
        except errors.EtcdError:
            time.sleep(0.05)
    raise AssertionError(f"write {key} ({tag}) never acked in {n} "
                         f"attempts of {attempt_s} s")


def run(engines, make, groups, seed=SEED, attempt_s=2.0, threads=1,
        on_step=None, kill_cycles=2):
    """The soak, from a pool whose every group is led. `engines` is the
    pool (one HostEngine a host, all started); `make(r)` builds host r's
    engine anew on its own data dir; `groups` are the groups each step
    writes, one key each, within the step's deadline. The schedule, from
    random.Random(seed):

    1. every engine alive and serving (60 s);
    2. `kill_cycles` times (twice by default): stop() one engine, a
       write to every group through the survivors (150 s), the engine
       rebuilt and started, every engine alive and serving again (150
       s);
    3. a pair's frames blocked both ways (`frames.blocked`), a write to
       every group through a third engine (150 s), healed, every engine
       alive and serving (150 s).

    "Serving" writes group g through engine g % len(engines). With
    `threads` > 1 a step's writes go out that many at once. `engines` is
    updated in place as hosts restart, so the caller stops the right
    ones. `on_step(name, info)`, where given, sees each step as it ends:
    "baseline", "stopped", "outage", "restarted", "post_restart",
    "partition" and "post_heal"; a write step's info holds `acks`, {g:
    (engine index, seconds from the step's start to its ack, attempts)}.
    """
    rng = random.Random(seed)
    n = len(engines)
    groups = list(groups)
    step = on_step or (lambda name, info: None)
    seq = 0

    def write_all(via, key, val, deadline_s, tag):
        t1 = time.time()
        deadline = t1 + deadline_s

        def put(g):
            i = via(g)
            t, n = put_retry(engines[i], g, key(g), val, deadline, tag,
                             attempt_s)
            return i, t - t1, n

        if threads <= 1:
            return {g: put(g) for g in groups}
        with ThreadPoolExecutor(threads) as pool:
            futs = {g: pool.submit(put, g) for g in groups}
        errs = [f.exception() for f in futs.values() if f.exception()]
        if errs:
            raise AssertionError(
                f"{tag}: {len(futs) - len(errs)} of {len(futs)} acked in "
                f"{deadline_s} s; round ms "
                f"{[round(e.round_ms_ewma, 1) for e in engines]}; "
                f"{errs[0]}")
        return {g: f.result() for g, f in futs.items()}

    def prove_all_serving(deadline_s, tag):
        nonlocal seq
        seq += 1
        # Every engine must be healthy here: a silent mid-soak crash must
        # fail the soak, not shrink the write pool.
        for e in engines:
            assert e.failed is None, (tag, e.my_slot, e.failed)
            assert e._thread is not None and e._thread.is_alive(), \
                (tag, e.my_slot)
        return write_all(lambda g: g % n, lambda g: f"/1/soak{seq}_{g}",
                         f"v{seq}", deadline_s, tag)

    step("baseline", {"acks": prove_all_serving(60, "baseline")})
    for cycle in range(kill_cycles):
        victim = rng.randrange(n)
        engines[victim].stop()
        step("stopped", {"cycle": cycle, "victim": victim})
        # The survivors serve through the outage.
        alive = [i for i in range(n) if i != victim]
        acks = write_all(lambda g: alive[g % (n - 1)],
                         lambda g: f"/1/kill{cycle}_{g}", "k", 150,
                         f"kill-cycle-{cycle}")
        step("outage", {"cycle": cycle, "acks": acks})
        # The victim restarts; the whole pool serves again.
        t_make = time.perf_counter()
        engines[victim] = make(victim)
        t_start = time.perf_counter()
        engines[victim].start()
        step("restarted", {"cycle": cycle, "victim": victim,
                           "rebuild_s": t_start - t_make})
        step("post_restart", {
            "cycle": cycle, "victim": victim,
            "acks": prove_all_serving(150, f"post-restart-{cycle}")})
    # One partition window: a random pair isolated, the majority serves.
    a = rng.randrange(n)
    b = (a + 1) % n
    c = next(i for i in range(n) if i not in (a, b))
    engines[a].frames.blocked.add(b)
    engines[b].frames.blocked.add(a)
    acks = write_all(lambda g: c, lambda g: f"/1/iso{g}", "i", 150,
                     "partition-window")
    dropped = (engines[a].frames.blocked_dropped
               + engines[b].frames.blocked_dropped)
    engines[a].frames.blocked.clear()
    engines[b].frames.blocked.clear()
    step("partition", {"pair": [a, b], "via": c, "acks": acks,
                       "blocked_frames_dropped": dropped})
    step("post_heal", {"acks": prove_all_serving(150, "post-heal")})
