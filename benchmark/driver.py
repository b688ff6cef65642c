"""One run of one cell: the system under test (`etcd_tpu_torch`'s
MultiEngine with its round thread) driven by an open loop of client
threads through `MultiEngine.submit_many`, then held to the reference.

Only the engine's public surface is used: `EngineConfig`, `MultiEngine`
with `start`, `wait_leaders`, `submit_many`, `collect_many`, `store`,
`stop`, and the public readings `phase_s`, `round_no`, `h_state`,
`h_mask`, `st` and `drop_mask` (the documented fault hook, set only by a
mix with faults); `ring_resolve.launches_by_variant` counts launches.

Timeline of a run: set-up (imports, CUDA, the engine and its election,
warm-up traffic), the measured window of `seconds`, then the drain (every
write's ack, up to `drain_s` past the close), the peak memory reading,
the engine's stop, and the reference's check.
"""
from __future__ import annotations

import gc
import os
import queue
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from benchmark import devtrace, reference, traffic

# EngineConfig fields a configuration file may set.
ENGINE_KEYS = ("groups", "peers", "window", "max_ents", "election_tick",
               "heartbeat_tick", "fsync", "checkpoint_rounds", "hops",
               "applier_shards", "wal_shards", "pipeline_wal")


# A traced run profiles the card for PROFILE_S seconds after its window,
# under the same open loop, which runs TAIL_S seconds longer than that to
# cover the profiler's own start.
PROFILE_S = 2.0
TAIL_S = 4.0


class FsyncWatch:
    """Records every `os.fsync` of the process: the file's inode, its
    size when the call began (every byte below it is durable once the
    call returns), the seconds the call took and when it returned."""

    def __init__(self) -> None:
        self.calls: List[tuple] = []
        self._real = None

    def __enter__(self) -> "FsyncWatch":
        real = self._real = os.fsync
        calls = self.calls

        def fsync(fd):
            st = os.fstat(fd)
            t0 = time.perf_counter()
            real(fd)
            t1 = time.perf_counter()
            calls.append((st.st_ino, st.st_size, t0, t1))
        os.fsync = fsync
        return self

    def __exit__(self, *exc) -> None:
        os.fsync = self._real

    def by_inode(self) -> Dict[int, List[tuple]]:
        out: Dict[int, List[tuple]] = {}
        for ino, size, _t0, t1 in self.calls:
            out.setdefault(ino, []).append((size, t1))
        return out


class GcWatch:
    """Pauses of the process's cyclic garbage collector, by generation:
    every collection stops all threads of the process while it runs."""

    def __init__(self) -> None:
        # (generation, start, seconds, objects freed)
        self.pauses: List[tuple] = []
        self._t0 = 0.0

    def _cb(self, phase, info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses.append((info["generation"], self._t0,
                                time.perf_counter() - self._t0,
                                info["collected"]))

    def __enter__(self) -> "GcWatch":
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._cb)

    def summary(self, t0: float, t1: float) -> Dict[str, float]:
        win = [p for p in self.pauses if t0 <= p[1] <= t1]
        full = [d for g, _t, d, _n in win if g == 2]
        return {"gc_full_collections": len(full),
                "gc_full_pause_max_ms": max(full, default=0.0) * 1e3,
                "gc_full_pause_total_ms": sum(full) * 1e3,
                "gc_pause_total_ms": sum(p[2] for p in win) * 1e3,
                "gc_freed_objects": sum(p[3] for p in win)}


class Clients:
    """The clients' side of the open loop. Each request's wait queue, as
    `submit_many` returns it, announces its ack on one shared queue the
    moment the engine puts the result into it; a few client threads take
    the announcements in the order the acks came and collect each result
    through `collect_many`. So a client wakes for whichever request was
    acked first, and no request waits behind another request's ack."""

    THREADS = 4

    def __init__(self, eng, writes: reference.Writes,
                 timeout: float) -> None:
        self.eng, self.writes = eng, writes
        self.timeout = timeout
        self.acked: "queue.SimpleQueue" = queue.SimpleQueue()
        self.lock = threading.Lock()
        self.seen: set = set()
        self.done = 0
        self.threads = [threading.Thread(target=self._loop, daemon=True,
                                         name=f"bench-client-{k}")
                        for k in range(self.THREADS)]
        for t in self.threads:
            t.start()

    def hand(self, j: int, g: int, tokens) -> None:
        """Watch request j's wait queue for its ack. The watch is taken
        off the queue with the ack: it refers back to the queue, and a
        cycle left behind would wait for the cyclic collector."""
        q = tokens[0][1]
        real_put, acked, job = q.put, self.acked, (j, g, tokens)

        def put(item, block=True, timeout=None):
            real_put(item, block, timeout)
            q.__dict__.pop("put", None)
            acked.put(job)
        q.put = put
        if q.full():            # acked before the watch was in place
            q.__dict__.pop("put", None)
            acked.put(job)

    def _loop(self) -> None:
        eng, w = self.eng, self.writes
        while True:
            job = self.acked.get()
            if job is None:
                return
            j, g, tokens = job
            with self.lock:
                if j in self.seen:
                    continue
                self.seen.add(j)
            res = eng.collect_many(g, tokens, self.timeout)[0]
            t = time.perf_counter()
            node = getattr(res, "node", None)
            if node is not None:
                w.ack_key[j], w.ack_value[j] = node.key, node.value
                w.ack_index[j] = node.modified_index
                w.t_ack[j] = t
            with self.lock:
                self.done += 1

    def stop(self) -> None:
        for _ in self.threads:
            self.acked.put(None)


@dataclass
class RunResult:
    checks: Dict[str, int]
    attempted: int
    failed: int
    obs: Dict[str, object]
    device: Dict[str, object]
    generator: Dict[str, float]
    breakdown: Optional[Dict[str, list]] = None


def _phase_copy(eng) -> Dict[str, float]:
    for _ in range(100):
        try:
            return dict(eng.phase_s)
        except RuntimeError:          # resized by a writer thread
            time.sleep(0)
    return dict(eng.phase_s)


def _launches() -> Dict[str, int]:
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve
    return dict(ring_resolve.launches_by_variant)


def _profiler():
    """A profiler of the card and of the host's torch operations on every
    thread (the engine's round runs on its own), where this torch can."""
    from torch.profiler import ProfilerActivity, profile
    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   **kw)


def engine_config(config: dict, data_dir: str, device: str):
    from etcd_tpu_torch.server.engine import EngineConfig
    kw = {k: config[k] for k in ENGINE_KEYS if k in config}
    return EngineConfig(data_dir=data_dir, device=device, stagger=True, **kw)


def wait_leaders(eng, timeout: float) -> np.ndarray:
    """Each tenant's leader slot, once every tenant has one (read from the
    engine's host mirrors of role and membership, all tenants at once)."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        rows = np.where(eng.h_mask, eng.h_state, 0) == reference.LEADER
        if rows.any(axis=1).all():
            return rows.argmax(axis=1)
        if eng.failed is not None:
            raise RuntimeError(f"engine failed: {eng.failed!r}")
        time.sleep(0.05)
    raise RuntimeError(f"not every tenant elected a leader in {timeout} s")


def run_cell(config: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device: str, t_process: float,
             drain_s: float = 60.0, engine_factory=None) -> RunResult:
    """One run. `t_process` is the process's start on the perf_counter
    clock; `engine_factory(cfg)` stands in for `MultiEngine` in tests."""
    import torch
    from etcd_tpu_torch.server.engine import MultiEngine
    from etcd_tpu_torch.server.request import Request

    def log(what: str) -> None:
        print(f"benchmark: {what} at {time.perf_counter() - t_process:.3f} s",
              file=sys.stderr, flush=True)
    log("imported")

    # A traced run's plan goes on past the window for the profiler.
    plan = traffic.plan(config, mix, seed,
                        seconds + (PROFILE_S + TAIL_S if trace else 0.0))
    n_all = len(plan.t_due)
    n_win = plan.warmup + int(np.searchsorted(plan.t_due[plan.warmup:],
                                              seconds))
    writes = reference.Writes(
        tenant=plan.tenant, key=plan.key, rid=np.zeros(n_all, np.int64),
        t_ack=np.full(n_all, np.nan), ack_index=np.full(n_all, -1),
        ack_key=[None] * n_all, ack_value=[None] * n_all,
        path=plan.path, value=plan.value)
    t_ack = writes.t_ack
    late = np.zeros(n_all)
    data_dir = tempfile.mkdtemp(prefix="bench-wal-",
                                dir=os.environ.get("TMPDIR"))
    watch = FsyncWatch()
    gcw = GcWatch()
    eng = clients = None
    stopped = False
    try:
        with watch, gcw:
            eng = (engine_factory or MultiEngine)(
                engine_config(config, data_dir, device))
            # The store of every tenant the run writes exists before
            # traffic, as in a deployment that has served it; the engine
            # otherwise makes a store on its tenant's first write. Stores
            # no request touches would be work that no request needs.
            for g in np.unique(plan.tenant).tolist():
                eng.store(g)
            log("engine and the written tenants' stores built")
            eng.start()
            lead = wait_leaders(eng, 300.0)
            log("leaders elected")
            mask, cut = traffic.fault_mask(config, mix, seed, lead)
            if mask is not None:
                eng.drop_mask = torch.as_tensor(mask, device=eng.device)
            timeout = seconds + drain_s + 60.0
            clients = Clients(eng, writes, timeout)

            def offer(lo: int, hi: int, t0: float) -> None:
                """The open loop over writes [lo, hi) from `t0`."""
                due, tenant, key, rid = (plan.t_due, plan.tenant, plan.key,
                                         writes.rid)
                j = lo
                while j < hi:
                    now = time.perf_counter() - t0
                    if due[j] > now:
                        time.sleep(min(due[j] - now, 0.002))
                        continue
                    while j < hi and due[j] <= now:
                        g = int(tenant[j])
                        toks = eng.submit_many(g, [Request(
                            method="PUT", path=plan.path(int(key[j])),
                            val=plan.value(j))])
                        rid[j] = toks[0][0]
                        late[j] = time.perf_counter() - t0 - due[j]
                        clients.hand(j, g, toks)
                        j += 1

            t_warm = time.perf_counter()
            offer(0, plan.warmup, t_warm)
            log("warm-up offered")
            # Every window starts from the same collector state: without
            # this, how many full collections (each stops the process for
            # ~0.5 s at 100,000 tenants) land in the window varies from
            # run to run with what set-up happened to leave.
            gc.collect()
            t_start = time.perf_counter()
            setup_s = t_start - t_process
            ph0, r0, l0 = _phase_copy(eng), eng.round_no, _launches()
            n_fs0 = len(watch.calls)
            offer(plan.warmup, n_win, t_start)
            remain = t_start + seconds - time.perf_counter()
            if remain > 0:
                time.sleep(remain)
            t_end = time.perf_counter()
            ph1, r1, l1 = _phase_copy(eng), eng.round_no, _launches()
            n_fs1 = len(watch.calls)
            prof = None
            if trace:
                # The profiler runs after the window, from this thread,
                # while the open loop goes on with the plan's tail on a
                # thread of its own.
                tail = threading.Thread(target=offer, daemon=True,
                                        args=(n_win, n_all, t_start),
                                        name="bench-generator-tail")
                tail.start()
                prof = _profiler()
                prof.start()
                time.sleep(PROFILE_S)
                prof.stop()
                tail.join()
            log("window closed")
            deadline = time.perf_counter() + drain_s
            while clients.done < n_all and time.perf_counter() < deadline:
                time.sleep(0.05)
            if device.startswith("cuda"):
                torch.cuda.synchronize(device)
                peak = torch.cuda.max_memory_allocated(device)
            else:
                peak = 0
            eng.stop()
            stopped = True
            if eng.failed is not None:
                raise RuntimeError(f"engine failed: {eng.failed!r}")
        st = eng.st
        dev = reference.DeviceState(
            term=st.term.cpu().numpy(), state=st.state.cpu().numpy(),
            commit=st.commit.cpu().numpy(),
            last=st.last_index.cpu().numpy(),
            ring=st.log_term.cpu().numpy(),
            mask=st.peer_mask.cpu().numpy())

        def read_key(g, path):
            try:
                n = eng.store(g).get(path).node
            except Exception:  # noqa: BLE001 — a missing key is a mismatch
                return None
            return (n.value, n.modified_index)

        log("engine stopped")
        scan = reference.scan_wal(data_dir)
        checks = reference.check(writes, scan, watch.by_inode(), read_key,
                                 dev, int(config["quorum"]))
        log("checked")
    finally:
        if clients is not None:
            clients.stop()
        if eng is not None and not stopped:
            eng.stop()
        shutil.rmtree(data_dir, ignore_errors=True)

    in_win = (t_ack >= t_start) & (t_ack <= t_end)
    due_abs = np.concatenate([t_warm + plan.t_due[:plan.warmup],
                              t_start + plan.t_due[plan.warmup:]])
    lat_ms = (t_ack[in_win] - due_abs[in_win]) * 1e3
    window_s = t_end - t_start
    fs = [(c[3] - c[2]) * 1e3 for c in watch.calls[n_fs0:n_fs1]]
    obs = {"config": config, "mix": mix, "window_s": window_s,
           "setup_s": setup_s, "latencies_ms": lat_ms,
           "acked_in_window": int(in_win.sum()), "rounds": r1 - r0,
           "phase_s": {k: ph1.get(k, 0.0) - ph0.get(k, 0.0) for k in ph1},
           "launches": {k: l1[k] - l0.get(k, 0) for k in l1},
           "fsync_ms": fs, "profile": None}
    breakdown = None
    device_info = {"memory_peak_bytes": int(peak)}
    if prof is not None:
        red = devtrace.reduce(prof.events())
        obs["profile"] = red
        device_info["busy_s"] = red["busy_s"]
        device_info["window_s"] = red["window_s"]
        breakdown = {"device_ops": red["top_ops"],
                     "idle_gaps": red["idle_gaps"]}
    w_late = late[plan.warmup:n_win] * 1e3
    gen = {"late_p50_ms": float(np.percentile(w_late, 50)) if len(w_late)
           else 0.0,
           "late_p99_ms": float(np.percentile(w_late, 99)) if len(w_late)
           else 0.0,
           "late_max_ms": float(w_late.max()) if len(w_late) else 0.0,
           **gcw.summary(t_start, t_end)}
    failed = int(np.isnan(t_ack).sum())
    return RunResult(checks, n_all, failed, obs, device_info, gen,
                     breakdown)
