"""ThreadSanitizer check of the port's C extensions (the closest this
Python runtime gets to the reference's `go test --race`).

Builds etcd_tpu_torch/native/{storecore,walcodec,ingresscore}.c with
-fsanitize=thread into a temp dir, then exercises them from concurrent
threads in a child process running under LD_PRELOAD=libtsan: 4 writer
threads + a reader against one Core, plus the applier-pool shapes — K
shard cores each driven by its own thread through set_many(need=...)
(the per-shard apply + descriptor-wake path), and two threads hammering
set_many on the SAME core (its batch mutation phase runs with the GIL
released under the per-Core mutex, so this is real C-level concurrency,
not GIL-serialized entry) against a concurrent reader — plus the WAL
codec round-trip, the WAL-writer, read-plane, observability, ingress
and pipelined-channel shapes. Any `WARNING: ThreadSanitizer` in the
child's output fails the check.

Scope: this instruments the port's C only; Python-level interleavings
and torch are out of scope.

Usage: python -m etcd_tpu_torch.tools.tsan_check        (exit 0 = clean)
       python -m etcd_tpu_torch.tools.tsan_check --if-available
           (exit 0 + loud skip when libtsan is not installed)
"""
import glob
import os
import subprocess
import sys
import sysconfig
import tempfile

from etcd_tpu_torch.tools.launch import ROOT

NATIVE = os.path.join(ROOT, "etcd_tpu_torch", "native")

CHILD = r"""
import sys, threading
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import ingresscore, storecore, walcodec
from etcd_tpu_torch.utils.metrics import Histogram, Registry
from etcd_tpu_torch.server.obs import FlightRecorder, SUBMITTED, ACKED

c = storecore.Core(("/0", "/1"))
thread_errors = []

def _hook(args):
    thread_errors.append(args.exc_value)

threading.excepthook = _hook   # a dead worker must FAIL the check,
                               # not silently shrink the coverage

def writer(tid):
    for i in range(3000):
        c.set(f"/1/k{tid}_{i}", False, "v" * 20, float("nan"), 1.0)

def reader():
    hits = 0
    for i in range(6000):
        try:
            ev = c.get("/1/k0_5", False, False)
            hits += 1
        except Exception as e:
            if "not found" not in str(e) and "100" not in str(e):
                raise
    # Proves the reads actually entered the C tree walk against live
    # writers (key appears early in writer 0's sequence).
    assert hits > 0, "reader never observed the key"

def codec():
    crc = 0
    for i in range(1500):
        before = crc
        blob, crc = walcodec.encode_records([(1, b"x" * 50)], crc)
        recs, _, consumed = walcodec.scan_records(blob, before)
        assert len(recs) == 1 and consumed == len(blob), (i, recs)
        walcodec.pack_multi([(1, b"\x00" + b"y" * 40)] * 8, 2)

# Applier-pool shapes: K shard cores, each applied by its own thread
# through set_many(need=...) — the per-shard apply + descriptor-wake
# path (engine._flush_many) — and a SHARED core hit by two set_many
# threads at once: its batch mutation phase drops the GIL under the
# per-Core mutex, so these interleave in real C, with a reader walking
# the same tree through the locked scalar path.
shards = [storecore.Core(("/0", "/1")) for _ in range(4)]
shared = storecore.Core(("/0", "/1"))

def shard_applier(core, sid):
    for b in range(60):
        paths = ["/1/s%d_%d_%d" % (sid, b, i) for i in range(50)]
        first, last, failed, recs, descs = core.set_many(
            paths, ["v" * 16] * 50, 3.0, False, [0, 7, 49])
        assert failed == 0 and len(descs) == 3, (failed, descs)
        for pos, nd, pd, idx in descs:
            assert nd[0] == paths[pos], (pos, nd)

def contender(tid):
    for b in range(100):
        first, last, failed, recs, descs = shared.set_many(
            ["/1/c%d_%d" % (tid, i) for i in range(40)],
            ["w" * 12] * 40, 4.0, False, [0, 39])
        assert failed == 0, failed
        assert descs[0][1][0] == "/1/c%d_0" % tid

def shared_reader():
    hits = 0
    for i in range(4000):
        try:
            shared.get("/1/c0_5", False, False)
            hits += 1
        except Exception as e:
            if "not found" not in str(e) and "100" not in str(e):
                raise
    assert hits > 0, "shared reader never observed the key"

# WAL-writer compartment shapes (engine walwriter.WALWriter): S writer
# threads each own a stream — a queue of (ticket, payload) batches
# encoded through walcodec with that stream's OWN rolling crc chain
# (encode_records runs C against S-way concurrency here), then publish
# a durable ticket under the watermark lock; a submitter fans every
# ticket out to all streams (the submit hand-off), and a waiter gates
# on min-over-streams durability exactly like ack release does.
WS = 3
wm = threading.Condition()
wal_durable = [0] * WS
wal_qs = [[] for _ in range(WS)]
wal_cvs = [threading.Condition() for _ in range(WS)]
WAL_TICKETS = 400

def wal_writer(k):
    crc = 0
    done = 0
    while done < WAL_TICKETS:
        with wal_cvs[k]:
            while not wal_qs[k]:
                wal_cvs[k].wait(5)
            batch, wal_qs[k][:] = list(wal_qs[k]), []
        before = crc
        blob, crc = walcodec.encode_records(
            [(2, pl) for _, pl in batch], crc)
        recs, _, consumed = walcodec.scan_records(blob, before)
        assert len(recs) == len(batch) and consumed == len(blob)
        done = batch[-1][0]
        with wm:
            wal_durable[k] = done
            wm.notify_all()

def wal_submitter():
    for t in range(1, WAL_TICKETS + 1):
        pl = b"r" * (20 + t % 7)
        for k in range(WS):
            with wal_cvs[k]:
                wal_qs[k].append((t, pl))
                wal_cvs[k].notify_all()

def wal_waiter():
    for t in (WAL_TICKETS // 3, WAL_TICKETS):
        with wm:
            while min(wal_durable) < t:
                wm.wait(10)
        assert min(wal_durable) >= t

# Read-plane shapes (engine read plane, round 9): a confirmer thread
# publishes per-group read indexes under the watermark condition (the
# batched heartbeat-quorum confirmation), an applier advances the
# applied index with set_many batches on the SAME core, and parked
# reader threads wake when BOTH confirmed and applied cover their read
# index, then serve straight from the C tree — the zero-append path.
# The serve races later batches' mutation phase (GIL dropped under the
# per-Core mutex); the linearizability contract is asserted raw: a
# reader woken at applied >= its read index must NEVER miss its key.
read_core = storecore.Core(("/0", "/1"))
rw = threading.Condition()
read_state = {"confirmed": 0, "applied": 0}
READ_BATCHES = 80
RB_N = 25

def read_applier():
    for b in range(READ_BATCHES):
        paths = ["/1/r%d_%d" % (b, i) for i in range(RB_N)]
        first, last, failed, recs, descs = read_core.set_many(
            paths, ["v" * 10] * RB_N, 5.0, False)
        assert failed == 0, failed
        with rw:
            read_state["applied"] = b + 1
            rw.notify_all()

def read_confirmer():
    for b in range(READ_BATCHES):
        with rw:
            read_state["confirmed"] = b + 1
            rw.notify_all()

def parked_reader(tid):
    for want in range(1 + tid, READ_BATCHES + 1, 3):
        with rw:
            while not (read_state["confirmed"] >= want
                       and read_state["applied"] >= want):
                rw.wait(10)
        # No try/except: a miss here is a stale serve, not noise.
        nd, _idx = read_core.get("/1/r%d_0" % (want - 1), False, False)
        assert nd[0] == "/1/r%d_0" % (want - 1), nd

# Observability-plane shapes (obs.py): the lock-light histogram's
# observe() is two plain increments racing a scraper's samples() pass,
# and the flight ring's SUBMITTED mark rebinds whole rows under readers
# walking to_trace_events(). Deliberately tolerant contracts — lost
# single counts, dropped late marks — but NEVER a torn exposition
# (cumulative buckets must stay monotone within one samples() pass)
# and never a mixed-round row (rebind is whole-object).
obs_hist = Histogram("tsan_obs_seconds", "tsan", registry=Registry())
HIST_N, HIST_T = 5000, 4

def hist_observer(tid):
    for i in range(HIST_N):
        obs_hist.observe((tid + 1) * 1e-4 * (1 + (i & 15)))

def hist_scraper():
    for _ in range(2000):
        rows = obs_hist.samples()
        cum = -1.0
        for name, labels, v in rows:
            if name.endswith("_bucket"):
                assert v >= cum, "torn exposition: buckets not monotone"
                cum = v

flight = FlightRecorder(capacity=64)
FLIGHT_N = 20000

def flight_submitter():
    for rnd in range(FLIGHT_N):
        flight.mark(rnd, SUBMITTED)
        flight.mark(rnd - 3, ACKED)   # late mark racing the wrap

def flight_reader():
    for _ in range(300):
        for ev in flight.to_trace_events()["traceEvents"]:
            if ev["ph"] == "X":
                assert ev["dur"] >= 0, ev

# Ingress-tier shapes (server/ingress.py): shallow submitter threads
# append pending writes to a per-tenant lane under its condition (the
# coalescing window — flush on count or drain, never a timer); the
# lane's flusher drains the window, encodes the batch through
# walcodec.pack_multi (the SAME C packing the engine's staging uses on
# the flushed entry), then releases each submitter's ack slot ONLY
# after the whole batch "upstream ack" — the ack-after-upstream-ack
# demux contract. A hub reader concurrently fans events into
# subscriber drains under the hub lock, racing the histogram scraper
# above through the shared registry idiom.
ING_SUBMITTERS, ING_WRITES, ING_FLUSH_MAX = 4, 300, 16
ing_cv = threading.Condition()
ing_buf = []
ing_state = {"open": True}
ing_acks = [0] * ING_SUBMITTERS
ing_ack_cv = threading.Condition()
ing_hist = Histogram("tsan_ingress_batch", "tsan", registry=Registry())

def ingress_submitter(tid):
    for i in range(ING_WRITES):
        with ing_cv:
            ing_buf.append((tid, i, b"\x00" + b"p" * (10 + i % 5)))
            ing_cv.notify()
        with ing_ack_cv:
            while ing_acks[tid] < i + 1:
                ing_ack_cv.wait(10)

def ingress_flusher():
    served = 0
    total = ING_SUBMITTERS * ING_WRITES
    while served < total:
        with ing_cv:
            while not ing_buf:
                ing_cv.wait(10)
            batch, ing_buf[:] = ing_buf[:ING_FLUSH_MAX], \
                ing_buf[ING_FLUSH_MAX:]
        # One flush window -> ONE deep packed entry (C under threads).
        blob = walcodec.pack_multi([(1, pl) for _, _, pl in batch], 2)
        assert blob
        ing_hist.observe(len(batch))
        served += len(batch)
        # Upstream ack for the WHOLE batch lands before ANY per-client
        # ack releases — the crash-safety ordering the tier guarantees.
        with ing_ack_cv:
            for tid, i, _ in batch:
                assert ing_acks[tid] == i, (tid, i, ing_acks[tid])
                ing_acks[tid] = i + 1
            ing_ack_cv.notify_all()

ING_EVENTS, ING_SUBS = 500, 3
hub_lock = threading.Lock()
hub_subs = [[] for _ in range(ING_SUBS)]
hub_done = threading.Event()

def ingress_hub_reader():
    for i in range(ING_EVENTS):
        with hub_lock:
            for q in hub_subs:
                q.append(i)
    hub_done.set()

def ingress_hub_sub(sid):
    got = []
    while len(got) < ING_EVENTS:
        with hub_lock:
            if hub_subs[sid]:
                got.extend(hub_subs[sid])
                hub_subs[sid][:] = []
        if not got and hub_done.is_set() and not hub_subs[sid]:
            break
    assert got == list(range(ING_EVENTS)), (sid, len(got))

# Pipelined-channel shapes (round 11, server/ingress.py _Channel):
# the flusher drains the lane window and SENDS while earlier flushes
# are still un-acked — up to PIPE_WINDOW flush ids in flight, tracked
# in an inflight map under the channel lock — and a demux thread
# delivers acks OUT OF ORDER by flush id (the reader thread's
# inflight.pop(fid) demux). Each send packs through pack_multi and
# each ack formats the fan-back through ingresscore.format_responses
# (both C under real thread interleaving). The contract asserted raw:
# every flush id acked exactly once, per-submitter acks stay FIFO even
# when the wire acks arrive scrambled.
PIPE_SUBMITTERS, PIPE_WRITES, PIPE_WINDOW = 3, 200, 4
pipe_cv = threading.Condition()
pipe_buf = []
pipe_lock = threading.Lock()          # the channel lock
pipe_inflight = {}                    # fid -> batch
pipe_wire = []                        # "socket": frames awaiting demux
pipe_wire_cv = threading.Condition()
pipe_acks = [0] * PIPE_SUBMITTERS
pipe_ack_cv = threading.Condition()
pipe_done = {"sent": 0, "acked": 0}

def pipe_submitter(tid):
    for i in range(PIPE_WRITES):
        with pipe_cv:
            pipe_buf.append((tid, i, b"\x00" + b"q" * (8 + i % 7)))
            pipe_cv.notify()
        with pipe_ack_cv:
            while pipe_acks[tid] < i + 1:
                pipe_ack_cv.wait(10)

def pipe_flusher():
    fid = 0
    total = PIPE_SUBMITTERS * PIPE_WRITES
    while pipe_done["sent"] < total:
        with pipe_cv:
            while not pipe_buf:
                pipe_cv.wait(10)
            batch, pipe_buf[:] = pipe_buf[:8], pipe_buf[8:]
        # Window gate: at most PIPE_WINDOW flushes in flight.
        with pipe_wire_cv:
            while len(pipe_inflight) >= PIPE_WINDOW:
                pipe_wire_cv.wait(10)
        blob = walcodec.pack_multi([(1, pl) for _, _, pl in batch], 2)
        fid += 1
        with pipe_lock:
            pipe_inflight[fid] = batch
        with pipe_wire_cv:
            pipe_wire.append((fid, blob))
            pipe_done["sent"] += len(batch)
            pipe_wire_cv.notify_all()

def pipe_demux():
    total = PIPE_SUBMITTERS * PIPE_WRITES
    while pipe_done["acked"] < total:
        with pipe_wire_cv:
            while not pipe_wire:
                pipe_wire_cv.wait(10)
            frames, pipe_wire[:] = list(pipe_wire), []
        # Scramble ack order within the drained window — the demux must
        # not depend on wire FIFO.
        for fid, blob in reversed(frames):
            with pipe_lock:
                batch = pipe_inflight.pop(fid)
            outs = ingresscore.format_responses(
                [(200, b'{"ok":%d}' % i) for _, i, _ in batch])
            assert len(outs) == len(batch)
            with pipe_ack_cv:
                for tid, i, _ in batch:
                    assert pipe_acks[tid] == i, (tid, i, pipe_acks[tid])
                    pipe_acks[tid] = i + 1
                pipe_done["acked"] += len(batch)
                pipe_ack_cv.notify_all()
        with pipe_wire_cv:
            pipe_wire_cv.notify_all()   # window freed

# Native hot-loop shapes: concurrent GIL-releasing request scans over
# per-thread buffers racing the formatter (two C passes that share no
# state — TSan proves it stays that way).
SCAN_REQ = (b"PUT /v2/keys/a HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: 7\r\n\r\nvalue=1") * 40

def native_scanner(tid):
    for _ in range(400):
        reqs, consumed, err = ingresscore.scan_requests(SCAN_REQ)
        assert err == 0 and len(reqs) == 40 and consumed == len(SCAN_REQ)

ts = ([threading.Thread(target=writer, args=(t,)) for t in range(4)]
      + [threading.Thread(target=reader), threading.Thread(target=codec)]
      + [threading.Thread(target=shard_applier, args=(shards[k], k))
         for k in range(4)]
      + [threading.Thread(target=contender, args=(t,)) for t in range(2)]
      + [threading.Thread(target=shared_reader)]
      + [threading.Thread(target=wal_writer, args=(k,))
         for k in range(WS)]
      + [threading.Thread(target=wal_submitter),
         threading.Thread(target=wal_waiter)]
      + [threading.Thread(target=read_applier),
         threading.Thread(target=read_confirmer)]
      + [threading.Thread(target=parked_reader, args=(t,))
         for t in range(3)]
      + [threading.Thread(target=hist_observer, args=(t,))
         for t in range(HIST_T)]
      + [threading.Thread(target=hist_scraper),
         threading.Thread(target=flight_submitter),
         threading.Thread(target=flight_reader)]
      + [threading.Thread(target=ingress_submitter, args=(t,))
         for t in range(ING_SUBMITTERS)]
      + [threading.Thread(target=ingress_flusher),
         threading.Thread(target=ingress_hub_reader)]
      + [threading.Thread(target=ingress_hub_sub, args=(s,))
         for s in range(ING_SUBS)]
      + [threading.Thread(target=pipe_submitter, args=(t,))
         for t in range(PIPE_SUBMITTERS)]
      + [threading.Thread(target=pipe_flusher),
         threading.Thread(target=pipe_demux)]
      + [threading.Thread(target=native_scanner, args=(t,))
         for t in range(2)])
for t in ts:
    t.start()
for t in ts:
    t.join()
if thread_errors:
    print("TSAN-CHILD-THREAD-ERRORS:", thread_errors[:3])
    sys.exit(3)
assert min(wal_durable) == WAL_TICKETS, wal_durable
assert min(ing_acks) == ING_WRITES, ing_acks
assert ing_hist.count > 0 and not ing_buf
assert min(pipe_acks) == PIPE_WRITES, pipe_acks
assert not pipe_inflight and not pipe_wire
assert read_state["applied"] == READ_BATCHES, read_state
assert read_core.index == READ_BATCHES * RB_N, read_core.index
# Lock-light loss bound: single counts may drop under the race, but
# the cells are monotone — never MORE than observed, and a total wipe
# would mean the increments aliased, not raced.
assert 0 < obs_hist.count <= HIST_N * HIST_T, obs_hist.count
rows = [r for r in flight.snapshot() if r[0] >= 0]
assert len(rows) == flight.capacity, len(rows)
assert all(r[0] < FLIGHT_N for r in rows)
first, last, failed, recs, descs = c.set_many(
    ["/1/b%d" % i for i in range(200)], ["v"] * 200, 2.0, False)
assert failed == 0 and last - first == 199 and descs is None
assert shared.index == 2 * 100 * 40
print("TSAN-CHILD-OK", c.index)
"""


def find_libtsan():
    for pat in ("/usr/lib/gcc/*/*/libtsan.so*",
                "/usr/lib/*/libtsan.so*",
                "/usr/lib64/libtsan.so*",
                "/usr/lib64/gcc/*/*/libtsan.so*"):
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    return None


def main() -> int:
    if_available = "--if-available" in sys.argv[1:]
    libtsan = find_libtsan()
    if libtsan is None:
        if if_available:
            # Skip LOUDLY when the machine can't: a silent skip would
            # read as clean.
            print("tsan_check: SKIPPED — libtsan not found on this "
                  "machine (install gcc's tsan runtime to enable the "
                  "sanitizer tier)")
            return 0
        # The caller ASKED for the sanitizer tier: a silent pass would
        # be false confidence. Fail and say why.
        print("tsan_check: FAILED — libtsan not found on this machine "
              "(install gcc's tsan runtime, or use the amplified-"
              "scheduler stress tests instead)")
        return 1
    inc = sysconfig.get_paths()["include"]
    ext = sysconfig.get_config_var("EXT_SUFFIX")
    with tempfile.TemporaryDirectory(prefix="tsan-") as tmp:
        for src in ("storecore", "walcodec", "ingresscore"):
            r = subprocess.run(
                ["cc", "-O1", "-g", "-fsanitize=thread", "-Wall",
                 "-shared", "-fPIC", f"-I{inc}",
                 os.path.join(NATIVE, f"{src}.c"),
                 "-o", os.path.join(tmp, f"{src}{ext}")],
                capture_output=True, text=True)
            if r.returncode != 0:
                print(f"tsan_check: {src} build failed:\n{r.stderr}")
                return 1
        env = dict(os.environ, LD_PRELOAD=libtsan,
                   TSAN_OPTIONS="halt_on_error=0 exitcode=66")
        r = subprocess.run(
            [sys.executable, "-c", CHILD, tmp, ROOT],
            capture_output=True, text=True, env=env, timeout=300)
        out = r.stdout + r.stderr
        warnings = out.count("WARNING: ThreadSanitizer")
        if (warnings or r.returncode != 0
                or "TSAN-CHILD-OK" not in out):
            print(f"tsan_check: FAILED (rc={r.returncode}, "
                  f"{warnings} TSan warnings)")
            print(out[-4000:])
            return 1
    print("tsan_check: OK — storecore + walcodec + ingresscore clean "
          "under ThreadSanitizer (4 writers + reader + codec threads, "
          "4 shard appliers via set_many(need=...), 2 same-core "
          "set_many contenders + reader, 3 WAL-writer streams + "
          "submitter + watermark waiter, read-plane confirmer + "
          "applier vs 3 parked readers, 4 histogram observers vs "
          "scraper + flight ring submitter vs trace reader, ingress "
          "coalescer: 4 depth-1 submitters vs lane flusher packing via "
          "pack_multi + hub reader vs 3 subscriber drains, pipelined "
          "channel: 3 submitters vs windowed flusher vs out-of-order "
          "ack demux through format_responses, 2 GIL-releasing "
          "scan_requests threads)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
