"""Launch one rank of the multi-host engine on localhost — N OS processes,
each owning one peer-slot column of every tenant group
(server/hostengine.py) on its own device ("cuda", the card, unless
MHE_DEVICE says "cpu"). Each rank serves the tenant HTTP API and
journals its own WAL; proposals and payloads ride the frame transport.
Several ranks may share one card.

The consensus data plane is MHE_PLANE:
- "collective" (the default): the ranks are the peers axis of a (1, N)
  mesh on torch.distributed — MHE_COORD (host:port) is the address of
  the TCPStore rank 0 opens, world MHE_NHOSTS, rank MHE_RANK — and the
  per-round mailbox is an all-to-all. MHE_BACKEND picks the process-group
  backend: "gloo" (the default; CUDA tensors go through pinned host
  memory, and several ranks may share one card) or "nccl" (one card per
  rank: a rank with MHE_DEVICE=cuda takes card MHE_RANK). A backend that
  does not come up ends the rank with rc 1 and a message; there is no
  fallback to another backend.
- "frames": every rank steps the full (G, N) round and the mailbox rides
  the frame transport; no process group.

Rank mode (driven by tests, chip_smoke.py or an external supervisor):
    MHE_RANK=0 MHE_NHOSTS=3 MHE_COORD=127.0.0.1:p MHE_DATA=/dir \\
    MHE_HTTP_PORTS=a,b,c MHE_FRAME_PORTS=d,e,f MHE_GROUPS=8 \\
    python -m etcd_tpu_torch.tools.multihost_engine

Other variables: MHE_WINDOW (32), MHE_MAX_ENTS (8), MHE_CKPT_ROUNDS
(4096), MHE_FSYNC (1), MHE_REQ_TIMEOUT (20), MHE_ROUND_INTERVAL (0),
MHE_DROP_PAY_PCT (0), MHE_FAULT_SEED (0) and MHE_LOG (INFO). On SIGTERM
the rank stops, shuts the process group down, prints one JSON line (its
plane and device, rounds, the groups it leads, `ring_resolve`'s launches
by instantiation, its peak device memory and, on the collective plane,
its comm calls and their seconds) and exits 0.

Standalone demo (spawns its own 3 ranks, serves until Ctrl-C):
    python -m etcd_tpu_torch.tools.multihost_engine
"""
import json
import os
import signal
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# How long a collective (and the group's start-up) waits for the other
# ranks; a rank that hangs longer is the supervisor's to restart.
PG_TIMEOUT_S = 120.0


def run_rank() -> int:
    import logging
    logging.basicConfig(
        level=os.environ.get("MHE_LOG", "INFO").upper(),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    rank = int(os.environ["MHE_RANK"])
    n = int(os.environ["MHE_NHOSTS"])
    data = os.environ["MHE_DATA"]
    http_ports = [int(p) for p in os.environ["MHE_HTTP_PORTS"].split(",")]
    frame_ports = [int(p) for p in os.environ["MHE_FRAME_PORTS"].split(",")]
    groups = int(os.environ.get("MHE_GROUPS", "8"))
    plane = os.environ.get("MHE_PLANE", "collective")
    if plane not in ("collective", "frames"):
        print(f"rank {rank}: MHE_PLANE={plane!r}: expected 'collective' "
              "or 'frames'", file=sys.stderr, flush=True)
        return 1
    device = os.environ.get("MHE_DEVICE", "cuda")
    backend = os.environ.get("MHE_BACKEND", "gloo")
    if plane == "collective" and backend == "nccl" and device == "cuda":
        device = f"cuda:{rank}"       # NCCL: one card per rank
    import torch
    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        # Refused before the process group and the data dir.
        print(f"rank {rank}: MHE_DEVICE={device} but no CUDA device is "
              "available; set MHE_DEVICE=cpu to run on the CPU",
              file=sys.stderr, flush=True)
        return 1
    if plane == "collective":
        if "MHE_COORD" not in os.environ:
            print(f"rank {rank}: the collective plane needs MHE_COORD "
                  "(host:port of the process group's store)",
                  file=sys.stderr, flush=True)
            return 1
        err = _join_process_group(rank, n, os.environ["MHE_COORD"], backend)
        if err is not None:
            print(f"rank {rank}: process group ({backend}) did not come "
                  f"up: {err}", file=sys.stderr, flush=True)
            return 1

    stop = {"flag": False, "eng": None}

    def on_term(signum, frame):
        stop["flag"] = True
        # Tell the round loop at once: on the collective plane the ranks
        # that stop first leave the collective, and a round broken by
        # that is a stop, not a failure, only once the loop knows.
        if stop["eng"] is not None:
            stop["eng"]._stop_ev.set()

    signal.signal(signal.SIGTERM, on_term)

    from etcd_tpu_torch.etcdhttp.tenants import EngineHttp
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve
    from etcd_tpu_torch.server.hostengine import HostEngine, HostEngineConfig

    cfg = HostEngineConfig(
        groups=groups, peers=n,
        data_dir=os.path.join(data, f"host{rank}"),
        host_id=rank,
        frame_listen=("127.0.0.1", frame_ports[rank]),
        frame_peers={h: ("127.0.0.1", frame_ports[h]) for h in range(n)},
        window=int(os.environ.get("MHE_WINDOW", "32")),
        max_ents=int(os.environ.get("MHE_MAX_ENTS", "8")),
        checkpoint_rounds=int(os.environ.get("MHE_CKPT_ROUNDS", "4096")),
        fsync=os.environ.get("MHE_FSYNC", "1") == "1",
        request_timeout=float(os.environ.get("MHE_REQ_TIMEOUT", "20")),
        round_interval=float(os.environ.get("MHE_ROUND_INTERVAL", "0")),
        drop_pay_pct=float(os.environ.get("MHE_DROP_PAY_PCT", "0")),
        fault_seed=int(os.environ.get("MHE_FAULT_SEED", "0")) + rank,
        data_plane=plane,
        device=device,
    )
    try:
        eng = stop["eng"] = HostEngine(cfg)
    except (RuntimeError, ValueError) as e:   # refused before the data dir
        print(f"rank {rank}: {e}", file=sys.stderr, flush=True)
        _leave_process_group(plane)
        return 1
    http = EngineHttp(eng, port=http_ports[rank])
    eng.start()
    http.start()
    print(f"rank {rank}: serving tenants on {http.url} "
          f"(frames :{frame_ports[rank]}) on {eng.device}, {plane} plane"
          + (f" ({backend})" if plane == "collective" else ""), flush=True)

    while not stop["flag"] and not eng._stop_ev.is_set():
        time.sleep(0.2)
    http.stop()
    eng.stop()
    peak = None
    if eng.device.type == "cuda":
        import torch
        peak = torch.cuda.max_memory_allocated(eng.device)
    comm = eng._comm
    print(json.dumps({
        "rank": rank, "plane": plane, "device": str(eng.device),
        "rounds": eng.round_no,
        "leading": int((eng.l_state == 2).sum()),
        "ring_resolve_launches": ring_resolve.launches,
        "launches_by_variant": dict(ring_resolve.launches_by_variant),
        "peak_device_bytes": peak,
        "backend": None if comm is None else comm.backend,
        "stages_through_host": None if comm is None
        else comm.stages_through_host and eng.device.type == "cuda",
        "comm": None if comm is None else comm.stats.as_dict(),
        "failed": None if eng.failed is None else repr(eng.failed)}),
        flush=True)
    code = 0 if eng.failed is None else 1
    if eng._thread is not None and eng._thread.is_alive():
        # The round thread is still inside a collective the other ranks
        # left: shutting the group down could wait on it, so leave now.
        sys.stdout.flush()
        os._exit(code)
    _leave_process_group(plane)
    return code


def _join_process_group(rank: int, n: int, coord: str, backend: str):
    """Initialise torch.distributed on a TCPStore at `coord` (rank 0 opens
    it); returns None, or the error that kept the group from coming up."""
    from datetime import timedelta

    import torch.distributed as dist
    timeout = timedelta(seconds=PG_TIMEOUT_S)
    try:
        host, port = coord.rsplit(":", 1)
        print(f"rank {rank}: joining process group {backend} at {coord}",
              flush=True)
        store = dist.TCPStore(host, int(port), n, is_master=(rank == 0),
                              timeout=timeout)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=n, timeout=timeout)
        dist.barrier()
    except Exception as e:  # noqa: BLE001 — reported, rank exits 1
        return f"{type(e).__name__}: {e}"
    return None


def _leave_process_group(plane: str) -> None:
    if plane != "collective":
        return
    import torch.distributed as dist
    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:  # noqa: BLE001 — peers may already be gone
            pass


def spawn_all(n: int = 3) -> int:
    import socket
    import subprocess
    import tempfile

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    coord = f"127.0.0.1:{free_port()}"
    http_ports = [free_port() for _ in range(n)]
    frame_ports = [free_port() for _ in range(n)]
    data = tempfile.mkdtemp(prefix="mhe-")
    procs = []
    for r in range(n):
        env = dict(os.environ, MHE_RANK=str(r), MHE_NHOSTS=str(n),
                   MHE_COORD=coord, MHE_DATA=data,
                   MHE_HTTP_PORTS=",".join(map(str, http_ports)),
                   MHE_FRAME_PORTS=",".join(map(str, frame_ports)))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "etcd_tpu_torch.tools.multihost_engine"],
            cwd=REPO, env=env))
    print(f"{n} ranks up; HTTP ports {http_ports}; data {data}")
    try:
        for p in procs:
            p.wait()
    except KeyboardInterrupt:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait()
    return 0


if __name__ == "__main__":
    if "MHE_RANK" in os.environ:
        sys.exit(run_rank())
    sys.exit(spawn_all())
