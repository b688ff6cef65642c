"""Launch one rank of the multi-host engine on localhost — N OS processes,
each stepping the full (G, P) slots round on its own device ("cuda", the
card, unless MHE_DEVICE says "cpu") and owning one peer-slot column of
every tenant group (server/hostengine.py, frames data plane). The
per-round mailbox, proposals and payloads ride the frame transport; each
rank serves the tenant HTTP API and journals its own WAL. Several ranks
may share one card.

Rank mode (driven by tests, chip_smoke.py or an external supervisor):
    MHE_RANK=0 MHE_NHOSTS=3 MHE_DATA=/dir MHE_HTTP_PORTS=a,b,c \\
    MHE_FRAME_PORTS=d,e,f MHE_GROUPS=8 \\
    python -m etcd_tpu_torch.tools.multihost_engine

Other variables: MHE_WINDOW (32), MHE_MAX_ENTS (8), MHE_CKPT_ROUNDS
(4096), MHE_FSYNC (1), MHE_REQ_TIMEOUT (20), MHE_ROUND_INTERVAL (0),
MHE_DROP_PAY_PCT (0), MHE_FAULT_SEED (0), MHE_LOG (INFO), MHE_DEVICE
("cuda"; "cpu" runs the rank on the CPU) and MHE_PLANE ("frames", the
only data plane ported; any other value exits 1). On SIGTERM the rank
stops, prints one JSON line (its device, rounds, the groups it leads,
`ring_resolve`'s launches by instantiation and its peak device memory)
and exits 0.

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
    plane = os.environ.get("MHE_PLANE", "frames")
    if plane != "frames":
        print(f"rank {rank}: MHE_PLANE={plane!r} is not in the PyTorch "
              "port: the collective plane waits for the device mesh "
              "(ROADMAP A6/A7); use MHE_PLANE=frames", file=sys.stderr,
              flush=True)
        return 1

    stop = {"flag": False}

    def on_term(signum, frame):
        stop["flag"] = True

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
        device=os.environ.get("MHE_DEVICE", "cuda"),
    )
    try:
        eng = HostEngine(cfg)
    except RuntimeError as e:      # no card: refused before the data dir
        print(f"rank {rank}: {e}", file=sys.stderr, flush=True)
        return 1
    http = EngineHttp(eng, port=http_ports[rank])
    eng.start()
    http.start()
    print(f"rank {rank}: serving tenants on {http.url} "
          f"(frames :{frame_ports[rank]}) on {eng.device}", flush=True)

    while not stop["flag"] and not eng._stop_ev.is_set():
        time.sleep(0.2)
    http.stop()
    eng.stop()
    peak = None
    if eng.device.type == "cuda":
        import torch
        peak = torch.cuda.max_memory_allocated(eng.device)
    print(json.dumps({
        "rank": rank, "device": str(eng.device), "rounds": eng.round_no,
        "leading": int((eng.l_state == 2).sum()),
        "ring_resolve_launches": ring_resolve.launches,
        "launches_by_variant": dict(ring_resolve.launches_by_variant),
        "peak_device_bytes": peak,
        "failed": None if eng.failed is None else repr(eng.failed)}),
        flush=True)
    return 0 if eng.failed is None else 1


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

    http_ports = [free_port() for _ in range(n)]
    frame_ports = [free_port() for _ in range(n)]
    data = tempfile.mkdtemp(prefix="mhe-")
    procs = []
    for r in range(n):
        env = dict(os.environ, MHE_RANK=str(r), MHE_NHOSTS=str(n),
                   MHE_DATA=data,
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
