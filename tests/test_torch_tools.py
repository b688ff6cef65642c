"""The port's serving launchers and operator tools on the CPU, at a tiny
size: `ingress_serve` (N=2 ingress processes in front of one engine it
spawns with `--engine-device cpu`), `etcd_top` over that engine's live
/metrics, `scale_curve` and `profile_engine` at a tiny G, and
`tsan_check --if-available` over the port's C."""
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from etcd_tpu_torch.tools import etcd_top

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def _run(*args, timeout=120):
    res = subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def _put(base, t, key, val):
    req = urllib.request.Request(
        f"{base}/tenants/{t}/v2/keys{key}", data=f"value={val}".encode(),
        method="PUT",
        headers={"Content-Type": "application/x-www-form-urlencoded"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def _get(base, t, key):
    with urllib.request.urlopen(f"{base}/tenants/{t}/v2/keys{key}",
                                timeout=30) as r:
        return json.loads(r.read())["node"]["value"]


def _gauge(base, name, **labels):
    text = urllib.request.urlopen(base + "/metrics", timeout=30).read()
    return etcd_top.gauge(etcd_top.parse_metrics(text.decode()), name,
                          tuple(labels.items()))


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


@pytest.fixture(scope="module")
def tier(tmp_path_factory):
    """`ingress_serve` with a spawned CPU engine (G=4, P=3) and two
    ingress processes; SIGTERM must end the launcher with rc 0 and take
    every child with it."""
    d = tmp_path_factory.mktemp("tier")
    p = subprocess.Popen(
        [sys.executable, "-m", "etcd_tpu_torch.tools.ingress_serve",
         "--data-dir", str(d / "engine"), "--ingress", "2", "--groups", "4",
         "--peers", "3", "--engine-device", "cpu"],
        cwd=REPO, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        info = json.loads(p.stdout.readline())
        assert "error" not in info, info
        yield info
    finally:
        p.send_signal(signal.SIGTERM)
        try:
            rc = p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = None
    deadline = time.time() + 30
    while any(_alive(pid) for pid in info["pids"]) and \
            time.time() < deadline:
        time.sleep(0.1)
    assert rc == 0
    assert not any(_alive(pid) for pid in info["pids"])


def test_ingress_serve_fronts_one_upstream(tier):
    """Two ingresses in front of the one engine: a write through either
    reads back through the other and from the engine itself; both run
    the C hot loop and the batchframe channel upstream."""
    ing = [f"http://127.0.0.1:{p}" for p in tier["ingress"]]
    assert len(ing) == 2
    with open(f"/proc/{tier['pids'][0]}/cmdline", "rb") as f:
        argv = f.read().split(b"\0")
    assert argv[1:3] == [b"-m", b"etcd_tpu_torch"]
    assert argv[argv.index(b"--engine-device") + 1] == b"cpu"
    for i in range(8):
        t = i % 4
        assert _put(ing[i % 2], t, f"/k{i}", f"v{i}")[0] == 201
    for i in range(8):
        t = i % 4
        assert _get(ing[(i + 1) % 2], t, f"/k{i}") == f"v{i}"
        assert _get(tier["upstream"], t, f"/k{i}") == f"v{i}"
    for base in ing:
        assert _gauge(base, "etcd_ingress_native_enabled") == 1.0
        sent = _gauge(base, "etcd_ingress_upstream_frames_total",
                      direction="sent")
        recv = _gauge(base, "etcd_ingress_upstream_frames_total",
                      direction="recv")
        assert sent is not None and 0 < sent == recv


def test_etcd_top_parses_live_metrics(tier):
    """etcd_top scrapes the live engine, parses every series and renders
    frames whose rates see writes made between two scrapes."""
    base = tier["upstream"]
    prev, t0 = etcd_top.scrape(base), time.time()
    names = {k[0] for k in prev}
    for fam in ("etcd_engine_rounds_total",
                "etcd_engine_round_phase_seconds_bucket",
                "etcd_server_proposal_durations_milliseconds_count"):
        assert fam in names, fam
    for i in range(6):
        _put(base, i % 4, f"/top{i}", "x")
    cur = etcd_top.scrape(base)
    frame = etcd_top.render(prev, cur, time.time() - t0)
    rates = re.match(r"rounds/s +([\d.]+) +acked/s +([\d.]+)", frame[0])
    assert rates and float(rates[1]) > 0 and float(rates[2]) > 0, frame[0]
    assert any(line.startswith("round loop") for line in frame)
    writer = threading.Thread(
        target=lambda: [_put(base, i % 4, f"/bg{i}", "y") for i in range(6)])
    writer.start()
    out = _run("etcd_tpu_torch.tools.etcd_top", base, "--interval", "0.3",
               "-n", "2")
    writer.join()
    assert out.count(f"etcd_top  {base}") == 2


def test_scale_curve_at_a_tiny_g():
    out = _run("etcd_tpu_torch.tools.scale_curve", "--groups", "4",
               "--peers", "3", "--pool-shards", "1,2", "--seconds", "0.5",
               "--applier-shards", "1", "--depth", "4", "--device", "cpu",
               timeout=240)
    res = json.loads(out)
    assert [pt["pool_shards"] for pt in res["curve"]] == [1, 2]
    for pt in res["curve"]:
        assert len(pt["per_shard"]) == pt["pool_shards"]
        assert all(s["acked"] > 0 for s in pt["per_shard"])
        assert pt["aggregate_acked_writes_per_sec"] == pytest.approx(
            sum(s["acked_per_sec"] for s in pt["per_shard"]), abs=0.11)


def test_profile_engine_at_a_tiny_g():
    out = _run("etcd_tpu_torch.tools.profile_engine", "8", "4", "--device",
               "cpu")
    head = re.search(r"G=8 P=5 E=4 fsync=on: 4 rounds, ([\d.]+) ms/round, "
                     r"([\d,]+) acked writes/s", out)
    assert head and float(head[1]) > 0 and int(head[2].replace(",", "")) > 0
    phases = set(re.findall(r"^  (\w+) +[\d.]+ ms/round", out, re.M))
    assert {"stage", "dispatch", "record", "apply"} <= phases, out


def test_tsan_check_if_available():
    """Clean under ThreadSanitizer where libtsan is installed, a loud
    skip where it is not."""
    from etcd_tpu_torch.tools.tsan_check import find_libtsan
    out = _run("etcd_tpu_torch.tools.tsan_check", "--if-available",
               timeout=300)
    want = "OK" if find_libtsan() else "SKIPPED"
    assert out.startswith(f"tsan_check: {want}"), out
