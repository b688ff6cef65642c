"""tests/test_ingress.py's cases that tests/test_torch_ingress.py does
not mirror, on the port's stack on the CPU: the port's MultiEngine, its
EngineHttp front and its Ingress (`etcd_tpu_torch/server/ingress.py`).

The JAX module runs compiled against the port and bound to the CPU
(tests/port_tests.py, `on_the_port(..., cpu=True)`); its ten tests
below are taken into this namespace as they are: the watch hub against
direct watches, malformed input, a recursive delete, waitIndex history,
the slow client's write-buffer cap, and the binary upstream channel
(out-of-order ack demux, a sever mid-window, the fallback to JSON, FIFO
across a flush window, the pure-Python leg).

test_many_connections_fd_smoke (`slow`, as in the JAX package) spawns
`python -m etcd_tpu.server.ingress`; here the module's `_spawn_ingress`
is rebound to spawn `python -m etcd_tpu_torch.server.ingress`, and the
test runs as it is otherwise. The file's other four tests are mirrored
in tests/test_torch_ingress.py."""
import json
import os
import subprocess
import sys

from etcd_tpu_torch.server import engine as port_engine
from etcd_tpu_torch.server import ingress as port_ingress
from port_tests import on_the_port

_ing = on_the_port("test_ingress", cpu=True)

test_watch_hub_differential_vs_direct = \
    _ing.test_watch_hub_differential_vs_direct
test_malformed_input_does_not_kill_loop = \
    _ing.test_malformed_input_does_not_kill_loop
test_recursive_delete_through_ingress = \
    _ing.test_recursive_delete_through_ingress
test_watch_waitindex_history_ring_and_cleared = \
    _ing.test_watch_waitindex_history_ring_and_cleared
test_slow_client_wbuf_cap = _ing.test_slow_client_wbuf_cap
test_out_of_order_ack_demux = _ing.test_out_of_order_ack_demux
test_midwindow_sever_503s_exactly_inflight = \
    _ing.test_midwindow_sever_503s_exactly_inflight
test_auto_mode_falls_back_to_json_path = \
    _ing.test_auto_mode_falls_back_to_json_path
test_frame_fifo_across_flush_window = _ing.test_frame_fifo_across_flush_window
test_pure_python_fallback_leg = _ing.test_pure_python_fallback_leg


def _spawn_ingress(upstream):
    """tests/test_ingress.py's `_spawn_ingress`, spawning the port's
    ingress process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.Popen(
        [sys.executable, "-m", "etcd_tpu_torch.server.ingress",
         "--upstream", upstream],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, cwd=_ing.REPO)
    info = json.loads(p.stdout.readline())
    return p, info["port"]


_ing._spawn_ingress = _spawn_ingress
test_many_connections_fd_smoke = _ing.test_many_connections_fd_smoke


def test_the_ingress_reruns_build_the_ports_modules():
    assert _ing.Ingress is port_ingress.Ingress
    assert _ing.IngressConfig is port_ingress.IngressConfig
    assert issubclass(_ing.EngineConfig, port_engine.EngineConfig)
    assert _ing.make_engine.__globals__["EngineConfig"] is _ing.EngineConfig
    assert _ing.EngineConfig(groups=1, peers=1,
                             data_dir="unused").device == "cpu"
    assert _ing.MultiEngine is port_engine.MultiEngine
    assert _ing._spawn_ingress is _spawn_ingress
    # The hand-bound fd smoke keeps the JAX test's `slow` mark.
    assert "slow" in {m.name for m in
                      test_many_connections_fd_smoke.pytestmark}
