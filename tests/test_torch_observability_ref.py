"""tests/test_observability.py's cases on the port, on the CPU
(`on_the_port(..., cpu=True)`): the copied `obs.py` and `metrics.py`
(histograms, label escaping, the flight ring and its Chrome-trace dump,
the master switch), etcd_top's parser, and the port's MultiEngine behind
its EngineHttp: every compartment's series on /metrics under concurrent
writes, the acked counter against the engine's own count, the flight and
trace endpoints, the SIGUSR2 dump, and traced request ids across a
SIGKILL and the WAL replay.

Three things of the JAX module name files by path, which the import
rename does not reach; each is pointed at the port's counterpart here:
- `_load_script("etcd_top")` loads `etcd_tpu_torch/tools/etcd_top.py`;
- test_acked_counter_differential loads the JAX package's `bench.py` for
  `_metrics_snapshot` and `_metrics_delta`, which read the JAX package's
  registry; its mirror below calls the port's bench's own two functions
  (`etcd_tpu_torch.bench`, over `etcd_tpu_torch.utils.metrics`);
- `_TRACE_CRASH_CHILD`, the source of the SIGKILLed child, builds its
  engine with `device="cpu"`.
The environment variable ETCD_TPU_TRACE_EVERY keeps its name: obs.py is
a copy."""
import importlib.util
import os

from etcd_tpu_torch.bench import _metrics_delta, _metrics_snapshot
from port_tests import on_the_port

_obs = on_the_port("test_observability", cpu=True)
ETCD_TOP = os.path.join(_obs.REPO, "etcd_tpu_torch", "tools", "etcd_top.py")


def _load_script(name):
    assert name == "etcd_top", name
    spec = importlib.util.spec_from_file_location(
        f"{name}_for_obs_test", ETCD_TOP)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_obs._load_script = _load_script
_CHILD_CFG = "eng = MultiEngine(EngineConfig(\n"
assert _obs._TRACE_CRASH_CHILD.count(_CHILD_CFG) == 1
_obs._TRACE_CRASH_CHILD = _obs._TRACE_CRASH_CHILD.replace(
    _CHILD_CFG, _CHILD_CFG + '    device="cpu",\n')

eng_http = _obs.eng_http
_http = _obs._http
G = _obs.G

test_histogram_buckets_cumulative_and_consistent = \
    _obs.test_histogram_buckets_cumulative_and_consistent
test_expose_escapes_label_values_roundtrip = \
    _obs.test_expose_escapes_label_values_roundtrip
test_etcd_top_quantiles_and_render = _obs.test_etcd_top_quantiles_and_render
test_flight_ring_wraparound_drops_late_marks = \
    _obs.test_flight_ring_wraparound_drops_late_marks
test_flight_dump_is_chrome_trace_json = \
    _obs.test_flight_dump_is_chrome_trace_json
test_obs_disabled_master_switch = _obs.test_obs_disabled_master_switch
test_metrics_http_all_compartments_under_load = \
    _obs.test_metrics_http_all_compartments_under_load
test_flight_and_traces_http = _obs.test_flight_and_traces_http
test_sigusr2_dumps_flight_ring = _obs.test_sigusr2_dumps_flight_ring
test_trace_ids_survive_sigkill_and_replay = \
    _obs.test_trace_ids_survive_sigkill_and_replay


def test_acked_counter_differential(eng_http):
    """Mirror: the registry's acked counter moves by exactly the number
    of writes the engine reports acked."""
    eng, base = eng_http
    snap0 = _metrics_snapshot()
    a0 = eng.acked_requests
    N = 12
    for i in range(N):
        _http("PUT", f"{base}/tenants/{i % G}/v2/keys/diff/k{i}",
              f"value=v{i}")
    delta = _metrics_delta(snap0, _metrics_snapshot())
    moved = delta.get("etcd_engine_acked_requests_total", 0)
    assert moved == N == eng.acked_requests - a0
