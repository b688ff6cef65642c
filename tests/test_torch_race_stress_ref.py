"""tests/test_race_stress.py's cases on the port, on the CPU
(`on_the_port(..., cpu=True)`), under the same amplified thread
scheduler (`sys.setswitchinterval(1e-5)`, the module's autouse fixture):
the Wait registry storm, concurrent clients against the live MultiEngine
with no lost update and no reused modifiedIndex, the lazy store-creation
race, and concurrent clients on three frames-plane HostEngines.

On the card the rounds are several times faster than here, so the
interleavings differ; chip_smoke.py's suite_card phase (leg race) runs
the engine's no-lost-update and lazy-creation checks at 100,000 groups
there."""
from port_tests import on_the_port

_rs = on_the_port("test_race_stress", cpu=True)

fast_switches = _rs.fast_switches
test_wait_registry_storm = _rs.test_wait_registry_storm
test_engine_concurrent_clients_no_lost_updates = \
    _rs.test_engine_concurrent_clients_no_lost_updates
test_engine_lazy_store_creation_race = _rs.test_engine_lazy_store_creation_race
test_frames_plane_concurrent_clients_race = \
    _rs.test_frames_plane_concurrent_clients_race
