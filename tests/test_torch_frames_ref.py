"""tests/test_frames.py's cases on the port's frame transport
(`etcd_tpu_torch/parallel/frames.py`, the multi-host engine's frames
plane), on the CPU: framing round trip and per-pair order, a large
blob, sends to self or an unknown host, drop and ReportUnreachable on a
dead peer, reconnect after the receiver restarts, a handler's exception
isolated from the stream, broadcast, the `blocked` partition hook and
the meta codec.

The JAX module runs compiled against the port (tests/port_tests.py,
`on_the_port`); its nine tests are taken into this namespace as they
are.

test_handler_exception_does_not_kill_stream sends before its receiver
is known to listen (it calls no `wait_peers`). If the sender's first
connect is refused after the two frames were queued, the transport
drops its queue, as its source does (`parallel/frames.py:111`,
drop-on-unreachable), and the test sees no frame. That is a timing fault
of the test, in both packages; its check stays as it is."""
from etcd_tpu_torch.parallel import frames as port_frames
from port_tests import on_the_port

_fr = on_the_port("test_frames")

test_roundtrip_and_ordering = _fr.test_roundtrip_and_ordering
test_large_blob = _fr.test_large_blob
test_send_to_unknown_or_self_is_noop = _fr.test_send_to_unknown_or_self_is_noop
test_unreachable_peer_reports_and_drops = \
    _fr.test_unreachable_peer_reports_and_drops
test_reconnect_after_receiver_restart = \
    _fr.test_reconnect_after_receiver_restart
test_handler_exception_does_not_kill_stream = \
    _fr.test_handler_exception_does_not_kill_stream
test_broadcast_reaches_every_peer = _fr.test_broadcast_reaches_every_peer
test_blocked_partition_hook = _fr.test_blocked_partition_hook
test_meta_codec_roundtrip = _fr.test_meta_codec_roundtrip


def test_the_frames_reruns_build_the_ports_transport():
    assert _fr.FrameTransport is port_frames.FrameTransport
    assert _fr.wait_peers is port_frames.wait_peers
    assert _fr._MAX_QUEUE == port_frames._MAX_QUEUE
