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
is known to listen (it calls no `wait_peers`), and
test_broadcast_reaches_every_peer builds its sender before its
receivers. In the JAX package a connect refused before the receiver
listened, but seen by the send thread only after the frames were
queued, clears the queue (`etcd_tpu/parallel/frames.py:111`), and the
test sees no frame: a timing fault of the reference. The port drops on a
refused connect only the frames queued before that attempt began, so a
frame queued during it is sent on the next connection
(test_a_refused_connect_keeps_the_frames_queued_after_it_began, below);
both checks stay as they are."""
import queue
import threading

from etcd_tpu_torch.parallel import frames as port_frames
from etcd_tpu_torch.tools.multihost_supervisor import listen_ports
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


def test_a_refused_connect_keeps_the_frames_queued_after_it_began():
    """The peer listens only from the second refused connect on. The
    first refusal's `report_unreachable` queues "stale"; the second
    attempt begins with "stale" queued and is refused too, and its
    callback starts the peer's listener and queues "fresh". The port
    drops "stale" (queued before that attempt began, the reference's
    drop-on-unreachable) and sends "fresh" on the third attempt, so
    "fresh" is the first frame the peer gets. On the verbatim copy of
    the reference the second refusal clears "fresh" too, nothing
    arrives, and this test fails. Each step waits for the one before it;
    no step sleeps."""
    p0, p1 = listen_ports(2)
    peers = {0: ("127.0.0.1", p0), 1: ("127.0.0.1", p1)}
    built = threading.Event()
    trs, refusals, got = {}, [], queue.Queue()

    def on_refused(h):
        assert built.wait(10)      # the callback may beat the constructor
        refusals.append(h)
        if len(refusals) == 1:
            trs[0].send(1, {"f": "stale"})
        elif len(refusals) == 2:
            trs[1] = port_frames.FrameTransport(
                1, peers[1], peers, lambda frm, hdr, blob: got.put(hdr["f"]))
            trs[0].send(1, {"f": "fresh"})

    trs[0] = port_frames.FrameTransport(0, peers[0], peers,
                                        lambda *a: None, on_refused)
    built.set()
    try:
        assert got.get(timeout=10) == "fresh"
        assert refusals == [1, 1]
    finally:
        for t in trs.values():
            t.stop()
