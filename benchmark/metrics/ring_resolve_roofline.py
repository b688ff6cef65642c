"""`ring_resolve`'s share of its memory-bandwidth bound, in percent, over
the profiler window (device trace).

Bytes per launch follow from the call's shapes: the idx tensor read once
and the output written once (R x T int32 each, R = groups x peers rows),
and `last` read once (R int32). The ring words a call touches depend on
the indices and are not counted, so the bytes are a floor and the share
cannot read above what the kernel achieves. T is the instantiation's
(`ring_resolve_tiles<4>` and `<5>`); the generic one (`<0>`) takes the
call site's T that no specialisation serves: send assembly's T = peers or
the conflict scan's T = max_ents. The bound is the bytes at the card's
HBM rate; the time is the kernels' summed device time."""
import re

from benchmark.peaks import HBM_BYTES_PER_S

_NAME = re.compile(r"ring_resolve_tiles<(\d+)>")


def read(obs):
    p = obs["profile"]
    if p is None:
        return None
    cfg = obs["config"]
    rows = int(cfg["groups"]) * int(cfg["peers"])
    generic = {int(cfg["peers"]), int(cfg["max_ents"])} - {4, 5}
    nbytes = secs = 0.0
    for name, _start, dur_us in p["device_ops"]:
        m = _NAME.search(name)
        if not m:
            continue
        te = int(m.group(1))
        if te == 0:
            if len(generic) != 1:
                return None
            te = next(iter(generic))
        nbytes += 4 * (2 * rows * te + rows)
        secs += dur_us / 1e6
    if not secs:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / secs
