"""95th percentile of due-to-ack milliseconds over every write acked in
the window (host clock), taken over all of them at once."""
import numpy as np


def read(obs):
    lat = obs["latencies_ms"]
    return float(np.percentile(lat, 95)) if len(lat) else None
