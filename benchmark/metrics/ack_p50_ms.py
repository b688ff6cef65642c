"""Median of due-to-ack milliseconds over every write acked in the window
(host clock)."""
import numpy as np


def read(obs):
    lat = obs["latencies_ms"]
    return float(np.percentile(lat, 50)) if len(lat) else None
