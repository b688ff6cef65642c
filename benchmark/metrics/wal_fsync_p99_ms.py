"""99th percentile of the milliseconds each WAL fsync took in the window,
timed around `os.fsync` in the process (host clock)."""
import numpy as np


def read(obs):
    fs = obs["fsync_ms"]
    return float(np.percentile(fs, 99)) if len(fs) else None
