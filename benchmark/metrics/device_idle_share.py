"""Share of the profiler window in which no operation ran on the card, in
percent (device trace)."""


def read(obs):
    p = obs["profile"]
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
