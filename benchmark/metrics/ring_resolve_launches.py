"""`ring_resolve` launches per engine round in the window, from the
wrapper's `launches_by_variant` counts."""


def read(obs):
    n = sum(obs["launches"].values())
    return n / obs["rounds"] if obs["rounds"] else None
