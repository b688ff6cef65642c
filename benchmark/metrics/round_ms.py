"""Milliseconds per engine round: the window's seconds over the rounds
the engine completed in it (`MultiEngine.round_no`)."""


def read(obs):
    return obs["window_s"] * 1e3 / obs["rounds"] if obs["rounds"] else None
