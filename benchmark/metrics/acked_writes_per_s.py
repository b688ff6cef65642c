"""Writes acked in the window over the window's seconds (host clock)."""


def read(obs):
    return obs["acked_in_window"] / obs["window_s"]
