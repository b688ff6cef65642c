"""Milliseconds per round in the engine's `dispatch` and `readback`
phases (`MultiEngine.phase_s`): launching the round on the card, the
waits on it and the compact readback of its result."""


def read(obs):
    ph, r = obs["phase_s"], obs["rounds"]
    if not r or "dispatch" not in ph:
        return None
    return (ph["dispatch"] + ph.get("readback", 0.0)) * 1e3 / r
