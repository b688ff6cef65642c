"""Milliseconds per round the engine's round thread spends blocked on
the card (`MultiEngine.phase_s` key `dispatch.wait`): the quiescence
read of each hop and the readback's reads. `dispatch_ms` less this is
the host's launching and bookkeeping time a round."""


def read(obs):
    ph, r = obs["phase_s"], obs["rounds"]
    if not r or "dispatch.wait" not in ph:
        return None
    return ph["dispatch.wait"] * 1e3 / r
