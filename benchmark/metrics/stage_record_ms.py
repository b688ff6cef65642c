"""Milliseconds per round in the engine's `stage`, `record` and
`wal_submit` phases (`MultiEngine.phase_s`): packing proposals at the
leaders, building the round's WAL record and handing it to the writers."""


def read(obs):
    ph, r = obs["phase_s"], obs["rounds"]
    if not r or "stage" not in ph:
        return None
    return (ph["stage"] + ph.get("record", 0.0)
            + ph.get("wal_submit", 0.0)) * 1e3 / r
