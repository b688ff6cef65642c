"""Mean milliseconds per acked write in stage `ack.apply`: from admission
to the end of the applier pass that applies the write: the WAL hand-off,
the round's tail, the applier queue and the apply. Read from
`MultiEngine.phase_s`: the sum of `ack.apply` and `ack.apply[k]` over
the count of writes `ack.writes` and `ack.writes[k]`."""


def read(obs):
    ph = obs["phase_s"]
    n = sum(v for k, v in ph.items() if k.startswith("ack.writes"))
    s = sum(v for k, v in ph.items()
            if k == "ack.apply" or k.startswith("ack.apply["))
    return s * 1e3 / n if n else None
