"""Mean milliseconds per acked write in stage `ack.gate`: from the end of
the apply pass to the ack: the wait at the WAL durability gate and the
waiter triggers. Read from `MultiEngine.phase_s`: the sum of `ack.gate`
and `ack.gate[k]` over the count of writes `ack.writes` and
`ack.writes[k]`."""


def read(obs):
    ph = obs["phase_s"]
    n = sum(v for k, v in ph.items() if k.startswith("ack.writes"))
    s = sum(v for k, v in ph.items()
            if k == "ack.gate" or k.startswith("ack.gate["))
    return s * 1e3 / n if n else None
