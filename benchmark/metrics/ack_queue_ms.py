"""Mean milliseconds per acked write in stage `ack.queue`: waiting in the
engine's `_pending` queue, from `submit_many` until the round that
admits the write takes it for staging. Read from `MultiEngine.phase_s`:
the sum of `ack.queue` and `ack.queue[k]` over the count of writes
`ack.writes` and `ack.writes[k]`."""


def read(obs):
    ph = obs["phase_s"]
    n = sum(v for k, v in ph.items() if k.startswith("ack.writes"))
    s = sum(v for k, v in ph.items()
            if k == "ack.queue" or k.startswith("ack.queue["))
    return s * 1e3 / n if n else None
