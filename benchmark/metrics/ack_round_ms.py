"""Mean milliseconds per acked write in stage `ack.round`: the round that
admits the write, from its staging to the admission (stage, dispatch,
readback and record). Read from `MultiEngine.phase_s`: the sum of
`ack.round` and `ack.round[k]` over the count of writes `ack.writes` and
`ack.writes[k]`."""


def read(obs):
    ph = obs["phase_s"]
    n = sum(v for k, v in ph.items() if k.startswith("ack.writes"))
    s = sum(v for k, v in ph.items()
            if k == "ack.round" or k.startswith("ack.round["))
    return s * 1e3 / n if n else None
