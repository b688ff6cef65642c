"""Applier milliseconds per round, summed over the applier threads
(`MultiEngine.phase_s` keys `apply` and `apply[k]`): applying committed
writes to the tenants' stores and releasing their acks."""


def read(obs):
    ph, r = obs["phase_s"], obs["rounds"]
    s = sum(v for k, v in ph.items() if k == "apply" or k.startswith("apply["))
    return s * 1e3 / r if r and s else None
