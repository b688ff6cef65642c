"""Reduction of a `torch.profiler` window to what the metrics read: the
device's busy seconds (the union of the intervals in which an operation
ran on the card), every device operation's name and seconds, and the
longest idle gaps labelled by the host operation running across them."""
from __future__ import annotations

from typing import Dict, List, Tuple

NAME_CHARS = 120     # an operation's name as the breakdown gives it


def reduce(events) -> Dict[str, object]:
    """`events`: the profiler's FunctionEvents. Returns `busy_s`,
    `window_s` (from the first event's start to the last one's end, host
    and device), `device_ops` [(name, start_us, dur_us)], the top-10 ops
    by seconds and the top-10 idle gaps."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev: List[Tuple[str, float, float]] = []
    host: List[Tuple[str, float, float]] = []
    for e in events:
        tr = e.time_range
        if e.device_type == cuda:
            dev.append((e.name, float(tr.start), float(tr.end)))
        else:
            host.append((e.name, float(tr.start), float(tr.end)))
    dev.sort(key=lambda x: x[1])
    busy_us = 0.0
    gaps: List[Tuple[float, float, float]] = []   # (length, start, end)
    cur_s = cur_e = None
    for _, s, e in dev:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy_us += cur_e - cur_s
            gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    totals: Dict[str, float] = {}
    for name, s, e in dev:
        totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
    top_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    top_ops = [(n[:NAME_CHARS], v) for n, v in top_ops]
    gaps.sort(reverse=True)
    idle = []
    for length, s, e in gaps[:10]:
        mid = (s + e) / 2
        across = [h for h in host if h[1] <= mid <= h[2]]
        # The innermost host operation spanning the gap's middle.
        label = (min(across, key=lambda h: h[2] - h[1])[0] if across
                 else "host code outside torch ops")
        idle.append([label[:NAME_CHARS], length / 1e6])
    spans = dev + host
    window_s = ((max(e for _, _, e in spans) - min(s for _, s, _ in spans))
                / 1e6 if spans else 0.0)
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "device_ops": [(n, s, e - s) for n, s, e in dev],
            "top_ops": [[n, v] for n, v in top_ops],
            "idle_gaps": idle}
