"""The profiled sub-window of a ``--trace 1`` run, read from
``torch.profiler``'s events: the device's busy time (the union of its
kernels', copies' and sets' intervals), the time and calls of each
device operation, and the idle gaps between device operations, each
named by the innermost host operation running at its middle."""

from __future__ import annotations

import bisect
from collections import defaultdict

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def make_profiler():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, window_s: float, top: int = 10) -> dict:
    """``busy_s``, ``window_s``, ``ops`` {name: (device s, calls)},
    ``n_device_ops``, and the breakdown's ``device_ops`` and
    ``idle_gaps`` (at most ``top`` each, seconds)."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU and tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    ops = defaultdict(lambda: [0.0, 0])
    for a, b, name in dev:
        ops[name][0] += (b - a) * 1e-6
        ops[name][1] += 1
    busy = _merge([(a, b) for a, b, _ in dev])
    host.sort()
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for (_, b), (a, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        name, best = "host: no traced op", None
        for h in host[max(0, bisect.bisect_right(starts, mid) - 64):
                      bisect.bisect_right(starts, mid)]:
            if h[1] >= mid and (best is None or h[1] - h[0] < best):
                name, best = h[2], h[1] - h[0]
        gaps[name] += (a - b) * 1e-6
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa
    return dict(
        busy_s=sum(b - a for a, b in busy) * 1e-6, window_s=window_s,
        ops={k: tuple(v) for k, v in ops.items()}, n_device_ops=len(dev),
        device_ops=[[k, v[0]] for k, v in sorted(
            ops.items(), key=lambda kv: -kv[1][0])[:top]],
        idle_gaps=[[k, v] for k, v in rank(gaps)])


def kernel(trace: dict, fragment: str):
    """(device seconds, calls) of the device operations whose name holds
    ``fragment``; None if the trace has none."""
    hits = [v for k, v in trace["ops"].items() if fragment in k]
    if not hits:
        return None
    return sum(h[0] for h in hits), sum(h[1] for h in hits)
