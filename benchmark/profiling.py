"""Reading a torch.profiler trace of a stretch of iterations.

The union of device intervals is a copy of ``bench_torch._busy``'s
arithmetic (the port's benchmark script before this folder existed): the
time in which at least one operation ran on the device, which overlapping
kernels cannot count twice.  Times are in microseconds as the profiler
gives them, on one clock for host and device events.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Trace:
    """What a profiled stretch of ``iters`` iterations left: device
    operations and host operations (with host activity recorded; else only
    the CUDA runtime's calls) as (name, start_us, end_us), and the
    stretch's host wall time in seconds."""
    device_ops: list
    host_ops: list
    iters: int
    wall_s: float


def from_profiler(prof, iters: int, wall_s: float) -> Trace:
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            dev.append(span)
        elif e.device_type == DeviceType.CPU:
            host.append(span)
    return Trace(sorted(dev, key=lambda s: s[1]),
                 sorted(host, key=lambda s: s[1]), iters, wall_s)


def union(spans) -> list:
    """Merged (start, end) intervals of (name, start, end) spans."""
    out = []
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(spans) -> float:
    return sum(e - s for s, e in union(spans))


def by_name(spans) -> dict:
    """Summed microseconds by operation name."""
    out = {}
    for name, s, e in spans:
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def idle_gaps(trace: Trace) -> dict:
    """Device idle time between the stretch's first and last device
    operation, in microseconds by what the host was doing: the innermost
    host operation that spans the gap's middle ("host python" where none
    does)."""
    merged = union(trace.device_ops)
    host = trace.host_ops                       # sorted by start
    out, open_ops, i = {}, [], 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        while i < len(host) and host[i][1] <= mid:
            open_ops.append(host[i])
            i += 1
        open_ops = [h for h in open_ops if h[2] >= mid]
        # host operations nest: the one that started last is innermost
        name = open_ops[-1][0] if open_ops else "host python"
        out[name] = out.get(name, 0.0) + (b - a)
    return out


#: characters of an operation's name kept in a breakdown (a templated
#: kernel's full signature runs to a thousand)
NAME_CHARS = 160


def top(d: dict, n: int = 10) -> list:
    """The n largest entries as [[name, seconds], ...] (d in us), names cut
    to NAME_CHARS."""
    items = sorted(d.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:NAME_CHARS], v / 1e6] for k, v in items]
