"""Device milliseconds an iteration in every operation that is not one of
the port's ray-query kernels: shading, compaction and gathers in plain
torch, with the copies the profiler lists."""
from benchmark.metrics import intersect_ms


def read(ctx):
    if ctx.trace is None or not ctx.trace.device_ops:
        return None
    us = sum(e - s for n, s, e in ctx.trace.device_ops
             if not intersect_ms.is_intersector(n))
    return us / 1e3 / ctx.trace.iters
