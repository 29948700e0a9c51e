"""Device operations an iteration (kernels, and the copies and fills the
profiler lists beside them), counted from the profiled stretch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device_ops:
        return None
    return len(ctx.trace.device_ops) / ctx.trace.iters
