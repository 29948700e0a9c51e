"""100 x (1 - device busy time an iteration / host wall time an iteration),
the device's idle share of an iteration that no profiler slows.

The busy time is the union of the device operations' intervals over the
device stretch, which does not depend on how fast the host launches.  The
wall time is the plain stretch's, run before any profiler in the process:
the profiler's own work on each launch slows the host by a quarter or more,
so the device stretch's wall would overstate the idle share."""
from benchmark import profiling


def read(ctx):
    if ctx.trace is None or not ctx.trace.device_ops or \
            ctx.plain_iter_s is None:
        return None
    busy_s = profiling.busy_us(ctx.trace.device_ops) / 1e6 / ctx.trace.iters
    return 100.0 * (1.0 - busy_s / ctx.plain_iter_s)
