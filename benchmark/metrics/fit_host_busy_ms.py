"""Host milliseconds a fit step inside the stage ``optim_step`` less its
``diff.sync`` stage (the finite check's read-back of the loss and the
gradients), over the device stretch's steps (metrics/host_busy_ms.py): the
host's own work a step, launches and Python, which the profiler and the
recorder's spans slow there.  None where no step or no ``diff.sync``
opened."""
from benchmark.metrics import host_busy_ms


def read(ctx):
    tracing = host_busy_ms.recorder()
    if tracing is None:
        return host_busy_ms.PLACEHOLDER
    spans, n = host_busy_ms.device_stretch(tracing)
    step = host_busy_ms.host_ms(spans, "optim_step")
    sync = host_busy_ms.host_ms(spans, "diff.sync")
    if not n or step is None or sync is None:
        return None
    return (step - sync) / n
