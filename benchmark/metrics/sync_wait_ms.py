"""Host milliseconds a frame blocked in the stage ``rt.sync``, the
bounces' one ``.item()`` each, over the device stretch's frames
(metrics/host_busy_ms.py)."""
from benchmark.metrics import host_busy_ms


def read(ctx):
    tracing = host_busy_ms.recorder()
    if tracing is None:
        return host_busy_ms.PLACEHOLDER
    spans, n = host_busy_ms.device_stretch(tracing)
    sync = host_busy_ms.host_ms(spans, "rt.sync")
    return sync / n if n and sync is not None else None
