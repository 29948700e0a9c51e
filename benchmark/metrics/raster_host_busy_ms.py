"""Host milliseconds a raster frame inside the stage ``raster.frame``, over
the device stretch's frames (metrics/host_busy_ms.py): the host's own work
a frame, launches and Python, which the profiler and the recorder's spans
slow there.  The frame reads nothing back, so no wait is inside it.  None
where no frame opened."""
from benchmark.metrics import host_busy_ms


def read(ctx):
    tracing = host_busy_ms.recorder()
    if tracing is None:
        return host_busy_ms.PLACEHOLDER
    spans, n = host_busy_ms.device_stretch(tracing)
    frame = host_busy_ms.host_ms(spans, "raster.frame")
    if not n or frame is None:
        return None
    return frame / n
