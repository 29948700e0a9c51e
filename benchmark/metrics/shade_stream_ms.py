"""Device-stream milliseconds a frame in the stage ``rt.shade`` less its
``rt.occlusion`` child (the shadow query's kernel), over the device
stretch's frames (metrics/host_busy_ms.py).

A span's device-stream time is the time between the stream reaching its
start event and its end event: its share of the device's timeline, idle
inside it included.  The profiler slows the host about 1.3x, so a span
that the host paces reads high here."""
from benchmark.metrics import host_busy_ms


def stream_ms(spans, name, parents=None):
    """Device-stream ms of the spans ``name`` (those whose parent is in
    ``parents``, where given); None where none opened or one has no time,
    as off the card."""
    ms = [s["stream_ms"] for s in spans if s["name"] == name
          and (parents is None or s["parent"] in parents)]
    return sum(ms) if ms and None not in ms else None


def stream_ms_per_frame(name, less_children=None):
    """stream_ms of ``name`` less that of its children ``less_children``,
    a frame of the device stretch; None where either never opened."""
    tracing = host_busy_ms.recorder()
    if tracing is None:
        return host_busy_ms.PLACEHOLDER
    spans, n = host_busy_ms.device_stretch(tracing)
    ms = stream_ms(spans, name)
    if not n or ms is None:
        return None
    if less_children is not None:
        child = stream_ms(spans, less_children,
                          {s["id"] for s in spans if s["name"] == name})
        if child is None:
            return None
        ms -= child
    return ms / n


def read(ctx):
    return stream_ms_per_frame("rt.shade", "rt.occlusion")
