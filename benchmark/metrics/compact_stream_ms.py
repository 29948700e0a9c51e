"""Device-stream milliseconds a frame in the stage ``rt.compact`` (the
bounce's sort key, argsort and packed-row gathers), over the device
stretch's frames (metrics/shade_stream_ms.py)."""
from benchmark.metrics import shade_stream_ms


def read(ctx):
    return shade_stream_ms.stream_ms_per_frame("rt.compact")
