"""Device-stream milliseconds a raster frame in the stage ``raster.shade``
(pass 2 in plain torch: the winners' interpolation, the texture, the
blended draw's fold over its slots and the masked merge), over the device
stretch's frames (metrics/shade_stream_ms.py)."""
from benchmark.metrics import shade_stream_ms


def read(ctx):
    return shade_stream_ms.stream_ms_per_frame("raster.shade")
