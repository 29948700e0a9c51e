"""Device-stream milliseconds a raster frame in the stage
``raster.visibility`` (pass 1, kernel #1, one launch a draw), over the
device stretch's frames (metrics/shade_stream_ms.py)."""
from benchmark.metrics import shade_stream_ms


def read(ctx):
    return shade_stream_ms.stream_ms_per_frame("raster.visibility")
