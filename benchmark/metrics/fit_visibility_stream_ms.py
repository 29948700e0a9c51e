"""Device-stream milliseconds a fit step in the stage ``diff.visibility``
(the hard-mode winner pass, kernel #4), over the device stretch's steps
(metrics/shade_stream_ms.py)."""
from benchmark.metrics import shade_stream_ms


def read(ctx):
    return shade_stream_ms.stream_ms_per_frame("diff.visibility")
