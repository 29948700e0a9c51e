"""The 95th percentile of every iteration's latency in the window (call to
synchronize), in ms."""
import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.lat), 95)) * 1e3
