"""Raster-unit demo app — tests/regression/raster analog.

Counterpart of skybox_rt_tpu.apps.raster_app, host numpy as there.  The
reference kernel (raster/kernel.cpp:28-37) drains raster stamps and writes
opaque white directly into the color buffer at every covered pixel (no
shading, no OM).  Equivalent here: bin the trace (geom.binning.bin_drawcall,
the native engine), evaluate coverage per tile, OR the coverage into a
white framebuffer.
"""
from __future__ import annotations

import numpy as np

from ..core import constants as C
from ..geom import binning, cgltrace

CLEAR = np.uint32(0xFF000000)       # raster/main.cpp:40
WHITE = np.uint32(0xFFFFFFFF)


def run(trace_path: str, width: int, height: int,
        tile_logsize: int = C.RASTER_TILE_LOGSIZE) -> np.ndarray:
    """``trace_path``: a trace file or a name geom.cgltrace.trace_path
    resolves.  Returns (H, W) uint32 ARGB framebuffer (row 0 = bottom)."""
    trace = cgltrace.load_cached(cgltrace.trace_path(trace_path))
    fb = np.full((height, width), CLEAR, np.uint32)
    ts = 1 << tile_logsize

    for dc in trace.drawcalls:
        binned = binning.bin_drawcall(
            dc.pos, dc.indices, dc.color, dc.texcoord,
            width, height, dc.near, dc.far, tile_logsize)
        if binned is None:
            continue
        # int32 wraparound edge evaluation, same math as the renderer
        for t in range(binned.num_tiles):
            tx, ty = binned.tile_xy[t]
            x0, y0 = int(tx) * ts, int(ty) * ts
            xs = (np.arange(ts, dtype=np.int64) + x0)[None, :]
            ys = (np.arange(ts, dtype=np.int64) + y0)[:, None]
            for pid in binned.tile_pids[t]:
                if pid < 0:
                    continue
                e = binned.edges[pid].astype(np.int64)
                cov = np.ones((ts, ts), bool)
                for k in range(3):
                    ev = (e[k, 0] * xs + e[k, 1] * ys + e[k, 2]
                          ).astype(np.int32)          # wraps like hardware
                    cov &= ev >= 0
                cov &= (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
                yy = slice(y0, min(y0 + ts, height))
                xx = slice(x0, min(x0 + ts, width))
                fb[yy, xx] = np.where(cov[: height - y0, : width - x0],
                                      WHITE, fb[yy, xx])
    return fb
