"""Host-side tile binning for the differentiable pipeline.

Counterpart of skybox_rt_tpu.diff.binning, copied as is (numpy on the host).
Bounding boxes are computed from detached numpy positions; the geometry
processing on the device (diff.pipeline.prim_setup) recomputes edge
equations differentiably.  ``inflate_px`` grows each bbox so the binning
stays valid while vertices move during optimization (rebin when they move
more than the margin).
"""
from __future__ import annotations

import numpy as np

F32 = np.float32


def bin_static(pos, indices, width, height, tile_logsize=5,
               inflate_px=0, pad_multiple=4) -> dict:
    pos = np.asarray(pos, F32)
    indices = np.asarray(indices, np.int64)
    w = pos[:, 3:4]
    sx = (pos[:, 0:1] / w * 0.5 + 0.5) * width
    sy = (pos[:, 1:2] / w * 0.5 + 0.5) * height
    xs = np.concatenate([sx[indices[:, k]] for k in range(3)], axis=1)
    ys = np.concatenate([sy[indices[:, k]] for k in range(3)], axis=1)

    left = np.clip(np.floor(xs.min(1)) - inflate_px, 0, width).astype(np.int64)
    right = np.clip(np.ceil(xs.max(1)) + inflate_px, 0, width).astype(np.int64)
    top = np.clip(np.floor(ys.min(1)) - inflate_px, 0, height).astype(np.int64)
    bottom = np.clip(np.ceil(ys.max(1)) + inflate_px, 0, height).astype(np.int64)

    ts = 1 << tile_logsize
    tiles: dict[tuple[int, int], list[int]] = {}
    for p in range(indices.shape[0]):
        if right[p] <= left[p] or bottom[p] <= top[p]:
            continue
        for ty in range(top[p] >> tile_logsize,
                        (bottom[p] + ts - 1) >> tile_logsize):
            for tx in range(left[p] >> tile_logsize,
                            (right[p] + ts - 1) >> tile_logsize):
                tiles.setdefault((tx, ty), []).append(p)

    if not tiles:
        tiles[(0, 0)] = []
    keys = sorted(tiles)
    T = len(keys)
    maxp = max(1, max(len(v) for v in tiles.values()))
    M = -(-maxp // pad_multiple) * pad_multiple
    tile_pids = np.full((T, M), -1, np.int32)
    tile_xy = np.zeros((T, 2), np.int32)
    for t, k in enumerate(keys):
        tile_xy[t] = k
        tile_pids[t, : len(tiles[k])] = tiles[k]

    return {
        "indices": np.asarray(indices, np.int32),
        "tile_pids": tile_pids,
        "tile_xy": tile_xy,
    }
