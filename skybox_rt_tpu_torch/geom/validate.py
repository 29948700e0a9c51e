"""Binning / coverage validation — the race-detector analog.

Counterpart of skybox_rt_tpu.geom.validate, copied (host numpy).

The reference avoids pixel races architecturally (one OM unit owns each
framebuffer word); our equivalent invariant is tile ownership: every pixel
belongs to exactly one binned tile, and a primitive's coverage is fully
contained in the tiles it was binned to.  These checks are the debug-mode
assertion suite (cheap enough for tests, not run in production paths).
"""
from __future__ import annotations

import numpy as np


def validate_binning(binned, width: int, height: int) -> None:
    """Structural invariants of a BinnedDrawcall; raises AssertionError."""
    txy = np.asarray(binned.tile_xy)
    # 1. tile ownership: no duplicate tiles
    keys = txy[:, 0].astype(np.int64) << 32 | txy[:, 1].astype(np.uint32)
    assert len(np.unique(keys)) == len(keys), "duplicate tile ownership"
    # 2. pid lists reference real prims, padding is trailing
    pids = np.asarray(binned.tile_pids)
    cnt = np.asarray(binned.tile_pid_count)
    for t in range(pids.shape[0]):
        row = pids[t]
        assert (row[:cnt[t]] >= 0).all() and (row[:cnt[t]]
                                              < binned.num_prims).all()
        assert (row[cnt[t]:] == -1).all(), "non-trailing padding"
    # 3. tiles lie inside the padded screen
    ts = 1 << binned.tile_logsize
    assert (txy >= 0).all()
    assert (txy[:, 0] * ts < width + ts).all()
    assert (txy[:, 1] * ts < height + ts).all()


def coverage_conservation(binned, width: int, height: int) -> None:
    """The pixel-coverage assertion: per-pixel covered-prim counts computed
    through the tile structure equal the counts from a direct global
    evaluation of every primitive (no pixel lost or double-counted by
    binning).  Raises AssertionError on mismatch."""
    edges = np.asarray(binned.edges)
    ts = 1 << binned.tile_logsize

    # direct: evaluate every prim over the whole screen
    xs = np.arange(width, dtype=np.int64)[None, :]
    ys = np.arange(height, dtype=np.int64)[:, None]
    direct = np.zeros((height, width), np.int64)
    for p in range(binned.num_prims):
        e = edges[p].astype(np.int64)
        cov = np.ones((height, width), bool)
        for k in range(3):
            ev = (e[k, 0] * xs + e[k, 1] * ys + e[k, 2]).astype(np.int32)
            cov &= ev >= 0
        direct += cov

    # through tiles: same eval restricted to each tile's pid list
    tiled = np.zeros((height, width), np.int64)
    for t in range(binned.num_tiles):
        tx, ty = np.asarray(binned.tile_xy)[t]
        x0, y0 = int(tx) * ts, int(ty) * ts
        xs_t = np.arange(ts, dtype=np.int64)[None, :] + x0
        ys_t = np.arange(ts, dtype=np.int64)[:, None] + y0
        acc = np.zeros((ts, ts), np.int64)
        for pid in np.asarray(binned.tile_pids)[t]:
            if pid < 0:
                continue
            e = edges[pid].astype(np.int64)
            cov = np.ones((ts, ts), bool)
            for k in range(3):
                ev = (e[k, 0] * xs_t + e[k, 1] * ys_t + e[k, 2]
                      ).astype(np.int32)
                cov &= ev >= 0
            acc += cov
        y1 = min(y0 + ts, height)
        x1 = min(x0 + ts, width)
        if y0 < height and x0 < width:
            tiled[y0:y1, x0:x1] += acc[: y1 - y0, : x1 - x0]

    mismatch = (direct != tiled)
    assert not mismatch.any(), (
        f"coverage not conserved at {int(mismatch.sum())} pixels — "
        "a primitive covers pixels outside its binned tiles")
