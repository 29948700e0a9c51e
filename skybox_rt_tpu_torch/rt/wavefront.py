"""Wavefront helpers: ray sorting for traversal coherence.

Counterpart of skybox_rt_tpu.rt.wavefront.  Rays that walk the same part of
the hierarchy should sit next to each other in the batch, so that the threads
of a warp read the same nodes and triangle records; after a bounce scatters
directions, re-sorting restores that coherence.

Sort key: direction octant (3 bits) then Morton code of the quantized
origin — the standard wavefront-path-tracer binning.  The JAX module keeps
the keys in uint32; torch has no uint32 arithmetic, so the keys here are
computed in int64 (values identical, all below 2**32).
"""
from __future__ import annotations

import numpy as np
import torch


def _expand_bits10(v):
    """Spread 10 bits to every 3rd position (Morton interleave helper)."""
    v = v.to(torch.int64)
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3d(x, y, z):
    """30-bit Morton code from 10-bit integer coordinates (int64)."""
    return ((_expand_bits10(x) << 2) | (_expand_bits10(y) << 1)
            | _expand_bits10(z))


def ray_sort_keys(orig, direction, scene_min, scene_max):
    """(R,) int64 sort keys below 2**32: [octant:3][morton(origin):30] with
    the lowest morton bit dropped."""
    ext = (scene_max - scene_min).clamp(min=1e-20)
    q = ((orig - scene_min) / ext * 1023.0).clamp(0.0, 1023.0)
    q = q.to(torch.int64)
    m = morton3d(q[:, 0], q[:, 1], q[:, 2])
    pos = (direction > 0).to(torch.int64)
    octant = pos[:, 0] | (pos[:, 1] << 1) | (pos[:, 2] << 2)
    return (octant << 29) | (m >> 1)


def sort_rays(orig, direction, scene_min, scene_max):
    """Returns (perm, inv_perm): apply perm to ray arrays before
    traversal, inv_perm to results after."""
    dev = orig.device
    keys = ray_sort_keys(
        orig, direction,
        torch.as_tensor(scene_min, dtype=orig.dtype, device=dev),
        torch.as_tensor(scene_max, dtype=orig.dtype, device=dev))
    perm = torch.argsort(keys, stable=True)
    inv = torch.argsort(perm, stable=True)
    return perm, inv


def traverse_sorted(closest_fn, orig, direction, scene_min, scene_max):
    """Sort -> traverse -> unsort wrapper around any closest-hit fn."""
    perm, inv = sort_rays(orig, direction, scene_min, scene_max)
    prim, t, u, v = closest_fn(orig[perm], direction[perm])
    return prim[inv], t[inv], u[inv], v[inv]


def tile_order_perm(width: int, height: int, tile: int = 32):
    """Static permutation turning scanline ray order into pixel-tile order
    (tile*tile consecutive rays per screen tile), so that primary-ray warps
    are spatially compact.  Returns (perm, inv) numpy int32 arrays:
    rays[perm] is tile-ordered; results[inv] restores scanline order."""
    ys, xs = np.mgrid[0:height, 0:width]
    key = (((ys // tile) * ((width + tile - 1) // tile) + (xs // tile))
           * (tile * tile)
           + (ys % tile) * tile + (xs % tile))
    perm = np.argsort(key.ravel(), kind="stable").astype(np.int32)
    inv = np.argsort(perm, kind="stable").astype(np.int32)
    return perm, inv
