"""Edge-function rasterization over pixel grids.

Counterpart of skybox_rt_tpu.raster.edge.  On int32 two's-complement
arithmetic the reference's incremental tile descent equals the direct
evaluation ``E_k(x, y) = a_k*x + b_k*y + c_k (mod 2^32)``
(graphics.cpp:715-843), so a flat evaluation over a tile is bit-identical.
The sum is taken in int64 and wrapped to int32 (core.fixed.i32), so the
wraparound is defined on every device.
"""
from __future__ import annotations

import torch

from ..core.fixed import i32


def eval_edges(edge: torch.Tensor, xs: torch.Tensor,
               ys: torch.Tensor) -> torch.Tensor:
    """Evaluate the three edge functions over a pixel grid.

    edge: (..., 3, 3) int32 fixed16 [edge][a, b, c], leading dims
    broadcastable against the grid; xs, ys: int32 pixel coordinates.
    Returns (3, *grid) int32 edge values.
    """
    e = edge.to(torch.int64)
    x = xs.to(torch.int64)
    y = ys.to(torch.int64)
    return torch.stack([i32(e[..., k, 0] * x + e[..., k, 1] * y
                            + e[..., k, 2]) for k in range(3)])


def coverage(evals: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
             scissor) -> torch.Tensor:
    """Coverage mask: inside all edges and the scissor rect
    (graphics.cpp:813-825 PREPARE_QUAD).  scissor: (left, top, right,
    bottom) ints."""
    left, top, right, bottom = scissor
    inside = (evals[0] >= 0) & (evals[1] >= 0) & (evals[2] >= 0)
    return (inside & (xs >= left) & (xs < right)
            & (ys >= top) & (ys < bottom))
