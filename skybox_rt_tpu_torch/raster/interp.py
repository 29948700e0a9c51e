"""Barycentric gradients and fixed24 attribute interpolation.

Counterpart of skybox_rt_tpu.raster.interp, the draw3d shader's per-stamp
math (draw3d/kernel.cpp:25-59):

  GRADIENTS: the raw fixed16 edge values are reinterpreted as fixed24,
  converted to float32, and dx = e0/(e0+e1+e2), dy = e1/(...) are formed as
  ``rcp = 1/((f0+f1)+f2)``, ``rcp*f0``, ``rcp*f1`` in IEEE float32, then
  truncated back to fixed24 with x86 cast semantics.

  INTERPOLATE: dst = ((x*dx)>>24 + z) + ((y*dy)>>24) on int32.
"""
from __future__ import annotations

import torch

from ..core import fixed
from ..core.fixed import i32, u32


def gradients(evals: torch.Tensor):
    """Per-pixel barycentric ratios (dx, dy) in fixed24 from (3, ...) int32
    raw edge values (GRADIENTS_HW_i, kernel.cpp:25-35).

    The reciprocal is a tensor/tensor true division, an IEEE float32 divide
    on the CPU and on CUDA, with the reference's summation order.
    """
    f0 = fixed.fixed_to_float(evals[0], fixed.ATTR_FRAC)
    f1 = fixed.fixed_to_float(evals[1], fixed.ATTR_FRAC)
    f2 = fixed.fixed_to_float(evals[2], fixed.ATTR_FRAC)
    r = torch.ones_like(f0) / ((f0 + f1) + f2)
    dx = fixed.to_fixed_x86(r * f0, fixed.ATTR_FRAC)
    dy = fixed.to_fixed_x86(r * f1, fixed.ATTR_FRAC)
    return dx, dy


def interpolate(attr: torch.Tensor, dx: torch.Tensor,
                dy: torch.Tensor) -> torch.Tensor:
    """Interpolate one attribute plane: attr (..., 3) int32 fixed24
    (dx-coef, dy-coef, c), broadcastable against dx/dy (INTERPOLATE_i,
    kernel.cpp:56-59)."""
    return fixed.interpolate24(attr[..., 0], attr[..., 1], attr[..., 2],
                               dx, dy)


def _chan(c: torch.Tensor, factor) -> torch.Tensor:
    """uint8((c * factor) >> 24) with int32 wraparound and arithmetic shift."""
    v = fixed.wrap_i32(c.to(torch.int64) * factor)
    return (v >> 24) & 0xFF


def to_rgba8(r, g, b, a) -> torch.Tensor:
    """fixed24 color channels -> packed ARGB8888 (TO_RGBA_i,
    kernel.cpp:67-71); 1.0 (data=2^24) maps to 255 via the wrap.  Returns
    int32 patterns."""
    return i32((_chan(a, 255) << 24) | (_chan(r, 255) << 16)
               | (_chan(g, 255) << 8) | _chan(b, 255))


def modulate(r, g, b, a, tex_argb) -> torch.Tensor:
    """Vertex color (fixed24) times texel (ARGB8888), MODULATE_i
    (kernel.cpp:61-65): channel = (data * texchan) >> 24, uint8."""
    tex = u32(tex_argb)
    ta = tex >> 24
    tr = (tex >> 16) & 0xFF
    tg = (tex >> 8) & 0xFF
    tb = tex & 0xFF
    return i32((_chan(a, ta) << 24) | (_chan(r, tr) << 16)
               | (_chan(g, tg) << 8) | _chan(b, tb))
