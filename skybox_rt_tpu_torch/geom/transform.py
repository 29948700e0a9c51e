"""Clip-space -> device-space transforms and edge-equation setup.

Counterpart of skybox_rt_tpu.geom.transform, copied as is (numpy).
Host-side (numpy float32) preprocessing, the analog of the reference's
``graphics::Binning`` front half (sim/common/gfxutil.cpp:35-234).  The
cocogfx helpers ``ClipToHDC`` / ``ClipToScreen`` live in the absent submodule;
they are re-derived here from the standard viewport transform they implement:

  HDC    :  h = M_viewport * v   without the perspective divide (keeps w)
  Screen :  s = h / h.w          (plus rhw in .w)

All arithmetic is float32 with the same operation ordering as the C++ so the
resulting fixed-point edge coefficients are bit-identical on IEEE hardware.
"""
from __future__ import annotations

import numpy as np

from ..core import fixed

F32 = np.float32


def clip_to_hdc(pos, left, right, top, bottom, near, far):
    """Clip space -> 2D homogeneous device coordinates (no divide).

    pos: (..., 4) float32.  Returns (..., 4) with w preserved.
    """
    pos = np.asarray(pos, F32)
    half_w = F32(0.5) * (F32(right) - F32(left))
    half_h = F32(0.5) * (F32(bottom) - F32(top))
    half_d = F32(0.5) * (F32(far) - F32(near))
    out = np.empty_like(pos)
    out[..., 0] = pos[..., 0] * half_w + pos[..., 3] * (F32(left) + half_w)
    out[..., 1] = pos[..., 1] * half_h + pos[..., 3] * (F32(top) + half_h)
    out[..., 2] = pos[..., 2] * half_d + pos[..., 3] * (F32(near) + half_d)
    out[..., 3] = pos[..., 3]
    return out


def clip_to_screen(pos, left, right, top, bottom, near, far):
    """Clip space -> screen space (perspective divide applied)."""
    pos = np.asarray(pos, F32)
    rhw = F32(1.0) / pos[..., 3]
    half_w = F32(0.5) * (F32(right) - F32(left))
    half_h = F32(0.5) * (F32(bottom) - F32(top))
    half_d = F32(0.5) * (F32(far) - F32(near))
    out = np.empty_like(pos)
    out[..., 0] = pos[..., 0] * rhw * half_w + (F32(left) + half_w)
    out[..., 1] = pos[..., 1] * rhw * half_h + (F32(top) + half_h)
    out[..., 2] = pos[..., 2] * rhw * half_d + (F32(near) + half_d)
    out[..., 3] = rhw
    return out


def edge_equation(p0, p1, p2):
    """2D homogeneous edge-equation matrix (gfxutil.cpp:35-75).

    p0/p1/p2: (P, 4) float32 HDC positions.
    Returns (edges (P, 3, 3) float32 [edge][a,b,c], valid (P,) bool).
    Degenerate (det == 0) primitives are flagged invalid; det < 0 flips all
    coefficients (no backface culling — both windings render).
    """
    x0, y0, w0 = p0[:, 0], p0[:, 1], p0[:, 3]
    x1, y1, w1 = p1[:, 0], p1[:, 1], p1[:, 3]
    x2, y2, w2 = p2[:, 0], p2[:, 1], p2[:, 3]

    a0 = (y1 * w2) - (y2 * w1)
    a1 = (y2 * w0) - (y0 * w2)
    a2 = (y0 * w1) - (y1 * w0)

    b0 = (x2 * w1) - (x1 * w2)
    b1 = (x0 * w2) - (x2 * w0)
    b2 = (x1 * w0) - (x0 * w1)

    c0 = (x1 * y2) - (x2 * y1)
    c1 = (x2 * y0) - (x0 * y2)
    c2 = (x0 * y1) - (x1 * y0)

    # same left-to-right accumulation as the C++ expression
    det = (c0 * w0 + c1 * w1) + c2 * w2

    edges = np.stack(
        [np.stack([a0, b0, c0], -1),
         np.stack([a1, b1, c1], -1),
         np.stack([a2, b2, c2], -1)], axis=1
    ).astype(F32)
    flip = det < 0
    edges[flip] *= F32(-1.0)
    return edges, det != 0


def edges_to_fixed(edges):
    """Normalize the edge matrix and convert to fixed16 (gfxutil.cpp:79-96).

    edges: (P, 3, 3) float32 with half-pixel offset already applied to c.
    Returns (P, 3, 3) int32 fixed16 data.
    """
    max_ab = np.abs(edges[:, :, :2]).reshape(edges.shape[0], -1).max(axis=1)
    scale = (F32(1.0) / max_ab.astype(F32)).astype(F32)
    t = edges * scale[:, None, None]
    return fixed.to_fixed_np(t, fixed.EDGE_FRAC)


def apply_half_pixel_offset(edges):
    """c += a*0.5 + b*0.5 — sample at pixel centers (gfxutil.cpp:211-214)."""
    out = edges.copy()
    out[:, :, 2] = edges[:, :, 2] + (
        edges[:, :, 0] * F32(0.5) + edges[:, :, 1] * F32(0.5)
    )
    return out


def attribute_deltas(a0, a1, a2):
    """Per-primitive attribute plane (x0-x2, x1-x2, x2) in fixed24.

    Reference: ATTRIBUTE_DELTA, gfxutil.cpp:204-230.  a*: (P,) float32.
    Returns (P, 3) int32 fixed24.
    """
    d = np.stack([a0 - a2, a1 - a2, a2], axis=-1).astype(F32)
    return fixed.to_fixed_np(d, fixed.ATTR_FRAC)
