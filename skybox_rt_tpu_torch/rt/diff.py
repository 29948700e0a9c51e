"""Differentiable ray tracing: pixel gradients through the RT path with
respect to vertex positions, colors and normals.

Counterpart of skybox_rt_tpu.rt.diff, under torch autograd.

Policy (the RT analog of diff/pipeline's discrete-step policy):
  * WHICH primitive a ray hits is discrete: the traversal runs without a
    graph and returns prim ids only;
  * WHERE it hits is continuous: t, u, v are recomputed from the winning
    primitive with the closed-form Möller–Trumbore solve, so gradients flow
    to the ray origin and direction and to the triangle vertices;
  * silhouette (visibility) gradients are out of scope for the HARD path, as
    in the raster pipeline's hard-coverage mode;
  * the SOFT path (:func:`render_lambert_soft`) composites the top-K
    plane-hit candidates of a ray with sigmoid boundary weights and
    front-to-back transmittance, so visibility is differentiable.

Every gather whose table takes a gradient (``verts[f]``, ``vert_colors[f]``,
``normals[f]``, the triangle arrays at the winning prim) goes through
diff.pipeline.gather_rows, whose backward is the row-accumulation kernel with
a pinned sum order: no scatter-add with atomics runs in a backward pass, and
the gradients are the same bits from run to run.

The renders take tensors or numpy arrays and run on ``device`` (None: the
CUDA card; core.device); a tensor argument that requires grad keeps its graph
through the move.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..diff.pipeline import gather_rows
from . import bvh as bvh_mod
from . import intersect

F32 = torch.float32


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _norm(a):
    """sqrt(x*x + y*y + z*z) over the last axis, keepdim."""
    return torch.sqrt(_dot(a, a))[..., None]


def _on(a, device, dtype=F32):
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=dtype)


def _inputs(device, verts, faces, o, d, *more):
    device = resolve_device(device)
    return (_on(verts, device), _on(faces, device, torch.int64),
            _on(o, device), _on(d, device),
            *(_on(a, device) for a in more))


def _bvh_on(bvh_arrays, device):
    if bvh_arrays is None:
        return None
    return tuple(a.to(device) for a in bvh_arrays)


def triangle_arrays(verts, faces):
    """rt.intersect.triangle_arrays with the gathers' transposes in
    gather_rows: (v0, e1, e2), (P, 3) each."""
    v0, v1, v2 = (gather_rows(verts, faces[:, k]) for k in range(3))
    return v0, v1 - v0, v2 - v0


def solve_hit(o, d, v0, e1, e2):
    """Differentiable Möller–Trumbore solve for known-hit pairs.

    o, d, v0, e1, e2: (..., 3).  Returns (t, u, v); no validity checks:
    callers mask with the traversal's hit mask."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = 1.0 / torch.where(det.abs() > 1e-12, det,
                                torch.full_like(det, 1e-12))
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    return t, u, v


def _closest_hit_diff(verts, faces, o, d, bvh_arrays, t_min, t_max,
                      leaf_size):
    tri = triangle_arrays(verts, faces)
    with torch.no_grad():
        tri_ng = tuple(a.detach() for a in tri)
        if bvh_arrays is not None:
            prim, _, _, _ = bvh_mod.closest_hit(
                bvh_arrays, tri_ng, o.detach(), d.detach(), t_min, t_max,
                leaf_size=leaf_size)
        else:
            prim, _, _, _ = intersect.closest_hit_bruteforce(
                o.detach(), d.detach(), *tri_ng, t_min, t_max)
    p = prim.clamp(min=0)
    v0, e1, e2 = (gather_rows(a, p) for a in tri)
    t, u, v = solve_hit(o, d, v0, e1, e2)
    hit = prim >= 0
    zero = torch.zeros_like(t)
    return (prim, torch.where(hit, t, torch.full_like(t, math.inf)),
            torch.where(hit, u, zero), torch.where(hit, v, zero))


def closest_hit_diff(verts, faces, o, d, bvh_arrays=None, t_min=1e-4,
                     t_max=math.inf, leaf_size=bvh_mod.LEAF_SIZE, device=None):
    """Differentiable closest hit.

    verts: (V, 3), gradients flow; faces: (P, 3) int.  Returns (prim (R,)
    int32 without a graph, t, u, v differentiable).  Uses the per-ray-stack
    BVH traversal when ``bvh_arrays`` (BVH.as_device_arrays) is given (pass
    leaf_size=bvh.leaf_size for a tree built with another capacity), else
    brute force; the selection is detached either way."""
    verts, faces, o, d = _inputs(device, verts, faces, o, d)
    return _closest_hit_diff(verts, faces, o, d,
                             _bvh_on(bvh_arrays, verts.device), t_min, t_max,
                             leaf_size)


def render_depth(verts, faces, o, d, bvh_arrays=None, background=0.0,
                 device=None):
    """Minimal differentiable RT image: hit distance per ray (the quantity
    inverse-geometry losses use).  Returns (R,) float32."""
    verts, faces, o, d = _inputs(device, verts, faces, o, d)
    prim, t, _, _ = _closest_hit_diff(
        verts, faces, o, d, _bvh_on(bvh_arrays, verts.device), 1e-4,
        math.inf, bvh_mod.LEAF_SIZE)
    return torch.where(prim >= 0, t, torch.full_like(t, background))


def _interp_rows(table, f, u, v):
    w = 1.0 - u - v
    return (gather_rows(table, f[:, 0]) * w[:, None]
            + gather_rows(table, f[:, 1]) * u[:, None]
            + gather_rows(table, f[:, 2]) * v[:, None])


def _facing(n, d):
    """n normalized and flipped against the incoming ray."""
    n = n / _norm(n).clamp(min=1e-20)
    return torch.where(_dot(n, d)[..., None] > 0, -n, n)


def _unit(light_dir, device):
    l = _on(light_dir, device)
    return l / _norm(l)


def _shade(albedo, ndotl, ambient, hit, background):
    rgb = albedo * (ambient + ndotl[:, None])
    return torch.where(hit[:, None], rgb, _on(background, rgb.device))


def render_lambert_smooth(verts, faces, normals, vert_colors, o, d,
                          light_dir, bvh_arrays=None, ambient=0.1,
                          background=(0., 0., 0.), device=None):
    """Differentiable RT with interpolated vertex normals: gradients flow
    to ``normals``, to verts (hit position and barycentrics) and to
    vert_colors.  Returns (R, 3) float32."""
    verts, faces, o, d, normals, vert_colors = _inputs(
        device, verts, faces, o, d, normals, vert_colors)
    prim, _, u, v = _closest_hit_diff(
        verts, faces, o, d, _bvh_on(bvh_arrays, verts.device), 1e-4,
        math.inf, bvh_mod.LEAF_SIZE)
    f = faces[prim.clamp(min=0).long()]
    albedo = _interp_rows(vert_colors, f, u, v)[:, :3]
    n = _facing(_interp_rows(normals, f, u, v), d)
    ndotl = _dot(n, _unit(light_dir, verts.device)).clamp(min=0.0)
    return _shade(albedo, ndotl, ambient, prim >= 0, background)


def topk_plane_hits(verts, faces, o, d, K: int, t_min=1e-4, t_max=math.inf,
                    margin: float = 0.2):
    """Candidate enumeration for the soft path, without a graph.

    Intersects every ray with every primitive's support PLANE (not the
    bounded triangle) and keeps candidates whose barycentric boundary
    distance min(u, v, 1-u-v) > -margin, so near-miss primitives just
    outside a ray's footprint are candidates too: that is what lets the soft
    weights carry gradients across the silhouette.
    Returns (R, K) int32 prim ids in ascending-t order, -1 = none; equal t
    keep the lower prim id first (a stable sort: ``torch.topk`` promises no
    order among ties).

    Brute force over (R, P), in ray chunks: the soft path targets
    inverse-rendering scenes (small P, small images)."""
    with torch.no_grad():
        v0, e1, e2 = (a.detach() for a in intersect.triangle_arrays(
            verts.detach(), faces))
        o, d = o.detach(), d.detach()
        R, P = o.shape[0], v0.shape[0]
        k = min(K, P)
        out = torch.full((R, K), -1, dtype=torch.int32, device=o.device)
        step = max(1, intersect.PAIR_BUDGET // max(P, 1))
        for lo in range(0, R, step):
            oc, dc = o[lo:lo + step, None, :], d[lo:lo + step, None, :]
            pvec = _cross(dc, e2[None])                  # (r, P, 3)
            det = _dot(e1[None], pvec)
            valid = det.abs() > 1e-12
            inv = 1.0 / torch.where(valid, det, torch.ones_like(det))
            tvec = oc - v0[None]
            u = _dot(tvec, pvec) * inv
            qvec = _cross(tvec, e1[None])
            v = _dot(dc, qvec) * inv
            t = _dot(e2[None], qvec) * inv
            bdist = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
            cand = valid & (bdist > -margin) & (t > t_min) & (t < t_max)
            key = torch.where(cand, t, torch.full_like(t, math.inf))
            skey, idx = torch.sort(key, dim=1, stable=True)
            out[lo:lo + step, :k] = torch.where(
                torch.isfinite(skey[:, :k]), idx[:, :k], -1).to(torch.int32)
        return out


def render_lambert_soft(verts, faces, vert_colors, o, d, light_dir,
                        K: int = 4, temp: float = 0.02,
                        margin: float = 0.2, ambient: float = 0.1,
                        t_min=1e-4, shade_smooth: float = 0.05,
                        background=(0., 0., 0.), device=None):
    """Differentiable RT render WITH silhouette gradients.

    Per ray, the K nearest plane-hit candidates (:func:`topk_plane_hits`,
    detached) are re-solved differentiably and composited front to back with
    sigmoid coverage weights

        w_k = sigmoid(min(u, v, 1-u-v) / temp)

    and transmittance prod_{j<k}(1 - w_j); the remaining transmittance takes
    the background.  w is ~1 inside a triangle, ~0 beyond the margin, and
    smooth across the edge, so d(image)/d(vertex) includes the visibility
    term.  The Lambert clamp is softplus-smoothed (shade_smooth) so the image
    is C^1 through the terminator too.  Returns (R, 3)."""
    verts, faces, o, d, vert_colors = _inputs(device, verts, faces, o, d,
                                              vert_colors)
    dev = verts.device
    prim_k = topk_plane_hits(verts, faces, o, d, K, t_min=t_min,
                             margin=margin)
    tri = triangle_arrays(verts, faces)
    l = _unit(light_dir, dev)

    R = o.shape[0]
    rgb = torch.zeros((R, 3), dtype=F32, device=dev)
    trans = torch.ones((R,), dtype=F32, device=dev)
    for k in range(K):
        prim = prim_k[:, k]
        live = prim >= 0
        p = prim.clamp(min=0)
        v0, e1, e2 = (gather_rows(a, p) for a in tri)
        _, u, v = solve_hit(o, d, v0, e1, e2)
        bdist = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        # smoothstep cutoff that reaches EXACTLY 0 at bdist = -margin:
        # candidates enter and leave the detached top-K set with zero
        # weight and C^1 continuity
        ramp = ((bdist + margin) / (0.5 * margin)).clamp(0.0, 1.0)
        cut = ramp * ramp * (3.0 - 2.0 * ramp)
        w = torch.sigmoid(bdist / temp) * cut * live.to(F32)

        f = faces[p.long()]
        albedo = _interp_rows(vert_colors, f, u, v)[:, :3]
        ndotl = _dot(_facing(_cross(e1, e2), d), l)
        if shade_smooth > 0:
            ndotl = shade_smooth * F.softplus(ndotl / shade_smooth)
        else:
            ndotl = ndotl.clamp(min=0.0)
        col = albedo * (ambient + ndotl[:, None])

        rgb = rgb + (trans * w)[:, None] * col
        trans = trans * (1.0 - w)
    return rgb + trans[:, None] * _on(background, dev)


def render_lambert(verts, faces, vert_colors, o, d, light_dir,
                   bvh_arrays=None, ambient=0.1, background=(0., 0., 0.),
                   device=None):
    """Differentiable Lambert-shaded RT render.

    Gradients flow to verts (through the hit position, the geometric normal
    and the barycentrics) and to vert_colors (through interpolation).
    Returns (R, 3) float32."""
    verts, faces, o, d, vert_colors = _inputs(device, verts, faces, o, d,
                                              vert_colors)
    prim, _, u, v = _closest_hit_diff(
        verts, faces, o, d, _bvh_on(bvh_arrays, verts.device), 1e-4,
        math.inf, bvh_mod.LEAF_SIZE)
    f = faces[prim.clamp(min=0).long()]
    albedo = _interp_rows(vert_colors, f, u, v)[:, :3]
    v0, v1, v2 = (gather_rows(verts, f[:, k]) for k in range(3))
    n = _facing(_cross(v1 - v0, v2 - v0), d)
    ndotl = _dot(n, _unit(light_dir, verts.device)).clamp(min=0.0)
    return _shade(albedo, ndotl, ambient, prim >= 0, background)
