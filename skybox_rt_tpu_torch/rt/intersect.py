"""Möller–Trumbore ray-triangle intersection, vectorized (plain torch).

Counterpart of skybox_rt_tpu.rt.intersect.  Rays and triangles are float32
tensors on one device; the brute-force closest hit here is the correctness
oracle for every traversal (rt.bvh, ops.cuda_rt).

The arithmetic is written out per component, in the order of the JAX
package's ``jnp.cross`` / ``jnp.sum`` (left to right), so that the two agree
to the last bit wherever neither backend contracts a multiply-add.  All-pairs
calls walk the rays in chunks so that no (R, P) intermediate exceeds
``PAIR_BUDGET`` ray-triangle pairs.

The small vector helpers and the parking ray below are shared by the frame
(rt.tracer) and the shade kernel's plain twin (ops.cuda_rt); this module
imports nothing of the package, so both can import it.
"""
from __future__ import annotations

import math

import torch

EPS = 1e-9
#: most ray-triangle pairs one all-pairs chunk may hold: each float32
#: intermediate of a chunk is then at most 16 MiB, and a chunk keeps about
#: forty of them alive, so a call stays under ~0.7 GiB
PAIR_BUDGET = 1 << 22

#: where a dead ray waits, and its direction (away from the scene): a
#: parked ray leaves every hierarchy at its top level
PARK_O = (3e7, 3e7, 3e7)
PARK_D = (0.57735, 0.57735, 0.57735)


def _norm3(a):
    """sqrt(x*x + y*y + z*z) over the last axis, keepdim."""
    return torch.sqrt(a[..., 0:1] * a[..., 0:1] + a[..., 1:2] * a[..., 1:2]
                      + a[..., 2:3] * a[..., 2:3])


def _dot3(a, b):
    """a.b over the last axis, keepdim, summed left to right."""
    return (a[..., 0:1] * b[..., 0:1] + a[..., 1:2] * b[..., 1:2]
            + a[..., 2:3] * b[..., 2:3])


def _vec(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


def _interp3(rows3, u, v):
    """Barycentric interpolation of a (R, 3, C) per-corner slice."""
    w = (1.0 - u - v)[..., None]
    return rows3[:, 0] * w + rows3[:, 1] * u[..., None] \
        + rows3[:, 2] * v[..., None]


def triangle_arrays(verts, faces):
    """(V,3) verts + (P,3) faces -> (v0, e1, e2) arrays for MT."""
    faces = faces.long()
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    return v0, v1 - v0, v2 - v0


def inv_dir(direction):
    """1/d per component for the slab tests, 1e30 where |d| <= 1e-12
    (axis-parallel rays): never inf, so no 0 * inf arises."""
    safe = direction.abs() > 1e-12
    one = torch.ones((), dtype=direction.dtype, device=direction.device)
    big = torch.full((), 1e30, dtype=direction.dtype, device=direction.device)
    return torch.where(safe, 1.0 / torch.where(safe, direction, one), big)


def _xyz(a):
    return a[..., 0], a[..., 1], a[..., 2]


def mt_components(ox, oy, oz, dx, dy, dz, v0, e1, e2):
    """Möller–Trumbore on broadcastable per-component tensors; v0, e1, e2
    are (x, y, z) tuples.  Returns (valid, t, u, v) without the interval
    test.  One multiply or add per line of the formula, left to right: the
    order of skybox_rt_tpu.ops.pallas_rt._mt_one and of csrc/rt_bvh.cu."""
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    valid = det.abs() > EPS
    one = torch.ones((), dtype=det.dtype, device=det.device)
    zero = torch.zeros((), dtype=det.dtype, device=det.device)
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, one), zero)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    return valid, t, u, v


def moller_trumbore(orig, direction, v0, e1, e2, t_min=1e-4, t_max=math.inf):
    """Batched Möller–Trumbore.

    orig, direction: (..., 3); v0, e1, e2: (..., 3) broadcastable triangle
    data (v0 = first vertex, e1 = v1-v0, e2 = v2-v0).  t_max is a number or
    a tensor broadcastable to the result.
    Returns (hit bool, t, u, v) with barycentrics u, v of the hit point
    (p = v0 + u*e1 + v*e2).  Backfaces hit too (two-sided).
    """
    valid, t, u, v = mt_components(*_xyz(orig), *_xyz(direction),
                                   _xyz(v0), _xyz(e1), _xyz(e2))
    hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    return hit, t, u, v


def _ray_chunks(R, P):
    step = max(1, PAIR_BUDGET // max(P, 1))
    return [(lo, min(lo + step, R)) for lo in range(0, R, step)]


def _per_ray(t_max, lo, hi):
    """Rows lo:hi of a per-ray t_max ((R,) or (R, 1)), as (r, 1); a scalar
    passes through."""
    if torch.is_tensor(t_max) and t_max.ndim > 0:
        return t_max.reshape(-1, 1)[lo:hi]
    return t_max


def closest_hit_bruteforce(orig, direction, v0, e1, e2,
                           t_min=1e-4, t_max=math.inf):
    """All-pairs closest hit: rays (R, 3) x triangles (P, 3).

    Returns (prim_id (R,) int32 [-1 = miss], t, u, v); ties go to the lowest
    prim id (argmin returns the first minimum).  O(R*P): the correctness
    oracle.
    """
    R, P = orig.shape[0], v0.shape[0]
    outs = []
    for lo, hi in _ray_chunks(R, P):
        hit, t, u, v = moller_trumbore(
            orig[lo:hi, None, :], direction[lo:hi, None, :],
            v0[None], e1[None], e2[None], t_min, _per_ray(t_max, lo, hi))
        t_masked = torch.where(hit, t, torch.full_like(t, math.inf))
        best = torch.argmin(t_masked, dim=1, keepdim=True)
        best_t = t_masked.gather(1, best)[:, 0]
        found = torch.isfinite(best_t)
        zero = torch.zeros_like(best_t)
        outs.append((
            torch.where(found, best[:, 0], -1).to(torch.int32),
            torch.where(found, best_t, torch.full_like(best_t, math.inf)),
            torch.where(found, u.gather(1, best)[:, 0], zero),
            torch.where(found, v.gather(1, best)[:, 0], zero)))
    if not outs:
        f = orig.new_zeros((0,))
        return f.to(torch.int32), f, f.clone(), f.clone()
    return tuple(torch.cat(c) for c in zip(*outs))


def any_hit_bruteforce(orig, direction, v0, e1, e2, t_min=1e-4, t_max=1.0):
    """Occlusion query (shadow rays): does anything block (t_min, t_max)?"""
    R, P = orig.shape[0], v0.shape[0]
    outs = []
    for lo, hi in _ray_chunks(R, P):
        hit, _, _, _ = moller_trumbore(
            orig[lo:hi, None, :], direction[lo:hi, None, :],
            v0[None], e1[None], e2[None], t_min, _per_ray(t_max, lo, hi))
        outs.append(hit.any(dim=1))
    if not outs:
        return torch.zeros((0,), dtype=torch.bool, device=orig.device)
    return torch.cat(outs)
