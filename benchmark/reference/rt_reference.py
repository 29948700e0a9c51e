"""Plain ray tracer: the reference that the ray-traced cells' images are
held to.

It renders the frame a ray-traced configuration and traffic mix describe
from the benchmark's own inputs (vertices, faces, vertex colours, texture
coordinates and texture, camera, shading constants), with the semantics of
a Whitted-style frame: a pinhole camera's rays through pixel centres
(row 0 at the bottom), two-sided Möller–Trumbore triangle tests
(|det| > 1e-9, u, v >= 0, u + v <= 1, 1e-4 < t < t_max), smooth normals
(area-weighted vertex normals, barycentric interpolation) facing the ray,
vertex colour times a bilinear texel with repeat wrapping, Lambert light
from one direction plus ambient, shadow rays from 1e-3 along the normal
(traced only where the surface faces the light), and mirror bounces from
1e-3 along the normal, blended by the scene's reflectivity.

It imports nothing of the program and takes nothing the program made.
Every ray is traced against every triangle that a conservative box test
cannot rule out: clusters of 32 triangles in Morton order of their
centroids, groups of 32 clusters, boxes padded and tested in float64.
Those tests only skip pairs that cannot hit, so the answer is that of the
all-pairs test; among hits at equal t the lowest triangle index wins.
The arithmetic of rays, triangle tests and shading runs in ``dtype``:
float64 for the reference, bfloat16 for the control.
"""
from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64
T_MIN = 1e-4
DET_EPS = 1e-9
SURFACE_OFFSET = 1e-3
SHADOW_T_MAX = 1e8
CLUSTER = 32
GROUP = 32
#: ray-triangle pairs a slice of the triangle tests holds (each float64
#: intermediate then 64 MiB)
PAIR_SLICE = 1 << 23
#: rays a chunk of the group test holds
RAY_CHUNK = 1 << 16


def vertex_normals(verts, faces):
    """Area-weighted vertex normals, float64 (V, 3)."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)


def _morton_order(cent):
    lo, hi = cent.min(0), cent.max(0)
    q = ((cent - lo) / np.maximum(hi - lo, 1e-20) * 1023).astype(np.int64)
    code = np.zeros(len(cent), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + (2 - axis))
    return np.argsort(code, kind="stable")


class Geometry:
    """Triangles in cluster order with their boxes, on ``device``."""

    def __init__(self, verts, faces, dtype, device):
        v = np.asarray(verts, np.float64)
        f = np.asarray(faces, np.int64)
        tri = v[f]                                        # (P, 3, 3)
        order = _morton_order(tri.mean(1))
        tri = tri[order]
        P = tri.shape[0]
        C = -(-P // CLUSTER)
        pad_rows = C * CLUSTER - P
        lo = np.concatenate([tri.min(1), np.full((pad_rows, 3), np.inf)])
        hi = np.concatenate([tri.max(1), np.full((pad_rows, 3), -np.inf)])
        c_lo = lo.reshape(C, CLUSTER, 3).min(1)
        c_hi = hi.reshape(C, CLUSTER, 3).max(1)
        G = -(-C // GROUP)
        gpad = G * GROUP - C
        g_lo = np.concatenate([c_lo, np.full((gpad, 3), np.inf)]
                              ).reshape(G, GROUP, 3).min(1)
        g_hi = np.concatenate([c_hi, np.full((gpad, 3), -np.inf)]
                              ).reshape(G, GROUP, 3).max(1)
        eps = 1e-9 * (1.0 + np.abs(v).max())

        def dev(a, dt=F64):
            return torch.as_tensor(a, device=device).to(dt)

        self.P, self.C, self.G = P, C, G
        self.prim = dev(order, torch.int64)               # slot -> face
        self.v0 = dev(tri[:, 0], dtype)
        self.e1 = dev(tri[:, 1] - tri[:, 0], dtype)
        self.e2 = dev(tri[:, 2] - tri[:, 0], dtype)
        self.c_lo, self.c_hi = dev(c_lo - eps), dev(c_hi + eps)
        self.g_lo, self.g_hi = dev(g_lo - eps), dev(g_hi + eps)


def _slab(o, inv, lo, hi, t_max):
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    near = torch.minimum(t1, t2).amax(-1)
    far = torch.maximum(t1, t2).amin(-1)
    return (near <= far) & (far >= 0.0) & (near <= t_max)


def _candidates(geo, o, d, t_max):
    """Yield (ray, slot) index pairs, ray within the chunk, in slices; every
    pair whose triangle the ray can hit below t_max is among them."""
    o64, d64 = o.to(F64), d.to(F64)
    inv = 1.0 / torch.where(d64.abs() < 1e-300,
                            torch.full_like(d64, 1e-300), d64)
    ar_g = torch.arange(GROUP, device=o.device)
    ar_c = torch.arange(CLUSTER, device=o.device)
    gm = _slab(o64[:, None], inv[:, None], geo.g_lo[None], geo.g_hi[None],
               t_max)
    ray, grp = gm.nonzero(as_tuple=True)
    step = max(1, PAIR_SLICE // GROUP)
    for s in range(0, ray.shape[0], step):
        r1, g1 = ray[s:s + step], grp[s:s + step]
        cl = (g1[:, None] * GROUP + ar_g[None]).reshape(-1)
        r2 = r1[:, None].expand(-1, GROUP).reshape(-1)
        keep = cl < geo.C
        r2, cl = r2[keep], cl[keep]
        cm = _slab(o64[r2], inv[r2], geo.c_lo[cl], geo.c_hi[cl], t_max)
        r2, cl = r2[cm], cl[cm]
        sub = max(1, PAIR_SLICE // CLUSTER)
        for k in range(0, r2.shape[0], sub):
            slot = (cl[k:k + sub, None] * CLUSTER + ar_c[None]).reshape(-1)
            r3 = r2[k:k + sub, None].expand(-1, CLUSTER).reshape(-1)
            keep = slot < geo.P
            yield r3[keep], slot[keep]


def _mt(o, d, v0, e1, e2, t_max):
    """Möller–Trumbore on matching rows: (hit, t, u, v)."""
    pv = torch.linalg.cross(d, e2)
    det = (e1 * pv).sum(-1)
    ok = det.abs() > DET_EPS
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tv = o - v0
    u = (tv * pv).sum(-1) * inv_det
    qv = torch.linalg.cross(tv, e1)
    v = (d * qv).sum(-1) * inv_det
    t = (e2 * qv).sum(-1) * inv_det
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > T_MIN) & (t < t_max)
    return hit, t, u, v


def closest_hit(geo, o, d):
    """(prim (R,) int64, -1 for a miss; t, u, v in o's dtype)."""
    R = o.shape[0]
    prim = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    t_out = torch.full((R,), math.inf, dtype=o.dtype, device=o.device)
    u_out = torch.zeros((R,), dtype=o.dtype, device=o.device)
    v_out = torch.zeros_like(u_out)
    for lo in range(0, R, RAY_CHUNK):
        oc, dc = o[lo:lo + RAY_CHUNK], d[lo:lo + RAY_CHUNK]
        found = []
        for r, s in _candidates(geo, oc, dc, math.inf):
            hit, t, u, v = _mt(oc[r], dc[r], geo.v0[s], geo.e1[s],
                               geo.e2[s], math.inf)
            found.append((r[hit], geo.prim[s[hit]], t[hit], u[hit], v[hit]))
        if not found:
            continue
        r, p, t, u, v = (torch.cat(c) for c in zip(*found))
        n = oc.shape[0]
        best_t = torch.full((n,), math.inf, dtype=t.dtype, device=t.device
                            ).scatter_reduce(0, r, t, "amin")
        at_best = t == best_t[r]
        best_p = torch.full((n,), geo.P, dtype=torch.int64, device=t.device
                            ).scatter_reduce(0, r[at_best], p[at_best], "amin")
        win = at_best & (p == best_p[r])
        rw = r[win] + lo
        prim[rw], t_out[rw], u_out[rw], v_out[rw] = p[win], t[win], u[win], \
            v[win]
    return prim, t_out, u_out, v_out


def any_hit(geo, o, d, t_max):
    """(R,) bool: does a triangle lie on the ray within (1e-4, t_max)?"""
    R = o.shape[0]
    occ = torch.zeros((R,), dtype=torch.bool, device=o.device)
    for lo in range(0, R, RAY_CHUNK):
        oc, dc = o[lo:lo + RAY_CHUNK], d[lo:lo + RAY_CHUNK]
        for r, s in _candidates(geo, oc, dc, t_max):
            hit, _, _, _ = _mt(oc[r], dc[r], geo.v0[s], geo.e1[s], geo.e2[s],
                               t_max)
            occ[r[hit] + lo] = True
    return occ


def _unit(a):
    return a / a.norm(dim=-1, keepdim=True)


def camera_rays(camera, width, height, dtype, device):
    """Rays through pixel centres in scanline order, row 0 at the bottom."""
    def vec(x):
        return torch.tensor(x, dtype=dtype, device=device)

    eye = vec(camera["eye"])
    fwd = _unit(vec(camera["look_at"]) - eye)
    right = _unit(torch.linalg.cross(fwd, vec(camera["up"])))
    up = torch.linalg.cross(right, fwd)
    tan_h = math.tan(math.radians(camera["fov_y_deg"]) / 2)
    ys = ((torch.arange(height, device=device, dtype=dtype) + 0.5) / height
          * 2 - 1) * tan_h
    xs = ((torch.arange(width, device=device, dtype=dtype) + 0.5) / width
          * 2 - 1) * (tan_h * width / height)
    d = (fwd + right * xs[None, :, None] + up * ys[:, None, None])
    d = _unit(d).reshape(-1, 3)
    return eye.expand(d.shape).contiguous(), d


def bilinear(tex, s, t):
    """Bilinear texel at (s, t) with repeat wrapping, texel centres at
    half-integers; tex (TH, TW, 4)."""
    th, tw = tex.shape[0], tex.shape[1]
    x = torch.remainder(s, 1.0) * tw - 0.5
    y = torch.remainder(t, 1.0) * th - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    xi = torch.remainder(x0.long(), tw)
    yi = torch.remainder(y0.long(), th)
    xj, yj = torch.remainder(xi + 1, tw), torch.remainder(yi + 1, th)
    top = tex[yi, xi] * (1 - fx) + tex[yi, xj] * fx
    bottom = tex[yj, xi] * (1 - fx) + tex[yj, xj] * fx
    return top * (1 - fy) + bottom * fy


class Renderer:
    """The frame of one scene, camera and traffic mix, in ``dtype``."""

    def __init__(self, scene, config, traffic, dtype=F64, device="cpu"):
        self.dtype, self.device = dtype, device
        self.traffic, self.config = traffic, config
        shade = config["shading"]
        faces = np.asarray(scene["faces"], np.int64)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   device=device).to(dtype)

        self.geo = Geometry(scene["verts"], faces, dtype, device)
        self.faces = torch.as_tensor(faces, device=device)
        self.normals = dev(vertex_normals(scene["verts"], faces))
        self.colors = dev(scene["colors"])
        self.uvs = None if scene["uvs"] is None else dev(scene["uvs"])
        self.texture = (None if scene["texture"] is None
                        else dev(scene["texture"]))
        self.reflectivity = float(config["reflectivity"])
        self.ambient = float(shade["ambient"])
        self.light_dir = _unit(dev(shade["light_dir"]))
        self.light_color = dev(shade["light_color"])
        self.background = dev(shade["background"])
        #: (kind, rays) of every query the frame traced, in order
        self.queries = []

    def _interp(self, attr, prim, u, v):
        corner = attr[self.faces[prim]]                   # (R, 3, C)
        w = (1 - u - v)[:, None]
        return (corner[:, 0] * w + corner[:, 1] * u[:, None]
                + corner[:, 2] * v[:, None])

    def shade(self, o, d):
        """Trace and shade rays: (rgb, hit, point, normal)."""
        prim, t, u, v = closest_hit(self.geo, o, d)
        self.queries.append(("closest", o.shape[0]))
        hit = prim >= 0
        rgb = torch.zeros_like(o)
        pt = torch.zeros_like(o)
        n = torch.zeros_like(o)
        if not bool(hit.any()):
            return rgb, hit, pt, n
        oh, dh, ph = o[hit], d[hit], prim[hit]
        uh, vh = u[hit], v[hit]
        p = oh + dh * t[hit][:, None]
        nh = _unit(self._interp(self.normals, ph, uh, vh))
        nh = torch.where((nh * dh).sum(-1, keepdim=True) > 0, -nh, nh)
        albedo = self._interp(self.colors, ph, uh, vh)[:, :3]
        if self.config.get("texture") is not None:
            st = self._interp(self.uvs, ph, uh, vh)
            albedo = albedo * bilinear(self.texture, st[:, 0], st[:, 1])[:, :3]
        ndotl = (nh * self.light_dir).sum(-1).clamp(min=0)
        if self.traffic["shadows"]:
            lit = ndotl > 0
            so = p[lit] + nh[lit] * SURFACE_OFFSET
            sd = self.light_dir.expand(so.shape)
            blocked = any_hit(self.geo, so, sd, SHADOW_T_MAX)
            self.queries.append(("any", so.shape[0]))
            lit_idx = lit.nonzero(as_tuple=True)[0]
            ndotl[lit_idx[blocked]] = 0
        rgb[hit] = albedo * (self.ambient + ndotl[:, None] * self.light_color)
        pt[hit], n[hit] = p, nh
        return rgb, hit, pt, n

    def render(self):
        """(H, W, 4) image, row 0 at the bottom."""
        W, H = self.traffic["width"], self.traffic["height"]
        o, d = camera_rays(self.config["camera"], W, H, self.dtype,
                           self.device)
        rgb, hit, pt, n = self.shade(o, d)
        bg3 = self.background[:3]
        weight = torch.where(hit, self.reflectivity, 0.0).to(self.dtype)
        cur_pt, cur_d, cur_n = pt, d, n
        for _ in range(self.traffic["bounces"] if self.reflectivity > 0
                       else 0):
            live = (weight > 0).nonzero(as_tuple=True)[0]
            if live.numel() == 0:
                break
            dl, nl = cur_d[live], cur_n[live]
            rd = dl - 2 * (dl * nl).sum(-1, keepdim=True) * nl
            ro = cur_pt[live] + nl * SURFACE_OFFSET
            rgb2, hit2, pt2, n2 = self.shade(ro, rd)
            w = weight[live][:, None]
            contrib = torch.where(hit2[:, None], rgb2, bg3)
            rgb[live] = rgb[live] * (1 - w) + contrib * w
            weight[live] = weight[live] * torch.where(
                hit2, self.reflectivity, 0.0).to(self.dtype)
            cur_pt, cur_d, cur_n = (torch.zeros_like(pt), torch.zeros_like(d),
                                    torch.zeros_like(n))
            cur_pt[live], cur_d[live], cur_n[live] = pt2, rd, n2
        one = torch.ones_like(rgb[:, :1])
        out = torch.where(hit[:, None], torch.cat([rgb, one], 1),
                          self.background)
        return out.reshape(H, W, 4)


def render(scene, config, traffic, dtype=F64, device="cpu"):
    """(image (H, W, 4), queries [(kind, rays), ...]) of the frame."""
    r = Renderer(scene, config, traffic, dtype, device)
    return r.render(), r.queries
