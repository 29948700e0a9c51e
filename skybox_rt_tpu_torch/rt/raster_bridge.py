"""Ray-traced rendering of CGLTrace (draw3d) scenes.

Counterpart of skybox_rt_tpu.rt.raster_bridge: the raster pipeline and the
ray-tracing path meet here.  Two camera models (``camera=`` of
:func:`render_trace_rt`):

  * "screen": every drawcall's clip-space geometry is mapped to screen space
    (geom/transform.clip_to_screen, the viewport mapping binning uses) and
    rendered with orthographic per-pixel rays marching along depth;
    screen-space barycentrics reweighted by 1/w give perspective-correct
    attribute interpolation.
  * "perspective": rays diverge from the origin of the space (x_clip, y_clip,
    w_clip), a linear image of view space, through each pixel's NDC, so
    coverage matches the raster per pixel and plain 3D barycentrics on the
    hit triangle interpolate attributes perspective-correctly.  Depth for the
    z-buffer is z_clip / w_clip at the hit, viewport-mapped.

This is a float renderer: it cross-checks the exact-int raster path scene by
scene and shows that the RT engines take captured geometry.

Depth-winner selection per drawcall:
  LESS/LEQUAL    -> closest hit
  GREATER/GEQUAL -> farthest hit (screen: closest on -z; perspective: the ray
                    starts beyond the scene and marches back)
  others         -> screen camera: last-submitted primitive wins
                    (orthographic hit on -prim_index)

Exactness: with the perspective camera, drawcalls whose winner is not an
ordering extreme (depth func ALWAYS/EQUAL/NOTEQUAL/NEVER, depth test off, or
blending on: every passing fragment contributes) run the submission-order
fragment scan :func:`_scan_drawcall`: every primitive in submission order
against the evolving per-ray z/color carry, a Python loop over the draw's
triangles on whole-ray tensors.  It is the exact oracle, not the fast path;
rt.frame is the fast one (``engine="pallas_bvh"``).

``color_writemask`` is read as the four ARGB byte masks of a 32-bit word, as
the JAX module reads it (the raster path takes its low 4 bits).

Stencil state is not modeled: drawcalls with stencil_test on raise
(``on_stencil="raise"``) or are skipped with a warning (``"skip"``).

Everything runs on one explicit device; ``device=None`` is the CUDA card
(core.device).
"""
from __future__ import annotations

import hashlib
import math
import warnings

import numpy as np
import torch

from ..core import constants as C
from ..core.device import resolve_device
from ..geom import cgltrace, transform
from ..ops import cuda_rt
from ..texture import mipmap
from . import bvh as bvh_mod
from . import intersect, tracer

F32 = torch.float32
#: treelet block size of the per-draw blocks of engine "pallas_bvh"; the JAX
#: package's value, so that both cut a draw into the same blocks
DRAW_TRI_BLOCK = 64


def _screen_triangles(dc, width: int, height: int):
    """Drawcall -> screen-space triangle soup + per-vertex attributes (numpy).

    Returns None when no primitive survives (behind the eye / degenerate).
    """
    pos = np.asarray(dc.pos, np.float32)
    keep_v = pos[:, 3] > 1e-20
    screen = np.zeros((pos.shape[0], 4), np.float32)
    safe = np.where(keep_v[:, None], pos, np.float32(1.0))
    screen[keep_v] = transform.clip_to_screen(
        safe, 0, width, 0, height, dc.near, dc.far)[keep_v]

    idx = np.asarray(dc.indices, np.int64)
    tri_ok = keep_v[idx].all(1)
    # degenerate screen-area reject (matches binning's det==0 reject)
    p = screen[idx]                      # (P, 3, 4)
    area = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
            - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))
    tri_ok &= np.abs(area) > 1e-12
    if not tri_ok.any():
        return None
    idx = idx[tri_ok]
    return {
        "xy_z": screen[:, :3],           # (V, 3) sx, sy, sz
        "rhw": screen[:, 3],             # (V,) 1/w
        "clip": pos,                     # (V, 4) clip-space positions
        "indices": idx.astype(np.int32),
        "color": np.asarray(dc.color, np.float32),
        "uv": np.asarray(dc.texcoord, np.float32),
    }


def _depth_key(geo, states):
    """Per-vertex 'depth' used for winner selection (see module doc)."""
    z = geo["xy_z"][:, 2]
    if not states.depth_test:
        return None                      # submission order decides
    f = states.depth_func
    if f in (C.CGL_COMPARE_LESS, C.CGL_COMPARE_LEQUAL):
        return z
    if f in (C.CGL_COMPARE_GREATER, C.CGL_COMPARE_GEQUAL):
        return -z
    return None


def _winner_tris(geo, key):
    """3D triangles whose ray-march order reproduces the depth winner.

    x, y are screen coords; the third coordinate is the selection key
    (depth, or -prim_index for submission order)."""
    idx = geo["indices"]
    if key is None:
        k = -np.arange(idx.shape[0], dtype=np.float32)
        kv = np.broadcast_to(k[:, None], idx.shape)
    else:
        kv = key[idx]
    v = geo["xy_z"][idx][:, :, :2]       # (P, 3, 2)
    tri = np.concatenate([v, kv[..., None]], -1)   # (P, 3, 3)
    return np.ascontiguousarray(tri.astype(np.float32))


def _persp_tris(geo):
    """(P, 3, 3) float32 numpy triangles in (x_c, y_c, w_c) space."""
    tri = geo["clip"][geo["indices"]][:, :, [0, 1, 3]]
    return np.ascontiguousarray(tri.astype(np.float32))


_ENGINE_PREP_CACHE: dict = {}


def _engine_prep(tri, engine: str, device):
    """Host acceleration-structure build for one triangle soup, cached by
    content hash, engine, device and leaf size: repeated renders of the
    same trace skip the per-draw SAH rebuild and the upload."""
    device = torch.device(device)
    key = (engine, str(device), tri.shape[0], tracer.BVH_LEAF_TRIS,
           hashlib.sha1(np.ascontiguousarray(tri).tobytes()).hexdigest())
    hit = _ENGINE_PREP_CACHE.get(key)
    if hit is not None:
        return hit
    v0 = torch.as_tensor(tri[:, 0], device=device)
    e1 = torch.as_tensor(tri[:, 1] - tri[:, 0], device=device)
    e2 = torch.as_tensor(tri[:, 2] - tri[:, 0], device=device)
    prep = {"v0": v0, "e1": e1, "e2": e2}
    if engine != "brute":
        verts = tri.reshape(-1, 3)
        faces = np.arange(verts.shape[0], dtype=np.int64).reshape(-1, 3)
        bvh = bvh_mod.build_sah(verts, faces)
        if engine == "pallas_bvh":
            bs = bvh_mod.build_block_set(bvh, tri_block=DRAW_TRI_BLOCK)
            prep["blocks"] = cuda_rt.prepare_bvh_blocks(
                v0, e1, e2, bs, bvh_mod.build_block_leaves(
                    bvh, bs, tracer.BVH_LEAF_TRIS))
        else:
            prep["stackless"] = bvh.as_stackless_arrays(device)
            prep["leaf_size"] = bvh.leaf_size
    while len(_ENGINE_PREP_CACHE) >= 256:   # bound: evict the oldest (FIFO)
        _ENGINE_PREP_CACHE.pop(next(iter(_ENGINE_PREP_CACHE)))
    _ENGINE_PREP_CACHE[key] = prep
    return prep


def _run_engine(tri, o, d, engine: str):
    """Closest hit of rays (o, d) against `tri` (P, 3, 3) float32 numpy:
    (prim, u, v)."""
    prep = _engine_prep(tri, engine, o.device)
    v0, e1, e2 = prep["v0"], prep["e1"], prep["e2"]
    if engine == "brute":
        prim, _, u, v = intersect.closest_hit_bruteforce(
            o, d, v0, e1, e2, t_min=1e-6)
    elif engine == "pallas_bvh":
        prim, _, u, v = cuda_rt.closest_hit_bvh(o, d, prep["blocks"],
                                                t_min=1e-6)
    else:
        prim, _, u, v = bvh_mod.closest_hit_stackless(
            prep["stackless"], (v0, e1, e2), o, d,
            t_min=1e-6, leaf_size=prep["leaf_size"])
    return prim, u, v


def _closest_hit(tri, px, py, engine: str):
    """Orthographic rays through the pixel grid against `tri` (P, 3, 3).

    Rays start below every selection key and march along +key, so the
    first hit is the winner.  Returns (prim (R,), u, v)."""
    kmin = float(tri[..., 2].min()) - 1.0
    o = torch.stack([px, py, torch.full_like(px, kmin)], -1)
    d = torch.zeros_like(o)
    d[:, 2] = 1.0
    return _run_engine(tri, o, d, engine)


def _persp_rays(tri, nx, ny, farthest: bool):
    """Perspective rays from the eye (the origin of (x_c, y_c, w_c) space)
    through the pixel grid's NDC; ``farthest`` starts them beyond the scene
    and marches back toward the eye (the GREATER/GEQUAL winner)."""
    dirs = torch.stack([nx, ny, torch.ones_like(nx)], -1)
    if farthest:
        return dirs * (float(tri[..., 2].max()) + 1.0), -dirs
    return torch.zeros_like(dirs), dirs


def _persp_hit(geo, nx, ny, farthest: bool, engine: str):
    """Closest (or farthest) hit of the perspective rays: (prim (R,), u, v)
    with 3D barycentrics."""
    tri = _persp_tris(geo)
    o, d = _persp_rays(tri, nx, ny, farthest)
    return _run_engine(tri, o, d, engine)


def _bary_weights(u, v):
    return torch.stack([1.0 - u - v, u, v], -1)            # (R, 3)


def _weighted(vals, w):
    """sum_k vals[:, k] * w[:, k]: (R, 3, K) x (R, 3) -> (R, K), summed left
    to right."""
    return (vals[:, 0] * w[:, 0:1] + vals[:, 1] * w[:, 1:2]
            + vals[:, 2] * w[:, 2:3])


def _interp_bary(attr, idx, prim, u, v):
    """Plain 3D-barycentric interpolation (perspective camera: the hit
    space is a linear image of view space, so this is perspective-correct
    with no 1/w reweighting)."""
    tri_idx = idx[prim.clamp(min=0).long()].long()          # (R, 3)
    return _weighted(attr[tri_idx], _bary_weights(u, v))


def _interp_pc(attr, idx, rhw, prim, u, v):
    """Perspective-correct interpolation: bary * rhw weights, renormalized."""
    tri_idx = idx[prim.clamp(min=0).long()].long()          # (R, 3)
    w = _bary_weights(u, v) * rhw[tri_idx]
    denom = (w[:, 0:1] + w[:, 1:2] + w[:, 2:3]).clamp(min=1e-30)
    return _weighted(attr[tri_idx], w) / denom


def _alpha4(c):
    return c[..., 3:4].expand(*c.shape[:-1], 4)


_BLEND_FACTORS = {
    C.CGL_BLEND_ZERO: lambda s, d: torch.zeros_like(s),
    C.CGL_BLEND_ONE: lambda s, d: torch.ones_like(s),
    C.CGL_BLEND_SRC_COLOR: lambda s, d: s,
    C.CGL_BLEND_ONE_MINUS_SRC_COLOR: lambda s, d: 1.0 - s,
    C.CGL_BLEND_SRC_ALPHA: lambda s, d: _alpha4(s),
    C.CGL_BLEND_ONE_MINUS_SRC_ALPHA: lambda s, d: 1.0 - _alpha4(s),
    C.CGL_BLEND_DST_ALPHA: lambda s, d: _alpha4(d),
    C.CGL_BLEND_ONE_MINUS_DST_ALPHA: lambda s, d: 1.0 - _alpha4(d),
    C.CGL_BLEND_DST_COLOR: lambda s, d: d,
    C.CGL_BLEND_ONE_MINUS_DST_COLOR: lambda s, d: 1.0 - d,
    # alpha-saturate: min(src_a, 1 - dst_a) on RGB, 1 on alpha
    C.CGL_BLEND_SRC_ALPHA_SATURATE: lambda s, d: torch.cat(
        [torch.minimum(s[..., 3:4], 1.0 - d[..., 3:4]).expand(
            *s.shape[:-1], 3), torch.ones_like(s[..., 3:4])], -1),
}


def _depth_pass(func, z, zbuf):
    table = {
        C.CGL_COMPARE_NEVER: lambda: torch.zeros_like(zbuf, dtype=torch.bool),
        C.CGL_COMPARE_LESS: lambda: z < zbuf,
        C.CGL_COMPARE_EQUAL: lambda: z == zbuf,
        C.CGL_COMPARE_LEQUAL: lambda: z <= zbuf,
        C.CGL_COMPARE_GREATER: lambda: z > zbuf,
        C.CGL_COMPARE_NOTEQUAL: lambda: z != zbuf,
        C.CGL_COMPARE_GEQUAL: lambda: z >= zbuf,
        C.CGL_COMPARE_ALWAYS: lambda: torch.ones_like(zbuf, dtype=torch.bool),
    }
    return table[func]()


def _sample_texture_wrap(tex, u, v, repeat: bool, bilinear: bool):
    """Texture fetch with repeat/clamp wrap: bilinear (half-texel centered
    like the fixed-point sampler) or point, per the draw state's
    magfilter."""
    th, tw = tex.shape[0], tex.shape[1]
    if not bilinear:
        def wrap_pt(i, n):
            i = torch.floor(i).to(torch.int64)
            return torch.remainder(i, n) if repeat else i.clamp(0, n - 1)
        return tex[wrap_pt(v * th, th), wrap_pt(u * tw, tw)]
    x = u * tw - 0.5
    y = v * th - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def wrap(i, n):
        i = torch.remainder(i, n) if repeat else i.clamp(0, n - 1)
        return i.to(torch.int64)

    x0i, x1i = wrap(x0, tw), wrap(x0 + 1, tw)
    y0i, y1i = wrap(y0, th), wrap(y0 + 1, th)
    t00 = tex[y0i, x0i]
    t01 = tex[y0i, x1i]
    t10 = tex[y1i, x0i]
    t11 = tex[y1i, x1i]
    top = t00 * (1 - fx) + t01 * fx
    bot = t10 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def _scan_statics(st, dc):
    """Hashable per-draw state tuple: what the composite of a draw depends
    on besides its arrays (the JAX package's jit cache key)."""
    return (st.texture_enabled, st.texture_envmode,
            st.texture_addressU == C.CGL_ADDRESS_WRAP,
            st.texture_magfilter != C.CGL_FILTER_NEAREST,
            st.color_enabled, st.depth_test, st.depth_func,
            st.depth_writemask, st.blend_enabled, st.blend_src,
            st.blend_dst, int(st.color_writemask) & 0xFFFFFFFF,
            float(dc.near), float(dc.far))


def _channel_mask(wm: int, device):
    """(4,) bool RGBA write mask from the ARGB bytes of the write mask.  Made
    when a draw is prepared: building it copies from the host."""
    return torch.tensor([bool(wm & 0x00FF0000), bool(wm & 0x0000FF00),
                         bool(wm & 0x000000FF), bool(wm & 0xFF000000)],
                        device=device)


def _texture_image(trace, dc, st, device):
    """(TH, TW, 4) float32 RGBA of the draw's texture, or one zero texel."""
    if not st.texture_enabled:
        return torch.zeros((1, 1, 4), dtype=F32, device=device)
    tex = trace.textures[dc.texture_id]
    vx_fmt = C.CGL_TO_VX_FORMAT[tex.format]
    return torch.as_tensor(np.asarray(mipmap.texture_rgba_float(
        tex.pixels, vx_fmt, tex.width, tex.height), np.float32),
        device=device)


def _texture_combine(envmode, src, texel):
    if envmode == C.CGL_ENVMODE_MODULATE:
        return src * texel
    if envmode == C.CGL_ENVMODE_ADD:
        return (src + texel).clamp(0.0, 1.0)
    return texel                         # REPLACE (and BLEND fallback)


def _om_write(statics, chan, passed, z, src, zbuf, color):
    """Depth test -> depth write -> blend -> channel-masked write of one
    fragment a ray: the output merger's step in float."""
    (_, _, _, _, _, depth_test, depth_func, depth_writemask, blend_enabled,
     blend_src, blend_dst, _, _, _) = statics
    if depth_test:
        passed = passed & _depth_pass(depth_func, z, zbuf)
        if depth_writemask:
            zbuf = torch.where(passed, z, zbuf)
    out = src
    if blend_enabled:
        sf = _BLEND_FACTORS[blend_src](src, color)
        df = _BLEND_FACTORS[blend_dst](src, color)
        out = (src * sf + color * df).clamp(0.0, 1.0)
    color = torch.where(passed[:, None] & chan[None, :], out, color)
    return zbuf, color


def _viewport_z(zw, near, far):
    """z_clip / w_clip (w guarded against 0), viewport-mapped."""
    half_d = 0.5 * (far - near)
    w = torch.where(zw[:, 1].abs() > 1e-30, zw[:, 1], torch.ones_like(zw[:, 1]))
    return (zw[:, 0] / w) * half_d + (near + half_d)


def _scan_arrays(geo, st, dc, trace, device):
    """Per-triangle rows of the scan on ``device``: v0, e1, e2 (P, 3) in
    (x_c, y_c, w_c) space, zw (P, 3, 2), col (P, 3, 4), uvv (P, 3, 2), the
    texture image and the channel mask."""
    clip = geo["clip"]
    idx = np.asarray(geo["indices"])
    tri = clip[idx][:, :, [0, 1, 3]].astype(np.float32)    # (P,3,3) x,y,w

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    return {
        "v0": up(tri[:, 0]), "e1": up(tri[:, 1] - tri[:, 0]),
        "e2": up(tri[:, 2] - tri[:, 0]),
        "zw": up(clip[idx][:, :, 2:4]),
        "col": up(np.asarray(geo["color"], np.float32)[idx]),
        "uvv": up(np.asarray(geo["uv"], np.float32)[idx]),
        "img": _texture_image(trace, dc, st, device),
        "chan": _channel_mask(_scan_statics(st, dc)[11], device),
    }


def _scan_run(statics, arr, nx, ny, zbuf, color):
    """The submission-order fragment scan over prepared arrays: one step a
    triangle, in order, each a Möller–Trumbore test of that triangle against
    all rays and the output merger's write.  Nothing here waits for the
    device."""
    (texture_enabled, envmode, repeat, bilinear, color_enabled,
     _, _, _, _, _, _, _, near, far) = statics
    dx, dy, dz = nx, ny, torch.ones_like(nx)
    ones = torch.ones((nx.shape[0], 4), dtype=F32, device=nx.device)
    for p in range(arr["v0"].shape[0]):
        v0x, v0y, v0z = arr["v0"][p].unbind()
        e1x, e1y, e1z = arr["e1"][p].unbind()
        e2x, e2y, e2z = arr["e2"][p].unbind()
        # Möller–Trumbore, one triangle against all rays from the origin
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = det.abs() > 1e-30
        inv = torch.where(ok, 1.0 / det, torch.zeros_like(det))
        tx, ty, tz = -v0x, -v0y, -v0z
        u = (tx * px + ty * py + tz * pz) * inv
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6)

        w = _bary_weights(u, v)

        def rows(a):
            return (w[:, 0:1] * a[p, 0] + w[:, 1:2] * a[p, 1]
                    + w[:, 2:3] * a[p, 2])

        z = _viewport_z(rows(arr["zw"]), near, far)
        src = rows(arr["col"]) if color_enabled else ones
        if texture_enabled:
            uvp = rows(arr["uvv"])
            texel = _sample_texture_wrap(arr["img"], uvp[:, 0], uvp[:, 1],
                                         repeat, bilinear)
            src = _texture_combine(envmode, src, texel)
        zbuf, color = _om_write(statics, arr["chan"], hit, z, src, zbuf,
                                color)
    return zbuf, color


def _scan_drawcall(geo, st, dc, trace, nx, ny, zbuf, color):
    """Submission-order fragment scan on perspective rays: the exact
    per-drawcall path (module docstring 'Exactness').

    Every primitive is intersected in submission order against the evolving
    per-ray (zbuf, color) carry, reproducing the output merger's sequential
    fragment semantics in float: depth funcs that need the live zbuf
    (EQUAL/NOTEQUAL/ALWAYS), submission-order winners (depth test off) and
    intra-draw multi-fragment blending are all exact, unlike the
    single-winner closest-hit path."""
    arr = _scan_arrays(geo, st, dc, trace, nx.device)
    return _scan_run(_scan_statics(st, dc), arr, nx, ny, zbuf, color)


def _winner_composite(statics, perspective, chan, idx, rhw, zattr, colattr,
                      uvattr, img, prim, u, v, zbuf, color):
    """Winner-path per-draw composite: interpolate -> texture -> depth ->
    blend -> masked write.  Nothing here waits for the device."""
    (texture_enabled, envmode, repeat, bilinear, color_enabled,
     _, _, _, _, _, _, _, near, far) = statics

    if perspective:
        def interp(attr):
            return _interp_bary(attr, idx, prim, u, v)
        zw = interp(zattr)
        half_d = 0.5 * (far - near)
        # z_ndc = z_c / w_c at the hit, viewport-mapped: the raster's
        # perspective-correct z (clip_to_screen z)
        z = (zw[:, 0] / zw[:, 1]) * half_d + (near + half_d)
    else:
        def interp(attr):
            return _interp_pc(attr, idx, rhw, prim, u, v)
        z = interp(zattr)[:, 0]
    hit = prim >= 0

    # color_enabled gates vertex-color interpolation (rgba defaults to 1.0
    # otherwise); the framebuffer write is gated by the write mask
    if color_enabled:
        src = interp(colattr)
    else:
        src = torch.ones((prim.shape[0], 4), dtype=F32, device=prim.device)
    if texture_enabled:
        uv_i = interp(uvattr)
        texel = _sample_texture_wrap(img, uv_i[:, 0], uv_i[:, 1], repeat,
                                     bilinear)
        src = _texture_combine(envmode, src, texel)
    return _om_write(statics, chan, hit, z, src, zbuf, color)


def pixel_rays(width: int, height: int, device):
    """Pixel centres (px, py) and their NDC (nx, ny), (H*W,) float32 each in
    scanline order, row 0 = top: the inverse of the viewport mapping in
    geom/transform.clip_to_screen."""
    ys, xs = np.mgrid[0:height, 0:width]
    px = (xs + 0.5).astype(np.float32).ravel()
    py = (ys + 0.5).astype(np.float32).ravel()
    nx = px * np.float32(2.0 / width) - np.float32(1.0)
    ny = py * np.float32(2.0 / height) - np.float32(1.0)
    return tuple(torch.as_tensor(a, device=device) for a in (px, py, nx, ny))


def clear_buffers(num_rays: int, device):
    """(zbuf (R,) = +inf, color (R, 4) = opaque black)."""
    color = torch.zeros((num_rays, 4), dtype=F32, device=device)
    color[:, 3] = 1.0
    zbuf = torch.full((num_rays,), math.inf, dtype=F32, device=device)
    return zbuf, color


def stencil_guard(st, on_stencil: str, who: str) -> bool:
    """True when the draw is to be skipped; raises when it must not be."""
    if not st.stencil_test:
        return False
    if on_stencil == "raise":
        raise NotImplementedError(
            f"{who} does not model stencil state; render this trace through "
            "the raster path, or pass on_stencil='skip'")
    warnings.warn(f"{who}: skipping drawcall with stencil enabled (not "
                  "modeled; use the raster path)")
    return True


def render_trace_rt(trace: cgltrace.CGLTrace, width: int, height: int,
                    engine: str = "bvh", camera: str = "screen",
                    start_draw: int = 0, end_draw: int = 2 ** 31,
                    on_stencil: str = "raise", device=None):
    """Ray-trace a CGLTrace scene -> (H, W, 4) float32 numpy RGBA (row 0 =
    top, the layout of ref.driver's framebuffers).

    camera: "screen" (orthographic screen-space rays) or "perspective" (rays
    diverging from the eye implied by the clip-space vertices).  engine:
    "brute", "bvh" (stackless) or "pallas_bvh" (the BVH-block kernel); with
    the perspective camera "pallas_bvh" takes the whole-frame path of
    rt.frame (the K-slot enumeration in place of the scan).
    """
    device = resolve_device(device)
    if camera == "perspective" and engine == "pallas_bvh":
        from . import frame as frame_mod
        return frame_mod.render_trace_rt_fused(
            trace, width, height, start_draw=start_draw,
            end_draw=end_draw, on_stencil=on_stencil, device=device)

    px, py, nx, ny = pixel_rays(width, height, device)
    zbuf, color = clear_buffers(height * width, device)

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    for dc in trace.drawcalls[start_draw:end_draw]:
        st = dc.states
        if stencil_guard(st, on_stencil, "raster_bridge"):
            continue
        geo = _screen_triangles(dc, width, height)
        if geo is None:
            continue
        key = _depth_key(geo, st)

        if camera == "perspective" and (key is None or st.blend_enabled):
            # exact submission-order fragment scan (see module docstring)
            zbuf, color = _scan_drawcall(geo, st, dc, trace, nx, ny,
                                         zbuf, color)
            continue

        if camera == "perspective":
            farthest = st.depth_func in (C.CGL_COMPARE_GREATER,
                                         C.CGL_COMPARE_GEQUAL)
            prim, u, v = _persp_hit(geo, nx, ny, farthest, engine)
            zattr = up(geo["clip"][:, 2:4].astype(np.float32))
        else:
            prim, u, v = _closest_hit(_winner_tris(geo, key), px, py, engine)
            zattr = up(geo["xy_z"][:, 2:3].astype(np.float32))
        statics = _scan_statics(st, dc)
        zbuf, color = _winner_composite(
            statics, camera == "perspective",
            _channel_mask(statics[11], device), up(geo["indices"]),
            up(geo["rhw"]), zattr, up(geo["color"]), up(geo["uv"]),
            _texture_image(trace, dc, st, device), prim, u, v, zbuf, color)

    return color.reshape(height, width, 4).cpu().numpy()


def render_scene_rt(name: str, width: int, height: int, **kw) -> np.ndarray:
    """Ray-trace one of the package's traces by name (geom.cgltrace
    trace_path)."""
    trace = cgltrace.load_trace(cgltrace.trace_path(name))
    return render_trace_rt(trace, width, height, **kw)


def framebuffer_to_float(fb: np.ndarray) -> np.ndarray:
    """(H, W) uint32 ARGB raster framebuffer -> (H, W, 4) float RGBA."""
    fb = np.asarray(fb, np.uint32)
    return np.stack([(fb >> 16) & 0xFF, (fb >> 8) & 0xFF, fb & 0xFF,
                     (fb >> 24) & 0xFF], -1).astype(np.float32) / 255.0
