"""Write the synthetic traces, ``data/synth_draw3d.npz`` and
``data/synth_config3.npz``.

The reference's captured scenes are not in this repository, so the port's
main path runs on a synthetic CGLTrace built to the shape of the flagship
scene (tekkaman: an untextured draw, then a textured, depth-tested
bilinear/WRAP/MODULATE draw) plus the OM states tekkaman lacks:

  d0  untextured icosphere (subdiv 4, 5,120 tris), per-vertex colors from
      np.random.default_rng(0), depth LESS with write
  d1  textured icosphere (subdiv 4), A8R8G8B8 64x64 checkerboard,
      bilinear, WRAP, MODULATE, depth LESS with write
  d2  alpha blending (SRC_ALPHA / ONE_MINUS_SRC_ALPHA) over 16 large
      overlapping triangles, depth LEQUAL without write, so the blend-slot
      retry grows past DEFAULT_BLEND_SLOTS
  d3  stencil ALWAYS with zpass INCR and writemask 0xFF over a grid plane,
      depth LESS without write.  The draw3d host writes the trace's zfail
      op into the ZPASS register (core/state.make_om_state), so the trace
      carries INCR in both fields

``synth_config3.npz`` is the trace of the ray-traced CGLTrace frame
(rt.frame).  It has the plan of the captured scene that path was written for
(vase: scan, winner, kslot x 3, scan) and the states that scene lacks.  Its
color write masks are 32-bit ARGB byte masks, which is how rt.raster_bridge
reads them (the raster path reads the low 4 bits: 0xFFFFFFFF writes every
channel under both readings):

  c0  full-screen quad (2 tris), depth test off, vertex colors: scan
  c1  textured icosphere (subdiv 4, 5,120 tris), the checkerboard, bilinear,
      WRAP, MODULATE, depth LESS with write: winner, nearest
  c2  a larger concentric icosphere (subdiv 4), textured, blend SRC_ALPHA /
      ONE_MINUS_SRC_ALPHA, depth LEQUAL without write: kslot, two fragments a
      ray (front and back face) outside c1's silhouette
  c3  the 16 large overlapping triangles of synth_draw3d's d2, same blend,
      depth LEQUAL without write, behind the viewer-side half of c1: kslot,
      K doubles from 1 to P = 16, where the last round runs no probe
  c4  icosphere (subdiv 3, 1,280 tris), texture CLAMP + NEAREST, envmode ADD,
      depth test off, no blend: kslot, opaque, the last submitted fragment
      of a ray wins
  c5  untextured icosphere (subdiv 3), depth GREATER with write: winner,
      farthest (it shows where it lies behind what was drawn with a write)
  c6  full-screen quad, blend DST_COLOR / ZERO, write mask RGB only
      (0x00FFFFFF): scan; alpha keeps what c0..c5 left

Both files are written in the JAX package's npz trace layout and committed:
both packages, on every machine, read the same bytes, so no float
computation of scene generation runs twice.

    python -m skybox_rt_tpu_torch.models.make_synth_trace [name [out.npz]]

``name`` is synth_draw3d or synth_config3; with no argument both are written
to their committed paths.
"""
from __future__ import annotations

import os
import sys

import numpy as np

from ..core import constants as C
from ..geom import cgltrace
from . import scenes

F32 = np.float32
OUT = os.path.join(cgltrace.DATA_DIR, "synth_draw3d.npz")
OUT_CONFIG3 = os.path.join(cgltrace.DATA_DIR, "synth_config3.npz")
ALL_CHANNELS = 0xFFFFFFFF


def _states(**kw) -> cgltrace.RenderStates:
    base = dict(
        color_enabled=True, color_writemask=0xF,
        depth_test=True, depth_writemask=1, depth_func=C.CGL_COMPARE_LESS,
        stencil_test=False, stencil_func=C.CGL_COMPARE_ALWAYS,
        stencil_zpass=C.CGL_STENCIL_KEEP, stencil_zfail=C.CGL_STENCIL_KEEP,
        stencil_fail=C.CGL_STENCIL_KEEP, stencil_ref=0, stencil_mask=0xFF,
        stencil_writemask=0xFF,
        texture_enabled=False, texture_envmode=C.CGL_ENVMODE_MODULATE,
        texture_minfilter=C.CGL_FILTER_LINEAR,
        texture_magfilter=C.CGL_FILTER_LINEAR,
        texture_addressU=C.CGL_ADDRESS_WRAP,
        texture_addressV=C.CGL_ADDRESS_WRAP,
        blend_enabled=False, blend_src=C.CGL_BLEND_ONE,
        blend_dst=C.CGL_BLEND_ZERO)
    base.update(kw)
    return cgltrace.RenderStates(**base)


def _sphere_clip(verts, cx, cy, r, zc):
    """Unit-sphere verts -> clip space: screen center (cx, cy), radius r,
    NDC depth zc + 0.3 z, with a mild perspective w = 1 + 0.25 z."""
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    w = F32(1.0) + F32(0.25) * z
    ndc = np.stack([cx + r * x, cy + r * y, zc + F32(0.3) * z], -1)
    return np.concatenate([ndc * w[:, None], w[:, None]], -1).astype(F32)


def _checker_argb_bytes(size=64, tiles=8) -> np.ndarray:
    tex = np.round(scenes.checkerboard_texture(size, tiles) * 255)
    r, g, b, a = (tex[..., k].astype(np.uint32) for k in range(4))
    words = (a << 24) | (r << 16) | (g << 8) | b
    return words.astype("<u4").reshape(-1).view(np.uint8).copy()


def _overlapping_triangles(rng, n_tris=16):
    """(pos (3n, 4), color (3n, 4)) of n large triangles at seeded depths,
    alpha 0.2..0.8: every pixel near the centre gets many fragments."""
    pos = np.zeros((3 * n_tris, 4), F32)
    for t in range(n_tris):
        base = rng.uniform(-0.4, 0.4, size=2)
        z = rng.uniform(-0.9, 0.9)
        ang = rng.uniform(0, 2 * np.pi)
        for k in range(3):
            a = ang + k * 2 * np.pi / 3
            pos[3 * t + k] = [base[0] + 0.9 * np.cos(a),
                              base[1] + 0.9 * np.sin(a), z, 1.0]
    col = rng.uniform(0.0, 1.0, size=(3 * n_tris, 4)).astype(F32)
    col[:, 3] = rng.uniform(0.2, 0.8, size=3 * n_tris)
    return pos, col


def _sphere_uv(sv):
    u = F32(2.0) * (F32(0.5) + np.arctan2(sv[:, 2], sv[:, 0])
                    / F32(2 * np.pi))
    v = F32(0.5) - np.arcsin(np.clip(sv[:, 1], -1, 1)) / F32(np.pi)
    return np.stack([u, v], -1).astype(F32)


def _full_screen_quad(z, colors):
    pos = np.array([[-1, -1, z, 1], [1, -1, z, 1], [1, 1, z, 1],
                    [-1, 1, z, 1]], F32)
    return dict(pos=pos, color=np.asarray(colors, F32),
                texcoord=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], F32),
                indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32))


def build_config3_trace() -> cgltrace.CGLTrace:
    rng = np.random.default_rng(3)
    sv4, sf4 = scenes.icosphere(subdiv=4)
    sv3, sf3 = scenes.icosphere(subdiv=3)
    blend = dict(blend_enabled=True, blend_src=C.CGL_BLEND_SRC_ALPHA,
                 blend_dst=C.CGL_BLEND_ONE_MINUS_SRC_ALPHA,
                 depth_func=C.CGL_COMPARE_LEQUAL, depth_writemask=0)

    def states(**kw):
        return _states(color_writemask=ALL_CHANNELS, **kw)

    def draw(st, near=0.0, far=1.0, **arrays):
        return cgltrace.DrawCall(states=st, texture_id=0, near=near, far=far,
                                 **arrays)

    def sphere(sv, sf, cx, cy, r, zc, color, uv=None):
        return dict(pos=_sphere_clip(sv, F32(cx), F32(cy), F32(r), F32(zc)),
                    color=color.astype(F32),
                    texcoord=(np.zeros((sv.shape[0], 2), F32) if uv is None
                              else uv), indices=sf)

    c0 = draw(states(depth_test=False, depth_writemask=0),
              **_full_screen_quad(0.9, [[0.10, 0.12, 0.30, 1.0],
                                        [0.30, 0.10, 0.12, 1.0],
                                        [0.12, 0.30, 0.10, 1.0],
                                        [0.25, 0.25, 0.05, 1.0]]))
    c1 = draw(states(texture_enabled=True),
              **sphere(sv4, sf4, -0.15, 0.05, 0.45, 0.0,
                       rng.uniform(0.5, 1.0, size=(sv4.shape[0], 4)),
                       _sphere_uv(sv4)))
    col2 = rng.uniform(0.3, 1.0, size=(sv4.shape[0], 4))
    col2[:, 3] = rng.uniform(0.25, 0.6, size=sv4.shape[0])
    c2 = draw(states(texture_enabled=True, **blend),
              **sphere(sv4, sf4, -0.15, 0.05, 0.62, 0.0, col2,
                       _sphere_uv(sv4)))
    # the rng of synth_draw3d's d2 starts after its two spheres' colors:
    # draw those first so that c3 is that draw's geometry
    rng0 = np.random.default_rng(0)
    nv = sv4.shape[0]
    rng0.uniform(0.0, 1.0, size=(nv, 4))
    rng0.uniform(0.5, 1.0, size=(nv, 4))
    pos3, col3 = _overlapping_triangles(rng0)
    c3 = draw(states(**blend), pos=pos3, color=col3,
              texcoord=np.zeros((pos3.shape[0], 2), F32),
              indices=np.arange(pos3.shape[0], dtype=np.int32).reshape(-1, 3))
    c4 = draw(states(depth_test=False, depth_writemask=0,
                     texture_enabled=True, texture_envmode=C.CGL_ENVMODE_ADD,
                     texture_magfilter=C.CGL_FILTER_NEAREST,
                     texture_minfilter=C.CGL_FILTER_NEAREST,
                     texture_addressU=C.CGL_ADDRESS_CLAMP,
                     texture_addressV=C.CGL_ADDRESS_CLAMP),
              **sphere(sv3, sf3, 0.55, -0.5, 0.3, 0.1,
                       rng.uniform(0.0, 0.6, size=(sv3.shape[0], 4)),
                       _sphere_uv(sv3) * F32(0.75) - F32(0.1)))
    c5 = draw(states(depth_func=C.CGL_COMPARE_GREATER),
              **sphere(sv3, sf3, 0.35, 0.45, 0.4, -0.1,
                       rng.uniform(0.2, 1.0, size=(sv3.shape[0], 4))))
    c6 = draw(_states(color_writemask=0x00FFFFFF, depth_test=False,
                      depth_writemask=0, blend_enabled=True,
                      blend_src=C.CGL_BLEND_DST_COLOR,
                      blend_dst=C.CGL_BLEND_ZERO),
              **_full_screen_quad(0.1, [[1.0, 0.9, 0.8, 0.5],
                                        [0.8, 1.0, 0.9, 0.5],
                                        [0.9, 0.8, 1.0, 0.5],
                                        [1.0, 1.0, 1.0, 0.5]]))
    tex = cgltrace.Texture(format=C.CGL_FORMAT_A8R8G8B8, width=64, height=64,
                           pixels=_checker_argb_bytes())
    return cgltrace.CGLTrace(drawcalls=[c0, c1, c2, c3, c4, c5, c6],
                             textures={0: tex})


def build_layered_trace(layers=3, grid=6) -> cgltrace.CGLTrace:
    """A one-draw trace of stacked translucent sheets
    (scenes.layered_trace): the frame's overflow retry has to reach
    K >= layers.  Not written to a file."""
    pos, idx, col, uv = scenes.layered_trace(layers, grid)
    st = _states(color_writemask=ALL_CHANNELS, depth_test=False,
                 depth_writemask=0, depth_func=C.CGL_COMPARE_NEVER,
                 blend_enabled=True, blend_src=C.CGL_BLEND_SRC_ALPHA,
                 blend_dst=C.CGL_BLEND_ONE_MINUS_SRC_ALPHA)
    dc = cgltrace.DrawCall(states=st, texture_id=-1, pos=pos, color=col,
                           texcoord=uv, indices=idx, near=0.0, far=1.0)
    return cgltrace.CGLTrace(drawcalls=[dc], textures={})


def build_trace() -> cgltrace.CGLTrace:
    rng = np.random.default_rng(0)
    sv, sf = scenes.icosphere(subdiv=4)
    nv = sv.shape[0]
    no_uv = np.zeros((nv, 2), F32)

    d0 = cgltrace.DrawCall(
        states=_states(), texture_id=0,
        pos=_sphere_clip(sv, F32(-0.3), F32(0.05), F32(0.55), F32(0.0)),
        color=rng.uniform(0.0, 1.0, size=(nv, 4)).astype(F32),
        texcoord=no_uv, indices=sf, near=0.0, far=1.0)

    d1 = cgltrace.DrawCall(
        states=_states(texture_enabled=True), texture_id=0,
        pos=_sphere_clip(sv, F32(0.3), F32(-0.05), F32(0.55), F32(-0.05)),
        color=rng.uniform(0.5, 1.0, size=(nv, 4)).astype(F32),
        texcoord=_sphere_uv(sv), indices=sf,
        near=0.0, far=1.0)

    n_tris = 16
    pos, col = _overlapping_triangles(rng, n_tris)
    d2 = cgltrace.DrawCall(
        states=_states(depth_func=C.CGL_COMPARE_LEQUAL, depth_writemask=0,
                       blend_enabled=True, blend_src=C.CGL_BLEND_SRC_ALPHA,
                       blend_dst=C.CGL_BLEND_ONE_MINUS_SRC_ALPHA),
        texture_id=0, pos=pos, color=col,
        texcoord=np.zeros((3 * n_tris, 2), F32),
        indices=np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3),
        near=0.0, far=1.0)

    gv, gf = scenes.mesh_grid_plane(n=16, y=0.0, half=1.0)
    gx, gz = gv[:, 0], gv[:, 2]
    gpos = np.stack([F32(0.85) * gx, F32(0.85) * gz,
                     F32(0.1) + F32(0.3) * gx, np.ones_like(gx)], -1)
    d3 = cgltrace.DrawCall(
        states=_states(depth_writemask=0, stencil_test=True,
                       stencil_func=C.CGL_COMPARE_ALWAYS,
                       stencil_zpass=C.CGL_STENCIL_INCR,
                       stencil_zfail=C.CGL_STENCIL_INCR),
        texture_id=0, pos=gpos.astype(F32),
        color=rng.uniform(0.0, 1.0, size=(gv.shape[0], 4)).astype(F32),
        texcoord=np.zeros((gv.shape[0], 2), F32), indices=gf,
        near=0.0, far=1.0)

    tex = cgltrace.Texture(format=C.CGL_FORMAT_A8R8G8B8, width=64, height=64,
                           pixels=_checker_argb_bytes())
    return cgltrace.CGLTrace(drawcalls=[d0, d1, d2, d3], textures={0: tex})


TRACES = {"synth_draw3d": (build_trace, OUT),
            "synth_config3": (build_config3_trace, OUT_CONFIG3)}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    for name in (argv[:1] or sorted(TRACES)):
        build, out = TRACES[name]
        out = argv[1] if len(argv) > 1 else out
        cgltrace.save_npz(build(), out)
        print(out)


if __name__ == "__main__":
    main()
