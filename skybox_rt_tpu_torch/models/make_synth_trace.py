"""Write the synthetic draw3d trace, ``data/synth_draw3d.npz``.

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

The file is written in the JAX package's npz trace layout and committed:
both packages, on every machine, read the same bytes, so no float
computation of scene generation runs twice.

    python -m skybox_rt_tpu_torch.models.make_synth_trace [out.npz]
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

    u = F32(2.0) * (F32(0.5) + np.arctan2(sv[:, 2], sv[:, 0])
                    / F32(2 * np.pi))
    v = F32(0.5) - np.arcsin(np.clip(sv[:, 1], -1, 1)) / F32(np.pi)
    d1 = cgltrace.DrawCall(
        states=_states(texture_enabled=True), texture_id=0,
        pos=_sphere_clip(sv, F32(0.3), F32(-0.05), F32(0.55), F32(-0.05)),
        color=rng.uniform(0.5, 1.0, size=(nv, 4)).astype(F32),
        texcoord=np.stack([u, v], -1).astype(F32), indices=sf,
        near=0.0, far=1.0)

    n_tris = 16
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


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else OUT
    cgltrace.save_npz(build_trace(), out)
    print(out)


if __name__ == "__main__":
    main()
