"""Immediate-mode tile renderer — the behavioral oracle.

Counterpart of skybox_rt_tpu.ref.renderer.  Every binned tile is processed
at once (a batch dimension over tiles); within a tile the primitives are
walked in submission order, which keeps the reference's per-pixel order for
blending and depth ties.  Per primitive: edge evaluation + coverage ->
barycentric gradients -> fixed24 interpolation -> optional texture sample ->
output-merger masked update.  Exact-int throughout, in plain torch ops.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.state import RenderState
from ..om import merger as om_merger
from ..ops import cuda_raster
from ..ops.deferred import device_arrays, update_tiles
from ..raster import edge as edge_mod
from ..raster import interp as interp_mod
from ..texture import sampler as sampler_mod

FX24_ONE = 1 << 24


def shade_prim_tile(render_state: RenderState, texels, pid, edges, attribs,
                    xs, ys, fb_color, fb_ds):
    """Rasterize + shade + merge one primitive per tile over its tile.

    pid: (T,) int32 (-1 = no primitive); edges (P,3,3); attribs (P,7,3);
    xs, ys: (T, ts, ts) int32 global pixel coords; fb_*: (T, ts, ts) int32
    patterns; texels: int32 texel table (dummy when texturing is off).
    """
    flags = render_state.flags
    p = pid.clamp(min=0).to(torch.int64)
    valid = (pid >= 0)[:, None, None]
    at = attribs[p][:, None, None]                            # (T,1,1,7,3)

    evals = edge_mod.eval_edges(edges[p][:, None, None], xs, ys)
    cov = edge_mod.coverage(evals, xs, ys, render_state.scissor) & valid
    dx, dy = interp_mod.gradients(evals)

    def interp(idx):
        return interp_mod.interpolate(at[..., idx, :], dx, dy)

    # DEFAULTS (kernel.cpp:16-23): z=0, rgba=1, uv=0 in fixed24
    z = interp(0) if flags.depth_enabled else torch.zeros_like(dx)
    if flags.color_enabled:
        r, g, b, a = interp(1), interp(2), interp(3), interp(4)
    else:
        r = g = b = a = torch.full_like(dx, FX24_ONE)

    if flags.tex_enabled:
        # fixed24 -> fixed23 (TFixed<TEX_FXD_FRAC>(TFixed<24>): data >> 1)
        tex_color = sampler_mod.sample(render_state.tex, texels,
                                       interp(5) >> 1, interp(6) >> 1, lod=0)
        out_color = (interp_mod.modulate(r, g, b, a, tex_color)
                     if flags.tex_modulate else tex_color)
    else:
        out_color = interp_mod.to_rgba8(r, g, b, a)

    # OUTPUT_i passes the raw fixed24 data as depth
    return om_merger.write(render_state.om, cov, out_color, z,
                           fb_color, fb_ds)


def render_tiles(render_state: RenderState, texels, edges, attribs,
                 tile_pids, tile_xy, tile_fb_color, tile_fb_ds,
                 tile_logsize: int):
    """Walk all primitives of every tile; tile_fb_*: (T, ts, ts) gathered
    framebuffer tiles.  Returns the updated tiles."""
    xs, ys = cuda_raster.tile_grids(tile_xy, tile_logsize)
    fbc, fbd = tile_fb_color, tile_fb_ds
    for i in range(tile_pids.shape[1]):
        fbc, fbd = shade_prim_tile(render_state, texels, tile_pids[:, i],
                                   edges, attribs, xs, ys, fbc, fbd)
    return fbc, fbd


def render_arrays(render_state: RenderState, texels, dev_arrays, fb_color,
                  fb_ds, tile_logsize: int):
    """Render one draw from its device arrays (ops.deferred.device_arrays)
    into copies of the (padded) framebuffers."""
    edges, attribs, _, tile_pids, tile_xy = dev_arrays
    return update_tiles(
        lambda sel_c, sel_d: render_tiles(render_state, texels, edges,
                                          attribs, tile_pids, tile_xy,
                                          sel_c, sel_d, tile_logsize),
        tile_xy, fb_color, fb_ds, tile_logsize)


def render_drawcall(render_state: RenderState, texels, binned, fb_color,
                    fb_ds):
    """Render one binned drawcall into copies of the (padded) framebuffers.

    texels: int32 texel table for the bound texture (None when texturing is
    disabled)."""
    device = fb_color.device
    if texels is None:
        texels = torch.zeros((1,), dtype=torch.int32, device=device)
    return render_arrays(render_state, texels,
                         device_arrays(binned, device), fb_color, fb_ds,
                         binned.tile_logsize)


def pad_framebuffer(fb: np.ndarray, tile_logsize: int) -> np.ndarray:
    """Pad an (H, W) buffer up to tile-size multiples (zeros)."""
    ts = 1 << tile_logsize
    H, W = fb.shape
    Hp = -(-H // ts) * ts
    Wp = -(-W // ts) * ts
    if (Hp, Wp) == (H, W):
        return fb
    out = np.zeros((Hp, Wp), fb.dtype)
    out[:H, :W] = fb
    return out
