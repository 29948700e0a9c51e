"""Output-merger demo app — tests/regression/om analog.

Counterpart of skybox_rt_tpu.apps.om_app.  The reference kernel
(om/kernel.cpp) fills the framebuffer through vx_om row-band by row-band;
with blending enabled each band gets alpha = band_index * (255 /
band_height), exercising SRC_A/ONE_MINUS_SRC_A ADD blending over the clear
color (om/main.cpp:174-186).  Both modes go through the OM module the
renderer uses (om.merger.write), on ``device``; words are int32 patterns
there (core.fixed) and leave as numpy uint32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core import fixed
from ..core.device import resolve_device
from ..om import blend as blend_mod
from ..om import depth_stencil as ds_mod
from ..om import merger as om_merger

STENCIL_OFF = dict(
    stencil_front_func=C.OM_DEPTH_FUNC_ALWAYS,
    stencil_front_zpass=C.OM_STENCIL_OP_KEEP,
    stencil_front_zfail=C.OM_STENCIL_OP_KEEP,
    stencil_front_fail=C.OM_STENCIL_OP_KEEP,
    stencil_front_ref=0, stencil_front_mask=C.OM_STENCIL_MASK,
    stencil_back_func=C.OM_DEPTH_FUNC_ALWAYS,
    stencil_back_zpass=C.OM_STENCIL_OP_KEEP,
    stencil_back_zfail=C.OM_STENCIL_OP_KEEP,
    stencil_back_fail=C.OM_STENCIL_OP_KEEP,
    stencil_back_ref=0, stencil_back_mask=C.OM_STENCIL_MASK,
)


def _om_state(blend_enable: bool, depth_enable: bool) -> om_merger.OMState:
    """The om host's DCR programming (om/main.cpp:147-186)."""
    ds = ds_mod.DepthStencilState(
        depth_func=(C.OM_DEPTH_FUNC_LESS if depth_enable
                    else C.OM_DEPTH_FUNC_ALWAYS),
        depth_writemask=depth_enable,
        **STENCIL_OFF)
    if blend_enable:
        bl = blend_mod.BlendState(
            mode_rgb=C.OM_BLEND_MODE_ADD, mode_a=C.OM_BLEND_MODE_ADD,
            src_rgb=C.OM_BLEND_FUNC_SRC_A, src_a=C.OM_BLEND_FUNC_SRC_A,
            dst_rgb=C.OM_BLEND_FUNC_ONE_MINUS_SRC_A,
            dst_a=C.OM_BLEND_FUNC_ONE_MINUS_SRC_A,
            const_color=0, logic_op=0)
    else:
        bl = blend_mod.BlendState(
            mode_rgb=C.OM_BLEND_MODE_ADD, mode_a=C.OM_BLEND_MODE_ADD,
            src_rgb=C.OM_BLEND_FUNC_ONE, src_a=C.OM_BLEND_FUNC_ONE,
            dst_rgb=C.OM_BLEND_FUNC_ZERO, dst_a=C.OM_BLEND_FUNC_ZERO,
            const_color=0, logic_op=0)
    return om_merger.OMState(
        ds=ds, blend=bl, depth_writemask=bool(depth_enable),
        stencil_front_writemask=0, stencil_back_writemask=0,
        cbuf_writemask4=0xF)


def run(width: int = 128, height: int = 128, color: int = 0xFFFFFFFF,
        depth: int | None = None, blend_enable: bool = False,
        depth_enable: bool = False, num_tasks: int = 64,
        device=None) -> np.ndarray:
    """Fill on ``device`` (None: the CUDA card); returns the (H, W) uint32
    ARGB color buffer (row 0 = bottom, framebuffer order, like the
    renderer; the host saves bottom-up)."""
    dev = resolve_device(device)
    if depth is None:
        depth = int(np.trunc(0.5 * (1 << 24)))      # TFixed<24>(0.5f)
    om = _om_state(blend_enable, depth_enable)

    def full(word):
        return torch.full((height, width), fixed.s32(word),
                          dtype=torch.int32, device=dev)

    fbc = full(0)                                   # clear_color 0x0
    fbd = full(depth)
    depth_grid = full(depth)

    tile_height = -(-height // num_tasks)
    alpha_step = np.float32(255.0) / np.float32(tile_height)
    ys = torch.arange(height, device=dev)
    for task in range(num_tasks):
        y0 = task * tile_height
        y1 = min(y0 + tile_height, height)
        if y0 >= y1:
            break
        alpha = int(np.float32(task) * alpha_step) if blend_enable else 0xFF
        c = ((alpha & 0xFF) << 24) | (color & 0x00FFFFFF)
        cov = ((ys >= y0) & (ys < y1))[:, None].expand(height, width)
        fbc, fbd = om_merger.write(om, cov, full(c), depth_grid, fbc, fbd)
    return fixed.to_numpy_u32(fbc)
