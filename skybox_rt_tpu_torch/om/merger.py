"""Output merger: depth/stencil test -> blend -> masked framebuffer update.

Counterpart of skybox_rt_tpu.om.merger, the port of OutputMerger
(sim/simx/om_unit.cpp:24-154) as a pure function on framebuffer tiles.
Words arrive and leave as int32 patterns (core.fixed).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import constants as C
from ..core.fixed import s32
from . import blend as blend_mod
from . import depth_stencil as ds_mod


@dataclasses.dataclass(frozen=True)
class OMState:
    """The OM DCR block, resolved (om_unit.cpp:28-49)."""
    ds: ds_mod.DepthStencilState
    blend: blend_mod.BlendState
    depth_writemask: bool
    stencil_front_writemask: int
    stencil_back_writemask: int
    cbuf_writemask4: int     # 4-bit per-byte mask

    @property
    def cbuf_writemask(self) -> int:
        m = self.cbuf_writemask4 & 0xF
        return (((m >> 0) & 1) * 0x000000FF
                | ((m >> 1) & 1) * 0x0000FF00
                | ((m >> 2) & 1) * 0x00FF0000
                | ((m >> 3) & 1) * 0xFF000000)

    @property
    def color_write(self) -> bool:
        return (self.cbuf_writemask4 & 0xF) != 0


def _masked(dst: torch.Tensor, src: torch.Tensor, mask) -> torch.Tensor:
    """(dst & ~mask) | (src & mask) on int32 patterns (bitwise, so exact)."""
    return (dst & ~mask) | (src & mask)


def ds_carry_update(state: OMState, depth, cov, dsw):
    """The ds-word half of :func:`write` as a carry update (front face).

    Applies DepthTencil::test and the masked ds write (om_unit.cpp:85-127)
    to a carried depth-stencil word; the visibility pass (ops.cuda_raster)
    uses it, and its CUDA kernel implements the same steps.  Returns
    (new dsw as int32 patterns, contrib = cov & passed).
    """
    depth_en = state.ds.depth_enabled
    stencil_en = state.ds.stencil_enabled(False)
    if not (depth_en or stencil_en):
        return dsw, cov                      # ds never tested nor written

    dsw = dsw.to(torch.int32)
    passed, ds_result = ds_mod.test(state.ds, False, depth, dsw)
    zero = torch.zeros_like(dsw)
    if depth_en and state.depth_writemask:
        depth_mask = torch.where(passed, zero + C.OM_DEPTH_MASK, zero)
    else:
        depth_mask = zero
    swm = state.stencil_front_writemask
    stencil_mask = s32((swm & 0xFF) << C.OM_DEPTH_BITS) if stencil_en else 0
    ds_writemask = depth_mask | stencil_mask
    new_ds = _masked(dsw, ds_result, ds_writemask)
    dsw = torch.where(cov & (ds_writemask != 0), new_ds, dsw)
    return dsw, cov & passed


def write(state: OMState, covered, color, depth, fb_color, fb_ds,
          is_backface: bool = False):
    """Masked OM update of a framebuffer tile.

    covered: bool — pixels this primitive writes
    color:   u32 ARGB source color
    depth:   u32 source depth (low 24 bits used)
    fb_color, fb_ds: u32 destination tiles (int32 patterns)
    Returns updated (fb_color, fb_ds) as int32 patterns.
    """
    depth_en = state.ds.depth_enabled
    stencil_en = state.ds.stencil_enabled(is_backface)
    fb_color = fb_color.to(torch.int32)
    fb_ds = fb_ds.to(torch.int32)
    color = torch.as_tensor(color).to(torch.int32)

    if depth_en or stencil_en:
        ds_passed, ds_result = ds_mod.test(state.ds, is_backface, depth,
                                           fb_ds)
    else:
        ds_passed = torch.ones_like(covered)
        ds_result = fb_ds                    # never written (mask 0 below)

    if state.blend.enabled:
        blended = blend_mod.blend(state.blend, color, fb_color)
        color = torch.where(ds_passed, blended, color)

    # depth-stencil write (om_unit.cpp:118-127)
    swm = (state.stencil_back_writemask if is_backface
           else state.stencil_front_writemask)
    zero = torch.zeros_like(fb_ds)
    if depth_en and state.depth_writemask:
        depth_mask = torch.where(ds_passed, zero + C.OM_DEPTH_MASK, zero)
    else:
        depth_mask = zero
    stencil_mask = s32((swm & 0xFF) << C.OM_DEPTH_BITS) if stencil_en else 0
    ds_writemask = depth_mask | stencil_mask
    new_ds = _masked(fb_ds, ds_result, ds_writemask)
    fb_ds = torch.where(covered & (ds_writemask != 0), new_ds, fb_ds)

    # color write (om_unit.cpp:129-135)
    if state.color_write:
        new_color = _masked(fb_color, color, s32(state.cbuf_writemask))
        fb_color = torch.where(covered & ds_passed, new_color, fb_color)
    return fb_color, fb_ds
