"""Carry state from the JAX package into the port.

The renderer's "weights" are the trace, the binned arrays, the resolved
render state and the texel table.  These helpers rebuild the port's objects
from the JAX package's by reading attributes and numpy arrays only — this
module never imports jax or skybox_rt_tpu — so a test can feed both
packages exactly the same state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import fixed
from .core.state import RenderState, ShaderFlags
from .geom import binning, cgltrace
from .om.blend import BlendState
from .om.depth_stencil import DepthStencilState
from .om.merger import OMState
from .texture.sampler import TextureState


def _copy_fields(cls, obj, **overrides):
    vals = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}
    vals.update(overrides)
    return cls(**vals)


def trace_from_reference(obj) -> cgltrace.CGLTrace:
    """A JAX-package CGLTrace -> the port's, arrays copied."""
    drawcalls = [
        cgltrace.DrawCall(
            states=_copy_fields(cgltrace.RenderStates, dc.states),
            texture_id=int(dc.texture_id),
            pos=np.array(dc.pos, np.float32),
            color=np.array(dc.color, np.float32),
            texcoord=np.array(dc.texcoord, np.float32),
            indices=np.array(dc.indices, np.int32),
            near=float(dc.near), far=float(dc.far))
        for dc in obj.drawcalls]
    textures = {
        int(tid): cgltrace.Texture(format=int(t.format), width=int(t.width),
                                   height=int(t.height),
                                   pixels=np.array(t.pixels, np.uint8))
        for tid, t in obj.textures.items()}
    return cgltrace.CGLTrace(drawcalls=drawcalls, textures=textures)


def binned_from_reference(obj) -> binning.BinnedDrawcall:
    """A JAX-package BinnedDrawcall -> the port's (numpy arrays)."""
    return binning.BinnedDrawcall(
        edges=np.array(obj.edges, np.int32),
        attribs=np.array(obj.attribs, np.int32),
        tile_xy=np.array(obj.tile_xy, np.int32),
        tile_pids=np.array(obj.tile_pids, np.int32),
        tile_pid_count=np.array(obj.tile_pid_count, np.int32),
        tile_logsize=int(obj.tile_logsize),
        num_prims=int(obj.num_prims))


def render_state_from_reference(obj) -> RenderState:
    """A JAX-package RenderState (ShaderFlags, OMState with its
    DepthStencilState / BlendState and masks, TextureState, scissor) ->
    the port's."""
    om = obj.om
    tex = obj.tex
    if tex is not None:
        tex = _copy_fields(TextureState, tex,
                           mip_offsets=tuple(int(o) for o in tex.mip_offsets))
    return RenderState(
        flags=_copy_fields(ShaderFlags, obj.flags),
        om=_copy_fields(OMState, om,
                        ds=_copy_fields(DepthStencilState, om.ds),
                        blend=_copy_fields(BlendState, om.blend)),
        tex=tex,
        scissor=tuple(int(v) for v in obj.scissor))


def texels_from_reference(arr, device=None) -> torch.Tensor:
    """``np.asarray`` of a JAX texel table (uint32, flat or (N, 4) quad)
    -> the port's int32-pattern tensor."""
    return fixed.from_numpy_u32(np.asarray(arr), device=device)
