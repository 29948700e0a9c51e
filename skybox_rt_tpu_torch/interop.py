"""Carry state from the JAX package into the port.

The renderer's "weights" are the trace, the binned arrays, the resolved
render state and the texel table; the apps' are the bound texture units and
the LBM lattice's shape; the ray tracer's are the scene, its BVH,
the treelet blocks or clusters, the camera and the config; the differentiable
pipeline's are the parameter and binning dicts.  These helpers rebuild the
port's objects from the JAX package's by reading attributes and numpy arrays
only — this module never imports jax or skybox_rt_tpu — so a test can feed
both packages exactly the same state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .apps import lbm
from .core import fixed
from .core.device import resolve_device
from .core.state import RenderState, ShaderFlags
from .diff import pipeline as diff_pipeline
from .geom import binning, cgltrace
from .om.blend import BlendState
from .om.depth_stencil import DepthStencilState
from .om.merger import OMState
from .ops import cuda_rt
from .rt import bvh as bvh_mod
from .rt import tracer
from .texture import units as units_mod
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
    tex = None if obj.tex is None else texture_state_from_reference(obj.tex)
    return RenderState(
        flags=_copy_fields(ShaderFlags, obj.flags),
        om=_copy_fields(OMState, om,
                        ds=_copy_fields(DepthStencilState, om.ds),
                        blend=_copy_fields(BlendState, om.blend)),
        tex=tex,
        scissor=tuple(int(v) for v in obj.scissor))


def texture_state_from_reference(obj) -> TextureState:
    """A JAX-package TextureState -> the port's, field by field."""
    return _copy_fields(TextureState, obj,
                        mip_offsets=tuple(int(o) for o in obj.mip_offsets))


def texture_units_from_reference(obj) -> units_mod.TextureUnits:
    """A JAX-package TextureUnits -> the port's (unbound stages stay None)."""
    return units_mod.bind(*(None if st is None
                            else texture_state_from_reference(st)
                            for st in obj.states))


def lbm_config_from_reference(obj) -> lbm.LBMConfig:
    """A JAX-package LBMConfig -> the port's."""
    return _copy_fields(lbm.LBMConfig, obj)


def texels_from_reference(arr, device=None) -> torch.Tensor:
    """``np.asarray`` of a JAX texel table (uint32, flat or (N, 4) quad)
    -> the port's int32-pattern tensor."""
    return fixed.from_numpy_u32(np.asarray(arr), device=device)


def _np_or_none(a, dtype):
    return None if a is None else np.array(a, dtype)


def bvh_from_reference(obj) -> bvh_mod.BVH:
    """A JAX-package rt.bvh.BVH -> the port's: the seven node arrays, the
    leaf size and, where already built, the five preorder arrays."""
    return bvh_mod.BVH(
        node_min=np.array(obj.node_min, np.float32),
        node_max=np.array(obj.node_max, np.float32),
        node_left=np.array(obj.node_left, np.int32),
        node_right=np.array(obj.node_right, np.int32),
        node_first=np.array(obj.node_first, np.int32),
        node_count=np.array(obj.node_count, np.int32),
        prim_order=np.array(obj.prim_order, np.int32),
        leaf_size=int(obj.leaf_size),
        pre_min=_np_or_none(obj.pre_min, np.float32),
        pre_max=_np_or_none(obj.pre_max, np.float32),
        pre_first=_np_or_none(obj.pre_first, np.int32),
        pre_count=_np_or_none(obj.pre_count, np.int32),
        pre_escape=_np_or_none(obj.pre_escape, np.int32))


def rt_scene_from_reference(obj) -> tracer.RTScene:
    """A JAX-package rt.tracer.RTScene -> the port's, arrays copied and the
    built BVH (if any) carried over."""
    return tracer.RTScene(
        verts=np.array(obj.verts, np.float32),
        faces=np.array(obj.faces),
        colors=np.array(obj.colors, np.float32),
        normals=_np_or_none(obj.normals, np.float32),
        uvs=_np_or_none(obj.uvs, np.float32),
        texture=_np_or_none(obj.texture, np.float32),
        reflectivity=float(obj.reflectivity),
        bvh=None if obj.bvh is None else bvh_from_reference(obj.bvh),
        bvh_method=str(obj.bvh_method))


def bvh_blocks_from_reference(blocks, device, leaves=None) -> dict:
    """The dict of the JAX package's ``pallas_rt.prepare_bvh_blocks`` ->
    the port's ``ops.cuda_rt.prepare_bvh_blocks`` dict on ``device``: the
    nine record floats without the 128-lane padding and the AABB embedded
    in row 0, the block counts, the slot -> prim map and the AABB pyramid.

    The JAX blocks carry no leaf cut.  ``leaves``: the port's
    rt.bvh.build_block_leaves of the same BVH and block set (a BVH carried
    over with :func:`bvh_from_reference`); None makes every block one leaf
    with its own box, the JAX kernels' whole-block gate."""
    return cuda_rt.pack_blocks(
        np.asarray(blocks["tri"])[:, :9].astype(np.float32),
        np.array(blocks["bcnt"], np.int32),
        np.array(blocks["s2p"], np.int32),
        [np.array(a, np.float32) for a in blocks["levels"]],
        int(blocks["tri_block"]), int(blocks["num_prims"]), device,
        leaves=leaves)


def clusters_from_reference(clusters, v0, e1, e2, device) -> dict:
    """The dict of the JAX package's ``rt.bvh.build_clusters`` and the
    triangle arrays (v0, e1, e2: (P, 3), as numpy) its clustered kernels are
    called with -> the port's ``ops.cuda_rt.prepare_clusters`` dict on
    ``device``: the records in treelet order without the 16-lane padding,
    the cluster table, and the port's own group table and octant visit
    tables (the JAX package derives its table inside each call, it is no
    state)."""
    order = np.array(clusters["order"], np.int32)
    tri = cuda_rt.pack_records(
        *(torch.from_numpy(np.array(a, np.float32)) for a in (v0, e1, e2)),
        order=order)
    return cuda_rt.pack_clusters(
        tri, np.array(clusters["aabb"], np.float32),
        np.array(clusters["first"], np.int32),
        np.array(clusters["count"], np.int32), order, device)


def camera_from_reference(obj) -> tracer.Camera:
    return tracer.Camera(
        eye=tuple(float(x) for x in obj.eye),
        look_at=tuple(float(x) for x in obj.look_at),
        up=tuple(float(x) for x in obj.up),
        fov_y_deg=float(obj.fov_y_deg))


def rt_config_from_reference(obj) -> tracer.RTConfig:
    """A JAX-package RTConfig -> the port's, field by field.  An engine name
    the port has no kernels for is kept, and fails where the intersectors
    are made.  ``use_bvh=False`` becomes engine "brute", what the JAX
    package renders for it; the JAX compaction fields are scheduling and
    have no counterpart."""
    return _copy_fields(tracer.RTConfig, obj,
                        engine=obj.engine if obj.use_bvh else "brute")


def diff_params_from_reference(params, device=None) -> dict:
    """The differentiable pipeline's parameter dict (``pos``, ``color``,
    ``uv``, ``tex``; JAX or numpy arrays) -> float32 tensors on ``device``
    (None: the CUDA card).  They do not require grad: ``diff.optim.fit``
    makes its own leaves, a caller of ``render_deferred`` sets it."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in params.items()}


def diff_static_from_reference(static, device=None) -> dict:
    """The dict of ``diff.binning.bin_static`` (``indices``, ``tile_pids``,
    ``tile_xy``; JAX or numpy arrays) -> int32 tensors on ``device`` (None:
    the CUDA card)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.int32)).to(dev)
            for k, v in static.items()}


def diff_config_from_reference(obj) -> diff_pipeline.DiffRenderConfig:
    """A JAX-package DiffRenderConfig -> the port's, field by field."""
    return _copy_fields(diff_pipeline.DiffRenderConfig, obj,
                        background=tuple(float(x) for x in obj.background))
