"""Ray-parallel RT rendering over a mesh of ranks.

Counterpart of skybox_rt_tpu.parallel.ray_shard.  The raster path stripes
*screen tiles* across ranks (tile_shard.py, mirroring
raster_unit.cpp:224-227's tile striping).  The RT path's natural
data-parallel axis is *rays* (SURVEY §2.7 "new-framework-only axes"):
camera rays are contiguous-block-sharded over the mesh, the scene
(triangles, BVH blocks or clusters, shading arrays) is replicated on every
rank, and each rank runs the full trace + shade body (tracer.trace_rays) on
its block.  No communication is needed until the framebuffer is assembled,
by one all-gather of the equal blocks.  Ray counts that the mesh does not
divide are padded.
"""
from __future__ import annotations

import torch

from ..rt import tracer
from . import mesh as mesh_mod
from . import overlap


def render_sharded(scene: tracer.RTScene, cam: tracer.Camera,
                   cfg: tracer.RTConfig, mesh, intersectors=None):
    """tracer.render with rays block-sharded over every rank of the mesh,
    on the mesh's device.  Returns the (H, W, 4) float32 tensor (row 0 =
    bottom) of the single-rank render, on every rank.

    The scene's BVH is built once (RTScene.finalize keeps it); a caller
    that renders the scene again may pass ``intersectors``, the (closest,
    occluded) pair of tracer.make_intersectors for this scene, config and
    device, so that the blocks or clusters are not packed again.  Rays go
    in the order of tracer.frame_rays, as tracer.make_frame_fn orders them
    (the JAX module tile-orders them for "pallas" alone; the per-ray
    results are the same)."""
    device = mesh_mod.mesh_device(mesh)
    scene = scene.finalize()
    scene_arrays = tracer.scene_shade_arrays(scene, cfg, device)
    closest, occluded = (intersectors if intersectors is not None
                         else tracer.make_intersectors(scene, cfg, device))
    o, d, inv = tracer.frame_rays(cam, cfg, device)

    n = mesh.size()
    R = o.shape[0]
    B = -(-R // n)
    if B * n != R:
        # padded rays get a harmless +x direction (never NaN, result cut)
        o = torch.cat([o, o.new_zeros((B * n - R, 3))])
        d = torch.cat([d, d.new_tensor([[1.0, 0.0, 0.0]]).expand(
            B * n - R, 3)])
    i = mesh_mod.block_index(mesh)
    block = tracer.trace_rays(scene_arrays, cfg, closest, occluded,
                              scene.reflectivity,
                              o[i * B:(i + 1) * B].contiguous(),
                              d[i * B:(i + 1) * B].contiguous())
    img = block.new_empty((B * n, 4))
    overlap.all_gather(img, block.contiguous(), mesh_mod.flat_group(mesh))
    img = img[:R]
    if inv is not None:
        img = img[inv]
    return img.reshape(cfg.height, cfg.width, 4)
