"""Tile-parallel sharded rendering and the inverse-rendering training step.

Counterpart of skybox_rt_tpu.parallel.tile_shard.  Sharding strategy
(SURVEY §2.7-2.8, north-star config 5):
  * geometry (vertices, indices, per-prim setup) is REPLICATED: every rank
    runs pipeline.prim_setup, as every raster unit of the reference reads
    the shared primitive buffer
  * screen tiles are SHARDED in contiguous blocks over the mesh (rank i of
    N holds rows i*T/N ... of the padded tile list, parallel.mesh.tile_block)
  * the loss is all-reduced; parameter gradients are all-reduced across the
    mesh (parallel.overlap: bucketed, two-level, or one a leaf)
  * framebuffer assembly = an all-reduce of disjoint tile scatters (each
    rank owns its tiles; padding tiles add zero at tile (0, 0))

Every rank calls the returned functions with the same (whole) arrays, takes
its own block of the tile axis, and returns the whole result.  On the card
the training step's hard-mode visibility is kernel #4 and the backward of
every gather kernel #5, as in the unsharded pipeline.render_deferred.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..diff import pipeline
from . import mesh as mesh_mod
from . import overlap


def shard_tiles(static: dict, n_shards: int) -> dict:
    """Pad binning output so the tile axis divides the mesh.

    Padding tiles get empty pid lists and scatter to tile (0, 0) with zero
    contribution (their rendered tiles are all-background and masked out of
    the scatter by a weight of 0).  Numpy in, numpy out; ``tile_valid`` is
    float32."""
    tile_pids = mesh_mod.pad_to_multiple(
        np.asarray(static["tile_pids"]), n_shards, axis=0, fill=-1
    )
    T = tile_pids.shape[0]
    tile_xy = np.zeros((T, 2), np.int32)
    tile_xy[: static["tile_xy"].shape[0]] = static["tile_xy"]
    tile_valid = np.zeros((T,), np.float32)
    tile_valid[: static["tile_xy"].shape[0]] = 1.0
    return dict(static, tile_pids=tile_pids, tile_xy=tile_xy,
                tile_valid=tile_valid)


def _on(a, device):
    """A tensor or array on ``device``."""
    if torch.is_tensor(a):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def _blocks(mesh, device, *arrays):
    return [mesh_mod.tile_block(_on(a, device), mesh) for a in arrays]


def make_sharded_render(mesh, cfg: pipeline.DiffRenderConfig):
    """Full-frame sharded forward render: each rank renders its tile block,
    frames are assembled with an all-reduce over disjoint scatters.
    render(params, static) -> (Hp, Wp, 4); ``static`` as shard_tiles
    returns it (numpy or tensors), params on the mesh's device."""
    ts = 1 << cfg.tile_logsize
    Hp = -(-cfg.height // ts) * ts
    Wp = -(-cfg.width // ts) * ts
    gh, gw = Hp // ts, Wp // ts
    group = mesh_mod.flat_group(mesh)

    @torch.no_grad()
    def render(params, static):
        dev = params["pos"].device
        tile_pids, tile_xy, tile_valid = _blocks(
            mesh, dev, static["tile_pids"], static["tile_xy"],
            static["tile_valid"])
        setup = pipeline.prim_setup(params, _on(static["indices"], dev), cfg)
        tiles = pipeline.render_tile_set(setup, tile_pids, tile_xy * ts, cfg)
        tiles = tiles * tile_valid[:, None, None, None]
        at = (tile_xy[:, 1].long(), tile_xy[:, 0].long())
        # accumulate, as the JAX package's .at[].add: an assignment would let
        # a padding tile overwrite tile (0, 0) with zeros
        canvas = torch.zeros((gh, gw, ts, ts, 4), device=dev).index_put_(
            at, tiles, accumulate=True)
        cover = torch.zeros((gh, gw), device=dev).index_put_(
            at, tile_valid, accumulate=True)
        overlap.all_reduce(canvas, group)
        overlap.all_reduce(cover, group)
        # tiles no primitive was binned to keep the clear color
        bg = torch.tensor(cfg.background, dtype=torch.float32, device=dev)
        canvas = canvas + ((cover == 0).float()[:, :, None, None, None]
                           * bg[None, None, None, None, :])
        return canvas.permute(0, 2, 1, 3, 4).reshape(Hp, Wp, 4)

    return render


def _reduce_grads(grads, mesh, group, grad_buckets, grad_collective):
    if grad_collective == "two_level":
        names = mesh.mesh_dim_names
        return overlap.two_level_psum(grads, mesh, dcn_axis=names[0],
                                      ici_axis=names[1],
                                      n_buckets=max(grad_buckets, 1))
    if grad_buckets > 0:
        return overlap.bucketed_psum(grads, group, grad_buckets)
    for g in grads.values():
        overlap.all_reduce(g, group)
    return grads


def make_train_step(mesh, cfg: pipeline.DiffRenderConfig, lr: float = 0.1,
                    trainable: tuple = ("color", "pos", "uv", "tex"),
                    deferred: bool = True, slots: int = 8,
                    grad_buckets: int = 3,
                    grad_collective: str = "flat"):
    """Inverse-rendering SGD step, tile-sharded with gradient all-reduce.

    target_tiles are pre-gathered per tile on the host (the per-rank loss
    only touches local tiles: no image-sized communication in the loss).
    deferred=True uses the two-pass pipeline (K-slot visibility + O(pixels
    * K) differentiable shading; hard mode: kernel #4 forward, kernel #5 in
    the backward of every gather on the card); exact vs the scan renderer in
    hard mode, and in blend/soft modes whenever per-pixel writes fit the
    slot count.  grad_buckets > 0 packs the parameter all-reduces into that
    many size-balanced concatenated collectives (overlap.bucketed_psum);
    0 = one all-reduce a parameter.  grad_collective: "flat" reduces each
    bucket over every rank of the mesh at once; "two_level" (2-D (hosts,
    chips) meshes only, else ValueError) reduce-scatters over the chips,
    all-reduces the shard over the hosts and all-gathers over the chips
    (overlap.two_level_psum).  A step issues those collectives, one
    all-reduce of the loss and one MAX all-reduce of max_writes.

    Returns step(params, arrays, target_tiles) -> (params, loss,
    max_writes): params a dict of float32 tensors on the mesh's device,
    arrays as shard_tiles returns them, target_tiles (T, ts, ts, 4) in the
    padded tile order (gather_target_tiles); the new params are detached,
    loss and max_writes are 0-d tensors, the same on every rank.
    max_writes is the mesh-max observed per-pixel write count of the
    deferred visibility pass (0 when deferred=False): when it exceeds
    ``slots`` in a blend/soft config, the deferred tiles (and so the loss
    and gradients) deviate from the exact scan renderer; re-dispatch with
    slots >= max_writes.
    """
    if grad_collective == "two_level" and mesh.ndim != 2:
        raise ValueError("two_level needs a (hosts, chips) mesh")
    ts = 1 << cfg.tile_logsize
    group = mesh_mod.flat_group(mesh)

    def step(params, arrays, target_tiles):
        dev = params["pos"].device
        tile_pids, tile_xy, tile_valid, target = _blocks(
            mesh, dev, arrays["tile_pids"], arrays["tile_xy"],
            arrays["tile_valid"], target_tiles)
        indices = _on(arrays["indices"], dev)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        setup = pipeline.prim_setup(leaves, indices, cfg)
        if deferred:
            tiles, maxw = pipeline.render_tile_set_deferred(
                setup, tile_pids, tile_xy * ts, cfg, slots)
        else:
            tiles = pipeline.render_tile_set(setup, tile_pids, tile_xy * ts,
                                             cfg)
            maxw = torch.zeros((), dtype=torch.int32, device=dev)
        err = (tiles - target) ** 2
        loss = torch.sum(err * tile_valid[:, None, None, None])
        names = list(leaves)
        found = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        # a leaf the render does not read (uv and tex untextured) gets a
        # zero gradient, as jax.grad gives it
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(names, found)}
        loss = loss.detach().reshape(1)
        maxw = maxw.to(torch.int32).reshape(1)
        overlap.all_reduce(loss, group)
        overlap.all_reduce(maxw, group, op=dist.ReduceOp.MAX)
        grads = _reduce_grads(grads, mesh, group, grad_buckets,
                              grad_collective)
        new = {k: (v.detach() - lr * grads[k] if k in trainable
                   else v.detach())
               for k, v in params.items()}
        return new, loss[0], maxw[0]

    return step


def gather_target_tiles(target_img: np.ndarray, tile_xy: np.ndarray,
                        tile_logsize: int) -> np.ndarray:
    """Cut the (H, W, 4) target image into the binned tile order."""
    ts = 1 << tile_logsize
    H, W = target_img.shape[:2]
    Hp = -(-H // ts) * ts
    Wp = -(-W // ts) * ts
    pad = np.zeros((Hp, Wp, 4), np.float32)
    pad[:H, :W] = target_img
    out = np.zeros((tile_xy.shape[0], ts, ts, 4), np.float32)
    for t, (tx, ty) in enumerate(np.asarray(tile_xy)):
        out[t] = pad[ty * ts:(ty + 1) * ts, tx * ts:(tx + 1) * ts]
    return out
