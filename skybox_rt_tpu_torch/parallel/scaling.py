"""Scaling-efficiency harness: the perf/graphics/run.sh sweep analog for
the mesh (north-star config 5: >= 80 % scaling efficiency).

Counterpart of skybox_rt_tpu.parallel.scaling.  Runs the tile-sharded train
step (forward + backward + gradient all-reduce) in worlds of increasing size
(mesh.spawn: one process a rank) and reports ms a step, speedup, and
efficiency against the first size.  On the card a rank holds a card of its
own (NCCL), so the default sizes are those up to the host's card count; on
the CPU (gloo) the default is 1 and 2 ranks.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.device import resolve_device, synchronize
from ..diff import binning as dbin
from ..diff import pipeline
from ..models import scenes
from . import mesh as mesh_mod
from . import tile_shard


def build_workload(size: int = 256, tile_logsize: int = 5, subdiv: int = 3):
    """A raster inverse-rendering workload big enough to shard: an
    icosphere projected to clip space, every tile populated.  Returns
    (params, static, cfg): numpy float32 params and numpy binning."""
    verts, faces = scenes.icosphere(subdiv=subdiv)
    V = verts.shape[0]
    # orthographic-ish clip placement filling the frame
    pos = np.concatenate(
        [verts[:, :2] * 0.9, verts[:, 2:3] * 0.4 + 0.5,
         np.ones((V, 1), np.float32)], 1).astype(np.float32)
    rng = np.random.default_rng(0)
    params = {
        "pos": pos,
        "color": rng.uniform(size=(V, 4)).astype(np.float32),
        "uv": rng.uniform(size=(V, 2)).astype(np.float32),
    }
    cfg = pipeline.DiffRenderConfig(width=size, height=size,
                                    tile_logsize=tile_logsize)
    static = dbin.bin_static(pos, np.asarray(faces, np.int32), size, size,
                             tile_logsize=tile_logsize)
    return params, static, cfg


def _time_steps(n, size, iters, warmup, compiled_loop, device_type):
    """One rank of a world of n: ms a step of the sharded train step."""
    mesh = mesh_mod.make_mesh(n, device=device_type)
    dev = mesh_mod.mesh_device(mesh)
    params, static, cfg = build_workload(size)
    sharded = tile_shard.shard_tiles(static, n)
    arrays = {k: torch.as_tensor(v, device=dev) for k, v in sharded.items()}
    ts = 1 << cfg.tile_logsize
    target = torch.zeros((sharded["tile_xy"].shape[0], ts, ts, 4),
                         device=dev)
    step = tile_shard.make_train_step(mesh, cfg, lr=1e-3)
    start = {k: torch.as_tensor(v, device=dev) for k, v in params.items()}

    p = start
    for _ in range(max(warmup, 1)):
        p, loss, _ = step(p, arrays, target)
    synchronize(dev)
    t0 = time.perf_counter()
    p = start
    for _ in range(iters):
        p, loss, _ = step(p, arrays, target)
        if not compiled_loop:
            synchronize(dev)
    synchronize(dev)
    return (time.perf_counter() - t0) / iters * 1e3


def measure(mesh_sizes=None, size: int = 256, iters: int = 10,
            warmup: int = 2, compiled_loop: bool = True,
            device=None) -> dict:
    """Returns {n_ranks: {"ms": .., "speedup": .., "efficiency": ..}}.

    Each size runs in a world of its own (mesh.spawn); rank 0's time is the
    size's.  compiled_loop=True (default) queues ``iters`` steps back to
    back and synchronizes once at the end, so a step's time holds no host
    wait for the device.  Eager torch has no counterpart of the JAX
    package's one-dispatch lax.fori_loop: the host still launches every
    kernel of every step (the decision of ref.driver.compile_frame_loop).
    False synchronizes after every step, the eager per-step protocol."""
    device = resolve_device(device)
    if mesh_sizes is None:
        avail = torch.cuda.device_count() if device.type == "cuda" else 2
        mesh_sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= avail]

    results = {}
    base_ms = None
    for n in mesh_sizes:
        ms = mesh_mod.spawn(_time_steps, n, n, size, iters, warmup,
                            compiled_loop, device.type,
                            backend=mesh_mod.backend_for(device))
        if base_ms is None:
            base_ms = ms
        speedup = base_ms / ms
        results[n] = {
            "ms": ms,
            "speedup": speedup,
            "efficiency": speedup / (n / mesh_sizes[0]),
        }
    return results
