"""Rank functions of the parallel tests (test_torch_parallel_raster.py,
_train.py and _rt.py), and the one test that keeps them apart from JAX.

Each rank function runs on every rank of a world that ``parallel.mesh.spawn`` forms (gloo,
CPU tensors) and returns numpy results from rank 0.  This module imports the
port alone: the spawned ranks never load JAX, whose test process (the
parent) holds the virtual 8-device mesh.  Inputs come from the parent as
numpy arrays made from a seed.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from skybox_rt_tpu_torch.diff import pipeline
from skybox_rt_tpu_torch.parallel import draw_shard, overlap, ray_shard
from skybox_rt_tpu_torch.parallel import mesh as mesh_mod
from skybox_rt_tpu_torch.parallel import tile_shard

CPU = "cpu"


def jax_loaded() -> bool:
    return any(m.split(".")[0] in ("jax", "jaxlib", "skybox_rt_tpu")
               for m in sys.modules)


def _gather(x, group=None):
    """Every rank's equal numpy array, stacked on rank 0 (uint32 words
    travel as int32, which gloo carries)."""
    x = np.ascontiguousarray(x)
    t = torch.as_tensor(x.view(np.int32) if x.dtype == np.uint32 else x)
    n = dist.get_world_size(group)
    out = t.new_empty(n * t.numel())
    dist.all_gather_into_tensor(out, t.reshape(-1), group=group)
    return out.numpy().view(x.dtype).reshape((n,) + x.shape)


def raster_world(n, cases):
    """render_trace_sharded of synth_draw3d at each (size, tile_logsize):
    the first frame (blend K measured), every rank's frame and the
    collectives of the frame; for the first case a second frame too, with
    the cached K (checked at frame end) and visibility="pallas"."""
    from skybox_rt_tpu_torch.geom import cgltrace
    mesh = mesh_mod.make_mesh(n, device=CPU)
    out = {}
    for size, tls in cases:
        trace = cgltrace.load_trace(cgltrace.trace_path("synth_draw3d"))
        overlap.reset_collective_counts()
        first = draw_shard.render_trace_sharded(trace, size, size, mesh, tls)
        counts = dict(overlap.collective_counts)
        cached = None
        if (size, tls) == cases[0]:
            cached = draw_shard.render_trace_sharded(
                trace, size, size, mesh, tls, visibility="pallas")
        out[(size, tls)] = {
            "first": first, "cached": cached, "every_rank": _gather(first),
            "counts": counts,
            "blend_k": trace._blend_k_cache[(size, size, tls, "prepared")]}
    out["jax_loaded"] = jax_loaded()
    return out


def _params(params_np):
    return {k: torch.as_tensor(v) for k, v in params_np.items()}


def train_world(n, mesh_shape, params_np, bad_np, static_np, cfg, target_img,
                configs, extra=None):
    """make_sharded_render of params, and one make_train_step from bad for
    each config (a dict of make_train_step keywords), on a 1-D mesh of n
    ranks or the 2-D mesh ``mesh_shape``: image, and per config the loss,
    max_writes, new params and the collectives the step issued; ``extra``,
    a (params, static, cfg) rendered too (its image "extra_image")."""
    if mesh_shape is None:
        mesh = mesh_mod.make_mesh(n, device=CPU)
    else:
        mesh = mesh_mod.make_mesh_2d(*mesh_shape, device=CPU)
    sharded = tile_shard.shard_tiles(static_np, n)
    render = tile_shard.make_sharded_render(mesh, cfg)
    out = {"image": render(_params(params_np), sharded).numpy(),
           "tiles": sharded["tile_pids"].shape[0]}
    target = tile_shard.gather_target_tiles(target_img, sharded["tile_xy"],
                                            cfg.tile_logsize)
    if extra is not None:
        x_params, x_static, x_cfg = extra
        out["extra_image"] = tile_shard.make_sharded_render(mesh, x_cfg)(
            _params(x_params), tile_shard.shard_tiles(x_static, n)).numpy()
    for name, kw in configs.items():
        step = tile_shard.make_train_step(mesh, cfg, **kw)
        overlap.reset_collective_counts()
        new, loss, maxw = step(_params(bad_np), sharded, target)
        out[name] = {"loss": float(loss), "max_writes": int(maxw),
                     "params": {k: v.numpy() for k, v in new.items()},
                     "counts": dict(overlap.collective_counts)}
    out["jax_loaded"] = jax_loaded()
    return out


def unsharded_step(params_np, static_np, cfg, target_img, lr=0.1,
                   trainable=("color", "pos", "uv", "tex")):
    """The port's unsharded SGD step (render_deferred, the same loss): for
    the parent, which forms no process group.  (loss, new params)."""
    p = {k: torch.as_tensor(v).requires_grad_(True)
         for k, v in params_np.items()}
    static = {k: torch.as_tensor(np.asarray(v)) for k, v in static_np.items()}
    img, _ = pipeline.render_deferred(p, static, cfg)
    H, W = target_img.shape[:2]
    loss = torch.sum((img[:H, :W] - torch.tensor(target_img)) ** 2)
    names = list(p)
    grads = torch.autograd.grad(loss, [p[k] for k in names],
                                allow_unused=True)
    new = {}
    for k, g in zip(names, grads):
        v = p[k].detach()
        new[k] = (v - lr * g if k in trainable and g is not None
                  else v).numpy()
    return float(loss.detach()), new


def collectives_world(trees):
    """On 4 ranks (1-D and 2x2 meshes): bucketed_psum of trees["f32"] at
    1, 2, 3 and 10 buckets and of trees["mixed"] at 2, each beside a
    per-leaf all-reduce; two_level_psum of the integer-valued trees["int"]
    at 1 and 3 buckets beside a flat all-reduce; the barrier of
    test_compute_apps.py::test_barrier_psum; with the collectives each
    issued.  Rank r holds every leaf times r + 1; the mixed tree's "h"
    is cast to bfloat16 on the rank and comes back as its 16-bit words."""
    mesh = mesh_mod.make_mesh(4, device=CPU)
    mesh2 = mesh_mod.make_mesh_2d(2, 2, device=CPU)
    r = dist.get_rank()

    def local(tree):
        out = {}
        for k, v in tree.items():
            t = torch.as_tensor(v)
            if tree is trees["mixed"] and k == "h":
                t = t.to(torch.bfloat16)
            out[k] = t * (r + 1)
        return out

    def host(tree):
        return {k: (v.view(torch.int16) if v.dtype == torch.bfloat16
                    else v).numpy() for k, v in tree.items()}

    def per_leaf(tree):
        tree = local(tree)
        for v in tree.values():
            dist.all_reduce(v)
        return host(tree)

    def counted(fn):
        overlap.reset_collective_counts()
        got = fn()
        return host(got), dict(overlap.collective_counts)

    out = {"bucketed": {}, "two_level": {}}
    for nb in (1, 2, 3, 10):
        out["bucketed"][nb] = counted(
            lambda: overlap.bucketed_psum(local(trees["f32"]), mesh, nb))
    out["bucketed_per_leaf"] = per_leaf(trees["f32"])
    out["mixed"] = counted(
        lambda: overlap.bucketed_psum(local(trees["mixed"]), mesh, 2))
    out["mixed_dtypes"] = {
        k: str(v.dtype) for k, v in overlap.bucketed_psum(
            local(trees["mixed"]), mesh, 2).items()}
    out["mixed_per_leaf"] = per_leaf(trees["mixed"])
    for nb in (1, 3):
        out["two_level"][nb] = counted(lambda: overlap.two_level_psum(
            local(trees["int"]), mesh2, n_buckets=nb))
    out["two_level_flat"] = per_leaf(trees["int"])
    out["coordinate"] = _gather(np.asarray(mesh2.get_coordinate()))

    # the barrier + reduction of test_barrier_psum: every rank deposits its
    # value, then reads the sum of everyone else's
    x = torch.tensor([float(r)])
    total = x.clone()
    overlap.all_reduce(total, mesh_mod.flat_group(mesh))
    out["barrier"] = _gather((total - x).numpy())[:, 0]
    out["jax_loaded"] = jax_loaded()
    return out


def rt_world(n, cases):
    """render_sharded over n ranks of each case, {name: (RTScene fields as
    numpy, Camera, RTConfig)}: the image, every rank's image and the
    collectives of the frame."""
    from skybox_rt_tpu_torch.rt import tracer
    mesh = mesh_mod.make_mesh(n, device=CPU)
    out = {}
    for name, (fields, cam, cfg) in cases.items():
        overlap.reset_collective_counts()
        img = ray_shard.render_sharded(tracer.RTScene(**fields), cam, cfg,
                                       mesh).numpy()
        out[name] = {"image": img, "every_rank": _gather(img),
                     "counts": dict(overlap.collective_counts)}
    out["jax_loaded"] = jax_loaded()
    return out


def tcp_rank(coordinator, pid, params_np, static_np, cfg, results):
    """One of two processes joined by initialize_distributed over TCP: the
    sharded forward render and a train step (lr 1e-4, zero target) on the
    2-rank mesh, as tests/multiprocess_worker.py runs them in JAX."""
    torch.set_num_threads(1)
    try:
        mesh_mod.initialize_distributed(coordinator, 2, pid, device=CPU)
        mesh = mesh_mod.make_mesh(2, device=CPU)
        sharded = tile_shard.shard_tiles(static_np, 2)
        img = tile_shard.make_sharded_render(mesh, cfg)(_params(params_np),
                                                        sharded)
        ts = 1 << cfg.tile_logsize
        target = np.zeros((sharded["tile_xy"].shape[0], ts, ts, 4),
                          np.float32)
        step = tile_shard.make_train_step(mesh, cfg, lr=1e-4)
        new, loss, maxw = step(_params(params_np), sharded, target)
        results.put((pid, {"world": dist.get_world_size(),
                           "rank": dist.get_rank(),
                           "img_sum": float(img.sum()),
                           "img": img.numpy(), "loss": float(loss),
                           "max_writes": int(maxw),
                           "color_sum": float(new["color"].sum()),
                           "jax_loaded": jax_loaded()}))
    except BaseException as e:
        results.put((pid, repr(e)))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_ranks_import_no_jax():
    """A rank imports this module by name and nothing of JAX comes with it
    (the parent test process holds JAX and its virtual mesh)."""
    import os
    import subprocess
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here, os.path.dirname(here)]))
    res = subprocess.run(
        [sys.executable, "-c", "import sys, test_torch_parallel_ranks as r; "
         "print(r.jax_loaded())"], capture_output=True, text=True, env=env,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False"]
