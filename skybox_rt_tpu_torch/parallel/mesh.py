"""Process meshes and sharding helpers.

Counterpart of skybox_rt_tpu.parallel.mesh.  The reference's parallelism
axes (SURVEY §2.7) map onto ranks of a torch.distributed world:

  SIMT lanes, warps     -> the CUDA kernels' threads (implicit)
  tile striping across raster units (raster_unit.cpp:224-227)
                        -> the 'tiles' mesh dimension across ranks
  cluster barriers      -> torch.distributed collectives

The JAX package has one controller that runs a function on every device's
block (shard_map).  Here every rank is a process, the DDP idiom: each rank
calls the same entry point with the same arguments, works on its own block,
joins the others through collectives on the mesh's groups, and returns the
whole result.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the default process group whose dimensions carry the JAX axis names; a rank's
block is its place in the mesh, row-major over the dimensions (what
``P(("hosts", "tiles"))`` blocks by).

``device=None`` means the CUDA card with NCCL, and raises without one
(core.device); ``device="cpu"`` means gloo.  With no process group yet,
:func:`make_mesh` of one rank forms a one-rank group itself on an in-process
store, so a world of size 1 is a complete program in one process (end it
with ``torch.distributed.destroy_process_group()``).  More ranks come from
:func:`initialize_distributed` (a TCP rendezvous, a process a host) or from
:func:`spawn` (ranks of one host on a file store: the tests and
scaling.measure).
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.device import resolve_device

TILE_AXIS = "tiles"
#: how long a rank waits in a collective, and spawn for a rank's word
TIMEOUT_S = 600


def backend_for(device) -> str:
    """The collective backend of ``device``: NCCL for the card, gloo else."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _world(device, n: int | None) -> int:
    """The world size, after forming a one-rank group if there is none."""
    if not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(
                f"need {n} ranks and no process group is formed: start "
                f"them with spawn or initialize_distributed")
        dist.init_process_group(
            backend_for(device), store=dist.HashStore(), rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.get_world_size()


def make_mesh(n_devices: int | None = None, axis: str = TILE_AXIS,
              device=None) -> DeviceMesh:
    """A one-dimensional mesh named ``axis`` over every rank of the world;
    raises when the world does not have ``n_devices`` ranks."""
    device = resolve_device(device)
    world = _world(device, n_devices)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"need {n_devices} ranks, the world has {world}")
    return init_device_mesh(device.type, (world,), mesh_dim_names=(axis,))


def make_mesh_2d(n_hosts: int, n_chips: int,
                 axes: tuple = ("hosts", TILE_AXIS), device=None) -> DeviceMesh:
    """hosts x chips mesh (SURVEY §2.8 multi-host DP): rank h * n_chips + c
    sits at (h, c).  Tiles stripe over both dimensions (the sharding
    modules treat the whole mesh as one tile axis), so a gradient reduction
    spans both; overlap.two_level_psum reduces over each in turn."""
    device = resolve_device(device)
    n = n_hosts * n_chips
    world = _world(device, n)
    if world != n:
        raise ValueError(f"need {n} ranks, the world has {world}")
    return init_device_mesh(device.type, (n_hosts, n_chips),
                            mesh_dim_names=tuple(axes))


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, device=None):
    """Multi-host bring-up: join a world of ``num_processes`` ranks through
    a TCP rendezvous at ``coordinator`` ("host:port"; None reads
    MASTER_ADDR / MASTER_PORT).  A no-op for one process; on the card,
    rank r takes card r modulo the host's count."""
    if num_processes is None or num_processes <= 1:
        return
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend_for(device),
        init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0,
                    fill=0) -> np.ndarray:
    n = arr.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - n)
    return np.pad(arr, pad, constant_values=fill)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device a rank of ``mesh`` computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def flat_group(mesh: DeviceMesh):
    """The process group of every rank of ``mesh``: its one dimension's, or
    the world's for a mesh of more dimensions (which spans the world)."""
    if mesh.ndim == 1:
        return mesh.get_group(0)
    if mesh.size() != dist.get_world_size():
        raise ValueError("a mesh of more dimensions must span the world")
    return dist.group.WORLD


def block_index(mesh: DeviceMesh) -> int:
    """This rank's place in ``mesh``, row-major over its dimensions."""
    return int(np.ravel_multi_index(mesh.get_coordinate(), tuple(mesh.shape)))


def tile_block(arr, mesh: DeviceMesh):
    """This rank's block of the leading (tile) dimension, whose length the
    mesh size divides: what the JAX package's ``tile_sharding`` puts on a
    device."""
    n = mesh.size()
    if arr.shape[0] % n:
        raise ValueError(f"{arr.shape[0]} rows do not divide {n} ranks")
    b = arr.shape[0] // n
    i = block_index(mesh)
    return arr[i * b:(i + 1) * b]


def _rank_main(fn, args, rank, world_size, store_path, backend, results):
    """A spawned rank: join the world, run fn, send (rank, ok, result)."""
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size), rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        out = fn(*args)
        results.put((rank, True, out if rank == 0 else None))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, backend: str = "gloo"):
    """Run ``fn(*args)`` on ``world_size`` ranks of this host, each a
    spawned process of one world (its rendezvous a file store in a
    temporary directory), and return rank 0's result.  ``fn`` and its
    arguments are pickled: ``fn`` must be importable.  backend: "gloo"
    (CPU tensors, and CUDA tensors where gloo carries them) or "nccl"
    (rank r on card r).  Raises with a failed rank's traceback, when a rank
    process dies before it reports, or when the ranks have not all reported
    after TIMEOUT_S seconds; stops every rank it started."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, world_size, store, backend,
                                   results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            got = {}
            deadline = time.monotonic() + TIMEOUT_S
            while len(got) < world_size:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    # a rank that died before it could report (its start-up
                    # failed, or it crashed) would leave the others waiting
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"spawn: ranks exited with {dead} "
                                           f"before they reported") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"spawn: the ranks did not all "
                                           f"report in {TIMEOUT_S} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return got[0]
