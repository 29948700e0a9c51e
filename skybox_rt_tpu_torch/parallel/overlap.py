"""Bucketed gradient all-reduce (SURVEY §2.8; VERDICT r1 #9).

Counterpart of skybox_rt_tpu.parallel.overlap.  The DDP-bucketing recipe:

  * gradients are grouped by dtype and greedily packed into ``n_buckets``
    roughly size-balanced buckets; each bucket is ONE concatenated
    all-reduce instead of one a parameter: fewer, larger collectives
  * every bucket's all-reduce is issued with ``async_op=True`` before the
    first is waited on, so the backend runs them back to back; all are
    waited on before a result is used
  * numerics are a per-leaf all-reduce's up to the backend's reduction
    order (concatenation and splitting commute with the elementwise sum)

Every collective that parallel/ issues goes through :func:`all_reduce`,
:func:`all_gather` or :func:`reduce_scatter`, which count it in
``collective_counts`` (keyed by kind), as the kernels count their launches:
the port's counterpart of the JAX test that finds a train step's
all-reduces in its HLO.  The JAX module's ``count_all_reduces`` and
``collective_schedule_report`` read XLA's HLO text, which eager torch has
not.  Overlapping the buckets with the backward pass (gradient hooks) is not
done here.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import mesh as mesh_mod

#: collectives issued by parallel/ since the last reset, by kind
collective_counts = collections.Counter()


def reset_collective_counts() -> None:
    collective_counts.clear()


def all_reduce(tensor, group, op=dist.ReduceOp.SUM, async_op=False):
    """torch.distributed.all_reduce of a contiguous tensor in place,
    counted."""
    collective_counts["all_reduce"] += 1
    return dist.all_reduce(tensor, op=op, group=group, async_op=async_op)


def all_gather(out, tensor, group):
    """Every rank's equal ``tensor`` concatenated into ``out``, counted."""
    collective_counts["all_gather"] += 1
    dist.all_gather_into_tensor(out, tensor, group=group)


def reduce_scatter(out, tensor, group):
    """This rank's block of the elementwise sum of ``tensor``, counted."""
    collective_counts["reduce_scatter"] += 1
    dist.reduce_scatter_tensor(out, tensor, group=group)


def _flatten(tree):
    """(leaves, rebuild): a pytree of dicts (keys in sorted order, as
    jax.tree.flatten takes them), lists and tuples over tensors."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    counts = [len(leaves) for leaves, _ in parts]

    def rebuild(leaves):
        out, off = [], 0
        for (_, sub), n in zip(parts, counts):
            out.append(sub(leaves[off:off + n]))
            off += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def _bucketed_reduce(tree, n_buckets: int, reduce_flat):
    """Shared bucketing: pack leaves (grouped by dtype, size-balanced) into
    concatenated flats and hand each to ``reduce_flat(flat)``, which issues
    its collectives and returns a callable giving the reduced flat; only
    after every bucket is issued are they finished and split back."""
    leaves, rebuild = _flatten(tree)
    if not leaves:
        return tree

    by_dtype = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)

    issued = []
    for group in by_dtype.values():
        nb = max(1, min(n_buckets, len(group)))
        order = sorted(group, key=lambda i: -leaves[i].numel())
        buckets = [[] for _ in range(nb)]
        fill = [0] * nb
        for i in order:
            b = fill.index(min(fill))
            buckets[b].append(i)
            fill[b] += leaves[i].numel()
        for idx in buckets:
            if idx:
                flat = torch.cat([leaves[i].reshape(-1) for i in idx])
                issued.append((idx, reduce_flat(flat)))

    out = [None] * len(leaves)
    for idx, finish in issued:
        flat = finish()
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].reshape(leaves[i].shape)
            off += n
    return rebuild(out)


def _group(group_or_mesh):
    if isinstance(group_or_mesh, DeviceMesh):
        return mesh_mod.flat_group(group_or_mesh)
    return group_or_mesh


def bucketed_psum(tree, group_or_mesh, n_buckets: int = 3):
    """Sum a gradient pytree over the ranks of a process group (or of every
    rank of a mesh) as up to ``n_buckets`` concatenated all-reduces.

    Leaves are grouped BY DTYPE (each concatenated all-reduce sums in the
    leaf's own dtype), then packed greedily, largest first, into the
    currently smallest bucket, so buckets are size-balanced.  A mixed-dtype
    tree may therefore issue more than ``n_buckets`` all-reduces (one set a
    dtype); a homogeneous float32 gradient issues exactly
    min(n_buckets, leaves)."""
    group = _group(group_or_mesh)

    def reduce_flat(flat):
        work = all_reduce(flat, group, async_op=True)

        def finish():
            work.wait()
            return flat

        return finish

    return _bucketed_reduce(tree, n_buckets, reduce_flat)


def two_level_psum(tree, mesh: DeviceMesh, dcn_axis: str = "hosts",
                   ici_axis: str = mesh_mod.TILE_AXIS, n_buckets: int = 3):
    """Slice-aware gradient all-reduce for (hosts, chips) meshes (SURVEY
    §2.8 multi-slice / DCN; VERDICT r3 missing #3), a bucket at a time:

      1. reduce-scatter over the fast ``ici_axis`` (after padding to a
         multiple of its size): each rank owns the ICI-reduced 1/|ici| shard
      2. all-reduce the SHARD over the slow ``dcn_axis``: cross-host bytes
         drop by |ici|
      3. all-gather the shards back over ``ici_axis`` and cut to length

    A sum with another (still deterministic) grouping: integer-valued
    float32 gradients reduce exactly; other float32 differ from a flat sum
    only by addition order.  Issues 3 collectives a bucket."""
    ici = mesh.get_group(ici_axis)
    dcn = mesh.get_group(dcn_axis)
    n_ici = dist.get_world_size(ici)

    def reduce_flat(flat):
        n = flat.shape[0]
        padded = -(-n // n_ici) * n_ici
        if padded != n:
            flat = torch.cat([flat, flat.new_zeros(padded - n)])
        shard = flat.new_empty(padded // n_ici)
        reduce_scatter(shard, flat, ici)
        all_reduce(shard, dcn)
        out = flat.new_empty(padded)
        all_gather(out, shard, ici)
        return lambda: out[:n]

    return _bucketed_reduce(tree, n_buckets, reduce_flat)
