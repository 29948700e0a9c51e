"""Ray queries and hit shading: the CUDA kernels and their plain torch
versions.

Counterpart of skybox_rt_tpu.ops.pallas_rt.  Eight kernels replace Pallas TPU
kernels of that module, and a ninth the worklist query's prepass; each source
says how a ray walks its structure and what bounds it.  A tenth,
:func:`shade_hits` (csrc/rt_shade.cu), shades a hit batch for rt.tracer: it
replaces no TPU kernel (the JAX package's shade_hits is plain jnp that XLA
fuses), and takes the place of some 60 plain torch launches a call.

  ===========================  ==========================  ====================
  wrapper                      replaces (pallas_rt)        source
  ===========================  ==========================  ====================
  :func:`closest_hit_bvh`      _make_bvh_worklist_kernel   csrc/rt_bvh.cu
  :func:`any_hit_bvh`          _make_bvh_anyhit_kernel     csrc/rt_bvh.cu
  :func:`closest_hit_bvh_after` _make_bvh_after_kernel     csrc/rt_bvh.cu
  :func:`closest_hit_clustered` _make_clustered_kernel     csrc/rt_clustered.cu
  :func:`any_hit_clustered`    _make_clustered_anyhit_kernel  csrc/rt_clustered.cu
  :func:`closest_hit_pallas`   _make_kernel                csrc/rt_clustered.cu
  :func:`closest_hit_streamed` _make_streamed_kernel       csrc/rt_streamed.cu
  :func:`closest_hit_worklist` _make_worklist_kernel       csrc/rt_streamed.cu
  :func:`active_block_lists`   _active_block_lists (XLA)   csrc/rt_streamed.cu
  ===========================  ==========================  ====================

(:func:`any_hit_pallas` wraps :func:`closest_hit_pallas`, as in the JAX
package.)  What the TPU schedule needed and the functions do not is gone: ray
packing into (8, 128) tiles, the BVH kernels' worklist prepass, the per-tile
cluster gate and dominant octant, the 128-lane record padding, the 512-row
triangle blocks and their shared-memory table caps, ``sub`` / ``L`` /
``unroll`` / ``early_exit`` / ``interpret``.  (The worklist query's prepass
stays: its lists are what that query is.)

  * a CUDA tensor launches the kernel on the current stream, or raises;
  * a CPU tensor runs the ``*_reference`` function beside the wrapper, the
    same arithmetic in the same order in plain torch.  The CPU tests and
    chip_smoke.py's comparison call them by name; nothing on the main path
    does when a card is present.

Tie rules.  Among hits of equal t the BVH-block, clustered, streamed and
worklist closest-hit queries return the one with the lowest *slot* (the triangle's record row, its
position in treelet order): the lexicographic (t, slot) minimum, mapped back
to the original prim id.  It does not depend on the order in which blocks or
clusters are met.  (The Pallas kernels keep the first hit in their visit
order, which depends on how rays were packed into tiles.)  The flat query
:func:`closest_hit_pallas` keeps the JAX rule: the lowest prim id.

Culling.  The clustered closest hit enters a cluster when the slab test
passes against the ray's *running* best t, so which clusters a ray enters
depends on the order it meets them in.  Kernel and plain version therefore
make the same per-ray decisions in the same two-level order: groups of
``CLUSTER_GROUP`` consecutive clusters near to far along the ray's direction
octant, and inside an entered group its clusters near to far
(:func:`pack_clusters`), with the same far bound.  A group's box contains its
clusters' boxes, so its gate culls no cluster that the cluster's own gate
would let in.  They test the same triangles against the same running best,
and agree bit for bit.  The any-hit queries cull against the fixed t_max,
so their answer does not depend on the order; the clustered one walks the
same two levels.

Records are the port's own layout: ``(rows, 12)`` float32 [v0 e1 e2 | 3 of
padding], three float4 a row.  BVH blocks hold ``C * tri_block`` rows; rows
past a block's ``bcnt[b]`` triangles are zero and never read.  All three
queries over them test a block's triangles leaf by leaf
(rt.bvh.build_block_leaves: ascending slot ranges with their own boxes, the
blocks dict's ``leaf_range`` / ``leaf_table``; without a leaf cut a block is
one leaf with its own box).  Clusters hold the P triangles in treelet
order, the flat query in prim order, the streamed and worklist queries in
the caller's ``order``, cut into blocks of ``tri_block`` rows with the last
one shorter.
"""
from __future__ import annotations

import collections
import ctypes
import math

import numpy as np
import torch

from ..diff.pipeline import sample_texture_bilinear
from ..rt import intersect
from ..utils.tracing import stage

T_MIN = 1e-4
#: deepest AABB pyramid the BVH-block kernels' level table holds
#: (csrc/rt_bvh.cu MAX_LEVELS); 64 * 8**7 blocks
MAX_LEVELS = 8
#: most entries a pyramid level may have (csrc/rt_bvh.cu MAX_LEVEL_ENTRIES)
MAX_LEVEL_ENTRIES = 1 << 24
#: clusters a group of the clustered queries holds
#: (:func:`pack_clusters`).  Swept over 4, 8 and 16 on an H100
#: (scripts/torch_rt_profile.py --cluster-group, PERF.md): 16 gave the
#: fastest closest-hit launches, 4 and 8 tie.
CLUSTER_GROUP = 16
RECORD_WIDTH = 12
#: rays of one tile of the streamed and worklist queries: one thread block
#: (csrc/rt_streamed.cu RAY_TILE), and the unit of the worklist's prepass
STREAM_RAY_TILE = 128
#: triangles of one block of those queries, staged through shared memory
#: together; at most csrc/rt_streamed.cu MAX_TRI_BLOCK
STREAM_TRI_BLOCK = 64
STREAM_MAX_TRI_BLOCK = 256
#: the streamed and worklist kernels' switch: a warp tests a block's
#: triangles across its lanes, one entering ray at a time, when fewer than
#: this many of its rays enter the block, else a ray a lane
#: (csrc/rt_streamed.cu); read at every launch, and by the plain versions'
#: lane counts
STREAM_LANE_SWITCH = 16
#: rays of one thread block of the flat kernel, a ray a thread
#: (csrc/rt_clustered.cu THREADS): the unit whose rays may share their origin
FLAT_THREADS = 128
#: most (ray, block) pairs one chunk of the worklist's plain prepass may hold
PREPASS_PAIRS = 1 << 24
#: most blocks the prepass kernel takes: a tile's keys and list, 8 bytes a
#: block, in one thread block's 227 KB of shared memory
#: (csrc/rt_streamed.cu PREPASS_MAX_BLOCKS)
PREPASS_MAX_BLOCKS = 227 * 1024 // 8

#: record row width of rt.tracer.scene_shade_arrays, untextured and textured
#: (:func:`shade_hits`)
SHADE_RECORD_WIDTH = {False: 21, True: 27}
#: a shadow ray starts this far along the hit's normal (:func:`shade_hits`)
SHADOW_OFFSET = 1e-3

#: Kernel launches since the last reset, keyed by kernel (closest_hit_bvh,
#: any_hit_bvh, closest_hit_bvh_after, closest_hit_clustered,
#: any_hit_clustered, closest_hit_flat, closest_hit_streamed,
#: closest_hit_worklist, active_block_lists, shade_hits; a kernel not
#: launched reads 0): a run reads them to show that its main
#: path went through the kernels.  Only :func:`_launch` adds to them.
launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def pack_blocks(rows9, bcnt, s2p, levels, tri_block, num_prims, device,
                leaves=None):
    """The dict the queries take, from numpy arrays: rows9 (C*TB, 9)
    records in slot order, bcnt (C,), s2p (C*TB,), levels [(C_l, 6)], and
    leaves, rt.bvh.build_block_leaves of the same blocks.  Without leaves
    every block is one leaf with the block's own box
    (``_whole_block_leaves``)."""
    device = torch.device(device)
    num_blocks = int(bcnt.shape[0])
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"AABB pyramid has {len(levels)} levels, the "
                         f"kernels take at most {MAX_LEVELS}")
    if rows9.shape != (num_blocks * tri_block, 9):
        raise ValueError(f"records have shape {tuple(rows9.shape)}, expected "
                         f"{(num_blocks * tri_block, 9)}")
    for lvl, a in enumerate(levels):
        if a.shape[0] > MAX_LEVEL_ENTRIES:
            raise ValueError(f"pyramid level {lvl} has {a.shape[0]} entries "
                             f"> {MAX_LEVEL_ENTRIES}")
    if levels[0].shape[0] != num_blocks:
        raise ValueError("level 0 of the pyramid must have one AABB a block")
    tri = torch.zeros((rows9.shape[0], RECORD_WIDTH), dtype=torch.float32)
    tri[:, :9] = torch.as_tensor(rows9, dtype=torch.float32)
    lv = [torch.as_tensor(a, dtype=torch.float32).reshape(-1, 6)
          for a in levels]
    counts = [int(a.shape[0]) for a in lv]
    offsets = [sum(counts[:l]) for l in range(len(counts))]
    aabb = torch.cat(lv).contiguous().to(device)
    if leaves is None:
        leaves = _whole_block_leaves(bcnt, levels[0], tri_block)
    leaf_range, leaf_table = _leaf_rows(leaves, bcnt, tri_block)
    return {
        "tri": tri.to(device),                            # (C*TB, 12)
        "bcnt": torch.as_tensor(bcnt, dtype=torch.int32).to(device),
        "s2p": torch.as_tensor(s2p, dtype=torch.int32).to(device),
        "aabb": aabb,                                     # (sum C_l, 6)
        "levels": [aabb[o:o + c] for o, c in zip(offsets, counts)],
        "level_offsets": tuple(offsets),
        "level_counts": tuple(counts),
        "leaf_range": leaf_range.to(device),              # (C + 1,)
        "leaf_table": leaf_table.to(device),              # (L, 8)
        "tri_block": int(tri_block),
        "num_blocks": num_blocks,
        "num_prims": int(num_prims),
    }


def _whole_block_leaves(bcnt, level0, tri_block):
    """The leaves of blocks cut no finer: one leaf a block that holds
    triangles, its slots [0, bcnt) with the block's box from ``level0``
    (C, 6), in rt.bvh.build_block_leaves' layout.  Each leaf box is its
    block's, so the leaf gate passes what the block gate passes: the walk
    tests whole blocks, as the JAX package's kernels do."""
    bcnt = np.asarray(bcnt, np.int64)
    full = np.nonzero(bcnt > 0)[0]
    return {"range": np.concatenate([[0], np.cumsum(bcnt > 0)]),
            "aabb": np.asarray(level0, np.float32).reshape(-1, 6)[full],
            "first": full * int(tri_block), "count": bcnt[full]}


def _leaf_rows(leaves, bcnt, tri_block):
    """(range (C + 1,) int32, table (L, 8) float32) of a leaf table: one
    row a leaf, [box | first slot, count as bit patterns], two float4 for
    the kernel.  Raises unless every block's leaves tile its slots [0,
    bcnt) in ascending order."""
    rng = np.asarray(leaves["range"], np.int64)
    box = np.asarray(leaves["aabb"], np.float32)
    first = np.asarray(leaves["first"], np.int64)
    count = np.asarray(leaves["count"], np.int64)
    bcnt = np.asarray(bcnt, np.int64)
    C, L = bcnt.shape[0], first.shape[0]
    if rng.shape != (C + 1,) or rng[0] != 0 or rng[-1] != L \
            or (np.diff(rng) < 0).any() or box.shape != (L, 6) \
            or count.shape != (L,):
        raise ValueError(f"leaf table disagrees with {C} blocks: range "
                         f"{rng.shape}, aabb {box.shape}, first "
                         f"{first.shape}, count {count.shape}")
    per_block = np.diff(rng)
    block = np.repeat(np.arange(C), per_block)
    end = first + count
    # a block's first leaf starts at its first slot, every other one where
    # the leaf before it ended; a block's last leaf ends at its count
    start = np.where(np.arange(L) == rng[block], block * tri_block,
                     np.roll(end, 1))
    full = per_block > 0
    block_end = np.arange(C) * tri_block + bcnt
    if (count < 1).any() or (first != start).any() \
            or (bcnt[~full] != 0).any() \
            or not np.array_equal(end[rng[1:][full] - 1], block_end[full]):
        raise ValueError("the leaves do not tile their blocks' slots in "
                         "ascending order")
    table = np.zeros((L, 8), np.float32)
    table[:, :6] = box
    table[:, 6:8] = np.stack([first, count], 1).astype(np.int32).view(
        np.float32)
    return (torch.from_numpy(rng.astype(np.int32)),
            torch.from_numpy(table))


def prepare_bvh_blocks(v0, e1, e2, block_set, leaves=None, device=None):
    """Pack triangle records into the block-slot layout (once per scene).

    v0, e1, e2: (P, 3) float32 tensors (rt.intersect.triangle_arrays);
    block_set: rt.bvh.build_block_set output; leaves: rt.bvh.
    build_block_leaves of the same BVH and block_set, or None (the JAX
    entry's call): a block is then one leaf with its own box
    (``_whole_block_leaves``), the same answers from more triangle
    tests.  The blocks land on ``device`` (default: where v0 lies)."""
    device = v0.device if device is None else torch.device(device)
    s2p = torch.as_tensor(block_set["slot_to_prim"]).long()
    tri9 = torch.cat([v0, e1, e2], dim=1).cpu()             # (P, 9)
    P = tri9.shape[0]
    rows = torch.where((s2p >= 0)[:, None], tri9[s2p.clamp(0, P - 1)],
                       torch.zeros((), dtype=tri9.dtype))
    return pack_blocks(rows.numpy(), block_set["bcnt"],
                       block_set["slot_to_prim"], block_set["aabb_levels"],
                       block_set["tri_block"], P, device, leaves=leaves)


def pack_records(v0, e1, e2, order=None):
    """(P, 12) float32 record rows [v0 e1 e2 | 3 of padding] where v0 lies,
    in prim order or, with ``order`` (P,), row i holding triangle order[i]."""
    tri9 = torch.cat([v0, e1, e2], dim=1).to(torch.float32)
    if order is not None:
        tri9 = tri9[torch.as_tensor(order, device=tri9.device).long()]
    tri = torch.zeros((tri9.shape[0], RECORD_WIDTH), dtype=torch.float32,
                      device=tri9.device)
    tri[:, :9] = tri9
    return tri


def octant_visit_table(aabb):
    """(8, C) int32 numpy: for each direction octant (bit k set <=> d[k] >
    0) the clusters in ascending projection of their box centres onto the
    octant's sign vector, near to far; equal keys keep ascending id."""
    aabb = np.asarray(aabb, np.float32)
    cen = (aabb[:, 0:3] + aabb[:, 3:6]) * np.float32(0.5)
    rows = []
    for octant in range(8):
        sx, sy, sz = (np.float32(1.0 if octant & (1 << k) else -1.0)
                      for k in range(3))
        key = sx * cen[:, 0] + sy * cen[:, 1] + sz * cen[:, 2]
        rows.append(np.argsort(key, kind="stable"))
    return np.asarray(rows, np.int32).reshape(8, aabb.shape[0])


def cluster_groups(aabb, group):
    """The two-level visit order of clusters with boxes ``aabb`` (C, >= 6)
    float32, cut into groups of ``group`` consecutive clusters (treelet
    order: they lie together in space; the last group may be shorter).
    Returns numpy (table (G, 8) float32: each group's box, the float32 min /
    max of its clusters' boxes, then its first cluster and count as bit
    patterns; group_visit (8, G) int32: :func:`octant_visit_table` of the
    group boxes; visit (8, C) int32: per octant the groups in that order,
    each group's clusters in the octant's near-to-far order of their own
    centres, flattened)."""
    if group < 1:
        raise ValueError(f"cluster group {group} < 1")
    box = np.asarray(aabb, np.float32)[:, :6]
    C = box.shape[0]
    G = -(-C // group)
    lo = np.full((G * group, 3), np.inf, np.float32)
    hi = np.full((G * group, 3), -np.inf, np.float32)
    lo[:C], hi[:C] = box[:, 0:3], box[:, 3:6]
    gfirst = np.arange(G) * group
    table = np.zeros((G, 8), np.float32)
    table[:, 0:3] = lo.reshape(G, group, 3).min(axis=1)
    table[:, 3:6] = hi.reshape(G, group, 3).max(axis=1)
    table[:, 6:8] = np.stack([gfirst, np.minimum(group, C - gfirst)],
                             axis=1).astype(np.int32).view(np.float32)
    group_visit = octant_visit_table(table)
    # per octant: the group's place in its order, then the cluster's own
    # near-to-far rank (the inverse permutations of the two visit rows)
    gpos = np.argsort(group_visit, axis=1).astype(np.int64)
    rank = np.argsort(octant_visit_table(box), axis=1).astype(np.int64)
    key = gpos[:, np.arange(C) // group] * C + rank
    visit = np.argsort(key, axis=1, kind="stable").astype(np.int32)
    return table, group_visit, visit.reshape(8, C)


def pack_clusters(tri, aabb, first, count, order, device, group=None):
    """The dict the clustered queries take: tri (P, 12) records in treelet
    order (a tensor), and numpy aabb (C, >= 6), first (C,), count (C,),
    order (P,) of rt.bvh.build_clusters; the clusters are cut into groups of
    ``group`` (default :data:`CLUSTER_GROUP`) by :func:`cluster_groups`."""
    device = torch.device(device)
    group = CLUSTER_GROUP if group is None else int(group)
    aabb = np.asarray(aabb, np.float32)
    first = np.asarray(first, np.int32)
    count = np.asarray(count, np.int32)
    order = np.asarray(order, np.int32)
    C, P = int(first.shape[0]), int(tri.shape[0])
    if tuple(tri.shape) != (P, RECORD_WIDTH) or order.shape != (P,):
        raise ValueError(f"records {tuple(tri.shape)} and order "
                         f"{order.shape} do not describe one scene")
    if aabb.ndim != 2 or aabb.shape[0] != C or aabb.shape[1] < 6 \
            or count.shape != (C,):
        raise ValueError(f"cluster arrays disagree: aabb {aabb.shape}, "
                         f"first {first.shape}, count {count.shape}")
    if C and (first.min() < 0 or count.min() < 0
              or int((first.astype(np.int64) + count).max()) > P):
        raise ValueError("a cluster's range leaves the records")
    # one (8,) row a cluster: the box, then first and count as bit patterns
    table = np.zeros((C, 8), np.float32)
    table[:, :6] = aabb[:, :6]
    table[:, 6:8] = np.stack([first, count], axis=1).view(np.float32)
    group_table, group_visit, visit = cluster_groups(aabb, group)
    return {
        "tri": tri.to(device=device, dtype=torch.float32).contiguous(),
        "table": torch.from_numpy(table).to(device),          # (C, 8)
        # the two-level order, flattened: each group's clusters are a run
        "visit": torch.from_numpy(visit).to(device),          # (8, C)
        "group_table": torch.from_numpy(group_table).to(device),  # (G, 8)
        "group_visit": torch.from_numpy(group_visit).to(device),  # (8, G)
        "order": torch.from_numpy(order).to(device),          # slot -> prim
        "num_clusters": C,
        "num_groups": int(group_table.shape[0]),
        "cluster_group": group,
        "num_prims": P,
    }


def prepare_clusters(v0, e1, e2, clusters, device=None, group=None):
    """Pack the scene for the clustered queries (once per scene): records in
    treelet order, the cluster and group tables and the octant visit
    tables.

    v0, e1, e2: (P, 3) float32 tensors (rt.intersect.triangle_arrays);
    clusters: rt.bvh.build_clusters output; group: clusters a group
    (default :data:`CLUSTER_GROUP`).  Lands on ``device`` (default: where v0
    lies)."""
    device = v0.device if device is None else torch.device(device)
    tri = pack_records(v0.cpu(), e1.cpu(), e2.cpu(), order=clusters["order"])
    return pack_clusters(tri, clusters["aabb"], clusters["first"],
                         clusters["count"], clusters["order"], device,
                         group=group)


def _slab(box, o, inv, far):
    """(tn, tf) of the slab test of AABBs ``box`` (six tensors or numbers
    [min.xyz max.xyz ...]) against rays o, inv (three tensors each) with the
    far clip ``far``, everything broadcast together: pallas_rt._slab /
    _slab_embedded, term by term."""
    t0x = (box[0] - o[0]) * inv[0]
    t1x = (box[3] - o[0]) * inv[0]
    t0y = (box[1] - o[1]) * inv[1]
    t1y = (box[4] - o[1]) * inv[1]
    t0z = (box[2] - o[2]) * inv[2]
    t1z = (box[5] - o[2]) * inv[2]
    zero = torch.zeros((), dtype=far.dtype, device=far.device)
    tn = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.maximum(torch.minimum(t0z, t1z), zero))
    tf = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.minimum(torch.maximum(t0z, t1z), far))
    return tn, tf


def _slab_pass(box, o, inv, far):
    """tn <= tf of one AABB row against rays ((r,) x 3 each), far (r,)."""
    tn, tf = _slab(box, o, inv, far)
    return tn <= tf


def _components(orig, direction):
    o = tuple(orig[:, k].contiguous() for k in range(3))
    d = tuple(direction[:, k].contiguous() for k in range(3))
    return o, d, tuple(intersect.inv_dir(c) for c in d)


def _take(components, idx):
    return tuple(c[idx] for c in components)


def _range_tests(tri, first, n, o, d, idx, t_min):
    """Möller–Trumbore of rays ``idx`` against record rows first .. first+n:
    (ok, t, u, v) over (len(idx), n), ok without the upper bound on t."""
    rec = tri[first:first + n]                              # (n, 12)
    col = [rec[None, :, k] for k in range(9)]
    ray = [c[idx][:, None] for c in o + d]
    valid, t, u, v = intersect.mt_components(
        *ray, col[0:3], col[3:6], col[6:9])
    ok = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return ok, t, u, v


def _idx_chunks(idx, n):
    step = max(1, intersect.PAIR_BUDGET // max(n, 1))
    return [idx[lo:lo + step] for lo in range(0, idx.numel(), step)]


def _count(stats, **kw):
    if stats is not None:
        for k, v in kw.items():
            stats[k] = stats.get(k, 0) + int(v)


def _new_best(tmax0):
    R, dev = tmax0.shape[0], tmax0.device
    return (tmax0.clone(),
            torch.full((R,), -1, dtype=torch.int64, device=dev),
            torch.zeros((R,), dtype=torch.float32, device=dev),
            torch.zeros((R,), dtype=torch.float32, device=dev))


def _merge_best(best, idx, hit, t, u, v, slots):
    """Fold the hits of rays ``idx`` ((r, n) masks and values; slots (r, n)
    or (1, n) int64, ascending along n) into best = (t, slot, u, v), in
    place: the lexicographic (t, slot) minimum."""
    best_t, best_s, best_u, best_v = best
    t_m = torch.where(hit, t, torch.full_like(t, math.inf))
    # first minimum = lowest slot of the range at equal t
    j = torch.argmin(t_m, dim=1, keepdim=True)
    cand_t = t_m.gather(1, j)[:, 0]
    slot = slots.expand_as(t_m).gather(1, j)[:, 0]
    cur_t, cur_s = best_t[idx], best_s[idx]
    better = (cand_t < math.inf) & (
        (cand_t < cur_t) | ((cand_t == cur_t) & (slot < cur_s)))
    w = idx[better]
    jb = j[better]
    best_t[w] = cand_t[better]
    best_s[w] = slot[better]
    best_u[w] = u[better].gather(1, jb)[:, 0]
    best_v[w] = v[better].gather(1, jb)[:, 0]


def _closest_box(best, tri, box, first, n, rays, o, d, inv, tmax0, t_min,
                 stats, after):
    """Fold one box (AABB row, first record row, n) into the running
    minimum ``best`` for ``rays`` (an index tensor; None: all rays): the
    slab gate against each ray's running best t, then the (rays that pass x
    n triangles) Möller–Trumbore batch.  With ``after`` = (t_lo (r,)
    float32, slot_lo (r,) int64) only hits with (t_lo, slot_lo) < (t, slot)
    in lexicographic order count."""
    if rays is None:
        idx_all = torch.nonzero(_slab_pass(box, o, inv, best[0]))[:, 0]
        tested = best[0].shape[0]
    else:
        idx_all = rays[_slab_pass(box, _take(o, rays), _take(inv, rays),
                                  best[0][rays])]
        tested = rays.numel()
    _count(stats, slab_tests=tested, slab_pass=idx_all.numel(),
           tri_tests=idx_all.numel() * n)
    if n == 0:
        return idx_all
    slots = first + torch.arange(n, device=tmax0.device)[None, :]
    for idx in _idx_chunks(idx_all, n):
        ok, t, u, v = _range_tests(tri, first, n, o, d, idx, t_min)
        hit = ok & (t < tmax0[idx][:, None])
        if after is not None:
            t_lo = after[0][idx][:, None]
            hit = hit & ((t > t_lo) | ((t == t_lo)
                                       & (slots > after[1][idx][:, None])))
        _merge_best(best, idx, hit, t, u, v, slots)
    return idx_all


def _closest_over(tri, boxes, o, d, inv, tmax0, t_min, stats):
    """The running lexicographic (t, slot) minimum of rays (o, d, inv:
    component tuples; tmax0 (r,)) over ``boxes``, an iterable of (AABB row,
    first record row, n) met in that order, each through
    :func:`_closest_box`, with the lane counts of :func:`_count_lanes`.
    Returns (best_t, best_slot [-1 = none], u, v)."""
    best = _new_best(tmax0)
    for box, first, n in boxes:
        _count_lanes(stats, _closest_box(best, tri, box, first, n, None, o,
                                         d, inv, tmax0, t_min, stats, None),
                     n)
    return best


def _count_lanes(stats, rays, n):
    """The streamed and worklist kernels' lanes on one step of their walk:
    ``rays`` (r,) entered a block of ``n`` triangles (an int, or (r,): a
    warp's rays share their block).  A warp is 32 consecutive rays; where k
    of them enter, the kernel runs 32 lanes over the n triangles when k >=
    STREAM_LANE_SWITCH, else k passes of ceil(n / 32) steps of 32 lanes.
    ``stats`` gains ``warp_visits`` (warps with k >= 1), ``warp_tri_tests``
    (the useful lane-steps, k * n a visit: ``tri_tests`` counted by warps),
    ``lane_steps`` (lane-steps run) and ``lane_steps_ray`` (those of a ray a
    lane on every visit: the earlier design)."""
    if stats is None or rays.numel() == 0:
        return
    warp, inv, k = torch.unique(rays // 32, return_inverse=True,
                                return_counts=True)
    n = torch.as_tensor(n, device=rays.device).expand(rays.shape)
    nw = torch.zeros_like(warp).scatter_(0, inv, n.to(warp.dtype))
    ray_lane = 32 * nw
    across = 32 * k * ((nw + 31) // 32)
    _count(stats, warp_visits=warp.numel(), warp_tri_tests=(k * nw).sum(),
           lane_steps_ray=ray_lane.sum(),
           lane_steps=torch.where(k >= STREAM_LANE_SWITCH, ray_lane,
                                  across).sum())


def _any_over(tri, boxes, o, d, inv, tmax, t_min, stats):
    """Whether any triangle of ``boxes`` (as in :func:`_closest_over`) hits
    with t_min < t < tmax (r,); a ray leaves the loop at its first hit."""
    R = tmax.shape[0]
    dev = tmax.device
    occ = torch.zeros((R,), dtype=torch.bool, device=dev)
    alive = torch.arange(R, device=dev)
    for box, first, n in boxes:
        idx_all = alive[_slab_pass(box, _take(o, alive), _take(inv, alive),
                                   tmax[alive])]
        _count(stats, slab_tests=alive.numel(), slab_pass=idx_all.numel(),
               tri_tests=idx_all.numel() * n)
        if n == 0 or idx_all.numel() == 0:
            continue
        for idx in _idx_chunks(idx_all, n):
            ok, t, _, _ = _range_tests(tri, first, n, o, d, idx, t_min)
            hit = (ok & (t < tmax[idx][:, None])).any(dim=1)
            occ[idx[hit]] = True
        alive = alive[~occ[alive]]
    return occ


def _closest_result(best_t, best_s, best_u, best_v, slot_to_prim):
    miss = best_s < 0
    prim = torch.where(miss, -1, slot_to_prim[best_s.clamp(min=0)])
    zero = torch.zeros_like(best_t)
    return (prim,
            torch.where(miss, torch.full_like(best_t, math.inf), best_t),
            torch.where(miss, zero, best_u),
            torch.where(miss, zero, best_v))


def _closest_over_blocks(blocks, block_order, o, d, inv, tmax0, t_min, stats,
                         after=None):
    """:func:`_closest_over` over the blocks' leaves: the blocks in
    ascending id (or ``block_order``), in each the slab gate of every ray
    against its running best t, and for the rays that enter, the block's
    leaves in ascending order through :func:`_closest_box`.

    The block gate changes no result: every leaf box lies inside its
    block's box and the running best only falls, so a ray that passes a
    leaf's gate has passed its block's (csrc/rt_bvh.cu, "Order").  It is
    here to count the kernel's work: ``stats`` gains ``blocks_entered`` and
    ``block_tri_tests`` (the triangle tests had every entered block been
    tested whole) beside the leaves' ``slab_tests``, ``slab_pass`` and
    ``tri_tests``."""
    rng, table = blocks["leaf_range"], blocks["leaf_table"]
    rng = rng.tolist()
    ranges = table[:, 6:8].contiguous().view(torch.int32).tolist()
    counts = blocks["bcnt"].tolist()
    level0 = blocks["levels"][0]
    best = _new_best(tmax0)
    order = range(blocks["num_blocks"]) if block_order is None else block_order
    for b in order:
        entered = torch.nonzero(_slab_pass(level0[b], o, inv, best[0]))[:, 0]
        _count(stats, blocks_entered=entered.numel(),
               block_tri_tests=entered.numel() * counts[b])
        if entered.numel() == 0:
            continue
        for k in range(rng[b], rng[b + 1]):
            _closest_box(best, blocks["tri"], table[k], *ranges[k], entered,
                         o, d, inv, tmax0, t_min, stats, after)
    return best


def closest_hit_bvh_reference(orig, direction, blocks, t_max=None,
                              t_min: float = T_MIN, block_order=None,
                              stats=None):
    """Plain torch closest hit over the blocks' leaves, on any device: what
    :func:`closest_hit_bvh` returns.

    Loops over level-0 blocks (ascending, or ``block_order``) and their
    leaves with :func:`_closest_over_blocks`.  ``stats``, a dict, gains the
    counts named there: ``slab_tests`` / ``slab_pass`` count the leaves'
    ray-box tests and those that passed, ``tri_tests`` the ray-triangle
    tests."""
    o, d, inv = _components(orig, direction)
    tmax0 = _per_ray_tmax(math.inf if t_max is None else t_max,
                          orig.shape[0], orig.device)
    best = _closest_over_blocks(blocks, block_order, o, d, inv, tmax0, t_min,
                                stats)
    return _closest_result(*best, blocks["s2p"])


def _any_over_leaves(tri, box, met, leaf_of, first, n, rays, o, d, inv,
                     tmax, t_min, occ, stats):
    """The leaves of one block for ``rays`` (an index tensor) against the
    fixed far ``tmax``: all leaf gates in one batch (box (nl, 6)), then the
    Möller–Trumbore batch of the block's n record rows from ``first`` on.
    ``met`` (n,) lists the block's slots (offsets from ``first``) in the
    order the walk meets them, leaf by leaf; ``leaf_of`` (n,) is each met
    slot's leaf.  Sets ``occ`` where a triangle of a passing leaf hits with
    t_min < t < tmax, and counts what a walk that stops at its first hit
    tests: ``slab_tests`` / ``slab_pass`` of the leaves up to the hit,
    ``tri_tests`` of their triangles, and ``block_tri_tests``, the triangles
    a walk that tested the block whole, in ascending slot order, would
    test."""
    nl = box.shape[0]
    lbox = [box[None, :, k] for k in range(6)]
    for idx in _idx_chunks(rays, n):
        far = tmax[idx][:, None]
        lpass = _slab_pass(lbox, [c[idx][:, None] for c in o],
                           [c[idx][:, None] for c in inv], far)   # (r, nl)
        ok, t, _, _ = _range_tests(tri, first, n, o, d, idx, t_min)
        whole = ok & (t < far)                    # (r, n), ascending slots
        gate = lpass[:, leaf_of]                  # (r, n), met order
        hit = whole[:, met] & gate
        found = hit.any(dim=1)
        occ[idx[found]] = True
        if stats is None:
            continue
        # the first hit in met order, and in ascending order for whole blocks
        j = torch.argmax(hit.to(torch.int8), dim=1, keepdim=True)
        jw = torch.argmax(whole.to(torch.int8), dim=1)
        last = torch.full_like(j, n - 1)
        upto = torch.where(found[:, None], j, last)         # last slot met
        k = leaf_of[upto]                                    # its leaf
        _count(stats,
               slab_tests=torch.where(found, k[:, 0] + 1, nl).sum(),
               slab_pass=lpass.cumsum(dim=1).gather(1, k).sum(),
               tri_tests=gate.cumsum(dim=1).gather(1, upto).sum(),
               block_tri_tests=torch.where(whole.any(dim=1), jw + 1,
                                           n).sum())


def any_hit_bvh_reference(orig, direction, blocks, t_max=1.0,
                          t_min: float = T_MIN, block_order=None, stats=None):
    """Plain torch occlusion query over the blocks' leaves, on any device:
    what :func:`any_hit_bvh` returns, whether a triangle hits with t_min < t
    < t_max (a number or (R,)) inside a leaf whose box the ray's slab test
    enters with far = its fixed t_max.

    Loops over level-0 blocks (ascending, or ``block_order``): the slab gate
    of every ray not yet occluded, then for the rays that enter, all of the
    block's leaves through :func:`_any_over_leaves`, in the order of the
    leaf table.  The far bound never changes, so the answer does not depend
    on the order of blocks or leaves, and the block gate changes none (a
    leaf's box lies inside its block's); the order decides only where a ray
    stops, and so the counts.  ``stats``, a dict, gains ``blocks_entered``
    and the counts named there."""
    rng, table = blocks["leaf_range"], blocks["leaf_table"]
    o, d, inv = _components(orig, direction)
    R, dev = orig.shape[0], orig.device
    tmax = _per_ray_tmax(t_max, R, dev)
    occ = torch.zeros((R,), dtype=torch.bool, device=dev)
    alive = torch.arange(R, device=dev)
    TB, level0 = blocks["tri_block"], blocks["levels"][0]
    rng, counts = rng.tolist(), blocks["bcnt"].tolist()
    ranges = table[:, 6:8].contiguous().view(torch.int32).long()
    order = range(blocks["num_blocks"]) if block_order is None else block_order
    for b in order:
        if alive.numel() == 0:
            break
        entered = alive[_slab_pass(level0[b], _take(o, alive),
                                   _take(inv, alive), tmax[alive])]
        _count(stats, blocks_entered=entered.numel())
        k0, k1, n = rng[b], rng[b + 1], counts[b]
        if entered.numel() == 0 or n == 0:
            continue
        # the block's slots leaf by leaf, in the table's order
        first, cnt = ranges[k0:k1, 0] - b * TB, ranges[k0:k1, 1]
        leaf_of = torch.repeat_interleave(
            torch.arange(k1 - k0, device=dev), cnt)
        start = torch.cumsum(cnt, 0) - cnt
        met = (first - start)[leaf_of] + torch.arange(n, device=dev)
        _any_over_leaves(blocks["tri"], table[k0:k1, :6], met, leaf_of,
                         b * TB, n, entered, o, d, inv, tmax, t_min, occ,
                         stats)
        alive = alive[~occ[alive]]
    return occ


def closest_hit_bvh_after_reference(orig, direction, blocks, t_lo, slot_lo,
                                    t_max=None, t_min: float = T_MIN,
                                    block_order=None, stats=None):
    """Plain torch next hit after the carry, on any device: what
    :func:`closest_hit_bvh_after` returns.  The loop of
    :func:`closest_hit_bvh_reference` (the slab gates' far bound is the
    running best t and admits equality) with the lower window (t_lo,
    slot_lo) < (t, slot).

    A ray whose carry has t_lo = +inf is a miss without a loop, as in the
    kernel.  That exit is exact: a hit has t < t_max <= +inf, so (+inf,
    slot_lo) < (t, slot) never holds, and the loop would return the same
    miss; it only keeps such rays out of ``stats``."""
    o, d, inv = _components(orig, direction)
    tmax0 = _per_ray_tmax(math.inf if t_max is None else t_max,
                          orig.shape[0], orig.device)
    best = _new_best(tmax0)
    live = torch.nonzero(t_lo != math.inf)[:, 0]
    got = _closest_over_blocks(
        blocks, block_order, _take(o, live), _take(d, live), _take(inv, live),
        tmax0[live], t_min, stats, after=(t_lo[live], slot_lo.long()[live]))
    for whole, part in zip(best, got):
        whole[live] = part
    slot = best[1].to(torch.int32)
    return (slot, *_closest_result(*best, blocks["s2p"]))


def _stream_boxes(stream):
    TB, P = stream["tri_block"], stream["num_prims"]
    return ((stream["aabb"][b], b * TB, min(TB, P - b * TB))
            for b in range(stream["num_blocks"]))


def _stream_prim(stream):
    """slot -> prim of the streamed / worklist records: ``order``, or the
    identity."""
    if stream["order"] is not None:
        return stream["order"]
    return torch.arange(stream["num_prims"], dtype=torch.int32,
                        device=stream["tri"].device)


def closest_hit_streamed_reference(orig, direction, stream, t_max=None,
                                   t_min: float = T_MIN, stats=None):
    """Plain torch streamed closest hit, on any device: what
    :func:`closest_hit_streamed` returns.  Every block in ascending id
    (:func:`_closest_over`): the slab gate of each ray against its running
    best t, then the block's triangles for the rays that pass.  ``stats``,
    a dict, gains the per-ray ``slab_tests``, ``slab_pass`` and
    ``tri_tests`` and the kernel's lanes (:func:`_count_lanes`)."""
    o, d, inv = _components(orig, direction)
    tmax0 = _per_ray_tmax(math.inf if t_max is None else t_max,
                          orig.shape[0], orig.device)
    best = _closest_over(stream["tri"], _stream_boxes(stream), o, d, inv,
                         tmax0, t_min, stats)
    return _closest_result(*best, _stream_prim(stream))


def active_block_lists_reference(orig, direction, stream, t_max=None,
                                 front_to_back: bool = True):
    """Plain torch prepass of :func:`closest_hit_worklist`, on any device:
    what :func:`active_block_lists` returns (pallas_rt._active_block_lists).
    For every tile of
    ``STREAM_RAY_TILE`` consecutive rays the blocks that some ray of the tile
    enters by the exact slab test against its fixed t_max, compacted to the
    front of the row, near to far by the tile's least entry distance
    (``front_to_back``; equal distances keep ascending id) or in ascending
    block id.  Returns (lists (G, NB) int32, counts (G,) int32); a row's
    entries past its count are never read."""
    R, dev = orig.shape[0], orig.device
    T, NB = STREAM_RAY_TILE, stream["num_blocks"]
    G = -(-R // T)
    o, d, inv = _components(orig, direction)
    far = _per_ray_tmax(math.inf if t_max is None else t_max, R, dev)
    o, inv = [c[:, None] for c in o], [c[:, None] for c in inv]
    active = torch.zeros((G, NB), dtype=torch.bool, device=dev)
    tn_min = torch.full((G, NB), math.inf, dtype=torch.float32, device=dev)
    step = max(1, PREPASS_PAIRS // max(R, 1))
    for b0 in range(0, NB, step):
        box = stream["aabb"][b0:b0 + step]                  # (nc, 6)
        tn, tf = _slab([box[None, :, k] for k in range(6)], o, inv,
                       far[:, None])
        hit = tn <= tf                                      # (R, nc)
        tn = torch.where(hit, tn, torch.full_like(tn, math.inf))
        pad = G * T - R
        if pad:     # the last tile is short: its missing rays enter nothing
            hit = torch.cat([hit, hit.new_zeros((pad, hit.shape[1]))])
            tn = torch.cat([tn, tn.new_full((pad, tn.shape[1]), math.inf)])
        active[:, b0:b0 + step] = hit.view(G, T, -1).any(dim=1)
        tn_min[:, b0:b0 + step] = tn.view(G, T, -1).amin(dim=1)
    if front_to_back:
        key = torch.where(active, tn_min, torch.full_like(tn_min, math.inf))
    else:
        key = (~active).to(torch.int8)
    lists = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    return lists.contiguous(), active.sum(dim=1).to(torch.int32)


def closest_hit_worklist_reference(orig, direction, stream, lists, counts,
                                   t_max=None, t_min: float = T_MIN,
                                   stats=None):
    """Plain torch worklist closest hit, on any device: what
    :func:`closest_hit_worklist` returns for the same lists.  Step k takes
    every ray whose tile's list has more than k entries to block
    ``lists[tile, k]``: the slab gate against the ray's running best t, then
    that block's triangles: the kernel's per-ray order.  ``stats`` as for
    :func:`closest_hit_streamed_reference`."""
    R, dev = orig.shape[0], orig.device
    T, TB, P = STREAM_RAY_TILE, stream["tri_block"], stream["num_prims"]
    tri, aabb = stream["tri"], stream["aabb"]
    o, d, inv = _components(orig, direction)
    tmax0 = _per_ray_tmax(math.inf if t_max is None else t_max, R, dev)
    best = _new_best(tmax0)
    tile = torch.arange(R, device=dev) // T
    steps_of = counts.long()[tile]                          # (R,)
    cols = torch.arange(TB, device=dev)[None, :]
    for k in range(int(counts.max()) if counts.numel() else 0):
        rays = torch.nonzero(steps_of > k)[:, 0]
        blk = lists[tile[rays], k].long()
        enter = _slab_pass(aabb[blk].unbind(dim=1), _take(o, rays),
                           _take(inv, rays), best[0][rays])
        rays, blk = rays[enter], blk[enter]
        n = (P - blk * TB).clamp(max=TB)
        _count(stats, slab_tests=enter.numel(), slab_pass=rays.numel(),
               tri_tests=n.sum())
        _count_lanes(stats, rays, n)
        for sel in _idx_chunks(torch.arange(rays.numel(), device=dev), TB):
            idx = rays[sel]
            slots = blk[sel][:, None] * TB + cols           # (r, TB)
            rec = tri[slots.clamp(max=P - 1)]               # (r, TB, 12)
            ray = [c[idx][:, None] for c in o + d]
            col = [rec[..., c] for c in range(9)]
            valid, t, u, v = intersect.mt_components(
                *ray, col[0:3], col[3:6], col[6:9])
            hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (t > t_min) & (slots < P) & (t < tmax0[idx][:, None]))
            _merge_best(best, idx, hit, t, u, v, slots)
    return _closest_result(*best, _stream_prim(stream))


def _octant_groups(clusters, d):
    """For each direction octant that holds rays: (ray indices, that
    octant's groups in its visit order, each (group AABB row, its clusters'
    (AABB row, first, count) in the octant's order))."""
    table, gtable = clusters["table"], clusters["group_table"]
    ranges = table[:, 6:8].contiguous().view(torch.int32).tolist()
    sizes = gtable[:, 7].contiguous().view(torch.int32).tolist()
    gvisit = clusters["group_visit"].tolist()
    visit = clusters["visit"].tolist()
    octant = ((d[0] > 0).long() | ((d[1] > 0).long() << 1)
              | ((d[2] > 0).long() << 2))
    for q in range(8):
        rays = torch.nonzero(octant == q)[:, 0]
        if not rays.numel():
            continue
        groups, pos = [], 0
        for g in gvisit[q]:
            groups.append((gtable[g], [(table[c], *ranges[c])
                                       for c in visit[q][pos:pos + sizes[g]]]))
            pos += sizes[g]
        yield rays, groups


def closest_hit_clustered_reference(orig, direction, clusters, t_max=None,
                                    t_min: float = T_MIN, stats=None):
    """Plain torch clustered closest hit, on any device: what
    :func:`closest_hit_clustered` returns.  The rays of one direction octant
    go through that octant's groups in its order together: the slab gate of
    every ray against its running best t, then for the rays that enter, the
    group's clusters in the octant's order through :func:`_closest_box`.

    The group gate changes no result: a group's box contains its clusters'
    boxes and the running best only falls, so a ray that passes a cluster's
    gate has passed its group's.  It is here to count the kernel's work:
    ``stats`` gains ``group_slab_tests`` and ``groups_entered`` beside the
    clusters' ``slab_tests`` / ``slab_pass`` and the ``tri_tests``."""
    R = orig.shape[0]
    dev = orig.device
    o, d, inv = _components(orig, direction)
    tmax0 = _per_ray_tmax(math.inf if t_max is None else t_max, R, dev)
    best = _new_best(tmax0)
    for rays, groups in _octant_groups(clusters, d):
        oq, dq, iq, tq = (_take(o, rays), _take(d, rays), _take(inv, rays),
                          tmax0[rays])
        got = _new_best(tq)
        for gbox, boxes in groups:
            entered = torch.nonzero(_slab_pass(gbox, oq, iq, got[0]))[:, 0]
            _count(stats, group_slab_tests=rays.numel(),
                   groups_entered=entered.numel())
            if entered.numel() == 0:
                continue
            for box, first, n in boxes:
                _closest_box(got, clusters["tri"], box, first, n, entered, oq,
                             dq, iq, tq, t_min, stats, None)
        for whole, part in zip(best, got):
            whole[rays] = part
    return _closest_result(*best, clusters["order"])


def any_hit_clustered_reference(orig, direction, clusters, t_max=1.0,
                                t_min: float = T_MIN, stats=None):
    """Plain torch clustered occlusion query, on any device: what
    :func:`any_hit_clustered` returns, in the kernel's per-ray order.  The
    rays of one direction octant meet that octant's groups in its order;
    the rays without a hit so far take the slab gate of a group against
    their fixed t_max, and those that enter go through the group's clusters
    in the octant's order through :func:`_any_over`, leaving at their first
    hit.

    The answer depends neither on the order nor on the group gate (a
    group's box contains its clusters' boxes and far is fixed); the counts
    in ``stats`` do: ``group_slab_tests`` and ``groups_entered`` beside the
    clusters' ``slab_tests`` / ``slab_pass`` and the ``tri_tests``."""
    R = orig.shape[0]
    o, d, inv = _components(orig, direction)
    tmax = _per_ray_tmax(t_max, R, orig.device)
    occ = torch.zeros((R,), dtype=torch.bool, device=orig.device)
    for rays, groups in _octant_groups(clusters, d):
        alive = rays
        for gbox, boxes in groups:
            entered = alive[_slab_pass(gbox, _take(o, alive),
                                       _take(inv, alive), tmax[alive])]
            _count(stats, group_slab_tests=alive.numel(),
                   groups_entered=entered.numel())
            if entered.numel() == 0:
                continue
            occ[entered] = _any_over(
                clusters["tri"], boxes, _take(o, entered), _take(d, entered),
                _take(inv, entered), tmax[entered], t_min, stats)
            alive = alive[~occ[alive]]
    return occ


def closest_hit_pallas_reference(orig, direction, tri, t_max=None,
                                 t_min: float = T_MIN):
    """Plain torch flat closest hit, on any device: what
    :func:`closest_hit_pallas` returns.  All pairs in ray chunks; the first
    minimum of a row is the lowest prim id among equal t."""
    R, P = orig.shape[0], tri.shape[0]
    dev = orig.device
    o, d, _ = _components(orig, direction)
    tmax0 = _per_ray_tmax(math.inf if t_max is None else t_max, R, dev)
    best_t = torch.full((R,), math.inf, dtype=torch.float32, device=dev)
    best_p = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((R,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((R,), dtype=torch.float32, device=dev)
    if P == 0:
        return best_p, best_t, best_u, best_v
    for idx in _idx_chunks(torch.arange(R, device=dev), P):
        ok, t, u, v = _range_tests(tri, 0, P, o, d, idx, t_min)
        hit = ok & (t < tmax0[idx][:, None])
        t_m = torch.where(hit, t, torch.full_like(t, math.inf))
        j = torch.argmin(t_m, dim=1, keepdim=True)
        cand_t = t_m.gather(1, j)[:, 0]
        found = cand_t < math.inf
        w = idx[found]
        jf = j[found]
        best_t[w] = cand_t[found]
        best_p[w] = jf[:, 0].to(torch.int32)
        best_u[w] = u[found].gather(1, jf)[:, 0]
        best_v[w] = v[found].gather(1, jf)[:, 0]
    return best_p, best_t, best_u, best_v


def flat_test_terms(tri, o, d):
    """The flat kernel's arithmetic (csrc/rt_clustered.cu) for rays against
    records tri (n, 12), in plain torch: a dict of (r, n) tensors det,
    t_num, u, v, t, each with mt_record's operations in its order, where the
    kernel's cuts read them.  d is (r, 3); o is (r, 3), or (3,): one origin
    for every ray, whose terms tv = o - v0, qv = tv x e1 and t_num = e2 . qv
    are computed once a record, as a thread block whose rays share their
    origin stages them."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        tri[None, :, k] for k in range(9))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    ox, oy, oz = (o[k] for k in range(3)) if o.ndim == 1 else (
        o[:, k:k + 1] for k in range(3))
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    t_num = e2x * qvx + e2y * qvy + e2z * qvz
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    valid = det.abs() > intersect.EPS
    one = torch.ones((), dtype=det.dtype, device=det.device)
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, one),
                          torch.zeros_like(one))
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t_num = t_num.expand_as(det)
    return {"det": det, "t_num": t_num, "u": u, "v": v, "t": t_num * inv_det}


def flat_t_may_pass(det, t_num, t_min: float = T_MIN):
    """The flat kernel's t-sign cut: False where a test with |det| >
    MT_EPS cannot pass t > t_min because t_num is 0, NaN or of the sign
    opposite to det's (csrc/rt_clustered.cu proves it); True everywhere when
    t_min < 0, where the kernel leaves the cut out."""
    if t_min < 0:
        return torch.ones_like(det, dtype=torch.bool)
    return ((t_num > 0) & (det > 0)) | ((t_num < 0) & (det < 0))


def _flat_shared_blocks(orig):
    """(blocks,) bool: the thread blocks of the flat kernel's launch over
    rays orig (R, 3), ``FLAT_THREADS`` consecutive rays each, whose rays
    share one origin bit for bit."""
    R, n = orig.shape[0], FLAT_THREADS
    bits = orig.contiguous().view(torch.int32)
    first = bits[torch.arange(R, device=orig.device) // n * n]
    differs = (bits != first).any(dim=1)
    differs = torch.cat([differs, differs.new_zeros((-R) % n)])
    return ~differs.view(-1, n).any(dim=1)


def flat_shared_origin_blocks(orig):
    """(blocks, blocks whose rays share their origin bit for bit) of the
    flat kernel's launch over rays orig (R, 3): thread blocks of
    ``FLAT_THREADS`` consecutive rays; a shared one stages tv, qv and t_num
    once a record."""
    shared = _flat_shared_blocks(orig)
    return int(shared.numel()), int(shared.sum())


def flat_work_counts(orig, direction, tri, t_min: float = T_MIN):
    """The flat kernel's work on rays (R, 3) against records tri (P, 12),
    counted by the plain arithmetic (:func:`flat_test_terms`): ``pairs``;
    ``det_pass``, the tests that go on past det (|det| > MT_EPS), and
    ``det_pass_general`` of them those in blocks that compute tv, qv and
    t_num a test; ``t_pass``, those the t-sign cut keeps (the reciprocal and
    u); ``u_pass``, those of them with u >= 0 (v and t); and ``blocks`` /
    ``shared_blocks`` of :func:`flat_shared_origin_blocks`."""
    P = tri.shape[0]
    shared = _flat_shared_blocks(orig)[
        torch.arange(orig.shape[0], device=orig.device) // FLAT_THREADS]
    keys = ("pairs", "det_pass", "det_pass_general", "t_pass", "u_pass")
    out = dict.fromkeys(keys, 0)
    for idx in _idx_chunks(torch.arange(orig.shape[0], device=orig.device),
                           P):
        terms = flat_test_terms(tri, orig[idx], direction[idx])
        det_pass = terms["det"].abs() > intersect.EPS
        t_pass = det_pass & flat_t_may_pass(terms["det"], terms["t_num"],
                                            t_min)
        out["pairs"] += idx.numel() * P
        out["det_pass"] += int(det_pass.sum())
        out["det_pass_general"] += int(det_pass[~shared[idx]].sum())
        out["t_pass"] += int(t_pass.sum())
        out["u_pass"] += int((t_pass & (terms["u"] >= 0)).sum())
    out["blocks"], out["shared_blocks"] = flat_shared_origin_blocks(orig)
    return out


def _per_ray_tmax(t_max, R, dev):
    t = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    return torch.broadcast_to(t, (R,)).contiguous()


def _check_rays(orig, direction):
    if orig.ndim != 2 or orig.shape[1] != 3 or direction.shape != orig.shape:
        raise ValueError(f"rays must be (R, 3): got {tuple(orig.shape)} and "
                         f"{tuple(direction.shape)}")
    if orig.dtype != torch.float32 or direction.dtype != torch.float32:
        raise TypeError("rays must be float32")
    if direction.device != orig.device:
        raise ValueError("origins and directions lie on different devices")


def _check_on_card(dev, what, tensors):
    """Raises unless the rays lie on a CUDA device and every (name, tensor,
    shape, dtype) of ``tensors`` lies there too, contiguous, as stated."""
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_tensors(dev, what, tensors, contiguous=True)


def _check_tensors(dev, what, tensors, contiguous=False):
    """Raises unless every (name, tensor, shape, dtype) of ``tensors`` lies
    on the rays' device ``dev`` with that shape and dtype (and contiguous,
    if asked)."""
    for name, t, shape, dtype in tensors:
        if t.device != dev:
            raise ValueError(f"{what}[{name!r}] is on {t.device}, the rays "
                             f"on {dev}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{what}[{name!r}] is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{what}[{name!r}] must be contiguous")


def _kernel_args(orig, direction, blocks):
    """(o, d, level offsets, level counts, levels) for a BVH-block launch,
    after checking the blocks and their leaf table on the rays' card."""
    slots = blocks["num_blocks"] * blocks["tri_block"]
    table = blocks["leaf_table"]
    _check_on_card(orig.device, "blocks", [
        ("tri", blocks["tri"], (slots, RECORD_WIDTH), torch.float32),
        ("bcnt", blocks["bcnt"], (blocks["num_blocks"],), torch.int32),
        ("s2p", blocks["s2p"], (slots,), torch.int32),
        ("aabb", blocks["aabb"], (sum(blocks["level_counts"]), 6),
         torch.float32),
        ("leaf_range", blocks["leaf_range"], (blocks["num_blocks"] + 1,),
         torch.int32),
        ("leaf_table", table, (table.shape[0], 8), torch.float32)])
    n = len(blocks["level_offsets"])
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"AABB pyramid has {n} levels, the kernels take "
                         f"at most {MAX_LEVELS}")
    arr = ctypes.c_int * n
    return (orig.contiguous(), direction.contiguous(),
            arr(*blocks["level_offsets"]), arr(*blocks["level_counts"]), n)


def _check_clusters(dev, clusters):
    C, P = clusters["num_clusters"], clusters["num_prims"]
    G = clusters["num_groups"]
    _check_on_card(dev, "clusters", (
        ("tri", clusters["tri"], (P, RECORD_WIDTH), torch.float32),
        ("table", clusters["table"], (C, 8), torch.float32),
        ("visit", clusters["visit"], (8, C), torch.int32),
        ("group_table", clusters["group_table"], (G, 8), torch.float32),
        ("group_visit", clusters["group_visit"], (8, G), torch.int32),
        ("order", clusters["order"], (P,), torch.int32)))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _launch(name, dev, *args):
    """Call the library's ``name`` on the current stream of ``dev`` and
    count the launch; raises unless the launch was accepted."""
    from .. import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, name)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launch_counts[name.removeprefix("skybox_rt_")] += 1


def _closest_outputs(R, dev):
    prim = torch.empty((R,), dtype=torch.int32, device=dev)
    t, u, v = (torch.empty((R,), dtype=torch.float32, device=dev)
               for _ in range(3))
    return prim, t, u, v


def closest_hit_bvh(orig, direction, blocks, t_max=None,
                    t_min: float = T_MIN):
    """Closest hit of rays (R, 3) float32 over the treelet blocks.

    blocks: :func:`prepare_bvh_blocks` output on the rays' device.  t_max:
    None (no bound) or (R,) float32.  Returns (prim (R,) i32 in ORIGINAL ids
    [-1 = miss], t [inf on a miss], u, v [0 on a miss]); equal t resolve to
    the lowest slot (module docstring)."""
    _check_rays(orig, direction)
    if t_max is not None:
        t_max = _per_ray_tmax(t_max, orig.shape[0], orig.device)
    if orig.device.type == "cpu":
        return closest_hit_bvh_reference(orig, direction, blocks, t_max,
                                         t_min)
    o, d, off, cnt, n = _kernel_args(orig, direction, blocks)
    R = o.shape[0]
    prim, t, u, v = _closest_outputs(R, o.device)
    _launch("skybox_rt_closest_hit_bvh", o.device,
            _ptr(o), _ptr(d), _ptr(t_max), _ptr(blocks["tri"]),
            _ptr(blocks["s2p"]), _ptr(blocks["aabb"]),
            _ptr(blocks["leaf_range"]), _ptr(blocks["leaf_table"]),
            off, cnt, n, t_min, R, _ptr(prim), _ptr(t), _ptr(u), _ptr(v))
    return prim, t, u, v


def any_hit_bvh(orig, direction, blocks, t_max=1.0, t_min: float = T_MIN):
    """Occlusion query over the treelet blocks' leaves: (R,) bool, true
    where some triangle hits with t_min < t < t_max (a number or (R,)
    float32) inside a leaf whose box the ray enters before t_max.

    blocks: :func:`prepare_bvh_blocks` output on the rays' device, with its
    leaf table."""
    _check_rays(orig, direction)
    tmax = _per_ray_tmax(t_max, orig.shape[0], orig.device)
    if orig.device.type == "cpu":
        return any_hit_bvh_reference(orig, direction, blocks, tmax, t_min)
    o, d, off, cnt, n = _kernel_args(orig, direction, blocks)
    R = o.shape[0]
    occ = torch.empty((R,), dtype=torch.bool, device=o.device)
    _launch("skybox_rt_any_hit_bvh", o.device,
            _ptr(o), _ptr(d), _ptr(tmax), _ptr(blocks["tri"]),
            _ptr(blocks["aabb"]), _ptr(blocks["leaf_range"]),
            _ptr(blocks["leaf_table"]), off, cnt, n, t_min, R, _ptr(occ))
    return occ


def closest_hit_clustered(orig, direction, clusters, t_max=None,
                          t_min: float = T_MIN):
    """Closest hit of rays (R, 3) float32 over the scene's clusters.

    clusters: :func:`prepare_clusters` output on the rays' device.  t_max:
    None (no bound) or (R,) float32.  Returns (prim (R,) i32 in ORIGINAL ids
    [-1 = miss], t [inf on a miss], u, v [0 on a miss]); equal t resolve to
    the lowest slot (module docstring)."""
    _check_rays(orig, direction)
    if t_max is not None:
        t_max = _per_ray_tmax(t_max, orig.shape[0], orig.device)
    if orig.device.type == "cpu":
        return closest_hit_clustered_reference(orig, direction, clusters,
                                               t_max, t_min)
    _check_clusters(orig.device, clusters)
    o, d = orig.contiguous(), direction.contiguous()
    R = o.shape[0]
    prim, t, u, v = _closest_outputs(R, o.device)
    _launch("skybox_rt_closest_hit_clustered", o.device,
            _ptr(o), _ptr(d), _ptr(t_max), _ptr(clusters["tri"]),
            _ptr(clusters["table"]), _ptr(clusters["visit"]),
            _ptr(clusters["group_table"]), _ptr(clusters["group_visit"]),
            _ptr(clusters["order"]), clusters["num_clusters"],
            clusters["num_groups"], t_min, R,
            _ptr(prim), _ptr(t), _ptr(u), _ptr(v))
    return prim, t, u, v


def any_hit_clustered(orig, direction, clusters, t_max=1.0,
                      t_min: float = T_MIN):
    """Occlusion query over the scene's clusters: (R,) bool, true where some
    triangle hits with t_min < t < t_max (a number or (R,) float32)."""
    _check_rays(orig, direction)
    tmax = _per_ray_tmax(t_max, orig.shape[0], orig.device)
    if orig.device.type == "cpu":
        return any_hit_clustered_reference(orig, direction, clusters, tmax,
                                           t_min)
    _check_clusters(orig.device, clusters)
    o, d = orig.contiguous(), direction.contiguous()
    R = o.shape[0]
    occ = torch.empty((R,), dtype=torch.bool, device=o.device)
    _launch("skybox_rt_any_hit_clustered", o.device,
            _ptr(o), _ptr(d), _ptr(tmax), _ptr(clusters["tri"]),
            _ptr(clusters["table"]), _ptr(clusters["visit"]),
            _ptr(clusters["group_table"]), _ptr(clusters["group_visit"]),
            clusters["num_clusters"], clusters["num_groups"], t_min, R,
            _ptr(occ))
    return occ


def closest_hit_pallas(orig, direction, tri, t_max=None,
                       t_min: float = T_MIN):
    """Flat closest hit of rays (R, 3) float32 over all P triangles.

    tri: (P, 12) records in prim order (:func:`pack_records`) on the rays'
    device.  t_max: None or (R,) float32.  Returns (prim (R,) i32 [-1 =
    miss], t [inf on a miss], u, v [0 on a miss]); equal t resolve to the
    lowest prim id, as intersect.closest_hit_bruteforce does."""
    _check_rays(orig, direction)
    if t_max is not None:
        t_max = _per_ray_tmax(t_max, orig.shape[0], orig.device)
    if orig.device.type == "cpu":
        return closest_hit_pallas_reference(orig, direction, tri, t_max,
                                            t_min)
    P = tri.shape[0]
    _check_on_card(orig.device, "records",
                   (("tri", tri, (P, RECORD_WIDTH), torch.float32),))
    o, d = orig.contiguous(), direction.contiguous()
    R = o.shape[0]
    prim, t, u, v = _closest_outputs(R, o.device)
    _launch("skybox_rt_closest_hit_flat", o.device,
            _ptr(o), _ptr(d), _ptr(t_max), _ptr(tri), P, t_min, R,
            _ptr(prim), _ptr(t), _ptr(u), _ptr(v))
    return prim, t, u, v


def any_hit_pallas(orig, direction, tri, t_max=1.0, t_min: float = T_MIN):
    """Occlusion through the flat query: (R,) bool.  No early exit: the
    bound only narrows the hit window (t_max a number or (R,))."""
    tmax = _per_ray_tmax(t_max, orig.shape[0], orig.device)
    return closest_hit_pallas(orig, direction, tri, tmax, t_min)[0] >= 0


def closest_hit_bvh_after(orig, direction, blocks, t_lo, slot_lo, t_max=None,
                          t_min: float = T_MIN):
    """The next hit of rays (R, 3) float32 over the treelet blocks strictly
    after a per-ray carry: among the hits with t_min < t < t_max the
    lexicographic (t, slot) minimum with (t_lo, slot_lo) < (t, slot); slot is
    the triangle's record row in ``blocks``.

    t_lo (R,) float32, slot_lo (R,) int32: the previous walk's (t, slot);
    start at (-inf, -1).  A miss returns t = +inf, so feeding (t, slot)
    straight back ends the enumeration.  Repeated walks list every hit along
    a ray exactly once, equal t included.  Returns (slot, prim, t, u, v):
    slot for the carry, prim in ORIGINAL ids; slot = prim = -1, t = inf,
    u = v = 0 on a miss.

    The JAX entry takes the dict of ``bvh_worklists`` in place of the rays:
    the lists are how the TPU kernel brings blocks to a ray tile.  Here a
    ray walks the AABB pyramid itself, so the entry takes the rays."""
    _check_rays(orig, direction)
    R, dev = orig.shape[0], orig.device
    if t_max is not None:
        t_max = _per_ray_tmax(t_max, R, dev)
    if tuple(t_lo.shape) != (R,) or t_lo.dtype != torch.float32 \
            or tuple(slot_lo.shape) != (R,) or slot_lo.dtype != torch.int32:
        raise ValueError(f"the carry must be (R,) float32 and (R,) int32: got "
                         f"{tuple(t_lo.shape)} {t_lo.dtype}, "
                         f"{tuple(slot_lo.shape)} {slot_lo.dtype}")
    if dev.type == "cpu":
        return closest_hit_bvh_after_reference(orig, direction, blocks, t_lo,
                                               slot_lo, t_max, t_min)
    _check_on_card(dev, "carry", (("t_lo", t_lo, (R,), torch.float32),
                                  ("slot_lo", slot_lo, (R,), torch.int32)))
    o, d, off, cnt, n = _kernel_args(orig, direction, blocks)
    slot = torch.empty((R,), dtype=torch.int32, device=dev)
    prim, t, u, v = _closest_outputs(R, dev)
    _launch("skybox_rt_closest_hit_bvh_after", dev,
            _ptr(o), _ptr(d), _ptr(t_max), _ptr(t_lo), _ptr(slot_lo),
            _ptr(blocks["tri"]), _ptr(blocks["s2p"]), _ptr(blocks["aabb"]),
            _ptr(blocks["leaf_range"]), _ptr(blocks["leaf_table"]),
            off, cnt, n, t_min, R,
            _ptr(slot), _ptr(prim), _ptr(t), _ptr(u), _ptr(v))
    return slot, prim, t, u, v


def prepare_stream_blocks(v0, e1, e2, order=None,
                          tri_block: int = STREAM_TRI_BLOCK, device=None):
    """Pack the scene for the streamed and worklist queries (once per
    scene): the records in ``order`` (e.g. rt.bvh.build_clusters' treelet
    order, which makes consecutive rows spatially tight; None: prim order)
    cut into blocks of ``tri_block`` rows, the last one shorter, and each
    block's AABB.

    The JAX entries take v0, e1, e2 and pack them inside every call; the
    port packs once, as for its other queries.  The boxes span the rows'
    v0, v0 + e1 and v0 + e2 and are widened by one float32 step outwards,
    so that the rounding of the two sums never leaves a vertex outside."""
    device = v0.device if device is None else torch.device(device)
    if not 1 <= tri_block <= STREAM_MAX_TRI_BLOCK:
        raise ValueError(f"tri_block {tri_block} not in 1.."
                         f"{STREAM_MAX_TRI_BLOCK}")
    tri = pack_records(v0.cpu(), e1.cpu(), e2.cpu(), order=order)
    P = tri.shape[0]
    NB = -(-P // tri_block)
    pts = torch.stack([tri[:, 0:3], tri[:, 0:3] + tri[:, 3:6],
                       tri[:, 0:3] + tri[:, 6:9]], dim=1)       # (P, 3, 3)
    if NB * tri_block > P:      # fill the last block with its own last row
        pts = torch.cat([pts, pts[-1:].expand(NB * tri_block - P, 3, 3)])
    pts = pts.reshape(NB, tri_block * 3, 3)
    inf = torch.tensor(math.inf)
    aabb = torch.cat([torch.nextafter(pts.amin(dim=1), -inf),
                      torch.nextafter(pts.amax(dim=1), inf)], dim=1)
    if order is not None:
        order = torch.as_tensor(np.asarray(order, np.int32)).to(device)
    return {"tri": tri.to(device).contiguous(),               # (P, 12)
            "aabb": aabb.to(device).contiguous(),             # (NB, 6)
            "order": order,                                   # slot -> prim
            "tri_block": int(tri_block), "num_blocks": NB, "num_prims": P}


def _check_stream(dev, stream):
    P, NB = stream["num_prims"], stream["num_blocks"]
    tensors = [("tri", stream["tri"], (P, RECORD_WIDTH), torch.float32),
               ("aabb", stream["aabb"], (NB, 6), torch.float32)]
    if stream["order"] is not None:
        tensors.append(("order", stream["order"], (P,), torch.int32))
    _check_on_card(dev, "stream", tensors)
    if not 1 <= stream["tri_block"] <= STREAM_MAX_TRI_BLOCK \
            or NB != -(-P // stream["tri_block"]):
        raise ValueError(f"{NB} blocks of {stream['tri_block']} rows do not "
                         f"hold {P} records")


def closest_hit_streamed(orig, direction, stream, t_max=None,
                         t_min: float = T_MIN):
    """Closest hit of rays (R, 3) float32 by a dense sweep: every tile of
    ``STREAM_RAY_TILE`` rays meets every triangle block in ascending id, and
    a block is entered where a ray passes its AABB against the ray's running
    best t.

    stream: :func:`prepare_stream_blocks` output on the rays' device.
    t_max: None or (R,) float32.  Returns (prim (R,) i32 in ORIGINAL ids
    [-1 = miss], t [inf on a miss], u, v [0 on a miss]); equal t resolve to
    the lowest slot (module docstring)."""
    _check_rays(orig, direction)
    if t_max is not None:
        t_max = _per_ray_tmax(t_max, orig.shape[0], orig.device)
    if orig.device.type == "cpu":
        return closest_hit_streamed_reference(orig, direction, stream, t_max,
                                              t_min)
    _check_stream(orig.device, stream)
    o, d = orig.contiguous(), direction.contiguous()
    R = o.shape[0]
    prim, t, u, v = _closest_outputs(R, o.device)
    _launch("skybox_rt_closest_hit_streamed", o.device,
            _ptr(o), _ptr(d), _ptr(t_max), _ptr(stream["tri"]),
            _ptr(stream["aabb"]), _ptr(stream["order"]),
            stream["num_blocks"], stream["num_prims"], stream["tri_block"],
            t_min, R, STREAM_LANE_SWITCH, _ptr(prim), _ptr(t), _ptr(u),
            _ptr(v))
    return prim, t, u, v


def active_block_lists(orig, direction, stream, t_max=None,
                       front_to_back: bool = True):
    """The prepass of :func:`closest_hit_worklist`: for every tile of
    ``STREAM_RAY_TILE`` consecutive rays (R, 3) float32 the blocks of
    ``stream`` that some ray of the tile enters by the exact slab test
    against its fixed t_max (None: +inf, or (R,) float32), compacted to the
    front of the row, near to far by the tile's least entry distance
    (``front_to_back``; equal distances keep ascending id) or in ascending
    block id; the rest of the row in ascending id.  Returns (lists (G, NB)
    int32, counts (G,) int32), element for element those of
    :func:`active_block_lists_reference`, which CPU tensors run.  The kernel
    takes at most ``PREPASS_MAX_BLOCKS`` blocks."""
    _check_rays(orig, direction)
    R, dev = orig.shape[0], orig.device
    if t_max is not None:
        t_max = _per_ray_tmax(t_max, R, dev)
    if dev.type == "cpu":
        return active_block_lists_reference(orig, direction, stream, t_max,
                                            front_to_back)
    _check_stream(dev, stream)
    NB = stream["num_blocks"]
    if NB > PREPASS_MAX_BLOCKS:
        raise ValueError(f"the prepass kernel takes at most "
                         f"{PREPASS_MAX_BLOCKS} blocks (a tile's keys and "
                         f"list in one block's shared memory), got {NB}: "
                         f"pack the scene with a larger tri_block")
    G = -(-R // STREAM_RAY_TILE)
    o, d = orig.contiguous(), direction.contiguous()
    lists = torch.empty((G, NB), dtype=torch.int32, device=dev)
    counts = torch.empty((G,), dtype=torch.int32, device=dev)
    _launch("skybox_rt_active_block_lists", dev,
            _ptr(o), _ptr(d), _ptr(t_max), _ptr(stream["aabb"]), NB, R,
            int(front_to_back), _ptr(lists), _ptr(counts))
    return lists, counts


def closest_hit_worklist(orig, direction, stream, t_max=None,
                         t_min: float = T_MIN, front_to_back: bool = True,
                         lists=None):
    """Closest hit of rays (R, 3) float32 over per-tile lists of active
    blocks: the prepass :func:`active_block_lists` (a kernel of its own)
    finds, for
    every tile of ``STREAM_RAY_TILE`` rays, the blocks that some ray of it
    enters, near to far (``front_to_back``) or in ascending id; the kernel
    walks only that list and enters a block where a ray passes its AABB
    against the ray's running best t.

    stream, t_max and the result as for :func:`closest_hit_streamed`.
    lists: the prepass's (lists, counts) for the same rays and t_max, to
    spare it (a caller that times the kernel alone)."""
    _check_rays(orig, direction)
    R, dev = orig.shape[0], orig.device
    if t_max is not None:
        t_max = _per_ray_tmax(t_max, R, dev)
    if lists is None:
        lists = active_block_lists(orig, direction, stream, t_max,
                                   front_to_back)
    blk, cnt = lists
    if dev.type == "cpu":
        return closest_hit_worklist_reference(orig, direction, stream, blk,
                                              cnt, t_max, t_min)
    _check_stream(dev, stream)
    G, NB = -(-R // STREAM_RAY_TILE), stream["num_blocks"]
    _check_on_card(dev, "lists", (("lists", blk, (G, NB), torch.int32),
                                  ("counts", cnt, (G,), torch.int32)))
    o, d = orig.contiguous(), direction.contiguous()
    prim, t, u, v = _closest_outputs(R, dev)
    _launch("skybox_rt_closest_hit_worklist", dev,
            _ptr(o), _ptr(d), _ptr(t_max), _ptr(stream["tri"]),
            _ptr(stream["aabb"]), _ptr(stream["order"]), _ptr(blk), _ptr(cnt),
            NB, stream["num_prims"], stream["tri_block"], t_min, R,
            STREAM_LANE_SWITCH, _ptr(prim), _ptr(t), _ptr(u), _ptr(v))
    return prim, t, u, v


def _shade_arrays(scene_arrays, cfg):
    """The record table and the texture (None untextured) of
    rt.tracer.scene_shade_arrays, with the (name, tensor, shape, dtype) rows
    they must match: a (P >= 1, 21 | 27) float32 table and a (TH, TW, 4)
    float32 texture, present exactly when ``cfg.textured``."""
    rec, tex = scene_arrays["rec"], scene_arrays.get("texture")
    if (tex is not None) != cfg.textured:
        raise ValueError(f"scene_arrays {'hold' if tex is not None else 'lack'}"
                         f" a texture, the config has textured="
                         f"{cfg.textured}")
    if rec.ndim != 2 or rec.shape[0] == 0:
        raise ValueError(f"scene_arrays['rec'] is {tuple(rec.shape)}, "
                         f"expected (P >= 1, C)")
    spec = [("rec", rec, (rec.shape[0], SHADE_RECORD_WIDTH[cfg.textured]),
             torch.float32)]
    if tex is not None:
        if tex.ndim != 3 or 0 in tex.shape[:2]:
            raise ValueError(f"scene_arrays['texture'] is {tuple(tex.shape)},"
                             f" expected (TH >= 1, TW >= 1, 4)")
        spec.append(("texture", tex, (tex.shape[0], tex.shape[1], 4),
                     torch.float32))
    return rec, tex, spec


def shade_hits(scene_arrays, cfg, occluded, orig, direction, prim, t, u, v,
               bounce: int = 0):
    """Lambert + optional texture + optional shadow for a hit batch: rays
    (R, 3) float32, their closest hits prim (R,) int32 [-1 = miss] and t, u,
    v (R,) float32.  ``scene_arrays`` is rt.tracer.scene_shade_arrays' dict,
    ``cfg`` the rt.tracer.RTConfig it was built for; with ``cfg.shadows``
    the shadow query occluded(o, d, 1e8) -> (R,) bool runs in the stage
    ``rt.occlusion`` of ``bounce``.

    A CUDA tensor launches csrc/rt_shade.cu once before the query (its
    textured form where the arrays hold a texture) and takes the blocked
    rays' colour with one torch.where after it; a CPU tensor runs
    :func:`shade_hits_reference`.  Returns (rgb (R, 3), hit (R,) bool,
    hit point (R, 3), normal (R, 3)), bit for bit the same on both."""
    _check_rays(orig, direction)
    R, dev = orig.shape[0], orig.device
    rec, tex, arrays = _shade_arrays(scene_arrays, cfg)
    _check_tensors(dev, "hits", [
        ("prim", prim, (R,), torch.int32), ("t", t, (R,), torch.float32),
        ("u", u, (R,), torch.float32), ("v", v, (R,), torch.float32)])
    if dev.type == "cpu":
        _check_tensors(dev, "scene_arrays", arrays)
        return shade_hits_reference(scene_arrays, cfg, occluded, orig,
                                    direction, prim, t, u, v, bounce)
    _check_on_card(dev, "scene_arrays", arrays)
    o, d = orig.contiguous(), direction.contiguous()
    prim, t, u, v = (x.contiguous() for x in (prim, t, u, v))
    pt, n, rgb = (torch.empty((R, 3), dtype=torch.float32, device=dev)
                  for _ in range(3))
    hit = torch.empty((R,), dtype=torch.bool, device=dev)
    dark = sh_o = sh_d = None
    if cfg.shadows:
        dark, sh_o, sh_d = (torch.empty((R, 3), dtype=torch.float32,
                                        device=dev) for _ in range(3))
    th, tw = (tex.shape[0], tex.shape[1]) if tex is not None else (0, 0)
    _launch("skybox_rt_shade_hits", dev,
            _ptr(o), _ptr(d), _ptr(prim), _ptr(t), _ptr(u), _ptr(v),
            _ptr(rec), _ptr(tex), rec.shape[1], th, tw, cfg.ambient,
            *cfg.light_dir, *cfg.light_color, *intersect.PARK_O,
            SHADOW_OFFSET, R, _ptr(pt), _ptr(n), _ptr(hit), _ptr(rgb),
            _ptr(dark), _ptr(sh_o), _ptr(sh_d))
    if cfg.shadows:
        with stage("rt.occlusion", stream=True, bounce=bounce, width=R):
            blocked = occluded(sh_o, sh_d, 1e8)
        rgb = torch.where(blocked[:, None], dark, rgb)
    return rgb, hit, pt, n


def shade_hits_reference(scene_arrays, cfg, occluded, o, d, prim, t, u, v,
                         bounce: int = 0):
    """The plain torch twin of :func:`shade_hits`: the kernel's arithmetic
    in the same order.  The CPU route, and what the card's tests and
    chip_smoke.py hold the kernel to."""
    dev = o.device
    hit = prim >= 0
    pt = o + d * torch.where(hit, t, torch.zeros_like(t))[..., None]
    # ONE packed record row per hit instead of six per-corner vertex
    # gathers (normals + colors [+ uvs] x 3 corners)
    r = scene_arrays["rec"][prim.clamp(min=0).long()]      # (R, 21 | 27)
    R = r.shape[0]
    n = intersect._interp3(r[:, 0:9].reshape(R, 3, 3), u, v)
    n = n / intersect._norm3(n).clamp(min=1e-20)
    # two-sided shading: flip normal against the incoming ray
    n = torch.where(intersect._dot3(n, d) > 0, -n, n)

    albedo = intersect._interp3(r[:, 9:21].reshape(R, 3, 4), u, v)[..., :3]
    if cfg.textured:
        uv = intersect._interp3(r[:, 21:27].reshape(R, 3, 2), u, v)
        texel = sample_texture_bilinear(scene_arrays["texture"],
                                        uv[..., 0], uv[..., 1])
        albedo = albedo * texel[..., :3]

    ldir = intersect._vec(cfg.light_dir, dev)
    ldir = ldir / intersect._norm3(ldir)
    ndotl = intersect._dot3(n, ldir)[..., 0].clamp(min=0.0)

    if cfg.shadows:
        # park shadow rays of non-hit pixels AND of terminator points
        # (ndotl <= 0: occlusion cannot change their shading — the Lambert
        # clamp already zeroed them).  Parked rays leave the hierarchy at
        # its top level.
        need = hit & (ndotl > 0.0)
        sh_o = torch.where(need[..., None], pt + n * SHADOW_OFFSET,
                           intersect._vec(intersect.PARK_O, dev))
        sh_d = torch.broadcast_to(ldir, sh_o.shape).contiguous()
        with stage("rt.occlusion", stream=True, bounce=bounce,
                   width=sh_o.shape[0]):
            blocked = occluded(sh_o, sh_d, 1e8)
        ndotl = torch.where(blocked, torch.zeros_like(ndotl), ndotl)

    lc = intersect._vec(cfg.light_color, dev)
    rgb = albedo * (cfg.ambient + ndotl[..., None] * lc)
    return rgb, hit, pt, n
