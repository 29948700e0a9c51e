"""Ray queries: the CUDA kernels and their plain torch versions.

Counterpart of skybox_rt_tpu.ops.pallas_rt.  Eight kernels replace Pallas TPU
kernels of that module; each source says how a ray walks its structure and
what bounds it:

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
make the same per-ray decisions: every ray takes the row of the (8, C) visit
table for its own direction octant (near to far), with the same far bound.
They test the same triangles against the same running best, and agree bit
for bit.  The any-hit queries cull against the fixed t_max, so their answer
does not depend on the order.

Records are the port's own layout: ``(rows, 12)`` float32 [v0 e1 e2 | 3 of
padding], three float4 a row.  BVH blocks hold ``C * tri_block`` rows; rows
past a block's ``bcnt[b]`` triangles are zero and never read.  Clusters hold
the P triangles in treelet order, the flat query in prim order, the streamed
and worklist queries in the caller's ``order``, cut into blocks of
``tri_block`` rows with the last one shorter.
"""
from __future__ import annotations

import collections
import ctypes
import math

import numpy as np
import torch

from ..rt import intersect

T_MIN = 1e-4
#: deepest AABB pyramid the kernel's per-thread stack is sized for
#: (csrc/rt_bvh.cu MAX_LEVELS); 64 * 8**7 blocks
MAX_LEVELS = 8
#: most entries a pyramid level may have (24 index bits of a stack entry)
MAX_LEVEL_ENTRIES = 1 << 24
RECORD_WIDTH = 12
#: rays of one tile of the streamed and worklist queries: one thread block
#: (csrc/rt_streamed.cu RAY_TILE), and the unit of the worklist's prepass
STREAM_RAY_TILE = 128
#: triangles of one block of those queries, staged through shared memory
#: together; at most csrc/rt_streamed.cu MAX_TRI_BLOCK
STREAM_TRI_BLOCK = 64
STREAM_MAX_TRI_BLOCK = 256
#: most (ray, block) pairs one chunk of the worklist's prepass may hold
PREPASS_PAIRS = 1 << 24

#: Kernel launches since the last reset, keyed by kernel (closest_hit_bvh,
#: any_hit_bvh, closest_hit_bvh_after, closest_hit_clustered,
#: any_hit_clustered, closest_hit_flat, closest_hit_streamed,
#: closest_hit_worklist; a kernel not launched reads 0): a run reads them to show that its main
#: path went through the kernels.  Only :func:`_launch` adds to them.
launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def pack_blocks(rows9, bcnt, s2p, levels, tri_block, num_prims, device):
    """The dict the queries take, from numpy arrays: rows9 (C*TB, 9)
    records in slot order, bcnt (C,), s2p (C*TB,), levels [(C_l, 6)]."""
    device = torch.device(device)
    num_blocks = int(bcnt.shape[0])
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"AABB pyramid has {len(levels)} levels, the "
                         f"kernel's stack holds {MAX_LEVELS}")
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
    return {
        "tri": tri.to(device),                            # (C*TB, 12)
        "bcnt": torch.as_tensor(bcnt, dtype=torch.int32).to(device),
        "s2p": torch.as_tensor(s2p, dtype=torch.int32).to(device),
        "aabb": aabb,                                     # (sum C_l, 6)
        "levels": [aabb[o:o + c] for o, c in zip(offsets, counts)],
        "level_offsets": tuple(offsets),
        "level_counts": tuple(counts),
        "tri_block": int(tri_block),
        "num_blocks": num_blocks,
        "num_prims": int(num_prims),
    }


def prepare_bvh_blocks(v0, e1, e2, block_set, device=None):
    """Pack triangle records into the block-slot layout (once per scene).

    v0, e1, e2: (P, 3) float32 tensors (rt.intersect.triangle_arrays);
    block_set: rt.bvh.build_block_set output.  The blocks land on ``device``
    (default: where v0 lies)."""
    device = v0.device if device is None else torch.device(device)
    s2p = torch.as_tensor(block_set["slot_to_prim"]).long()
    tri9 = torch.cat([v0, e1, e2], dim=1).cpu()             # (P, 9)
    P = tri9.shape[0]
    rows = torch.where((s2p >= 0)[:, None], tri9[s2p.clamp(0, P - 1)],
                       torch.zeros((), dtype=tri9.dtype))
    return pack_blocks(rows.numpy(), block_set["bcnt"],
                       block_set["slot_to_prim"], block_set["aabb_levels"],
                       block_set["tri_block"], P, device)


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


def pack_clusters(tri, aabb, first, count, order, device):
    """The dict the clustered queries take: tri (P, 12) records in treelet
    order (a tensor), and numpy aabb (C, >= 6), first (C,), count (C,),
    order (P,) of rt.bvh.build_clusters."""
    device = torch.device(device)
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
    return {
        "tri": tri.to(device=device, dtype=torch.float32).contiguous(),
        "table": torch.from_numpy(table).to(device),          # (C, 8)
        "visit": torch.from_numpy(octant_visit_table(aabb)).to(device),
        "order": torch.from_numpy(order).to(device),          # slot -> prim
        "num_clusters": C,
        "num_prims": P,
    }


def prepare_clusters(v0, e1, e2, clusters, device=None):
    """Pack the scene for the clustered queries (once per scene): records in
    treelet order, the cluster table and the octant visit table.

    v0, e1, e2: (P, 3) float32 tensors (rt.intersect.triangle_arrays);
    clusters: rt.bvh.build_clusters output.  Lands on ``device`` (default:
    where v0 lies)."""
    device = v0.device if device is None else torch.device(device)
    tri = pack_records(v0.cpu(), e1.cpu(), e2.cpu(), order=clusters["order"])
    return pack_clusters(tri, clusters["aabb"], clusters["first"],
                         clusters["count"], clusters["order"], device)


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


def _closest_over(tri, boxes, o, d, inv, tmax0, t_min, stats, after=None):
    """The running lexicographic (t, slot) minimum of rays (o, d, inv:
    component tuples; tmax0 (r,)) over ``boxes``, an iterable of (AABB row,
    first record row, n) met in that order: per box the slab gate against
    each ray's running best t, then the (rays that pass x n triangles)
    Möller–Trumbore batch.  With ``after`` = (t_lo (r,) float32, slot_lo (r,)
    int64) only hits with (t_lo, slot_lo) < (t, slot) in lexicographic order
    count.  Returns (best_t, best_slot [-1 = none], u, v)."""
    R = tmax0.shape[0]
    dev = tmax0.device
    best = _new_best(tmax0)
    for box, first, n in boxes:
        idx_all = torch.nonzero(_slab_pass(box, o, inv, best[0]))[:, 0]
        _count(stats, slab_tests=R, slab_pass=idx_all.numel(),
               tri_tests=idx_all.numel() * n)
        if n == 0:
            continue
        slots = first + torch.arange(n, device=dev)[None, :]
        for idx in _idx_chunks(idx_all, n):
            ok, t, u, v = _range_tests(tri, first, n, o, d, idx, t_min)
            hit = ok & (t < tmax0[idx][:, None])
            if after is not None:
                t_lo = after[0][idx][:, None]
                hit = hit & ((t > t_lo) | ((t == t_lo)
                                           & (slots > after[1][idx][:, None])))
            _merge_best(best, idx, hit, t, u, v, slots)
    return best


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


def _block_boxes(blocks, block_order):
    TB = blocks["tri_block"]
    counts = blocks["bcnt"].tolist()
    level0 = blocks["levels"][0]
    order = range(blocks["num_blocks"]) if block_order is None else block_order
    return ((level0[b], b * TB, counts[b]) for b in order)


def closest_hit_bvh_reference(orig, direction, blocks, t_max=None,
                              t_min: float = T_MIN, block_order=None,
                              stats=None):
    """Plain torch closest hit over the blocks, on any device: what
    :func:`closest_hit_bvh` returns.

    Loops over level-0 blocks (ascending, or ``block_order``) with
    :func:`_closest_over`.  ``stats``, a dict, gains ``slab_tests``,
    ``slab_pass`` and ``tri_tests`` (counts of this call's ray-box tests, of
    those that passed, and of its ray-triangle tests)."""
    o, d, inv = _components(orig, direction)
    tmax0 = _per_ray_tmax(math.inf if t_max is None else t_max,
                          orig.shape[0], orig.device)
    best = _closest_over(blocks["tri"], _block_boxes(blocks, block_order),
                         o, d, inv, tmax0, t_min, stats)
    return _closest_result(*best, blocks["s2p"])


def any_hit_bvh_reference(orig, direction, blocks, t_max=1.0,
                          t_min: float = T_MIN, block_order=None, stats=None):
    """Plain torch occlusion query over the blocks, on any device: whether
    any triangle hits with t_min < t < t_max (a number or (R,))."""
    o, d, inv = _components(orig, direction)
    tmax = _per_ray_tmax(t_max, orig.shape[0], orig.device)
    return _any_over(blocks["tri"], _block_boxes(blocks, block_order),
                     o, d, inv, tmax, t_min, stats)


def closest_hit_bvh_after_reference(orig, direction, blocks, t_lo, slot_lo,
                                    t_max=None, t_min: float = T_MIN,
                                    block_order=None, stats=None):
    """Plain torch next hit after the carry, on any device: what
    :func:`closest_hit_bvh_after` returns.  The loop of
    :func:`closest_hit_bvh_reference` (level-0 blocks ascending, or
    ``block_order``; the slab gate's far bound is the running best t and
    admits equality) with the lower window (t_lo, slot_lo) < (t, slot)."""
    o, d, inv = _components(orig, direction)
    tmax0 = _per_ray_tmax(math.inf if t_max is None else t_max,
                          orig.shape[0], orig.device)
    best = _closest_over(blocks["tri"], _block_boxes(blocks, block_order),
                         o, d, inv, tmax0, t_min, stats,
                         after=(t_lo, slot_lo.long()))
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
    best t, then the block's triangles for the rays that pass."""
    o, d, inv = _components(orig, direction)
    tmax0 = _per_ray_tmax(math.inf if t_max is None else t_max,
                          orig.shape[0], orig.device)
    best = _closest_over(stream["tri"], _stream_boxes(stream), o, d, inv,
                         tmax0, t_min, stats)
    return _closest_result(*best, _stream_prim(stream))


def active_block_lists(orig, direction, stream, t_max=None,
                       front_to_back: bool = True):
    """The prepass of :func:`closest_hit_worklist`, plain torch on any
    device (pallas_rt._active_block_lists): for every tile of
    ``STREAM_RAY_TILE`` consecutive rays the blocks that some ray of the tile
    enters by the exact slab test against its fixed t_max, compacted to the
    front of the row, near to far by the tile's least entry distance
    (``front_to_back``; equal distances keep ascending id) or in ascending
    block id.  Returns (lists (G, NB) int32, counts (G,) int32); a row's
    entries past its count are the inactive blocks and are never read."""
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
    that block's triangles: the kernel's per-ray order."""
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
        _count(stats, slab_tests=enter.numel(), slab_pass=rays.numel(),
               tri_tests=(P - blk * TB).clamp(max=TB).sum())
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
    """For each direction octant that holds rays: (ray indices, the
    clusters' (AABB row, first, count) in that octant's visit order)."""
    table = clusters["table"]
    ranges = table[:, 6:8].contiguous().view(torch.int32).tolist()
    visit = clusters["visit"].tolist()
    octant = ((d[0] > 0).long() | ((d[1] > 0).long() << 1)
              | ((d[2] > 0).long() << 2))
    for q in range(8):
        rays = torch.nonzero(octant == q)[:, 0]
        if rays.numel():
            yield rays, [(table[c], *ranges[c]) for c in visit[q]]


def closest_hit_clustered_reference(orig, direction, clusters, t_max=None,
                                    t_min: float = T_MIN, stats=None):
    """Plain torch clustered closest hit, on any device: what
    :func:`closest_hit_clustered` returns.  The rays of one direction octant
    go through that octant's row of the visit table together
    (:func:`_closest_over`); ``stats`` as in
    :func:`closest_hit_bvh_reference`."""
    R = orig.shape[0]
    dev = orig.device
    o, d, inv = _components(orig, direction)
    tmax0 = _per_ray_tmax(math.inf if t_max is None else t_max, R, dev)
    best = _new_best(tmax0)
    for rays, boxes in _octant_groups(clusters, d):
        got = _closest_over(clusters["tri"], boxes, _take(o, rays),
                            _take(d, rays), _take(inv, rays), tmax0[rays],
                            t_min, stats)
        for whole, part in zip(best, got):
            whole[rays] = part
    return _closest_result(*best, clusters["order"])


def any_hit_clustered_reference(orig, direction, clusters, t_max=1.0,
                                t_min: float = T_MIN, stats=None):
    """Plain torch clustered occlusion query, on any device: what
    :func:`any_hit_clustered` returns, in the kernel's per-ray visit order
    (the answer does not depend on it; the counts in ``stats`` do)."""
    R = orig.shape[0]
    o, d, inv = _components(orig, direction)
    tmax = _per_ray_tmax(t_max, R, orig.device)
    occ = torch.zeros((R,), dtype=torch.bool, device=orig.device)
    for rays, boxes in _octant_groups(clusters, d):
        occ[rays] = _any_over(clusters["tri"], boxes, _take(o, rays),
                              _take(d, rays), _take(inv, rays), tmax[rays],
                              t_min, stats)
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
    for name, t, shape, dtype in tensors:
        if t.device != dev:
            raise ValueError(f"{what}[{name!r}] is on {t.device}, the rays "
                             f"on {dev}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{what}[{name!r}] is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}[{name!r}] must be contiguous")


def _kernel_args(orig, direction, blocks):
    slots = blocks["num_blocks"] * blocks["tri_block"]
    _check_on_card(orig.device, "blocks", (
        ("tri", blocks["tri"], (slots, RECORD_WIDTH), torch.float32),
        ("bcnt", blocks["bcnt"], (blocks["num_blocks"],), torch.int32),
        ("s2p", blocks["s2p"], (slots,), torch.int32),
        ("aabb", blocks["aabb"], (sum(blocks["level_counts"]), 6),
         torch.float32)))
    n = len(blocks["level_offsets"])
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"AABB pyramid has {n} levels, the kernel's stack "
                         f"holds {MAX_LEVELS}")
    arr = ctypes.c_int * n
    return (orig.contiguous(), direction.contiguous(),
            arr(*blocks["level_offsets"]), arr(*blocks["level_counts"]), n)


def _check_clusters(dev, clusters):
    C, P = clusters["num_clusters"], clusters["num_prims"]
    _check_on_card(dev, "clusters", (
        ("tri", clusters["tri"], (P, RECORD_WIDTH), torch.float32),
        ("table", clusters["table"], (C, 8), torch.float32),
        ("visit", clusters["visit"], (8, C), torch.int32),
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
            _ptr(blocks["bcnt"]), _ptr(blocks["s2p"]),
            _ptr(blocks["aabb"]), off, cnt, n, blocks["tri_block"],
            t_min, R, _ptr(prim), _ptr(t), _ptr(u), _ptr(v))
    return prim, t, u, v


def any_hit_bvh(orig, direction, blocks, t_max=1.0, t_min: float = T_MIN):
    """Occlusion query: (R,) bool, true where some triangle hits with
    t_min < t < t_max (a number or (R,) float32)."""
    _check_rays(orig, direction)
    tmax = _per_ray_tmax(t_max, orig.shape[0], orig.device)
    if orig.device.type == "cpu":
        return any_hit_bvh_reference(orig, direction, blocks, tmax, t_min)
    o, d, off, cnt, n = _kernel_args(orig, direction, blocks)
    R = o.shape[0]
    occ = torch.empty((R,), dtype=torch.bool, device=o.device)
    _launch("skybox_rt_any_hit_bvh", o.device,
            _ptr(o), _ptr(d), _ptr(tmax), _ptr(blocks["tri"]),
            _ptr(blocks["bcnt"]), _ptr(blocks["aabb"]), off, cnt, n,
            blocks["tri_block"], t_min, R, _ptr(occ))
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
            _ptr(clusters["order"]), clusters["num_clusters"], t_min, R,
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
            clusters["num_clusters"], t_min, R, _ptr(occ))
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
            _ptr(blocks["tri"]), _ptr(blocks["bcnt"]), _ptr(blocks["s2p"]),
            _ptr(blocks["aabb"]), off, cnt, n, blocks["tri_block"], t_min, R,
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
            t_min, R, _ptr(prim), _ptr(t), _ptr(u), _ptr(v))
    return prim, t, u, v


def closest_hit_worklist(orig, direction, stream, t_max=None,
                         t_min: float = T_MIN, front_to_back: bool = True,
                         lists=None):
    """Closest hit of rays (R, 3) float32 over per-tile lists of active
    blocks: the prepass :func:`active_block_lists` (plain torch) finds, for
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
            _ptr(prim), _ptr(t), _ptr(u), _ptr(v))
    return prim, t, u, v
