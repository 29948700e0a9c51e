"""BVH construction (host) + lockstep traversal (device).

Counterpart of skybox_rt_tpu.rt.bvh.  The build functions are host numpy, copied
as is (same node order, same prim_order, same treelet cuts, so a scene cuts into
the same blocks in both packages); only :meth:`BVH.as_device_arrays` and
:meth:`BVH.as_stackless_arrays` make torch tensors, on an explicit device.
Node layout is a flat struct-of-arrays:

  node_min/max (N, 3) f32   AABB
  node_left    (N,)   i32   left child   (internal nodes)
  node_right   (N,)   i32   right child
  node_first   (N,)   i32   first index into prim_order (leaves)
  node_count   (N,)   i32   prim count (0 => internal)
  prim_order   (P,)   i32   triangle permutation so leaf prims are contiguous

Two traversals, both plain torch: the stackless lockstep walk (engine
"bvh"), a second oracle that scales past brute force, and the per-ray-stack
:func:`closest_hit` / :func:`any_hit` that rt.diff's discrete hit selection
runs on (a vmapped while-loop in the JAX module; here all rays that still
hold a node advance together, one pop a pass).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import intersect

LEAF_SIZE = 4
STACK_DEPTH = 64


@dataclasses.dataclass
class BVH:
    node_min: np.ndarray
    node_max: np.ndarray
    node_left: np.ndarray
    node_right: np.ndarray
    node_first: np.ndarray
    node_count: np.ndarray
    prim_order: np.ndarray
    # leaf capacity this tree was built with — traversals MUST test this
    # many prims per leaf (pass bvh.leaf_size, not the module default)
    leaf_size: int = LEAF_SIZE
    # preorder + escape-link layout for the stackless lockstep traversal
    # (computed lazily): node i's first child is i+1; `escape[i]` is the
    # preorder index to jump to when i's subtree is done (N = exit)
    pre_min: np.ndarray = None
    pre_max: np.ndarray = None
    pre_first: np.ndarray = None
    pre_count: np.ndarray = None
    pre_escape: np.ndarray = None

    @property
    def num_nodes(self):
        return self.node_min.shape[0]

    def as_device_arrays(self, device):
        return tuple(torch.as_tensor(a, device=device) for a in (
            self.node_min, self.node_max, self.node_left, self.node_right,
            self.node_first, self.node_count, self.prim_order))

    def build_preorder(self):
        """Re-layout nodes in preorder with escape links (host, once)."""
        if self.pre_escape is not None:
            return self
        N = self.num_nodes
        sizes = np.ones(N, np.int64)
        # postorder subtree sizes (children were appended after parents in
        # build(), so a reverse index sweep sees children before parents)
        internal = self.node_count == 0
        for i in range(N - 1, -1, -1):
            if internal[i]:
                sizes[i] = 1 + sizes[self.node_left[i]] \
                             + sizes[self.node_right[i]]
        perm = np.empty(N, np.int64)        # preorder position -> old index
        escape = np.empty(N, np.int32)
        stack = [(0, N)]
        pos = 0
        while stack:
            old, esc = stack.pop()
            perm[pos] = old
            escape[pos] = esc
            if internal[old]:
                l, r = self.node_left[old], self.node_right[old]
                right_pos = pos + 1 + sizes[l]
                stack.append((r, esc))          # popped after left subtree
                stack.append((l, right_pos))    # left is next (pos + 1)
            pos += 1
        self.pre_min = self.node_min[perm]
        self.pre_max = self.node_max[perm]
        self.pre_first = self.node_first[perm]
        self.pre_count = self.node_count[perm]
        self.pre_escape = escape
        return self

    def as_stackless_arrays(self, device):
        self.build_preorder()
        return tuple(torch.as_tensor(a, device=device) for a in (
            self.pre_min, self.pre_max, self.pre_first, self.pre_count,
            self.pre_escape, self.prim_order))


class _NodeArrays:
    """Shared node-array bookkeeping for the top-down build functions.

    All of them emit the same flat layout (and keep each subtree's prims
    contiguous in prim_order, which build_clusters and build_block_set rely
    on); they differ only in how a range is partitioned.
    """

    def __init__(self, verts, faces):
        verts = np.asarray(verts, np.float32)
        faces = np.asarray(faces, np.int64)
        self.P = faces.shape[0]
        tri = verts[faces]                  # (P, 3, 3)
        self.tmin = tri.min(1)
        self.tmax = tri.max(1)
        self.cent = tri.mean(1)
        self.order = np.arange(self.P)
        self.node_min, self.node_max = [], []
        self.node_left, self.node_right = [], []
        self.node_first, self.node_count = [], []

    def new_node(self):
        self.node_min.append(None)
        self.node_max.append(None)
        self.node_left.append(-1)
        self.node_right.append(-1)
        self.node_first.append(0)
        self.node_count.append(0)
        return len(self.node_min) - 1

    def set_bounds(self, ni, ids):
        self.node_min[ni] = self.tmin[ids].min(0)
        self.node_max[ni] = self.tmax[ids].max(0)

    def make_leaf(self, ni, lo, hi):
        self.node_first[ni] = lo
        self.node_count[ni] = hi - lo

    def split_node(self, ni):
        li = self.new_node()
        ri = self.new_node()
        self.node_left[ni] = li
        self.node_right[ni] = ri
        return li, ri

    def finish(self, leaf_size):
        return BVH(
            node_min=np.asarray(self.node_min, np.float32),
            node_max=np.asarray(self.node_max, np.float32),
            node_left=np.asarray(self.node_left, np.int32),
            node_right=np.asarray(self.node_right, np.int32),
            node_first=np.asarray(self.node_first, np.int32),
            node_count=np.asarray(self.node_count, np.int32),
            prim_order=self.order.astype(np.int32),
            leaf_size=leaf_size,
        )


def build(verts: np.ndarray, faces: np.ndarray,
          leaf_size: int = LEAF_SIZE, method: str = "median") -> BVH:
    """Build a BVH. method: 'median' (centroid median split),
    'sah' (binned surface-area heuristic), 'lbvh' (Morton radix split)."""
    if method == "median":
        return build_median(verts, faces, leaf_size)
    if method == "sah":
        return build_sah(verts, faces, leaf_size)
    if method == "lbvh":
        return build_lbvh(verts, faces, leaf_size)
    raise ValueError(f"unknown BVH build method {method!r}")


def build_median(verts: np.ndarray, faces: np.ndarray,
                 leaf_size: int = LEAF_SIZE) -> BVH:
    """Median-split BVH over triangle centroids."""
    b = _NodeArrays(verts, faces)
    root = b.new_node()
    work = [(root, 0, b.P)]
    while work:
        ni, lo, hi = work.pop()
        ids = b.order[lo:hi]
        b.set_bounds(ni, ids)
        n = hi - lo
        if n <= leaf_size:
            b.make_leaf(ni, lo, hi)
            continue
        ext = b.cent[ids].max(0) - b.cent[ids].min(0)
        axis = int(ext.argmax())
        part = np.argsort(b.cent[ids, axis], kind="stable")
        b.order[lo:hi] = ids[part]
        mid = lo + n // 2
        li, ri = b.split_node(ni)
        work.append((li, lo, mid))
        work.append((ri, mid, hi))
    return b.finish(leaf_size)


def _half_area(bmin, bmax):
    """Half surface area of AABBs; 0 for empty (inverted) boxes."""
    e = np.maximum(bmax - bmin, 0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] \
        + e[..., 2] * e[..., 0]


def build_sah(verts: np.ndarray, faces: np.ndarray,
              leaf_size: int = LEAF_SIZE, num_bins: int = 16) -> BVH:
    """Binned surface-area-heuristic BVH (host numpy, top-down).

    Per node, centroids are scattered into `num_bins` bins along each
    axis; prefix/suffix AABB sweeps give the SAH cost
    area_L*n_L + area_R*n_R for every bin boundary, and the cheapest
    (axis, boundary) partitions the range.  Falls back to a median split
    when every centroid lands in one bin.  Same flat layout/contiguity
    guarantees as build_median, so every traversal and the treelet
    cluster cut work unchanged; typically 1.5-3x fewer ray-box/ray-tri
    tests than median split on irregular geometry.
    """
    b = _NodeArrays(verts, faces)
    root = b.new_node()
    work = [(root, 0, b.P)]
    while work:
        ni, lo, hi = work.pop()
        ids = b.order[lo:hi]
        b.set_bounds(ni, ids)
        n = hi - lo
        if n <= leaf_size:
            b.make_leaf(ni, lo, hi)
            continue

        c = b.cent[ids]
        cmin = c.min(0)
        ext = c.max(0) - cmin
        best_cost = np.inf
        best_part = None
        for axis in range(3):
            if ext[axis] <= 1e-12:
                continue
            scale = num_bins * (1.0 - 1e-6) / ext[axis]
            bins = ((c[:, axis] - cmin[axis]) * scale).astype(np.int64)
            counts = np.bincount(bins, minlength=num_bins)
            bbmin = np.full((num_bins, 3), np.inf, np.float32)
            bbmax = np.full((num_bins, 3), -np.inf, np.float32)
            np.minimum.at(bbmin, bins, b.tmin[ids])
            np.maximum.at(bbmax, bins, b.tmax[ids])
            # prefix (left) and suffix (right) sweeps over bin boundaries
            lmin = np.minimum.accumulate(bbmin, 0)
            lmax = np.maximum.accumulate(bbmax, 0)
            rmin = np.minimum.accumulate(bbmin[::-1], 0)[::-1]
            rmax = np.maximum.accumulate(bbmax[::-1], 0)[::-1]
            ncum = np.cumsum(counts)
            n_l = ncum[:-1]                       # prims left of boundary i+1
            n_r = n - n_l
            cost = np.where(n_l > 0, _half_area(lmin, lmax)[:-1] * n_l, 0.0) \
                + np.where(n_r > 0, _half_area(rmin, rmax)[1:] * n_r, 0.0)
            cost = np.where((n_l == 0) | (n_r == 0), np.inf, cost)
            k = int(np.argmin(cost))
            if cost[k] < best_cost:
                best_cost = cost[k]
                best_part = bins <= k
        if best_part is None or not (0 < best_part.sum() < n):
            # degenerate centroids: median split keeps the tree balanced
            axis = int(ext.argmax())
            part = np.argsort(c[:, axis], kind="stable")
            b.order[lo:hi] = ids[part]
            mid = lo + n // 2
        else:
            b.order[lo:hi] = np.concatenate(
                [ids[best_part], ids[~best_part]])
            mid = lo + int(best_part.sum())
        li, ri = b.split_node(ni)
        work.append((li, lo, mid))
        work.append((ri, mid, hi))
    return b.finish(leaf_size)


def morton_codes(cent: np.ndarray, bits: int = 10) -> np.ndarray:
    """30-bit Morton codes of points quantized to a 2^bits grid (vectorized)."""
    cent = np.asarray(cent, np.float64)
    lo = cent.min(0)
    ext = np.maximum(cent.max(0) - lo, 1e-30)
    q = np.minimum(((cent - lo) / ext * (1 << bits)).astype(np.uint64),
                   (1 << bits) - 1)

    def part1by2(x):
        x &= np.uint64(0x3FF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x30000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x9249249)
        return x

    return (part1by2(q[:, 0]) << np.uint64(2)) \
        | (part1by2(q[:, 1]) << np.uint64(1)) | part1by2(q[:, 2])


def build_lbvh(verts: np.ndarray, faces: np.ndarray,
               leaf_size: int = LEAF_SIZE, bits: int = 10) -> BVH:
    """Linear BVH: Morton-sort centroids, then split each range at its
    highest differing Morton bit (the radix/Karras-style hierarchy).

    The sort is the only O(P log P) step; each split is a binary search
    (the bit column is monotonic within a sorted range whose higher bits
    agree).  Build is near-linear and order-deterministic — the host-side
    analog of a GPU LBVH, and the natural build for animated geometry
    where per-frame rebuild cost dominates traversal quality.
    """
    b = _NodeArrays(verts, faces)
    codes = morton_codes(b.cent, bits)
    perm = np.argsort(codes, kind="stable")
    b.order = b.order[perm]
    codes = codes[perm]

    root = b.new_node()
    work = [(root, 0, b.P, 3 * bits - 1)]
    while work:
        ni, lo, hi, bit = work.pop()
        ids = b.order[lo:hi]
        b.set_bounds(ni, ids)
        n = hi - lo
        if n <= leaf_size:
            b.make_leaf(ni, lo, hi)
            continue
        # find the highest bit that actually splits this range
        mid = lo
        while bit >= 0:
            col = (codes[lo:hi] >> np.uint64(bit)) & np.uint64(1)
            mid = lo + int(np.searchsorted(col, 1))
            if lo < mid < hi:
                break
            bit -= 1
        if not (lo < mid < hi):
            # all codes equal: median split on the longest axis
            axis = int((b.cent[ids].max(0) - b.cent[ids].min(0)).argmax())
            part = np.argsort(b.cent[ids, axis], kind="stable")
            b.order[lo:hi] = ids[part]
            codes[lo:hi] = codes[lo:hi][part]
            mid = lo + n // 2
        li, ri = b.split_node(ni)
        work.append((li, lo, mid, bit - 1))
        work.append((ri, mid, hi, bit - 1))
    return b.finish(leaf_size)


def build_clusters(bvh: BVH, max_tris: int = 64):
    """Cut the BVH into treelets of <= max_tris contiguous primitives.

    Because build() stores leaf prims contiguously in prim_order, any
    subtree covers a contiguous [first, first+count) range — a treelet is
    just that range plus its AABB, so a traversal tests the treelet AABB
    once and skips the whole triangle range on a miss.

    Returns dict(aabb (C, 8) f32 [min.xyz max.xyz 0 0], first (C,) i32,
    count (C,) i32, order (P,) i32 = prim_order).
    """
    aabbs, firsts, counts = [], [], []

    # subtree (first, count) for every node in ONE reverse sweep:
    # build() appends children after parents, so a reverse index sweep
    # sees both children before their parent (no recursion — the naive
    # per-node recursion is quadratic and took minutes at 1M prims)
    N = bvh.num_nodes
    sub_first = bvh.node_first.astype(np.int64).copy()
    sub_count = bvh.node_count.astype(np.int64).copy()
    internal = bvh.node_count == 0
    for i in range(N - 1, -1, -1):
        if internal[i]:
            l, r = bvh.node_left[i], bvh.node_right[i]
            lo = min(sub_first[l], sub_first[r])
            c = sub_count[l] + sub_count[r]
            assert max(sub_first[l] + sub_count[l],
                       sub_first[r] + sub_count[r]) - lo == c, \
                "non-contiguous"
            sub_first[i] = lo
            sub_count[i] = c

    def subtree_range(ni):
        return int(sub_first[ni]), int(sub_count[ni])

    stack = [0]
    while stack:
        ni = stack.pop()
        f, c = subtree_range(ni)
        if c <= max_tris or bvh.node_count[ni] > 0:
            aabbs.append(np.concatenate([
                bvh.node_min[ni], bvh.node_max[ni],
                np.zeros(2, np.float32)]))
            firsts.append(f)
            counts.append(c)
        else:
            stack.append(bvh.node_right[ni])
            stack.append(bvh.node_left[ni])
    return {
        "aabb": np.asarray(aabbs, np.float32),
        "first": np.asarray(firsts, np.int32),
        "count": np.asarray(counts, np.int32),
        "order": bvh.prim_order.astype(np.int32),
    }


def build_block_set(bvh: BVH, tri_block: int = 256, top_size: int = 64):
    """Cut the BVH into fixed-slot triangle blocks + a group-AABB pyramid.

    The BVH kernels (ops.cuda_rt.closest_hit_bvh / any_hit_bvh) read
    triangle records in blocks of `tri_block` slots.  This function makes
    those blocks BVH treelets (build_clusters at tri_block granularity), so
    every block has the TIGHT AABB of a real subtree.

    On top of the blocks sits a pyramid of group AABBs: level l+1 group g
    covers level-l entries 8g..8g+7 (blocks follow treelet order, so
    consecutive blocks are spatially coherent).  Levels stop once a level
    has <= top_size groups.  A ray walks the pyramid from the top level
    down as an implicit 8-ary hierarchy.

    Returns dict:
      aabb_levels  [np (C_l, 6) f32]  level-0 = per-block AABBs
      bcnt         (C,) i32           real triangles per block
      slot_to_prim (C * tri_block,) i32  record row -> original prim (-1 pad)
      tri_block, num_blocks
    """
    cl = build_clusters(bvh, max_tris=tri_block)
    first = cl["first"].astype(np.int64)
    count = cl["count"].astype(np.int64)
    order = cl["order"].astype(np.int64)
    aabb6 = cl["aabb"][:, :6].astype(np.float32)        # (C, 6)
    C = first.shape[0]

    slot_to_prim = np.full((C * tri_block,), -1, np.int64)
    offs = np.concatenate([np.arange(c) for c in count]) \
        if C else np.zeros((0,), np.int64)
    b_idx = np.repeat(np.arange(C), count)
    slot_to_prim[b_idx * tri_block + offs] = order[
        np.concatenate([np.arange(f, f + c) for f, c in zip(first, count)])
        if C else np.zeros((0,), np.int64)]

    levels = [aabb6]
    while levels[-1].shape[0] > top_size:
        prev = levels[-1]
        n = prev.shape[0]
        npad = -(-n // 8) * 8
        lo = np.full((npad, 3), np.inf, np.float32)
        hi = np.full((npad, 3), -np.inf, np.float32)
        lo[:n] = prev[:, 0:3]
        hi[:n] = prev[:, 3:6]
        levels.append(np.concatenate(
            [lo.reshape(-1, 8, 3).min(1), hi.reshape(-1, 8, 3).max(1)],
            axis=1))

    return {
        "aabb_levels": levels,
        "bcnt": count.astype(np.int32),
        "slot_to_prim": slot_to_prim.astype(np.int32),
        "tri_block": tri_block,
        "num_blocks": C,
    }


def _stackless_step(arrays, tri_arrays, orig, direction, inv_d, node, far,
                    t_min, leaf_size):
    """One lockstep step for the rays at preorder nodes ``node`` (all < N):
    slab test against ``far``, masked (r, leaf_size) leaf tests, next node.
    Returns (h, t, u, v, pids, nxt), h already masked by the leaf and by
    t < far."""
    nmin, nmax, nfirst, ncount, escape, prim_order = arrays
    v0, e1, e2 = tri_arrays
    P = prim_order.shape[0]
    ks = torch.arange(leaf_size, device=orig.device)
    nc = node.long()
    t0 = (nmin[nc] - orig) * inv_d
    t1 = (nmax[nc] - orig) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    hit_box = tn.clamp(min=0.0) <= torch.minimum(tf, far)

    cnt = ncount[nc]
    is_leaf = cnt > 0
    first = nfirst[nc].long()
    pids = prim_order[(first[:, None] + ks[None, :]).clamp(0, P - 1)].long()
    pm = hit_box[:, None] & is_leaf[:, None] & (ks[None, :] < cnt[:, None])
    h, t, u, v = intersect.moller_trumbore(
        orig[:, None], direction[:, None], v0[pids], e1[pids], e2[pids],
        t_min, math.inf)
    h = h & pm & (t < far[:, None])
    descend = hit_box & ~is_leaf
    nxt = torch.where(descend, node + 1, escape[nc])
    return h, t, u, v, pids, nxt


def closest_hit_stackless(stackless_arrays, tri_arrays, orig, direction,
                          t_min=1e-4, t_max=math.inf,
                          leaf_size: int = LEAF_SIZE):
    """Lockstep traversal over the preorder + escape-link layout.

    Per-ray state is ONE int32 node pointer (no stacks): at an interior
    node whose box the ray hits, descend to node+1 (preorder first child);
    otherwise jump to escape[node].  All rays advance together, one masked
    step per pass of a host loop that ends when every ray has left the
    tree; rays that have left are dropped from the step's gathers.

    stackless_arrays: BVH.as_stackless_arrays(device); rays (R, 3).
    Returns (prim (R,) i32 [-1 miss], t, u, v).
    """
    N = stackless_arrays[0].shape[0]
    R = orig.shape[0]
    dev = orig.device
    inv_d = intersect.inv_dir(direction)
    node = torch.zeros((R,), dtype=torch.int32, device=dev)
    best_t = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (R,)).clone()
    best_p = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((R,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((R,), dtype=torch.float32, device=dev)
    idx = torch.arange(R, device=dev)
    while idx.numel():
        h, t, u, v, pids, nxt = _stackless_step(
            stackless_arrays, tri_arrays, orig[idx], direction[idx],
            inv_d[idx], node[idx], best_t[idx], t_min, leaf_size)
        t_m = torch.where(h, t, torch.full_like(t, math.inf))
        k_best = torch.argmin(t_m, dim=1, keepdim=True)
        cand_t = t_m.gather(1, k_best)[:, 0]
        better = cand_t < best_t[idx]
        w = idx[better]
        kb = k_best[better]
        best_t[w] = cand_t[better]
        best_p[w] = pids[better].gather(1, kb)[:, 0].to(torch.int32)
        best_u[w] = u[better].gather(1, kb)[:, 0]
        best_v[w] = v[better].gather(1, kb)[:, 0]
        node[idx] = nxt
        idx = idx[nxt < N]
    inf = torch.full_like(best_t, math.inf)
    return best_p, torch.where(best_p >= 0, best_t, inf), best_u, best_v


def any_hit_stackless(stackless_arrays, tri_arrays, orig, direction,
                      t_min=1e-4, t_max=1.0, leaf_size: int = LEAF_SIZE):
    """Occlusion traversal with a true early-out: a ray that finds ANY
    hit in (t_min, t_max) leaves the walk at once, and the loop ends as
    soon as every ray is done or occluded."""
    N = stackless_arrays[0].shape[0]
    R = orig.shape[0]
    dev = orig.device
    inv_d = intersect.inv_dir(direction)
    tmax_arr = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (R,))
    node = torch.zeros((R,), dtype=torch.int32, device=dev)
    occluded = torch.zeros((R,), dtype=torch.bool, device=dev)
    idx = torch.arange(R, device=dev)
    while idx.numel():
        h, _, _, _, _, nxt = _stackless_step(
            stackless_arrays, tri_arrays, orig[idx], direction[idx],
            inv_d[idx], node[idx], tmax_arr[idx], t_min, leaf_size)
        occ = h.any(dim=1)
        occluded[idx[occ]] = True
        node[idx] = nxt
        idx = idx[(nxt < N) & ~occ]
    return occluded


def closest_hit(bvh_arrays, tri_arrays, orig, direction,
                t_min=1e-4, t_max=math.inf,
                leaf_size: int = LEAF_SIZE,
                stack_depth: int = STACK_DEPTH):
    """Closest-hit traversal with a stack a ray, for a ray batch.

    bvh_arrays: BVH.as_device_arrays(device); tri_arrays: (v0, e1, e2) in
    the ORIGINAL primitive order (prim_order indices resolve into them).
    orig, direction: (R, 3).  Every ray pops one node a pass of a host loop
    (right child first, as the JAX module pushes left then right) until no
    ray holds a node; a leaf's best candidate replaces the ray's best under
    strict ``<``.
    Returns (prim_id (R,) int32, t, u, v): prim ids in original order, -1 and
    t = inf on a miss.
    """
    nmin, nmax, nleft, nright, nfirst, ncount, prim_order = bvh_arrays
    v0, e1, e2 = tri_arrays
    R, dev = orig.shape[0], orig.device
    P = prim_order.shape[0]
    inv_d = intersect.inv_dir(direction)
    ks = torch.arange(leaf_size, device=dev)
    stack = torch.zeros((R, stack_depth), dtype=torch.int64, device=dev)
    sp = torch.ones((R,), dtype=torch.int64, device=dev)     # the root waits
    best_t = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (R,)).clone()
    best_p = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((R,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((R,), dtype=torch.float32, device=dev)
    idx = torch.arange(R, device=dev)
    while idx.numel():
        top = sp[idx] - 1
        node = stack[idx, top]
        o, far = orig[idx], best_t[idx]
        t0 = (nmin[node] - o) * inv_d[idx]
        t1 = (nmax[node] - o) * inv_d[idx]
        tn = torch.minimum(t0, t1).amax(dim=-1)
        tf = torch.maximum(t0, t1).amin(dim=-1)
        hit_box = tn.clamp(min=0.0) <= torch.minimum(tf, far)
        cnt = ncount[node]
        is_leaf = cnt > 0

        # leaf: up to leaf_size prims, masked
        first = nfirst[node].long()
        pids = prim_order[(first[:, None] + ks[None, :]).clamp(0, P - 1)]
        pids = pids.long()
        h, t, u, v = intersect.moller_trumbore(
            o[:, None], direction[idx][:, None], v0[pids], e1[pids],
            e2[pids], t_min, far[:, None])
        h = h & (hit_box & is_leaf)[:, None] & (ks[None, :] < cnt[:, None])
        t_m = torch.where(h, t, torch.full_like(t, math.inf))
        kb = torch.argmin(t_m, dim=1, keepdim=True)
        cand_t = t_m.gather(1, kb)[:, 0]
        better = cand_t < far
        w = idx[better]
        kbb = kb[better]
        best_t[w] = cand_t[better]
        best_p[w] = pids[better].gather(1, kbb)[:, 0].to(torch.int32)
        best_u[w] = u[better].gather(1, kbb)[:, 0]
        best_v[w] = v[better].gather(1, kbb)[:, 0]

        # internal: push the children, left then right
        push = hit_box & ~is_leaf
        pi, pt = idx[push], top[push]
        if pt.numel() and int(pt.max()) + 1 >= stack_depth:
            raise RuntimeError(f"BVH deeper than the {stack_depth}-entry "
                               "stack")
        stack[pi, pt] = nleft[node[push]].long()
        stack[pi, pt + 1] = nright[node[push]].long()
        sp[idx] = top + 2 * push.long()
        idx = idx[sp[idx] > 0]
    inf = torch.full_like(best_t, math.inf)
    return best_p, torch.where(best_p >= 0, best_t, inf), best_u, best_v


def any_hit(bvh_arrays, tri_arrays, orig, direction, t_min=1e-4, t_max=1.0,
            leaf_size: int = LEAF_SIZE, stack_depth: int = STACK_DEPTH):
    """Occlusion query through the full closest-hit traversal (the per-ray
    stack walk has no early-out; any_hit_stackless has one)."""
    prim, _, _, _ = closest_hit(bvh_arrays, tri_arrays, orig, direction,
                                t_min, t_max, leaf_size, stack_depth)
    return prim >= 0
