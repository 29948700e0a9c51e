"""Ray queries over BVH-treelet blocks: the CUDA kernels and their plain
torch versions.

Counterpart of the ``*_bvh`` part of skybox_rt_tpu.ops.pallas_rt.  The two
kernels of ``csrc/rt_bvh.cu`` replace the Pallas TPU kernels
``pallas_rt._make_bvh_worklist_kernel`` (:func:`closest_hit_bvh`) and
``pallas_rt._make_bvh_anyhit_kernel`` (:func:`any_hit_bvh`); the source says
how a ray walks the hierarchy and what bounds it.  What the TPU schedule
needed and the function does not is gone: ray packing, the worklist prepass,
``sub`` / ``L`` / ``unroll`` / ``early_exit`` / ``interpret``.

  * a CUDA tensor launches the kernel on the current stream, or raises;
  * a CPU tensor runs :func:`closest_hit_bvh_reference` /
    :func:`any_hit_bvh_reference`, the same arithmetic in the same order in
    plain torch.  The CPU tests and chip_smoke.py's comparison call them by
    name; nothing on the main path does when a card is present.

Tie rule.  Among hits of equal t the closest-hit query returns the one with
the lowest *slot* (the triangle's record row, block * tri_block + j, i.e. its
position in treelet order): the lexicographic (t, slot) minimum.  It does not
depend on the order in which blocks are met, so kernel and plain version can
be compared exactly.  (The Pallas kernel keeps the first hit in its bundle's
front-to-back worklist order, which no other schedule can reproduce.)

Records are the port's own layout: ``(C * tri_block, 12)`` float32 rows
[v0 e1 e2 | 3 of padding], three float4 a row; rows past a block's
``bcnt[b]`` triangles are zero and never read by the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..rt import intersect

T_MIN = 1e-4
#: deepest AABB pyramid the kernel's per-thread stack is sized for
#: (csrc/rt_bvh.cu MAX_LEVELS); 64 * 8**7 blocks
MAX_LEVELS = 8
#: most entries a pyramid level may have (24 index bits of a stack entry)
MAX_LEVEL_ENTRIES = 1 << 24
RECORD_WIDTH = 12

# Kernel launches made by closest_hit_bvh / any_hit_bvh since the last
# reset: a run reads them to show that its main path went through the kernels.
closest_launch_count = 0
anyhit_launch_count = 0


def reset_launch_counts() -> None:
    global closest_launch_count, anyhit_launch_count
    closest_launch_count = 0
    anyhit_launch_count = 0


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


def _slab_pass(box, o, inv, far):
    """tn <= tf of one (6,) AABB against rays o, inv ((r,) x 3 each) with
    the far clip ``far`` (r,): pallas_rt._slab_embedded, term by term."""
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
    return tn <= tf


def _components(orig, direction):
    o = tuple(orig[:, k].contiguous() for k in range(3))
    d = tuple(direction[:, k].contiguous() for k in range(3))
    return o, d, tuple(intersect.inv_dir(c) for c in d)


def _block_tests(blocks, b, n, o, d, idx, t_min):
    """Möller–Trumbore of rays ``idx`` against the n triangles of block b:
    (ok, t, u, v) over (len(idx), n), ok without the upper bound on t."""
    TB = blocks["tri_block"]
    rec = blocks["tri"][b * TB:b * TB + n]                  # (n, 12)
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


def closest_hit_bvh_reference(orig, direction, blocks, t_max=None,
                              t_min: float = T_MIN, block_order=None,
                              stats=None):
    """Plain torch closest hit over the blocks, on any device: what
    :func:`closest_hit_bvh` returns.

    Loops over level-0 blocks (ascending, or ``block_order``); per block the
    slab gate against each ray's running best t, then the (rays that pass x
    triangles) Möller–Trumbore batch and the lexicographic (t, slot)
    update.  ``stats``, a dict, gains ``slab_tests``, ``slab_pass`` and
    ``tri_tests`` (counts of this call's ray-box tests, of those that
    passed, and of its ray-triangle tests)."""
    R = orig.shape[0]
    dev = orig.device
    TB = blocks["tri_block"]
    o, d, inv = _components(orig, direction)
    tmax0 = _per_ray_tmax(math.inf if t_max is None else t_max, R, dev)
    best_t = tmax0.clone()
    best_s = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((R,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((R,), dtype=torch.float32, device=dev)
    counts = blocks["bcnt"].tolist()
    level0 = blocks["levels"][0]
    order = range(blocks["num_blocks"]) if block_order is None else block_order
    for b in order:
        n = counts[b]
        idx_all = torch.nonzero(_slab_pass(level0[b], o, inv, best_t))[:, 0]
        _count(stats, slab_tests=R, slab_pass=idx_all.numel(),
               tri_tests=idx_all.numel() * n)
        if n == 0:
            continue
        for idx in _idx_chunks(idx_all, n):
            ok, t, u, v = _block_tests(blocks, b, n, o, d, idx, t_min)
            hit = ok & (t < tmax0[idx][:, None])
            t_m = torch.where(hit, t, torch.full_like(t, math.inf))
            # first minimum = lowest slot of the block at equal t
            j = torch.argmin(t_m, dim=1, keepdim=True)
            cand_t = t_m.gather(1, j)[:, 0]
            slot = b * TB + j[:, 0]
            cur_t, cur_s = best_t[idx], best_s[idx]
            better = (cand_t < math.inf) & (
                (cand_t < cur_t) | ((cand_t == cur_t) & (slot < cur_s)))
            w = idx[better]
            jb = j[better]
            best_t[w] = cand_t[better]
            best_s[w] = slot[better]
            best_u[w] = u[better].gather(1, jb)[:, 0]
            best_v[w] = v[better].gather(1, jb)[:, 0]
    miss = best_s < 0
    s2p = blocks["s2p"]
    prim = torch.where(miss, -1, s2p[best_s.clamp(min=0)])
    zero = torch.zeros_like(best_t)
    return (prim,
            torch.where(miss, torch.full_like(best_t, math.inf), best_t),
            torch.where(miss, zero, best_u),
            torch.where(miss, zero, best_v))


def any_hit_bvh_reference(orig, direction, blocks, t_max=1.0,
                          t_min: float = T_MIN, block_order=None, stats=None):
    """Plain torch occlusion query over the blocks, on any device: whether
    any triangle hits with t_min < t < t_max (a number or (R,)).  A ray
    leaves the loop at its first hit."""
    R = orig.shape[0]
    dev = orig.device
    o, d, inv = _components(orig, direction)
    tmax = _per_ray_tmax(t_max, R, dev)
    occ = torch.zeros((R,), dtype=torch.bool, device=dev)
    alive = torch.arange(R, device=dev)
    counts = blocks["bcnt"].tolist()
    level0 = blocks["levels"][0]
    order = range(blocks["num_blocks"]) if block_order is None else block_order
    for b in order:
        n = counts[b]
        oa = tuple(c[alive] for c in o)
        ia = tuple(c[alive] for c in inv)
        idx_all = alive[_slab_pass(level0[b], oa, ia, tmax[alive])]
        _count(stats, slab_tests=alive.numel(), slab_pass=idx_all.numel(),
               tri_tests=idx_all.numel() * n)
        if n == 0 or idx_all.numel() == 0:
            continue
        for idx in _idx_chunks(idx_all, n):
            ok, t, _, _ = _block_tests(blocks, b, n, o, d, idx, t_min)
            hit = (ok & (t < tmax[idx][:, None])).any(dim=1)
            occ[idx[hit]] = True
        alive = alive[~occ[alive]]
    return occ


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


def _kernel_args(orig, direction, blocks):
    dev = orig.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    slots = blocks["num_blocks"] * blocks["tri_block"]
    for name, shape, dtype in (
            ("tri", (slots, RECORD_WIDTH), torch.float32),
            ("bcnt", (blocks["num_blocks"],), torch.int32),
            ("s2p", (slots,), torch.int32),
            ("aabb", (sum(blocks["level_counts"]), 6), torch.float32)):
        t = blocks[name]
        if t.device != dev:
            raise ValueError(f"blocks[{name!r}] is on {t.device}, the rays "
                             f"on {dev}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"blocks[{name!r}] is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"blocks[{name!r}] must be contiguous")
    n = len(blocks["level_offsets"])
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"AABB pyramid has {n} levels, the kernel's stack "
                         f"holds {MAX_LEVELS}")
    arr = ctypes.c_int * n
    return (orig.contiguous(), direction.contiguous(),
            arr(*blocks["level_offsets"]), arr(*blocks["level_counts"]), n)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


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
    dev = o.device
    prim = torch.empty((R,), dtype=torch.int32, device=dev)
    t, u, v = (torch.empty((R,), dtype=torch.float32, device=dev)
               for _ in range(3))

    from .. import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.skybox_rt_closest_hit_bvh(
        _ptr(o), _ptr(d), _ptr(t_max), _ptr(blocks["tri"]),
        _ptr(blocks["bcnt"]), _ptr(blocks["s2p"]), _ptr(blocks["aabb"]),
        off, cnt, n, blocks["tri_block"], t_min, R, _ptr(prim), _ptr(t),
        _ptr(u), _ptr(v), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"rt_closest_hit_bvh kernel launch failed: CUDA "
                           f"error {rc}")
    global closest_launch_count
    closest_launch_count += 1
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

    from .. import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream(o.device).cuda_stream
    rc = lib.skybox_rt_any_hit_bvh(
        _ptr(o), _ptr(d), _ptr(tmax), _ptr(blocks["tri"]),
        _ptr(blocks["bcnt"]), _ptr(blocks["aabb"]), off, cnt, n,
        blocks["tri_block"], t_min, R, _ptr(occ), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"rt_any_hit_bvh kernel launch failed: CUDA "
                           f"error {rc}")
    global anyhit_launch_count
    anyhit_launch_count += 1
    return occ
