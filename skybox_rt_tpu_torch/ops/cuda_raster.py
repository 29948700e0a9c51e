"""Pass 1 (visibility) of the deferred renderer: the CUDA kernel and its
plain torch version.

Counterpart of skybox_rt_tpu.ops.pallas_raster.  The kernel,
``csrc/raster_visibility.cu``, replaces the Pallas TPU kernel
``pallas_raster._make_kernel``; its source says how it is laid out and what
bounds it.  :func:`visibility_tiles` keeps the JAX signature and outputs
(minus ``interpret``):

  * a CUDA tensor launches the kernel on the current stream, or raises;
  * a CPU tensor runs :func:`visibility_tiles_reference`, the plain torch
    port of the XLA twin ``ops.deferred._visibility_tiles``, extended with
    the fused dx/dy outputs.  The CPU tests and chip_smoke.py's comparison
    phase call it by name; nothing on the main path does when a card is
    present.

The kernel gives a warp a patch of PATCH_W x PATCH_H pixels and skips the
prims that :func:`patch_culled` proves cover none of them.
:func:`patch_culled` is that test's plain twin, and :func:`cull_counts`
counts the kernel's steps with it; the CPU tests and chip_smoke.py call
them, the main path does not.  :func:`wrapping_case` makes check inputs
whose edge values wrap.

All words are int32 tensors; ds words are u32 bit patterns (core.fixed).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.fixed import s32
from ..om import merger as om_merger
from ..raster import edge as edge_mod
from ..raster import interp as interp_mod
from ..utils import tracing

TILE_LOGSIZES = (3, 4, 5, 6)
#: the pixels of one warp of the kernel: a patch PATCH_W wide, PATCH_H tall
#: (csrc/raster_visibility.cu kPatchW, kPatchH)
PATCH_W, PATCH_H = 8, 4
#: warps (patches) of one block (csrc/raster_visibility.cu kWarps); a tile
#: with fewer patches is one block
PATCH_WARPS = 4
#: the frame of :func:`wrapping_case`, and a scissor (left, top, right,
#: bottom) that leaves the first patch of its tile at (0, 0) outside and
#: cuts the next, at every tile size
WRAP_EXTENT = 512
WRAP_SCISSOR = (13, 6, WRAP_EXTENT - 21, WRAP_EXTENT - 7)

# Kernel launches since the last reset: a run reads it to show that its
# main path went through the kernel.  Each launch also adds 1 to the tracing
# counter ``raster.vis_kernel``.  A launch captured into a CUDA graph counts
# once for each replay of the graph (count_launch), not at capture.
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def count_launch() -> None:
    """Count one launch of the kernel."""
    global launch_count
    launch_count += 1
    tracing.count("raster.vis_kernel")


def tile_grids(tile_xy: torch.Tensor, tile_logsize: int):
    """(T, ts, ts) int32 global pixel x / y of each binned tile."""
    ts = 1 << tile_logsize
    dev = tile_xy.device
    lin = torch.arange(ts, dtype=torch.int32, device=dev)
    origins = tile_xy.to(torch.int32) * ts
    xs = lin[None, None, :] + origins[:, 0, None, None]
    ys = lin[None, :, None] + origins[:, 1, None, None]
    return xs.expand(-1, ts, ts), ys.expand(-1, ts, ts)


def prim_steps(render_state, edges, zattr, tile_pids, tile_xy, fb_ds_tiles,
               tile_logsize, need_grad=True):
    """Walk every tile's prims in submission order, carrying the exact ds
    word (om.merger.ds_carry_update) from fb_ds_tiles.

    Yields, per prim slot of tile_pids, (pid (T,), cov, contrib, dx, dy,
    dsw) over (T, ts, ts), dsw being the carried word after the step; dx/dy
    are None unless need_grad or the ds test needs the shaded z."""
    om = render_state.om
    shade_z = render_state.flags.depth_enabled
    ds_active = om.ds.depth_enabled or om.ds.stencil_enabled(False)
    xs, ys = tile_grids(tile_xy, tile_logsize)
    dsw = fb_ds_tiles.to(torch.int32)
    for i in range(tile_pids.shape[1]):
        pid = tile_pids[:, i]
        p = pid.clamp(min=0).to(torch.int64)
        valid = (pid >= 0)[:, None, None]
        evals = edge_mod.eval_edges(edges[p][:, None, None], xs, ys)
        cov = edge_mod.coverage(evals, xs, ys, render_state.scissor) & valid
        dx = dy = None
        if need_grad or (ds_active and shade_z):
            dx, dy = interp_mod.gradients(evals)
        if ds_active and shade_z:
            z = interp_mod.interpolate(zattr[p][:, None, None], dx, dy)
        else:
            z = torch.zeros_like(xs)            # shader DEFAULTS z=0
        dsw, contrib = om_merger.ds_carry_update(om, z, cov, dsw)
        yield pid, cov, contrib, dx, dy, dsw


def visibility_tiles_reference(render_state, edges, zattr, tile_pids, tile_xy,
                               fb_ds_tiles, tile_logsize, fused=False,
                               blend_slots=0):
    """Plain torch pass 1, vectorized over (T, ts, ts), looping over M.

    Returns what :func:`visibility_tiles` returns, on any device."""
    ts = 1 << tile_logsize
    T = tile_pids.shape[0]
    dev = fb_ds_tiles.device
    K = blend_slots
    fused = fused and K == 0
    dsw = fb_ds_tiles.to(torch.int32)
    steps = prim_steps(render_state, edges, zattr, tile_pids, tile_xy,
                       fb_ds_tiles, tile_logsize, need_grad=fused)
    if K > 0:
        slots = torch.full((T, K, ts, ts), -1, dtype=torch.int32, device=dev)
        cnt = torch.zeros((T, ts, ts), dtype=torch.int32, device=dev)
        k_iota = torch.arange(K, dtype=torch.int32,
                              device=dev)[None, :, None, None]
        for pid, _, contrib, _, _, dsw in steps:
            onehot = (k_iota == cnt[:, None]) & contrib[:, None]
            slots = torch.where(onehot, pid[:, None, None, None], slots)
            cnt = cnt + contrib.to(torch.int32)
        return dsw, slots, cnt

    win = torch.full((T, ts, ts), -1, dtype=torch.int32, device=dev)
    dxw = torch.zeros((T, ts, ts), dtype=torch.int32, device=dev)
    dyw = torch.zeros((T, ts, ts), dtype=torch.int32, device=dev)
    for pid, _, contrib, dx, dy, dsw in steps:
        win = torch.where(contrib, pid[:, None, None], win)
        if fused:
            dxw = torch.where(contrib, dx, dxw)
            dyw = torch.where(contrib, dy, dyw)
    if fused:
        return dsw, win, dxw, dyw
    return dsw, win


def patch_culled(edges, x0, y0):
    """Whether a prim provably covers no pixel of the kernel's patch
    [x0, x0 + PATCH_W) x [y0, y0 + PATCH_H): the kernel's cull, exact under
    its wrapping arithmetic.

    edges (..., 3, 3) int32 [edge][a, b, c]; x0, y0 ints or int tensors
    broadcastable against edges[..., 0, 0].  A pixel's edge value is
    a*x + b*y + c wrapped to int32 (raster.edge.eval_edges).  Over the patch
    the unwrapped int64 value is affine, so its least and largest values lo
    and hi lie at corners; every int64 of [lo, hi] wraps to a negative int32
    when lo and hi have one quotient by 2**31 (floor division) and it is
    odd.  A prim is culled when that holds for one of its edges: that edge
    is negative on every pixel, so the prim covers none."""
    e = edges.to(torch.int64)
    a, b, c = e[..., 0], e[..., 1], e[..., 2]
    x0 = torch.as_tensor(x0, dtype=torch.int64, device=e.device)[..., None]
    y0 = torch.as_tensor(y0, dtype=torch.int64, device=e.device)[..., None]
    x1, y1 = x0 + (PATCH_W - 1), y0 + (PATCH_H - 1)
    lo = c + torch.where(a >= 0, a * x0, a * x1) \
        + torch.where(b >= 0, b * y0, b * y1)
    hi = c + torch.where(a >= 0, a * x1, a * x0) \
        + torch.where(b >= 0, b * y1, b * y0)
    q = lo >> 31
    return ((q == hi >> 31) & ((q & 1) == 1)).any(dim=-1)


def patch_origins(tile_xy, tile_logsize):
    """(T, patches, 2) int64 global pixel (x0, y0) of each kernel patch of
    each tile, in the kernel's patch order (row-major in the tile)."""
    ts = 1 << tile_logsize
    px = torch.arange(0, ts, PATCH_W, device=tile_xy.device)
    py = torch.arange(0, ts, PATCH_H, device=tile_xy.device)
    local = torch.stack(torch.broadcast_tensors(px[None, :], py[:, None]),
                        dim=-1).reshape(-1, 2)
    return tile_xy.to(torch.int64)[:, None, :] * ts + local[None]


def cull_counts(edges, tile_pids, tile_xy, tile_logsize, scissor):
    """The kernel's work on one draw, by :func:`patch_culled`: returns
    (steps: pixel-prim steps its warps take, cull_tests: (patch, prim)
    tests, all_steps: the steps of every pixel over every real prim).  A
    patch with no pixel inside the scissor takes none of them."""
    ts = 1 << tile_logsize
    left, top, right, bottom = (int(v) for v in scissor)
    org = patch_origins(tile_xy, tile_logsize)              # (T, Q, 2)
    live = ((org[..., 0] < right) & (org[..., 0] + PATCH_W > left)
            & (org[..., 1] < bottom) & (org[..., 1] + PATCH_H > top))
    real = tile_pids >= 0                                   # (T, M)
    steps = tests = 0
    for t in range(tile_pids.shape[0]):
        pids = tile_pids[t][real[t]].to(torch.int64)
        o = org[t][live[t]]
        keep = ~patch_culled(edges[pids][:, None], o[None, :, 0],
                             o[None, :, 1])
        steps += int(keep.sum()) * PATCH_W * PATCH_H
        tests += pids.numel() * o.shape[0]
    return steps, tests, int(real.sum()) * ts * ts


def wrapping_case(tile_logsize, seed, device="cpu"):
    """Check inputs of pass 1 whose edge values wrap: (edges, zattr,
    tile_pids, tile_xy, fb_ds_tiles) int32 for 6 tiles of up to 40 of 96
    prims, made with numpy from ``seed``.

    Each edge has coefficients a, b of a random scale from 2**2 to 2**30,
    and a c that puts its zero, or its wrap at +-2**31 or 2**32, near a
    random pixel of the WRAP_EXTENT^2 frame, so that edges cross both ways
    inside patches.  The first tile sits at (0, 0) and the last at the
    frame's far corner, where :data:`WRAP_SCISSOR` leaves patches outside
    and cuts others; rows of tile_pids hold ascending pids, -1 padded, one
    row empty and one full."""
    rng = np.random.default_rng(seed)
    tiles, prims, max_prims, extent = 6, 96, 40, WRAP_EXTENT
    ts = 1 << tile_logsize
    n = extent // ts
    cells = rng.choice(n * n - 2, size=tiles - 2, replace=False) + 1
    cells = np.concatenate([[0], cells, [n * n - 1]])
    tile_xy = np.stack([cells % n, cells // n], axis=1)
    scale = 2 ** rng.integers(2, 31, size=(prims, 3, 1))
    ab = rng.integers(-scale, scale + 1, size=(prims, 3, 2))
    at = rng.integers(0, extent, size=(prims, 3, 2))
    target = rng.choice([0, 2**31, -2**31, 2**32], size=(prims, 3))
    c = (target - ab[..., 0] * at[..., 0] - ab[..., 1] * at[..., 1]
         + rng.integers(-8, 9, size=(prims, 3)) * scale[..., 0])
    edges = np.concatenate([ab, c[..., None]], axis=-1)
    zattr = rng.integers(-2**31, 2**31, size=(prims, 3))
    tile_pids = np.full((tiles, max_prims), -1)
    for t in range(tiles):
        m = (0 if t == tiles // 2 else max_prims if t == 1
             else int(rng.integers(1, max_prims)))
        tile_pids[t, :m] = np.sort(rng.choice(prims, size=m, replace=False))
    words = rng.integers(0, 2**32, size=(tiles, ts, ts), dtype=np.uint64)
    words = np.where(rng.random((tiles, ts, ts)) < 0.5, words | 0xFFFFFF,
                     words)

    def i32(a):
        a = np.asarray(a, np.int64) & 0xFFFFFFFF
        return torch.from_numpy(
            np.ascontiguousarray(a.astype(np.uint32).view(np.int32))
        ).to(device)

    return (i32(edges), i32(zattr), i32(tile_pids), i32(tile_xy), i32(words))


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def visibility_tiles(render_state, edges, zattr, tile_pids, tile_xy,
                     fb_ds_tiles, tile_logsize, fused=False, blend_slots=0):
    """Pass 1 over the binned tiles of one draw.

    edges (P,3,3) i32, zattr (P,3) i32, tile_pids (T,M) i32 (-1 padded),
    tile_xy (T,2) i32, fb_ds_tiles (T,ts,ts) u32 as int32 patterns.

    blend_slots == 0: returns (dsw (T,ts,ts), winner pid (T,ts,ts) with -1 =
    none); fused=True adds the winner's fixed24 gradients (dx, dy), so pass
    2 skips the per-pixel edge gather and re-evaluation.
    blend_slots == K: returns (dsw, slots (T,K,ts,ts) pids in submission
    order (-1 empty), cnt (T,ts,ts) passing-fragment count).
    """
    dev = fb_ds_tiles.device
    if dev.type == "cpu":
        return visibility_tiles_reference(
            render_state, edges, zattr, tile_pids, tile_xy, fb_ds_tiles,
            tile_logsize, fused=fused, blend_slots=blend_slots)
    if dev.type != "cuda":
        raise ValueError(f"visibility_tiles: unsupported device {dev}")
    if tile_logsize not in TILE_LOGSIZES:
        raise ValueError(f"tile_logsize {tile_logsize} not in {TILE_LOGSIZES}")
    if blend_slots < 0:
        raise ValueError(f"blend_slots {blend_slots} < 0")
    ts = 1 << tile_logsize
    T, M = tile_pids.shape
    P = edges.shape[0]
    K = blend_slots
    fused = fused and K == 0
    _check("edges", edges, (P, 3, 3), dev)
    _check("zattr", zattr, (P, 3), dev)
    _check("tile_pids", tile_pids, (T, M), dev)
    _check("tile_xy", tile_xy, (T, 2), dev)
    _check("fb_ds_tiles", fb_ds_tiles, (T, ts, ts), dev)

    def out(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    dsw = out(T, ts, ts)
    win = dx = dy = slots = cnt = None
    if K > 0:
        slots, cnt = out(T, K, ts, ts), out(T, ts, ts)
    else:
        win = out(T, ts, ts)
        if fused:
            dx, dy = out(T, ts, ts), out(T, ts, ts)

    from .. import _build
    lib = _build.load_library()
    om = render_state.om
    ds = om.ds
    depth_en = ds.depth_enabled
    left, top, right, bottom = (int(v) for v in render_state.scissor)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.skybox_visibility_tiles(
        ptr(edges), ptr(zattr), ptr(tile_pids), ptr(tile_xy),
        ptr(fb_ds_tiles), ptr(dsw), ptr(win), ptr(dx), ptr(dy), ptr(slots),
        ptr(cnt), T, M, tile_logsize, left, top, right, bottom,
        int(render_state.flags.depth_enabled), int(depth_en),
        ds.depth_func, int(depth_en and om.depth_writemask),
        int(ds.stencil_enabled(False)), ds.stencil_front_func,
        s32(ds.stencil_front_ref), s32(ds.stencil_front_mask),
        ds.stencil_front_zpass, ds.stencil_front_zfail,
        ds.stencil_front_fail, s32(om.stencil_front_writemask),
        int(fused), K, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"raster_visibility kernel launch failed: CUDA "
                           f"error {rc}")
    if not torch.cuda.is_current_stream_capturing():
        count_launch()
    if K > 0:
        return dsw, slots, cnt
    if fused:
        return dsw, win, dx, dy
    return dsw, win
