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

All words are int32 tensors; ds words are u32 bit patterns (core.fixed).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.fixed import s32
from ..om import merger as om_merger
from ..raster import edge as edge_mod
from ..raster import interp as interp_mod

TILE_LOGSIZES = (3, 4, 5, 6)

# Kernel launches made by visibility_tiles since the last reset: a run reads
# it to show that its main path went through the kernel.
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


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
    global launch_count
    launch_count += 1
    if K > 0:
        return dsw, slots, cnt
    if fused:
        return dsw, win, dx, dy
    return dsw, win
