"""Tile-striped execution of the exact-int draw3d path over a mesh of ranks.

Counterpart of skybox_rt_tpu.parallel.draw_shard.  The reference's primary
parallel axis stripes a drawcall's binned tiles round-robin across raster
units: unit i of N takes tiles i, i+N, i+2N, ... (sim/simx/
raster_unit.cpp:109-114,221-227; SW twin gpu_sw.h:38).  This module applies
the identical rule across the ranks of a mesh (parallel.mesh):

  * geometry (edge/attribute planes, texel table) is REPLICATED: every rank
    holds the whole draw, as every raster unit reads the shared primbuf
  * the tile list is PERMUTED into round-robin strips (rank i's block holds
    tiles i, i+N, ...), padded to equal length with invalid tiles
  * each rank runs the unchanged exact deferred passes
    (ops.deferred.render_tiles_deferred: kernel #1 for CUDA tensors, its
    plain version for CPU tensors) on its own tiles; bit-exact by
    construction, since tiles are independent given the pre-draw fb state
  * framebuffer assembly: each rank writes its owned tiles into a zeroed
    tiled frame, one all-reduce (SUM) each sums the disjoint color, ds and
    count words, and unowned tiles keep the incoming fb; integer-exact
    (every real tile has exactly one contributor).  The blended pass's
    fragment count is all-reduced with MAX, so every rank takes the same
    overflow decision.

The frame equals the single-rank renderer's bit for bit for every OM state
(tests/test_torch_parallel_raster.py, at 1, 2 and 4 ranks).  The JAX
package's ``pallas_raster.supported`` gate and its fallback to "xla" are TPU
gates and are not carried: ``visibility="xla"`` and ``"pallas"`` both take
ops.deferred, as ref.driver's modes "deferred" and "pallas" do.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core import fixed
from ..ops import deferred
from ..ref import driver as ref_driver
from . import mesh as mesh_mod
from . import overlap

VISIBILITY = ("xla", "pallas")


def _check_visibility(visibility: str) -> None:
    if visibility == "pallas_interpret":
        ref_driver._check_mode(visibility)
    if visibility not in VISIBILITY:
        raise ValueError(f"visibility {visibility!r} not in {VISIBILITY}")


def stripe_tiles(binned, n_devices: int):
    """Round-robin tile striping (raster_unit.cpp:221-227): rank i's
    contiguous block holds tiles i, i+N, i+2N, ... padded to equal length
    with invalid tiles.  Returns (tile_pids, tile_xy, tile_valid) numpy
    int32 with leading dim n_devices * ceil(T/N)."""
    tile_pids = np.asarray(binned.tile_pids)
    tile_xy = np.asarray(binned.tile_xy)
    T, M = tile_pids.shape
    Tl = -(-T // n_devices)
    pids = np.full((n_devices, Tl, M), -1, np.int32)
    xy = np.zeros((n_devices, Tl, 2), np.int32)
    valid = np.zeros((n_devices, Tl), np.int32)
    for i in range(n_devices):
        sel = np.arange(i, T, n_devices)
        pids[i, : len(sel)] = tile_pids[sel]
        xy[i, : len(sel)] = tile_xy[sel]
        valid[i, : len(sel)] = 1
    return (pids.reshape(n_devices * Tl, M),
            xy.reshape(n_devices * Tl, 2),
            valid.reshape(n_devices * Tl))


def _stripe_arrays(binned, mesh, device) -> tuple:
    """This rank's stripe of a binned draw on ``device``, uploaded once and
    cached on the binned object: (edges, attribs, zattr, tile_pids, tile_xy,
    own) with ``own`` the rows of the stripe that are real tiles."""
    n = mesh.size()
    i = mesh_mod.block_index(mesh)
    cache = binned.__dict__.setdefault("_dev_stripes", {})
    key = (n, i, str(device))
    if key not in cache:
        pids, xy, valid = stripe_tiles(binned, n)
        blk = slice(i * (len(valid) // n), (i + 1) * (len(valid) // n))
        edges, attribs, zattr, _, _ = deferred.device_arrays(binned, device)
        cache[key] = (edges, attribs, zattr,
                      torch.from_numpy(pids[blk].copy()).to(device),
                      torch.from_numpy(xy[blk].copy()).to(device),
                      torch.from_numpy(np.flatnonzero(valid[blk])).to(device))
    return cache[key]


def _render_stripe(render_state, texels, stripe, fb_color, fb_ds,
                   tile_logsize, group, blend_slots):
    """Both deferred passes over this rank's stripe, assembled over the
    group: (fb_color, fb_ds, max_frag_count), the same on every rank."""
    edges, attribs, zattr, tile_pids, tile_xy, own = stripe
    Hp, Wp = fb_color.shape
    ts = 1 << tile_logsize
    fbc_t = deferred.tiles_view(fb_color, tile_logsize)
    fbd_t = deferred.tiles_view(fb_ds, tile_logsize)
    tx = tile_xy[:, 0].to(torch.int64)
    ty = tile_xy[:, 1].to(torch.int64)
    out_c, out_d, max_cnt = deferred.render_tiles_deferred(
        render_state, texels, edges, attribs, zattr, tile_pids, tile_xy,
        fbc_t[ty, tx], fbd_t[ty, tx], tile_logsize, blend_slots=blend_slots)

    gh, gw = fbc_t.shape[:2]
    dev = fb_color.device
    upd_c = torch.zeros((gh, gw, ts, ts), dtype=torch.int32, device=dev)
    upd_d = torch.zeros_like(upd_c)
    cnt = torch.zeros((gh, gw), dtype=torch.int32, device=dev)
    oy, ox = ty[own], tx[own]
    upd_c[oy, ox] = out_c[own]      # padding tiles write nothing
    upd_d[oy, ox] = out_d[own]
    cnt[oy, ox] = 1
    max_cnt = max_cnt.to(torch.int32).reshape(1)
    for words in (upd_c, upd_d, cnt):
        overlap.all_reduce(words, group)
    overlap.all_reduce(max_cnt, group, op=dist.ReduceOp.MAX)

    owned = (cnt > 0)[:, :, None, None]
    fbc = torch.where(owned, upd_c, fbc_t).permute(0, 2, 1, 3).reshape(Hp, Wp)
    fbd = torch.where(owned, upd_d, fbd_t).permute(0, 2, 1, 3).reshape(Hp, Wp)
    return fbc, fbd, max_cnt[0]


def render_drawcall_sharded(mesh, render_state, texels, binned,
                            fb_color, fb_ds, visibility="xla", info=None,
                            blend_k=None, overflow_out=None):
    """Tile-striped exact render of one drawcall over the mesh.

    Bit-identical to ops.deferred.render_drawcall (same passes, same blend
    slot / overflow protocol, the fragment count MAX-reduced over the ranks).
    fb_color, fb_ds: (Hp, Wp) int32 framebuffers on the mesh's device, the
    same on every rank; returns new ones.  blend_k / overflow_out: cached-K
    dispatch with frame-end overflow verification, the same contract as
    ops.deferred.render_drawcall (VERDICT r3 #7)."""
    _check_visibility(visibility)
    device = fb_color.device
    if texels is None:
        texels = deferred._dummy_texels(device)
    stripe = _stripe_arrays(binned, mesh, device)
    group = mesh_mod.flat_group(mesh)

    def run(k):
        return _render_stripe(render_state, texels, stripe, fb_color, fb_ds,
                              binned.tile_logsize, group, k)

    return deferred.dispatch_blend_slots(
        run, render_state, binned.tile_pids.shape[1], info, blend_k,
        overflow_out)


def render_trace_sharded(trace, width: int, height: int, mesh,
                         tile_logsize: int = 5,
                         visibility: str = "xla") -> np.ndarray:
    """Full-frame tile-striped render (the sharded twin of
    ref.driver.render_trace; persistent z/color buffers across draws), on
    the mesh's device; returns the (H, W) uint32 ARGB framebuffer.

    Shares the trace-attached blend-K cache with ref.driver's frames
    (the measured counts are identical: the sharded render is bit-exact
    and the count is MAX-reduced), so steady-state frames dispatch blended
    draws with a static K and verify overflow only at frame end."""
    _check_visibility(visibility)
    device = mesh_mod.mesh_device(mesh)
    draws = ref_driver.prepare_drawcalls(trace, width, height, tile_logsize,
                                         device=device)
    cache = trace.__dict__.setdefault("_blend_k_cache", {})
    # "prepared" namespace: prepare_drawcalls drops unbinnable draws, so
    # its indices differ from render_trace's raw drawcall indices
    ks = cache.setdefault((width, height, tile_logsize, "prepared"), {})
    pending = []
    fbc, fbd = ref_driver.clear_framebuffers(width, height, tile_logsize,
                                             device)
    for d, (rs, texels, binned) in enumerate(draws):
        info = {}
        hint = ks.get(d)
        fbc, fbd = render_drawcall_sharded(
            mesh, rs, texels, binned, fbc, fbd, visibility=visibility,
            info=info, blend_k=hint or None,
            overflow_out=pending if hint else None)
        ks[d] = info["blend_k"]
    out = fixed.to_numpy_u32(fbc[:height, :width])
    if pending and any(int(mc) > k for k, mc in pending):
        cache.pop((width, height, tile_logsize, "prepared"), None)
        return render_trace_sharded(trace, width, height, mesh,
                                    tile_logsize, visibility)
    return out
