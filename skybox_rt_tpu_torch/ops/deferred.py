"""Deferred-shading drawcall renderer — the exact main path.

Counterpart of skybox_rt_tpu.ops.deferred.  The immediate-mode oracle
(ref.renderer) shades every covered fragment of every primitive; this
module splits a draw into

  pass 1 (visibility, ops.cuda_raster.visibility_tiles): scan primitives
      per tile carrying only (depth-stencil word, winner / fragment-slot
      state) per pixel — the hand-written CUDA kernel on a card
  pass 2 (shading): shade only the surviving primitives — one texture
      fetch per contributing fragment

Exactness, matching the sequential OM semantics of om_unit.cpp:24-154:

  * the ds-word carry applies the full DepthTencil::test plus the masked ds
    write per primitive step, so the ds buffer after the draw is exact
  * blending off: the color word equals the LAST passing covered
    fragment's masked color write; pass 1 tracks that fragment's pid and
    its gradients (fused), pass 2 shades it once per pixel
  * blending on: every passing covered fragment contributes in submission
    order; pass 1 records each pixel's first K passing pids plus the count,
    pass 2 folds blend + masked write over the K slots, and the caller
    re-dispatches with a larger K on overflow

Face is hardwired front (draw3d/kernel.cpp:225 passes face=0).  Framebuffers
are (Hp, Wp) int32 tensors of u32 patterns, padded to tile multiples; a draw
returns new buffers and leaves its inputs untouched (the blend retry
re-renders from the same inputs).

Stages (utils.tracing, device-stream times recorded): ``raster.visibility``
around pass 1, ``raster.shade`` around pass 2 (interpolation, texture,
the blend fold and the masked merge), both inside ``raster.tiles``
(:func:`update_tiles`).  :class:`GraphedDraws` replays a frame's draws
captured as CUDA graphs, inside the same stages.
"""
from __future__ import annotations

import torch

from ..core.fixed import s32
from ..core.state import RenderState
from ..om import blend as blend_mod
from ..raster import edge as edge_mod
from ..raster import interp as interp_mod
from ..texture import sampler as sampler_mod
from ..utils.tracing import count, stage
from . import cuda_raster

FX24_ONE = 1 << 24

DEFAULT_BLEND_SLOTS = 4


def deferrable(render_state: RenderState) -> bool:
    """True when the single-winner (blend-off) pass 2 applies; blended
    draws take the slotted pass 2 (still deferred)."""
    return not render_state.om.blend.enabled


def _shade_pixels(render_state, texels, edges, attribs, win, xs, ys,
                  grads=None):
    """Pass 2: per-pixel shading of winners (win >= 0).

    Recomputes the winner's edge values and gradients, unless ``grads`` =
    (dx, dy) comes from the fused pass 1, and runs the exact
    interpolate/texture/modulate shader (draw3d/kernel.cpp:167-228) once
    per pixel.  Returns packed ARGB as int32 patterns.
    """
    flags = render_state.flags
    p = win.clamp(min=0).to(torch.int64)
    if grads is None:
        evals = edge_mod.eval_edges(edges[p], xs, ys)   # per-pixel gather
        dx, dy = interp_mod.gradients(evals)
    else:
        dx, dy = grads

    at = attribs[p]                                     # (..., 7, 3)

    def interp(idx):
        return interp_mod.interpolate(at[..., idx, :], dx, dy)

    if flags.color_enabled:
        r, g, b, a = interp(1), interp(2), interp(3), interp(4)
    else:
        r = g = b = a = torch.full_like(dx, FX24_ONE)

    if flags.tex_enabled:
        tex_color = sampler_mod.sample(render_state.tex, texels,
                                       interp(5) >> 1, interp(6) >> 1, lod=0)
        if flags.tex_modulate:
            return interp_mod.modulate(r, g, b, a, tex_color)
        return tex_color
    return interp_mod.to_rgba8(r, g, b, a)


def _merge_color(om, valid, color, dst):
    """Masked color write (om_unit.cpp:129-135) of one fragment layer."""
    cmask = s32(om.cbuf_writemask)
    merged = (dst & ~cmask) | (color & cmask)
    return torch.where(valid, merged, dst)


def visibility_pass(render_state, edges, zattr, tile_pids, tile_xy, sel_d,
                    tile_logsize, blend_slots=0):
    """Pass 1 over gathered tiles: (ds words, what pass 2 reads), the
    latter (winner, dx, dy) for an opaque draw and (slots, count) for a
    blended one."""
    dsw, *vis = cuda_raster.visibility_tiles(
        render_state, edges, zattr, tile_pids, tile_xy, sel_d, tile_logsize,
        fused=True, blend_slots=blend_slots)
    return dsw, vis


def shade_pass(render_state, texels, edges, attribs, tile_xy, vis, sel_c,
               tile_logsize, blend_slots=0):
    """Pass 2 over gathered tiles from pass 1's ``vis``: (colour tiles,
    max_frag_count as a device scalar; 0 unless blended)."""
    om = render_state.om
    if blend_slots == 0:
        win, dxw, dyw = vis
        color = _shade_pixels(render_state, texels, edges, attribs, win,
                              None, None, grads=(dxw, dyw))
        if om.color_write:
            sel_c = _merge_color(om, win >= 0, color, sel_c)
        return sel_c, torch.zeros((), dtype=torch.int32, device=sel_c.device)

    slots, cnt = vis
    xs, ys = cuda_raster.tile_grids(tile_xy, tile_logsize)
    # fold slots in submission order: blend reads the evolving destination
    # (om_unit.cpp:107-113), then the masked write
    for k in range(blend_slots):
        win_k = slots[:, k]
        color = _shade_pixels(render_state, texels, edges, attribs, win_k,
                              xs, ys)
        blended = blend_mod.blend(om.blend, color, sel_c)
        if om.color_write:
            sel_c = _merge_color(om, win_k >= 0, blended, sel_c)
    return sel_c, cnt.max()


def render_tiles_deferred(render_state, texels, edges, attribs, zattr,
                          tile_pids, tile_xy, sel_c, sel_d, tile_logsize,
                          blend_slots=0):
    """Both deferred passes over a set of gathered framebuffer tiles.

    sel_c, sel_d: (T, ts, ts) int32 tiles gathered at tile_xy.  Returns
    (out_c, out_d, max_frag_count as a device scalar; 0 unless blended).
    """
    with stage("raster.visibility", stream=True):
        dsw, vis = visibility_pass(render_state, edges, zattr, tile_pids,
                                   tile_xy, sel_d, tile_logsize, blend_slots)
    with stage("raster.shade", stream=True):
        sel_c, max_cnt = shade_pass(render_state, texels, edges, attribs,
                                    tile_xy, vis, sel_c, tile_logsize,
                                    blend_slots)
    return sel_c, dsw, max_cnt


def tiles_view(fb: torch.Tensor, tile_logsize: int) -> torch.Tensor:
    """(Hp, Wp) -> (gh, gw, ts, ts) view of the same storage."""
    ts = 1 << tile_logsize
    Hp, Wp = fb.shape
    return fb.view(Hp // ts, ts, Wp // ts, ts).permute(0, 2, 1, 3)


def gather_tiles(tile_xy, fb_color, fb_ds, tile_logsize):
    """Copies of both framebuffers and the binned tiles gathered from them:
    (fb_color, fb_ds, (ty, tx), sel_c, sel_d)."""
    at = (tile_xy[:, 1].to(torch.int64), tile_xy[:, 0].to(torch.int64))
    fb_color = fb_color.clone()
    fb_ds = fb_ds.clone()
    return (fb_color, fb_ds, at, tiles_view(fb_color, tile_logsize)[at],
            tiles_view(fb_ds, tile_logsize)[at])


def scatter_tiles(at, fb_color, fb_ds, out_c, out_d, tile_logsize):
    """Write the tiles back into the copies that gather_tiles made."""
    tiles_view(fb_color, tile_logsize)[at] = out_c
    tiles_view(fb_ds, tile_logsize)[at] = out_d


def update_tiles(fn, tile_xy, fb_color, fb_ds, tile_logsize):
    """Gather the binned tiles from copies of the framebuffers, run
    ``fn(sel_c, sel_d) -> (out_c, out_d, *extra)`` and scatter the result
    back.  Returns (fb_color, fb_ds, *extra).  The stage ``raster.tiles``
    spans the call: less the stages that ``fn`` opens, it is the clones,
    the gathers and the scatter."""
    with stage("raster.tiles", stream=True):
        fb_color, fb_ds, at, sel_c, sel_d = gather_tiles(
            tile_xy, fb_color, fb_ds, tile_logsize)
        out_c, out_d, *extra = fn(sel_c, sel_d)
        scatter_tiles(at, fb_color, fb_ds, out_c, out_d, tile_logsize)
    return (fb_color, fb_ds, *extra)


class GraphedDraws:
    """A frame's deferred draws on the card, captured once as CUDA graphs
    and replayed: the same kernels as render_arrays, one graph launch for
    each part of a draw in place of its thousands of plain-torch launches.

    ``draws``: (render_state, texels, dev_arrays, tile_logsize, blend_slots)
    in submission order, rendered from the buffers (fb_color, fb_ds), which
    stay as they are.  Each draw is four graphs, its gather, pass 1, pass 2
    and scatter, so that :meth:`replay` opens the stages of the eager draw
    around them and each device-stream span times its own part.  The
    graphs share one memory pool and are replayed in the order they were
    captured, so a tensor one graph writes is where the next reads it.
    Capture runs the draws' code once and launches nothing; the caller has
    run them once before, so nothing is loaded during capture.
    """

    def __init__(self, draws, fb_color, fb_ds):
        pool = torch.cuda.graph_pool_handle()
        self.parts = []

        def capture(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool):
                out = fn()
            return g, out

        for rs, texels, dev_arrays, tls, k in draws:
            edges, attribs, zattr, tile_pids, tile_xy = dev_arrays
            gather, (fb_color, fb_ds, at, sel_c, sel_d) = capture(
                lambda: gather_tiles(tile_xy, fb_color, fb_ds, tls))
            vis, (dsw, v) = capture(lambda: visibility_pass(
                rs, edges, zattr, tile_pids, tile_xy, sel_d, tls, k))
            shade, (out_c, _) = capture(lambda: shade_pass(
                rs, texels, edges, attribs, tile_xy, v, sel_c, tls, k))
            scatter, _ = capture(lambda: scatter_tiles(
                at, fb_color, fb_ds, out_c, dsw, tls))
            self.parts.append((gather, vis, shade, scatter, k))
        #: the last draw's colour buffer, which every replay rewrites
        self.fb_color = fb_color

    def replay(self) -> torch.Tensor:
        """Render the frame again; returns :attr:`fb_color`.  Counts kernel
        #1's launches and ``raster.blend_slots`` as the eager frame does."""
        for gather, vis, shade, scatter, k in self.parts:
            with stage("raster.tiles", stream=True):
                gather.replay()
                with stage("raster.visibility", stream=True):
                    vis.replay()
                    cuda_raster.count_launch()
                with stage("raster.shade", stream=True):
                    shade.replay()
                scatter.replay()
            if k:
                count("raster.blend_slots", k)
        return self.fb_color


def render_arrays(render_state, texels, dev_arrays, fb_color, fb_ds,
                  tile_logsize, blend_slots=0):
    """Deferred render of one draw from its device arrays
    (:func:`device_arrays`).  Returns (fb_color, fb_ds, max_frag_count)."""
    edges, attribs, zattr, tile_pids, tile_xy = dev_arrays
    return update_tiles(
        lambda sel_c, sel_d: render_tiles_deferred(
            render_state, texels, edges, attribs, zattr, tile_pids, tile_xy,
            sel_c, sel_d, tile_logsize, blend_slots=blend_slots),
        tile_xy, fb_color, fb_ds, tile_logsize)


def device_arrays(binned, device) -> tuple:
    """(edges, attribs, zattr, tile_pids, tile_xy) of a binned draw as int32
    tensors on `device`, uploaded once and cached on the binned object."""
    device = torch.device(device)
    cache = binned.__dict__.setdefault("_dev_arrays", {})
    key = str(device)
    if key not in cache:
        cache[key] = tuple(
            torch.from_numpy(a.astype("int32", copy=True)).to(device)
            for a in (binned.edges, binned.attribs, binned.attribs[:, 0],
                      binned.tile_pids, binned.tile_xy))
    return cache[key]


def _dummy_texels(device):
    return torch.zeros((1,), dtype=torch.int32, device=device)


def _next_pow2(n: int) -> int:
    k = 1
    while k < n:
        k *= 2
    return k


def render_drawcall(render_state: RenderState, texels, binned, fb_color,
                    fb_ds, info=None, blend_k=None, overflow_out=None):
    """Deferred render of one drawcall — exact for every OM state.

    Blended draws start at DEFAULT_BLEND_SLOTS per-pixel slots and
    re-dispatch with the measured count on overflow (one host sync of a
    scalar per blended draw).  ``info``, when a dict, receives ``blend_k``
    (the K that sufficed, 0 for opaque draws) and ``max_frag_count``.

    blend_k: a previously measured K for this draw (a frame-level cache).
    The draw dispatches once with it and, instead of syncing, appends
    ``(blend_k, max_cnt device scalar)`` to ``overflow_out`` for the caller
    to verify at frame end.  With blend_k set and overflow_out None the
    count is verified at once, falling back to the retry loop on overflow.
    """
    device = fb_color.device
    if texels is None:
        texels = _dummy_texels(device)
    arrays = device_arrays(binned, device)

    def run(k):
        return render_arrays(render_state, texels, arrays, fb_color, fb_ds,
                             binned.tile_logsize, blend_slots=k)

    return dispatch_blend_slots(run, render_state, binned.tile_pids.shape[1],
                                info, blend_k, overflow_out)


def dispatch_blend_slots(run, render_state: RenderState, max_k: int,
                         info=None, blend_k=None, overflow_out=None):
    """The blend-slot protocol of :func:`render_drawcall` around
    ``run(k) -> (fb_color, fb_ds, max_frag_count)``, which renders the draw
    with k slots (0: the opaque pass) from the same inputs every time;
    ``max_k`` is the draw's prims a tile, which no count exceeds.  Returns
    (fb_color, fb_ds)."""
    if deferrable(render_state):
        fbc, fbd, _ = run(0)
        if info is not None:
            info["blend_k"] = 0
        return fbc, fbd

    if blend_k is not None:
        k = min(max(int(blend_k), 1), max_k)
        fbc, fbd, max_cnt = run(k)
        if overflow_out is not None:
            overflow_out.append((k, max_cnt))   # verified at frame end
            if info is not None:
                info["blend_k"] = k
            return fbc, fbd
        m = int(max_cnt)
        if m <= k or k >= max_k:
            if info is not None:
                info["blend_k"] = k
                info["max_frag_count"] = m
            return fbc, fbd
        k = min(_next_pow2(m), max_k)           # stale hint: measure again
    else:
        k = DEFAULT_BLEND_SLOTS
    while True:
        fbc, fbd, max_cnt = run(min(k, max_k))
        m = int(max_cnt)
        if m <= k or k >= max_k:
            break
        k = min(_next_pow2(m), max_k)
    if info is not None:
        info["blend_k"] = min(k, max_k)
        info["max_frag_count"] = m
    return fbc, fbd


def measure_drawcall_counts(render_state: RenderState, binned,
                            fb_ds: torch.Tensor) -> dict:
    """Exact fragment counts of one drawcall against the current ds buffer
    (emulator.cpp:416-545 analog): ``fragments`` covered by the rasterizer
    and ``om_passing`` passing the ds test.  Replays pass 1's coverage and
    ds carry in plain torch ops."""
    device = fb_ds.device
    edges, _, zattr, tile_pids, tile_xy = device_arrays(binned, device)
    ty = tile_xy[:, 1].to(torch.int64)
    tx = tile_xy[:, 0].to(torch.int64)
    sel_d = tiles_view(fb_ds, binned.tile_logsize)[ty, tx]
    ncov = torch.zeros((), dtype=torch.int64, device=device)
    npass = torch.zeros((), dtype=torch.int64, device=device)
    for _, cov, contrib, _, _, _ in cuda_raster.prim_steps(
            render_state, edges, zattr, tile_pids, tile_xy, sel_d,
            binned.tile_logsize, need_grad=False):
        ncov += cov.sum()
        npass += contrib.sum()
    return {"fragments": int(ncov), "om_passing": int(npass)}
