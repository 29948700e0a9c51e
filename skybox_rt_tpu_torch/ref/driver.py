"""Frame driver: the host render loop (draw3d/main.cpp:171-390 analog).

Counterpart of skybox_rt_tpu.ref.driver.  Walks a CGLTrace's drawcalls,
bins each one, resolves the per-draw RenderState (with the reference host's
DCR programming quirks, core/state.py) and renders it on ``device``.  The
color and ds buffers persist across drawcalls, like the reference's
device-resident zbuf/cbuf (main.cpp:470-490 allocate-once + clear).

Modes: "immediate" (the ref.renderer oracle, the default as in the JAX
package), "deferred" (ops.deferred, whose pass 1 is the CUDA visibility
kernel on a card) and "pallas", the JAX package's name for deferred with its
Pallas pass 1: here the same path as "deferred", which launches the CUDA
kernel for CUDA tensors and runs its plain version for CPU tensors.
"pallas_interpret" (JAX: the Pallas interpreter) has no counterpart and is
refused; the plain version runs with device="cpu".  Results leave as numpy
uint32 (H, W) ARGB.

:func:`compile_frame_loop` is the device-wall measurement protocol: N
frames, each data-dependent on the one before through
``FRAME_LOOP_SENTINEL``, timed at two loop lengths (bench_torch.py).

Stages (utils.tracing): every frame that :func:`render_trace`,
:func:`compile_frame` and :func:`compile_frame_loop` render is one
``raster.frame`` (a frame stage); the set-up they share is
``raster.prepare`` with ``.bin``, ``.upload`` and ``.blend_k``, and
``.capture`` where compile_frame captures the draws as CUDA graphs.  The
counter ``raster.blend_slots`` adds each blended draw's K in every frame.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import constants as C
from ..core import fixed
from ..core import state as state_mod
from ..core.device import resolve_device
from ..geom import binning, cgltrace
from ..ops import deferred as deferred_mod
from ..runtime import perf as perf_mod
from ..texture import sampler as sampler_mod
from ..texture.mipmap import generate_mipmaps
from ..utils.tracing import count, stage
from . import renderer

CLEAR_COLOR = np.uint32(0xFF000000)   # main.cpp:47
CLEAR_DEPTH = np.uint32(0xFFFFFFFF)   # main.cpp:48
MODES = ("immediate", "deferred", "pallas")
# modes whose draws go through ops.deferred
DEFERRED_MODES = ("deferred", "pallas")


def _check_mode(mode: str) -> None:
    if mode == "pallas_interpret":
        raise ValueError(
            'mode "pallas_interpret" names the JAX package\'s Pallas '
            'interpreter, which the port has not: mode="pallas" with '
            'device="cpu" runs the kernel\'s plain version')
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")


def log2ceil(x: int) -> int:
    return max(int(math.ceil(math.log2(x))), 0) if x > 1 else 0


@dataclasses.dataclass
class FrameStats:
    drawcalls: int = 0
    prims_binned: int = 0
    tiles: int = 0
    # analytic per-unit traffic (runtime.perf.drawcall_traffic, the
    # raster/tex/om MPM-counter analog), summed over draws
    traffic: dict = dataclasses.field(default_factory=dict)

    def add_traffic(self, t: dict):
        for k, v in t.items():
            self.traffic[k] = self.traffic.get(k, 0) + v


def make_texture_binding(trace: cgltrace.CGLTrace, drawcall, states,
                         device=None) -> tuple:
    """Resolve the TEX DCR block for a drawcall (main.cpp:286-331),
    reproducing the host's quirks: the filter checks magfilter twice and
    wrap V uses addressU (main.cpp:304-308).  Returns (TextureState, int32
    texel table on ``device``); the table is the 2x2 quad layout wherever
    sampler.quad_supported holds, as in the JAX package's default."""
    texture = trace.textures[drawcall.texture_id]
    vx_format = C.CGL_TO_VX_FORMAT[texture.format]
    mip_chain, mip_offsets = generate_mipmaps(
        texture.pixels, vx_format, texture.width, texture.height)
    tex_filter = (states.texture_magfilter != C.CGL_FILTER_NEAREST)
    wrap_u = (C.TEX_WRAP_REPEAT if states.texture_addressU == C.CGL_ADDRESS_WRAP
              else C.TEX_WRAP_CLAMP)
    wrap_v = wrap_u  # host quirk: V uses addressU too (main.cpp:308)
    tex_state = sampler_mod.TextureState(
        format=vx_format,
        log_width=log2ceil(texture.width),
        log_height=log2ceil(texture.height),
        filter=(C.TEX_FILTER_BILINEAR if tex_filter else C.TEX_FILTER_POINT),
        wrap_u=wrap_u,
        wrap_v=wrap_v,
        mip_offsets=tuple(mip_offsets),
    )
    texels = sampler_mod.make_texel_array(vx_format, mip_chain)
    if sampler_mod.quad_supported(tex_state):
        # one fetch per bilinear sample instead of four (exact)
        texels = sampler_mod.make_texel_quad_array(tex_state, texels)
        tex_state = dataclasses.replace(tex_state, quad=True)
    return tex_state, fixed.from_numpy_u32(texels, device=device)


def _resolve_draw(trace, dc, width, height, tile_logsize, device):
    """Bin one drawcall and resolve its state: (RenderState, texels or
    None, BinnedDrawcall), or None when no primitive survives binning."""
    binned = binning.bin_drawcall(
        dc.pos, dc.indices, dc.color, dc.texcoord,
        width, height, dc.near, dc.far, tile_logsize)
    if binned is None:
        return None
    flags = state_mod.make_shader_flags(
        dc.states.depth_test, dc.states.color_enabled,
        dc.states.texture_enabled, dc.states.texture_envmode)
    om_state = state_mod.make_om_state(dc.states)
    tex_state, texels = None, None
    if dc.states.texture_enabled:
        tex_state, texels = make_texture_binding(trace, dc, dc.states,
                                                 device=device)
    render_state = state_mod.RenderState(
        flags=flags, om=om_state, tex=tex_state,
        scissor=(0, 0, width, height))  # main.cpp:220-221
    return render_state, texels, binned


def clear_framebuffers(width, height, tile_logsize, device):
    """Cleared (color, ds) buffers padded to tile multiples, on device."""
    fbs = []
    for v in (CLEAR_COLOR, CLEAR_DEPTH):
        fb = renderer.pad_framebuffer(np.full((height, width), v, np.uint32),
                                      tile_logsize)
        fbs.append(fixed.from_numpy_u32(fb, device=device))
    return tuple(fbs)


def render_trace(trace: cgltrace.CGLTrace, width: int, height: int,
                 tile_logsize: int = C.RASTER_TILE_LOGSIZE,
                 start_draw: int = 0, end_draw: int = 2**31,
                 stats: FrameStats | None = None,
                 mode: str = "immediate", measure_traffic: bool = False,
                 device=None) -> np.ndarray:
    """Render a full trace on ``device`` (None: the CUDA card, see
    core.device); returns the (H, W) uint32 ARGB framebuffer.

    mode: "immediate", "deferred" or "pallas" (the same path as "deferred":
    kernel #1 for CUDA tensors, its plain version for CPU tensors); see the
    module docstring.
    stats: a FrameStats that gains each rendered draw's counts and its
    runtime.perf.drawcall_traffic.  measure_traffic: with stats, run the
    exact fragment-counting pass per draw against the live ds buffer
    (ops.deferred.measure_drawcall_counts, which reads its counts back) so
    stats.traffic carries MEASURED tex/OM traffic instead of the
    coverage-area upper bound.

    Blended-draw slot counts are measured on the first render of a (trace,
    size) and cached on the trace object; later frames dispatch with the
    cached K and verify the overflow counters only at frame end, where the
    framebuffer readback has already paid the device sync.
    """
    _check_mode(mode)
    device = resolve_device(device)
    while True:
        with stage("raster.frame", frame=True):
            out, stale = _render_trace_once(
                trace, width, height, tile_logsize, start_draw, end_draw,
                stats, mode, measure_traffic, device)
        if not stale:
            return out
        # the trace changed under a cached K: measure again (the draws
        # are counted once, as in the JAX package)
        trace._blend_k_cache.pop((width, height, tile_logsize), None)
        stats = None


def _render_trace_once(trace, width, height, tile_logsize, start_draw,
                       end_draw, stats, mode, measure_traffic, device):
    """One frame of :func:`render_trace`: (framebuffer, whether a cached
    blend K overflowed)."""
    deferred_mode = mode in DEFERRED_MODES
    if deferred_mode:
        cache = trace.__dict__.setdefault("_blend_k_cache", {})
        ks = cache.setdefault((width, height, tile_logsize), {})
        pending = []
    fbc, fbd = clear_framebuffers(width, height, tile_logsize, device)

    for d, dc in enumerate(trace.drawcalls):
        if d < start_draw or d > end_draw:
            continue
        resolved = _resolve_draw(trace, dc, width, height, tile_logsize,
                                 device)
        if resolved is None:
            continue
        render_state, texels, binned = resolved
        counts = None
        if stats is not None and measure_traffic:
            counts = deferred_mod.measure_drawcall_counts(render_state,
                                                          binned, fbd)
        if deferred_mode:
            info = {}
            hint = ks.get(d)
            fbc, fbd = deferred_mod.render_drawcall(
                render_state, texels, binned, fbc, fbd, info=info,
                blend_k=hint or None, overflow_out=pending if hint else None)
            ks[d] = info["blend_k"]
            if ks[d]:
                count("raster.blend_slots", ks[d])
        else:
            fbc, fbd = renderer.render_drawcall(render_state, texels, binned,
                                                fbc, fbd)
        if stats is not None:
            stats.drawcalls += 1
            stats.prims_binned += binned.num_prims
            stats.tiles += binned.num_tiles
            stats.add_traffic(perf_mod.drawcall_traffic(
                binned, render_state, counts=counts))

    out = fixed.to_numpy_u32(fbc[:height, :width])
    return out, deferred_mode and any(int(mc) > k for k, mc in pending)


def render_scene(name: str, width: int, height: int, **kw) -> np.ndarray:
    """Render one of the package's traces by name (geom.cgltrace.trace_path,
    read through load_cached); ``kw`` goes to :func:`render_trace`."""
    trace = cgltrace.load_cached(cgltrace.trace_path(name))
    return render_trace(trace, width, height, **kw)


def prepare_drawcalls(trace: cgltrace.CGLTrace, width: int, height: int,
                      tile_logsize: int = C.RASTER_TILE_LOGSIZE,
                      device=None):
    """Host-side frame setup: bin every drawcall and resolve its state.
    Returns a list of (RenderState, texels, BinnedDrawcall), texels on
    ``device`` (None: the CUDA card; a 1-element dummy for untextured
    draws)."""
    device = resolve_device(device)
    draws = []
    for dc in trace.drawcalls:
        resolved = _resolve_draw(trace, dc, width, height, tile_logsize,
                                 device)
        if resolved is None:
            continue
        rs, texels, binned = resolved
        if texels is None:
            texels = torch.zeros((1,), dtype=torch.int32, device=device)
        draws.append((rs, texels, binned))
    return draws


def _frame_setup(trace, width, height, tile_logsize, mode, device,
                 capture=False):
    """What compile_frame and compile_frame_loop share: the draws binned
    once, their arrays uploaded once, and blended draws' slot counts
    measured once with one deferred frame (exact: every call starts from
    the same cleared buffers and inputs).  Returns (render, arrays,
    cleared, graphed): render(arrays, fbc, fbd) -> (fbc, fbd) runs every
    draw on the device, without syncing; ``graphed``, with ``capture`` in
    a deferred mode on the card, the draws captured from ``arrays`` and
    the cleared buffers (ops.deferred.GraphedDraws), else None."""
    _check_mode(mode)
    device = resolve_device(device)
    deferred = mode in DEFERRED_MODES
    graphed = None
    with stage("raster.prepare", mode=mode, width=width, height=height):
        with stage("raster.prepare.bin", draws=len(trace.drawcalls)):
            draws = prepare_drawcalls(trace, width, height, tile_logsize,
                                      device)
        with stage("raster.prepare.upload"):
            arrays = tuple((texels, deferred_mod.device_arrays(b, device))
                           for _, texels, b in draws)
            # draws write into copies (ops.deferred.update_tiles), so the
            # cleared buffers are made once and reused by every frame
            cleared = clear_framebuffers(width, height, tile_logsize, device)
        blend_ks = [0] * len(draws)
        if deferred:
            with stage("raster.prepare.blend_k"):
                fbc, fbd = cleared
                for d, (rs, texels, b) in enumerate(draws):
                    info = {}
                    fbc, fbd = deferred_mod.render_drawcall(
                        rs, texels, b, fbc, fbd, info=info)
                    blend_ks[d] = info["blend_k"]
        statics = [(rs, b.tile_logsize, k)
                   for (rs, _, b), k in zip(draws, blend_ks)]
        if capture and deferred and device.type == "cuda":
            with stage("raster.prepare.capture"):
                graphed = deferred_mod.GraphedDraws(
                    [(rs, texels, dev_arrays, tls, k) for (rs, tls, k),
                     (texels, dev_arrays) in zip(statics, arrays)],
                    *cleared)

    def render(arrays, fbc, fbd):
        for (rs, tls, k), (texels, dev_arrays) in zip(statics, arrays):
            if deferred:
                fbc, fbd, _ = deferred_mod.render_arrays(
                    rs, texels, dev_arrays, fbc, fbd, tls, blend_slots=k)
                if k:
                    count("raster.blend_slots", k)
            else:
                fbc, fbd = renderer.render_arrays(rs, texels, dev_arrays,
                                                  fbc, fbd, tls)
        return fbc, fbd

    return render, arrays, cleared, graphed


def compile_frame(trace: cgltrace.CGLTrace, width: int, height: int,
                  tile_logsize: int = C.RASTER_TILE_LOGSIZE,
                  mode: str = "immediate", device=None):
    """Prepare a whole frame once, for repeated rendering on ``device``
    (None: the CUDA card).  mode: as in :func:`render_trace`, "immediate"
    by default as in the JAX package.

    Draws are binned once, their arrays uploaded once, and blended draws'
    slot counts measured once with one deferred frame (exact: every call
    starts from the same cleared buffers and inputs).  Returns
    ``(frame, arrays)``; ``frame(arrays)`` renders all draws on the device
    and returns the (H, W) int32 ARGB-pattern tensor, without syncing.
    In a deferred mode on the card the draws are captured as CUDA graphs
    (ops.deferred.GraphedDraws, ``raster.prepare.capture``) and
    ``frame(arrays)`` with the returned ``arrays`` replays them and
    returns a copy of the result, a tensor of its own; other arrays render
    eagerly.
    """
    render, arrays, cleared, graphed = _frame_setup(
        trace, width, height, tile_logsize, mode, device, capture=True)
    captured = arrays

    def frame(arrays):
        with stage("raster.frame", frame=True):
            if graphed is not None and arrays is captured:
                return graphed.replay()[:height, :width].clone()
            fbc, _ = render(arrays, *cleared)
        return fbc[:height, :width]

    return frame, arrays


FRAME_LOOP_SENTINEL = np.uint32(0xDEADBEEF)


def shift_arrays(dev_arrays: tuple, z: torch.Tensor) -> tuple:
    """One draw's ``ops.deferred.device_arrays`` with the frame loop's carry
    ``z`` added to its edges, attribs, zattr and tile_pids (the first four);
    with z = 0 the draw renders as before, but it waits for z."""
    return tuple(a + z for a in dev_arrays[:4]) + dev_arrays[4:]


def compile_frame_loop(trace: cgltrace.CGLTrace, width: int, height: int,
                       frames: int,
                       tile_logsize: int = C.RASTER_TILE_LOGSIZE,
                       mode: str = "deferred", device=None):
    """An N-frame render loop whose frames cannot be skipped or merged —
    the device-wall measurement protocol.

    Frame n+1 data-depends on frame n: its two clear buffers are XORed,
    and every draw's edges, attribs, zattr and tile_pids are added, with
    z = the count of pixels of frame n equal to FRAME_LOOP_SENTINEL (frame
    1 counts them in the cleared color buffer).  The scene never renders
    that color (the caller checks the final frame), so z is 0 and every
    frame equals compile_frame's, but each frame's launches wait for the
    one before.  z stays a device tensor: the loop reads nothing back, and
    syncs nowhere that compile_frame's frame does not.  Its launches above
    ``frames`` x a frame: a compare and a sum, 2 XORs and 4 adds a draw,
    each frame.  Timing two loop lengths and taking the difference
    quotient cancels the launch and sync overhead of a call (the
    reference's in-window elapsed-cycles protocol,
    tests/regression/draw3d/main.cpp:349-378).  Setup is compile_frame's;
    mode="pallas" (and "deferred") launch kernel #1 for CUDA tensors.

    Returns (loop_fn, arrays): loop_fn(arrays) -> the final (H, W) int32
    ARGB-pattern tensor, as compile_frame's frame returns it.
    """
    render, arrays, (clear_c, clear_d), _ = _frame_setup(
        trace, width, height, tile_logsize, mode, device)
    sentinel = fixed.s32(int(FRAME_LOOP_SENTINEL))

    def loop(arrays):
        fb = clear_c
        for _ in range(frames):
            with stage("raster.frame", frame=True):
                z = (fb == sentinel).sum(dtype=torch.int32)
                shifted = tuple((texels, shift_arrays(dev_arrays, z))
                                for texels, dev_arrays in arrays)
                fb, _ = render(shifted, clear_c ^ z, clear_d ^ z)
        return fb[:height, :width]

    return loop, arrays
