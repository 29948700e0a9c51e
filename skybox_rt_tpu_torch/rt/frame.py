"""Whole-frame ray tracing of CGLTrace scenes (the config-3 path).

Counterpart of skybox_rt_tpu.rt.frame.  Replaces raster_bridge's per-draw
loop and its O(rays x prims) submission-order scan for translucent drawcalls
with one frame function whose per-draw work is fixed when the plan is built:

  * ``winner``: opaque drawcalls with an ordering-extreme depth func run the
    BVH-block closest-hit kernel once (ops.cuda_rt.closest_hit_bvh) and
    composite through the bridge's winner math;
  * ``kslot``: every other drawcall (blended, depth func
    ALWAYS/EQUAL/NOTEQUAL/NEVER, depth test off) runs the K-slot enumeration:
    K walks of ops.cuda_rt.closest_hit_bvh_after with the lexicographic
    (t, slot) carry collect every fragment along each ray (equal t included),
    the slots are sorted back to submission order (original prim id), and
    the output merger's carry (depth test -> depth write -> blend -> masked
    write) replays over the K slots;
  * ``scan``: such a drawcall with at most ``_SCAN_MAX_PRIMS`` triangles runs
    the bridge's exact scan instead of its own K-slot walks.

Overflow contract: a ``kslot`` draw with K < P runs one more walk, the probe;
a ray that still hits means fragments were dropped.  The probe counts leave
the frame as one device tensor, a value a probed draw, and are read back once
AFTER the frame; on overflow the draw's K doubles (the hint is kept per trace
and draw, so steady-state rendering never overflows) and the frame is built
again.

The frame function is eager torch.  What the plan fixes: every branch on
draw state is a Python branch taken from the plan, every array is on the
device before the first frame, and nothing between the first and the last
draw of a frame waits for the device or copies from the host
(``torch.cuda.set_sync_debug_mode("error")`` passes around a frame call).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import constants as C
from ..core.device import resolve_device
from ..ops import cuda_rt
from . import raster_bridge as rb

F32 = torch.float32
I32 = torch.int32

_EXTREME_FUNCS = (C.CGL_COMPARE_LESS, C.CGL_COMPARE_LEQUAL,
                  C.CGL_COMPARE_GREATER, C.CGL_COMPARE_GEQUAL)
#: Starting slot count of a K-slot draw with no measured hint: the probe walk
#: and the doubling retry find the scene's true per-ray fragment ceiling in
#: at most log2 renders, kept per trace.  The JAX package's value: it defines
#: the same plan in both packages and has not been tuned for the card.
_DEFAULT_K = 1
#: Blended / ordering-free draws at or below this many triangles run the
#: exact submission-order scan in place of K-slot walks.  The JAX package's
#: value, kept because it defines the same plan in both packages; it has not
#: been tuned for the card (scripts/torch_rt_profile.py --scene config3
#: --scan-max-prims measures other cutoffs).
_SCAN_MAX_PRIMS = 2
_BIG_PRIM = 2 ** 30

# (trace id, draw index) -> measured slot count K
_K_HINTS: dict = {}
# (trace id, device, w, h, start, end, k tuple, ...) -> (frame, arrays, rays,
# metas); bounded, first in first out
_FRAME_CACHE: dict = {}
_FRAME_CACHE_SIZE = 16


def _trace_key(trace):
    return id(trace)


def _build_plan(trace, width: int, height: int, start_draw: int,
                end_draw: int, on_stencil: str, k_hints, device):
    """Host-side preparation: per draw its statics (the bridge's
    _scan_statics), its mode and K, its arrays on ``device`` and, unless it
    scans, its BVH blocks."""
    plan = []
    for di, dc in enumerate(trace.drawcalls[start_draw:end_draw]):
        st = dc.states
        if rb.stencil_guard(st, on_stencil, "rt.frame"):
            continue
        geo = rb._screen_triangles(dc, width, height)
        if geo is None:
            continue
        statics = rb._scan_statics(st, dc)
        idx = np.asarray(geo["indices"])
        clip = np.asarray(geo["clip"], np.float32)
        tri = rb._persp_tris(geo)                       # (P,3,3) x,y,w
        P = tri.shape[0]

        winner = (not st.blend_enabled and st.depth_test
                  and st.depth_func in _EXTREME_FUNCS)
        scan = (not winner) and P <= _SCAN_MAX_PRIMS
        farthest = st.depth_func in (C.CGL_COMPARE_GREATER,
                                     C.CGL_COMPARE_GEQUAL)
        if winner or scan:
            k = 1
        else:
            k = k_hints.get(di, min(_DEFAULT_K, P))
            k = min(max(int(k), 1), P)

        def up(a, dtype=np.float32):
            return torch.as_tensor(np.ascontiguousarray(a, dtype),
                                   device=device)

        if scan:
            arrays = rb._scan_arrays(geo, st, dc, trace, device)
        else:
            arrays = {
                "img": rb._texture_image(trace, dc, st, device),
                "chan": rb._channel_mask(statics[11], device),
                "blocks": rb._engine_prep(tri, "pallas_bvh",
                                          device)["blocks"],
            }
            if winner:
                arrays.update(idx=up(idx, np.int32), zattr=up(clip[:, 2:4]),
                              colattr=up(geo["color"]),
                              uvattr=up(geo["uv"]))
            else:
                # one row a triangle, [z w | r g b a | u v] a corner: a slot
                # of the replay costs one row gather a ray
                arrays["rec"] = up(np.concatenate(
                    [clip[idx][:, :, 2:4],
                     np.asarray(geo["color"], np.float32)[idx],
                     np.asarray(geo["uv"], np.float32)[idx]], -1))
        meta = {
            "draw_index": di,
            "statics": statics,
            "mode": ("winner" if winner else "scan" if scan else "kslot"),
            "farthest": bool(farthest),
            "far_d": float(tri[..., 2].max()) + 1.0,
            "K": k,
            "P": P,
        }
        plan.append((meta, arrays))
    return plan


def _sort_slots_by_prim(slots):
    """The K (prim, t, u, v) slots of every ray sorted by ORIGINAL prim id
    (submission order), misses last: one stable sort of the (R, K) keys and
    a gather of each field, for any K."""
    if len(slots) == 1:
        return list(slots)
    prim, t, u, v = (torch.stack(f, dim=1) for f in zip(*slots))   # (R, K)
    key = torch.where(prim < 0, _BIG_PRIM, prim)
    order = torch.sort(key, dim=1, stable=True).indices
    prim, t, u, v = (f.gather(1, order) for f in (prim, t, u, v))
    return [(prim[:, k], t[:, k], u[:, k], v[:, k])
            for k in range(len(slots))]


def _om_replay(meta, arr, slots, zbuf, color):
    """Replay the output merger's fragment carry over the
    submission-ordered slots: the math of the bridge's scan step (z from
    clip z/w, texture combine, depth test/write, blend, masked write)."""
    statics = meta["statics"]
    (texture_enabled, envmode, repeat, bilinear, color_enabled,
     _, _, _, _, _, _, _, near, far) = statics
    for prim, t, u, v in slots:
        rec = arr["rec"][prim.clamp(min=0).long()]            # (R, 3, 8)
        w = rb._bary_weights(u, v)
        z = rb._viewport_z(rb._weighted(rec[..., 0:2], w), near, far)
        if color_enabled:
            src = rb._weighted(rec[..., 2:6], w)
        else:
            src = torch.ones((prim.shape[0], 4), dtype=F32,
                             device=prim.device)
        if texture_enabled:
            uvp = rb._weighted(rec[..., 6:8], w)
            texel = rb._sample_texture_wrap(arr["img"], uvp[:, 0], uvp[:, 1],
                                            repeat, bilinear)
            src = rb._texture_combine(envmode, src, texel)
        zbuf, color = rb._om_write(statics, arr["chan"], prim >= 0, z, src,
                                   zbuf, color)
    return zbuf, color


def make_frame_fn(trace, width: int, height: int, *, start_draw: int = 0,
                  end_draw: int = 2 ** 31, on_stencil: str = "raise",
                  device=None):
    """Build the frame function for one trace on ``device`` (None: the CUDA
    card).

    Returns (frame, arrays, rays, metas): frame(arrays, nx, ny) -> (zbuf
    (R,), color (R, 4), overflow) with everything on the device; overflow is
    a (probed draws,) int32 tensor of the rays whose fragments exceeded K
    (read it AFTER the frame; module docstring).  The plan, its arrays and
    the draws' BVH blocks are cached, so a second call for the same trace,
    size and K hints builds nothing."""
    device = resolve_device(device)
    tkey = _trace_key(trace)
    hints = {di: k for (tk, di), k in _K_HINTS.items() if tk == tkey}
    end_draw = min(end_draw, 2 ** 31)
    # the key names every input of the plan; the K of a draw is its hint
    # clipped to its triangle count, so the hints stand for the Ks
    ckey = (tkey, str(device), width, height, start_draw, end_draw,
            tuple(sorted(hints.items())), on_stencil, _SCAN_MAX_PRIMS,
            _DEFAULT_K)
    cached = _FRAME_CACHE.get(ckey)
    if cached is not None:
        return cached
    plan = _build_plan(trace, width, height, start_draw, end_draw,
                       on_stencil, hints, device)
    metas = [m for m, _ in plan]

    @torch.no_grad()
    def frame(arrays, nx, ny):
        R = nx.shape[0]
        dev = nx.device
        dirs = torch.stack([nx, ny, torch.ones_like(nx)], -1)
        eye = torch.zeros_like(dirs)
        zbuf, color = rb.clear_buffers(R, dev)
        overflow = []

        for meta, arr in zip(metas, arrays):
            if meta["mode"] == "scan":
                zbuf, color = rb._scan_run(meta["statics"], arr, nx, ny,
                                           zbuf, color)
                continue
            blocks = arr["blocks"]
            if meta["mode"] == "winner":
                if meta["farthest"]:
                    o, d = dirs * meta["far_d"], -dirs
                else:
                    o, d = eye, dirs
                prim, _, u, v = cuda_rt.closest_hit_bvh(o, d, blocks,
                                                        t_min=1e-6)
                zbuf, color = rb._winner_composite(
                    meta["statics"], True, arr["chan"], arr["idx"], None,
                    arr["zattr"], arr["colattr"], arr["uvattr"], arr["img"],
                    prim, u, v, zbuf, color)
                continue

            # K-slot enumeration: K walks, and the probe when K < P
            K, P = meta["K"], meta["P"]
            tlo = torch.full((R,), -math.inf, dtype=F32, device=dev)
            slo = torch.full((R,), -1, dtype=I32, device=dev)
            slots = []
            for k in range(K + (1 if K < P else 0)):
                slot, prim, t, u, v = cuda_rt.closest_hit_bvh_after(
                    eye, dirs, blocks, tlo, slo, t_min=1e-6)
                if k < K:
                    slots.append((prim, t, u, v))
                else:
                    overflow.append((prim >= 0).sum().to(I32))
                tlo, slo = t, slot
            zbuf, color = _om_replay(meta, arr, _sort_slots_by_prim(slots),
                                     zbuf, color)

        ovf = (torch.stack(overflow) if overflow
               else torch.zeros((0,), dtype=I32, device=dev))
        return zbuf, color, ovf

    _, _, nx, ny = rb.pixel_rays(width, height, device)
    out = (frame, [a for _, a in plan], (nx, ny), metas)
    while len(_FRAME_CACHE) >= _FRAME_CACHE_SIZE:   # evict the oldest
        _FRAME_CACHE.pop(next(iter(_FRAME_CACHE)))
    _FRAME_CACHE[ckey] = out
    return out


def probed_draws(metas):
    """The metas of the draws that run a probe walk, in the order of the
    frame's overflow tensor."""
    return [m for m in metas if m["mode"] == "kslot" and m["K"] < m["P"]]


def render_trace_rt_fused(trace, width: int, height: int, *,
                          start_draw: int = 0, end_draw: int = 2 ** 31,
                          on_stencil: str = "raise", device=None) -> np.ndarray:
    """Render a CGLTrace through the frame function, with the overflow
    retry: K doubles for every draw whose probe fired, at most 8 rounds.
    Returns (H, W, 4) float32 numpy RGBA, row 0 = top."""
    tkey = _trace_key(trace)
    for _ in range(8):
        frame, arrays, rays, metas = make_frame_fn(
            trace, width, height, start_draw=start_draw, end_draw=end_draw,
            on_stencil=on_stencil, device=device)
        _, color, ovf = frame(arrays, *rays)
        ovf = ovf.cpu().numpy()                     # the one readback
        if not ovf.any():
            break
        for m, n in zip(probed_draws(metas), ovf):
            if n > 0:
                _K_HINTS[(tkey, m["draw_index"])] = min(2 * m["K"], m["P"])
    else:
        raise RuntimeError("rt.frame: K-slot overflow did not converge")
    return color.reshape(height, width, 4).cpu().numpy()


def fragment_margins(trace, width: int, height: int, *, start_draw: int = 0,
                     end_draw: int = 2 ** 31, on_stencil: str = "raise",
                     device=None) -> np.ndarray:
    """How close each pixel's fragments come to a discrete decision: (H, W)
    float32 numpy, per pixel the least, over the fragments the frame finds
    there (the winner of a ``winner`` draw, the K slots of a ``kslot`` draw,
    the triangles of a ``scan`` draw), of the barycentric edge distance
    min(u, v, 1 - u - v) and of the gap |t - t'| to the draw's next fragment
    on the ray; +inf where a pixel has no fragment.  A pixel under 1e-4 is a
    graze or a tie: another float implementation may find a fragment more or
    fewer there, or the tied pair in the other order.  Run it after the K
    hints have converged."""
    frame, arrays, (nx, ny), metas = make_frame_fn(
        trace, width, height, start_draw=start_draw, end_draw=end_draw,
        on_stencil=on_stencil, device=device)
    dirs = torch.stack([nx, ny, torch.ones_like(nx)], -1)
    eye = torch.zeros_like(dirs)
    R, dev = nx.shape[0], nx.device
    inf = torch.full((R,), math.inf, dtype=F32, device=dev)
    margin = inf.clone()

    def edge(prim, u, v):
        e = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        return torch.where(prim >= 0, e, inf)

    for meta, arr in zip(metas, arrays):
        if meta["mode"] == "scan":
            from . import intersect
            hit, _, u, v = intersect.moller_trumbore(
                eye[:, None], dirs[:, None], arr["v0"][None], arr["e1"][None],
                arr["e2"][None], t_min=-math.inf)
            e = torch.minimum(torch.minimum(u, v), 1.0 - u - v).abs()
            margin = torch.minimum(margin, e.amin(dim=1))
            continue
        if meta["mode"] == "winner":
            o, d = ((dirs * meta["far_d"], -dirs) if meta["farthest"]
                    else (eye, dirs))
            prim, _, u, v = cuda_rt.closest_hit_bvh(o, d, arr["blocks"],
                                                    t_min=1e-6)
            margin = torch.minimum(margin, edge(prim, u, v))
            continue
        tlo = torch.full((R,), -math.inf, dtype=F32, device=dev)
        slo = torch.full((R,), -1, dtype=I32, device=dev)
        for _ in range(meta["K"]):
            slot, prim, t, u, v = cuda_rt.closest_hit_bvh_after(
                eye, dirs, arr["blocks"], tlo, slo, t_min=1e-6)
            gap = torch.where((prim >= 0) & torch.isfinite(tlo), t - tlo, inf)
            margin = torch.minimum(margin,
                                   torch.minimum(edge(prim, u, v), gap))
            tlo, slo = t, slot
    return margin.reshape(height, width).cpu().numpy()
