"""Drive the PyTorch port's five paths on one CUDA card and check them: the
exact-int draw3d raster frame, the ray-traced frame of the large scene, the
ray-traced frame of the small scene, the training step of the differentiable
render, and the ray-traced CGLTrace frame (config 3), with the two comparison
engines of the ray tracer beside it.

    python3 chip_smoke.py

Phases, each printed on its own line; any mismatch raises, so the script
exits non-zero, and only a run where every phase passed prints the final
``{"ok": true, ...}`` line:

  1. device  — needs torch.cuda; prints nvidia-smi's name and power limit
  2. build   — compiles skybox_rt_tpu_torch/csrc/*.cu with nvcc (sm_90a),
               one nvcc per source at the same time
  3. kernel  — the CUDA visibility kernel against its plain torch version,
               bit for bit: every draw of the synthetic trace at 256x256,
               fused and K-slot, tile_logsize 3..6, stencil/depth OM
               variants over seeded ds words, and the textured draw at
               1024x1024
  4. frame   — the 256x256 frame through render_trace and compile_frame,
               bit-equal to the JAX package's committed framebuffer and to
               the port's immediate oracle on the card; the kernel's launch
               count on that run is checked
  5. draw1024 — the textured draw alone at 1024x1024 against its
               committed sha256
  6. timing  — CUDA events, median of 20 after warm-up: kernel vs plain
               pass 1 at 256x256 and 1024x1024, and the whole 256x256 frame
  7. rt_kernel_vs_plain — the closest-hit and any-hit BVH kernels against
               their plain torch versions: the small check scenes whole,
               then the 184,832-triangle sphere field on 65,536 rays of
               each of the six launches of the real 1024x1024 frame
               (primary, bounce 1, bounce 2, each with its shadow launch;
               bounce launches hold parked rays), captured from the port's
               trace_rays, and on the whole primary and primary-shadow
               launches.  prim, miss mask and occlusion must be equal;
               t, u, v may differ by rtol 1e-6 at most (bit equality is
               expected; the count of rays that are not is printed)
  8. rt_frame_256 — make_frame_fn at 256x256, 2 bounces, shadows, on the
               default device against the committed JAX golden
               (data/rt_northstar_256.npz, rendered from the same rays):
               atol 1e-4 and >= 99.9 % of values within 2e-5; 3 + 3 launches
  9. rt_frame_1024 — the full-width frame, 1,048,576 rays: finite, alpha 1,
               primary hit mask equal to the plain version's on a 65,536-ray
               sample, 3 + 3 launches (the counts are set to 0 just before
               and read just after)
 10. rt_timing — CUDA events, median of 20: each of the six launches'
               kernels alone, the plain versions on the samples, the whole
               1024x1024 frame; host seconds of the BVH build and the block
               preparation (printed, not judged)

  11. rt_clustered_vs_plain — the clustered closest-hit, clustered any-hit
               and flat closest-hit kernels against their plain torch
               versions, bit for bit (``rays_differ`` must be 0): the small
               check scenes whole (and one with more clusters than the
               shared-memory stage holds), then the 12,032-triangle sphere
               field on 65,536 rays of each of the six launches of its real
               1024x1024 frame, and on the whole primary and primary-shadow
               launches.  On the same rays the clustered kernels against the
               flat one: occlusion and miss masks equal, every output equal
               where the prims agree, t within rtol 1e-5 where they do not
               (ties across clusters, under 1 % of the hits)
 12. rt_small_frame_256 — make_frame_fn with the default engine at 256x256,
               2 bounces, shadows, plain and textured, against the committed
               JAX golden (data/rt_small_256.npz): atol 1e-4 and >= 99.9 % of
               values within 2e-5; 3 + 3 launches each
 13. rt_small_frame_1024 — the full-width small-scene frame, 1,048,576 rays:
               finite, alpha 1, hit fraction and mean RGB equal to the 256x256
               frame's to 3 digits, primary hit mask equal to the flat
               kernel's on a 65,536-ray sample.  The counts are set to 0
               just before the frame and read just after it: 3 + 3 clustered
               launches and no other; the flat kernel's 1 launch that follows
               is this script's oracle check (the tracer reaches that kernel
               through no engine), and its entry says so: ``tracer_launches``
               0, ``launched_by``
 14. rt_small_timing — CUDA events, median of 20 (the flat kernel: of 5):
               each of the six launches' kernels alone, the flat kernel on the
               primary launch, the plain versions on the samples, the whole
               1024x1024 and 256x256 frames

  15. diff_vis_vs_plain — the differentiable pipeline's hard-mode visibility
               kernel against the plain chunk reduction (engine="xla") on the
               card, equal on every pixel: random-triangle scenes (seeds 0 and
               3, depth test on and off), tile_logsize 3..6, a scene with
               coplanar duplicates, one with degenerate triangles (w = 1e-30,
               w = 0, zero area), and the training icosphere at 512x512 and
               1024x1024
 16. diff_accumulate_vs_plain — the row-accumulation kernel against its
               order-exact plain version, bit for bit, and two launches
               bit-identical: (N, R, C) = (3000, 256, 16) with out-of-range
               and negative rows, and all five calls of a real 1024x1024
               backward pass, captured (the texel and record tables and the
               pos, color and uv vertex tables); the largest difference from
               a float64 sum is printed
 17. diff_step_256 — one forward and backward of render_deferred at 256x256
               in the hard, alpha and soft modes against the committed JAX
               golden (data/diff_step_256.npz): image atol 1e-4 with >= 99.9 %
               of values within 2e-5, loss rtol 1e-5, each gradient
               max |diff| <= 1e-4 * max |gradient|, winner steps differing
               only at ties on under 0.1 % of the pixels; launches read just
               after each step: visibility 1 (hard mode; the K-slot modes
               have no kernel), accumulation 4 + K
 18. diff_train_1024 — the training path at full width, 1024x1024, 5,120
               triangles: two steps from the same parameters give the same
               gradient bits; the counts are set to 0, ten plain SGD steps
               (p - 1e-6 g) run, every loss finite and lower than the one
               before, every gradient finite, and the counts read 10 and 50
               (1 + 5 a step); then diff.optim.fit(steps=10, lr=1e-2) from
               the same start: 10 finite losses, no rejected step, 10 and 50
               launches.  Then the alpha and soft modes at 512x512 with
               auto_slots, one step each: finite, max_writes <= slots, image
               equal to the sequential render()'s on the card within rtol
               1e-4, atol 1e-4
 19. diff_timing — CUDA events, median of 20: the visibility kernel and the
               plain chunk reduction (of 5) at 1024x1024; the accumulation
               kernel, its plain version (one run, from phase 16) and
               ``zeros(R, C).index_add_`` (the library call; it takes only
               the kept rows) on the texel, record, pos and uv tables;
               forward, backward and whole step at 512x512 and 1024x1024,
               Mpix/s = size^2 / step time

  20. rt_after_vs_plain — the next-hit-after kernel against its plain torch
               version, bit for bit (``rays_differ`` must be 0): the check
               soups whole (an exact duplicate triangle, a coplanar grid whose
               rays meet up to eight triangles at exactly t = 1, parked rays, a
               per-ray t_max), every walk fed from the one before; then every
               walk of every K-slot draw of the real 1024x1024 config-3 frame
               on a 65,536-ray sample, and walk 1 and the last walk on all
               1,048,576 rays; walk 1 from (-inf, -1) equal to the closest-hit
               kernel on the same blocks
  21. rt_config3_128 — rt.frame.render_trace_rt_fused on the default device,
               data/synth_config3.npz at 128x128, against the committed JAX
               golden (data/synth_config3_128.npz: color, zbuf, the plan's
               modes, K and P): >= 99.9 % of the values within 2e-5, and every
               pixel beyond 1e-4 a graze or a tie in the port's own
               enumeration (rt.frame.fragment_margins under 1e-4; their count
               is printed); zbuf within 2e-5; against the port's scan oracle
               on the card within 1e-3; launches a frame: the closest-hit
               kernel once a ``winner`` draw, the next-hit-after kernel K (+ 1
               probe) times a ``kslot`` draw, none a ``scan`` draw
  22. rt_config3_1024 — the full-width frame, 1,048,576 rays, from a trace
               with no hints: the K hints converge within 8 rounds, none
               below the 128x128 ones; the frame call runs under
               torch.cuda.set_sync_debug_mode("error"), so a wait for the
               device or a copy from the host between the first and the last
               draw fails it; the counts are set to 0 just before it and read
               just after, the overflow tensor read once after that (all 0);
               finite, every value in [0, 1], the 8x8 cell means near the
               golden's pixels; a second make_frame_fn returns the cached plan
  23. rt_diff — rt.diff.render_lambert (per-ray-stack BVH) and
               render_lambert_soft forward and backward on the card, 16,384
               rays on a 1,280-triangle scene: finite, image within 2e-5 and
               gradients within 1e-4 of their largest value of the CPU run of
               the same code, two runs' gradients bit-identical, the
               accumulation kernel's launches counted
  24. rt_streamed_worklist — the streamed and worklist closest-hit kernels
               against their plain versions, bit for bit, on the check scenes
               and on 65,536 rays of each of the six launches of the small
               scene's 1024x1024 frame and on its whole primary launch; equal
               to each other and to the clustered kernel on every ray, against
               the flat kernel tie-aware; both engines' 1024x1024 frames: 3 + 3
               launches of their kernel (the closest hit, and the closest hit
               inside the bound as the occlusion query), image equal to the
               clustered frame's (max |diff| 0)
  25. rt_config3_timing — CUDA events, median of 20: every walk of every K-slot
               draw, the closest-hit kernel on the ``winner`` draws, one scan
               draw, the whole frame at 512x512 and 1024x1024; the streamed and
               worklist kernels on the small scene's primary launch beside the
               clustered and the flat one, the worklist's prepass apart from
               its kernel, the three engines' frames

The ``kernels`` line gives each kernel's time beside its bound, both terms
of it: ``bound_bytes_ms`` (inputs read once, outputs written once; holds
for any algorithm) and ``bound_ops_ms`` (the operations this algorithm did
on this run's data; for the ray queries, the tests made at the shipped
block size or cluster table).  The ray queries' ``ms`` and ``bound_ms`` are
those of the primary launch (the any-hit kernels': the primary shadow
launch); ``launch_ms``, ``frame_ms`` and ``frame_bound_ms`` cover the three
launches of a frame.  ``max_abs_err`` is the largest |kernel - plain| over
every output of the comparison run (measured; a run that prints the line
measured 0, since any difference raises), and the ray queries add
``rays_differ`` or ``rays_not_bit_equal``, the count of rays behind it.
The training path's two entries give the kernel on the 1024x1024 step's
tensors; ``launches`` are those of the ten SGD steps.  ``diff_accumulate``'s
``ms`` is the texel table's launch (the widest of a step's five) and
``step_ms`` lists the table classes; its ``library_ms`` is ``index_add_``,
which the port never calls on a CUDA tensor.  Its ``bound_ms`` is the
function's own (the bytes, and one add a kept value's column); the R * N
row compares that the owner-computes algorithm spends on top are printed
apart, as ``algorithm_ops`` and ``algorithm_ops_ms``, and enter no bound.

The next-hit-after entry gives walk 1 of the largest K-slot draw (the
5,080-triangle shell) on all rays; ``walk_ms`` lists every walk of every such
draw, ``frame_ms`` their sum, ``launches`` the frame's count.  The streamed and
worklist entries give the small scene's primary launch; the worklist's
``prepass_ms`` is its plain-torch prepass, which the bound leaves out.

The script imports no JAX: the references it checks against are committed
files (skybox_rt_tpu_torch/data/).
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WARMUP, REPS = 3, 20
SIZE = 256
TEXTURED_DRAW = 1

# Published peaks of one H100 SXM at its full 700 W: device memory rate and
# float32 outside the tensor cores (NVIDIA's data sheet), int32 outside the
# tensor cores (the H100 architecture whitepaper's table of peak rates: half
# of an SM's 128 float32 lanes also do int32).  Both count a multiply-add as
# two operations, so the counts below take a multiply and an add as one each.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12
# Operations of the visibility kernel's inner loop (csrc/raster_visibility.cu,
# visibility_kernel), counted from its body.  Every pixel does for every real
# prim of its tile: three edge functions (2 multiplies + 2 adds each, 12),
# three sign compares and three ands with the scissor flag.
RASTER_STEP_INT_OPS = 18
# A covered pixel (fused outputs, depth-stencil test on the shaded z) adds,
# in float32: 3 int->float + 3 multiplies, 2 adds, 1 divide, 2 multiplies by
# the reciprocal, and per to_fixed24_x86 a multiply, a truncation, 3 compares
# and a convert (12 for the two) ...
RASTER_COVERED_FLOAT_OPS = 23
# ... and in int32: two imadd24 (mul.lo, mul.hi, funnel shift, add: 8) and
# ds_step (5 masks/shifts of the operands, 2 compares, their and, 2 selects
# of the stencil op, the op itself 2, shift + or of the result, 2 + 3 for the
# write mask, 4 for the masked merge: 23).
RASTER_COVERED_INT_OPS = 31
# float operations of one Möller–Trumbore test (csrc/rt_bvh.cu mt_one and
# the caller's t < bound: two cross products 18, four dot products 20, tvec
# 3, 1 divide, 3 multiplies by 1/det, u + v, |det|, 6 compares) and of one
# slab test (6 subtracts, 6 multiplies, 12 min/max, 1 compare)
MT_OPS = 53
SLAB_OPS = 25
RT_SAMPLE = 65536
RT_SIZE = 1024         # the full-width frame


def phase(name, **fields):
    torch.cuda.synchronize()        # a fault in the phase surfaces here
    print(json.dumps({"phase": name, **fields}), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return res.stdout.strip().splitlines()[0]


def median_ms(fn, reps=REPS, warmup=WARMUP) -> float:
    """Median over `reps` of one call of fn, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over all outputs (u32 words compared as
    their 32-bit patterns); raises unless the outputs are bit-equal."""
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    if err:
        raise AssertionError(f"kernel != plain version, max |diff| {err}")
    return err


def bound(bytes_moved: int, float_ops: int, int_ops: int = 0) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate, and which of them.
    int32 operations run on half of the float32 lanes, so the operations
    take at least int_ops at the int32 rate and all of them at the float32
    rate.  Both terms are returned: ``bound_bytes_ms`` holds for any
    algorithm that computes the function, ``bound_ops_ms`` for the
    operations this algorithm did on this run's data."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = max(int_ops / INT32_OPS_PER_S,
                 (int_ops + float_ops) / FP32_OPS_PER_S) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes_ms": by_bytes, "bound_ops_ms": by_ops,
            "bytes": int(bytes_moved), "operations": int(int_ops + float_ops)}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def northstar_camera():
    from skybox_rt_tpu_torch.rt import tracer
    return tracer.Camera(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0),
                         fov_y_deg=55.0)


def northstar_scene():
    """The full-width ray-traced workload: the 184,832-triangle sphere
    field with mirror reflectivity 0.35 (not finalized yet) and its camera."""
    from skybox_rt_tpu_torch.models import scenes
    from skybox_rt_tpu_torch.rt import tracer
    verts, faces, colors = scenes.sphere_field(copies=9, subdiv=5)
    scene = tracer.RTScene(verts=verts, faces=faces, colors=colors,
                           reflectivity=0.35)
    return scene, northstar_camera()


LAUNCH_NAMES = ["primary", "primary_shadow", "bounce1", "bounce1_shadow",
                "bounce2", "bounce2_shadow"]


def capture_launches(scene, cfg, closest, occluded, o, d):
    """The six launches of a 2-bounce shadowed frame as [(kind, o, d,
    t_max)], captured from the port's trace_rays; closest(o, d) and
    occluded(o, d, t_max (R,)) are the queries it runs through."""
    from skybox_rt_tpu_torch.rt import tracer
    launches = []

    def rec_closest(o, d, t_max=float("inf")):
        launches.append(("closest", o, d, None))
        return closest(o, d)

    def rec_occluded(o, d, t_max):
        tm = torch.full((o.shape[0],), t_max, dtype=torch.float32,
                        device=o.device)
        launches.append(("any", o, d, tm))
        return occluded(o, d, tm)

    tracer.trace_rays(tracer.scene_shade_arrays(scene, cfg), cfg,
                      rec_closest, rec_occluded, scene.reflectivity, o, d)
    kinds = [k for k, _, _, _ in launches]
    if kinds != ["closest", "any"] * 3:
        raise AssertionError(f"launch classes {kinds}")
    return launches


def sample_launch(name, launch):
    """RT_SAMPLE rays of a launch, evenly strided: (o, d, t_max)."""
    _, o, d, tm = launch
    stride = max(1, o.shape[0] // RT_SAMPLE)
    sl = slice(0, stride * RT_SAMPLE, stride)
    os_, ds_ = o[sl].contiguous(), d[sl].contiguous()
    if os_.shape[0] < RT_SAMPLE:
        raise AssertionError(f"{name}: only {os_.shape[0]} rays")
    return os_, ds_, None if tm is None else tm[sl].contiguous()


def timed(fn):
    """(fn(), its seconds on the host clock, the device drained)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def frame_against_golden(what, img, want):
    """Raises unless img is within atol 1e-4 of the JAX golden and >= 99.9 %
    of its values within 2e-5; returns the figures the phases print."""
    diff = np.abs(img - want)
    within = float((diff <= 2e-5).mean())
    if not (diff.max() <= 1e-4 and within >= 0.999):
        raise AssertionError(f"{what} != JAX golden: max |diff| "
                             f"{diff.max()}, within 2e-5: {within}")
    return {"max_abs_diff": float(diff.max()),
            "values_beyond_2e5": int((diff > 2e-5).sum()),
            "values": int(diff.size),
            "hit_fraction": float((img[..., :3].sum(-1) > 0).mean()),
            "mean_rgb": [float(x) for x in img[..., :3].mean((0, 1))]}


def rt_phases(dev, card) -> list:
    """Phases 7 to 10; returns the two RT kernels' entries of the kernels
    line."""
    from skybox_rt_tpu_torch.geom import cgltrace
    from skybox_rt_tpu_torch.models import scenes
    from skybox_rt_tpu_torch.ops import cuda_rt
    from skybox_rt_tpu_torch.rt import bvh as bvh_mod
    from skybox_rt_tpu_torch.rt import intersect, tracer, wavefront

    def on_card(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    def make_blocks(verts, faces, bvh, tri_block):
        tri = intersect.triangle_arrays(on_card(verts),
                                        on_card(np.asarray(faces, np.int64)))
        return cuda_rt.prepare_bvh_blocks(
            *tri, bvh_mod.build_block_set(bvh, tri_block=tri_block))

    def compare(kind, o, d, tm, blocks, stats=None):
        """Kernel against plain version on one query; raises on a
        mismatch.  Returns (max |diff| of t/u/v, rays not bit-equal,
        kernel outputs, plain seconds)."""
        if kind == "any":
            got = cuda_rt.any_hit_bvh(o, d, blocks, t_max=tm)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = cuda_rt.any_hit_bvh_reference(o, d, blocks, tm,
                                                 stats=stats)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            if got.dtype != torch.bool or not torch.equal(got, want):
                raise AssertionError(
                    f"any_hit_bvh != plain version on "
                    f"{int((got != want).sum())} of {got.numel()} rays")
            return 0.0, 0, got, plain_s
        got = cuda_rt.closest_hit_bvh(o, d, blocks, t_max=tm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = cuda_rt.closest_hit_bvh_reference(o, d, blocks, tm,
                                                 stats=stats)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if got[0].dtype != torch.int32 or not torch.equal(got[0], want[0]):
            raise AssertionError(
                f"closest_hit_bvh prims != plain version on "
                f"{int((got[0] != want[0]).sum())} of {got[0].numel()} rays")
        hit = got[0] >= 0
        if not bool(torch.isinf(got[1][~hit]).all()):
            raise AssertionError("a miss with finite t")
        err, inexact = 0.0, torch.zeros_like(hit)
        for g, w in zip(got[1:], want[1:]):
            g, w = torch.where(hit, g, 0.0), torch.where(hit, w, 0.0)
            diff = (g - w).abs()
            if bool((diff > 1e-6 * w.abs()).any()):
                raise AssertionError(
                    f"closest_hit_bvh t/u/v beyond rtol 1e-6 of the plain "
                    f"version: max |diff| {float(diff.max())}")
            err = max(err, float(diff.max()))
            inexact |= g != w
        return err, int(inexact.sum()), got, plain_s

    # 7a. the small check scenes, whole
    err, inexact, cases = 0.0, 0, 0
    for name in sorted(scenes.BVH_CHECK_SCENES):
        verts, faces, tri_block, queries = scenes.bvh_check_queries(name)
        blocks = make_blocks(verts, faces, bvh_mod.build(verts, faces),
                             tri_block)
        for kind, o, d, tm in queries:
            e, n, _, _ = compare(kind, on_card(o), on_card(d),
                                 on_card(tm) if kind == "closest" else
                                 (tm if np.ndim(tm) == 0 else on_card(tm)),
                                 blocks)
            err, inexact, cases = max(err, e), inexact + n, cases + 1
    small = {"cases": cases, "max_abs_err": err, "rays_not_bit_equal": inexact}

    # the full-width scene, built once for every later phase
    scene, cam = northstar_scene()
    verts, faces = scene.verts, scene.faces
    t0 = time.perf_counter()
    scene.finalize()
    bvh_build_s = time.perf_counter() - t0
    kw = dict(bounces=2, shadows=True)
    cfg1024 = tracer.RTConfig(width=RT_SIZE, height=RT_SIZE, **kw)
    cfg256 = tracer.RTConfig(width=SIZE, height=SIZE, **kw)
    if tracer.resolve_engine(cfg1024, faces.shape[0]) != "pallas_bvh":
        raise AssertionError("the full-width scene must take pallas_bvh")
    t0 = time.perf_counter()
    blocks = make_blocks(verts, faces, scene.bvh, tracer.BVH_TRI_BLOCK)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame1024, (o1024, d1024) = tracer.make_frame_fn(scene, cam, cfg1024)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if o1024.device != blocks["tri"].device:
        raise AssertionError("make_frame_fn did not default to the card")

    def launch_bound(kind, o, d, tm, tri_tests, slab_pass):
        """Bound of one launch: rays, records, counts and boxes read once,
        the outputs (prim, t, u, v, or one occlusion byte a ray) written
        once, against the tests the plain version counted."""
        R = o.shape[0]
        moved = nbytes(o, d, tm, blocks["tri"], blocks["bcnt"],
                       blocks["aabb"])
        moved += R if kind == "any" else 16 * R + nbytes(blocks["s2p"])
        return bound(moved, tri_tests * MT_OPS + slab_pass * SLAB_OPS)

    # 7b. the six launches of the real frame, captured from trace_rays
    launches = capture_launches(
        scene, cfg1024, lambda o, d: cuda_rt.closest_hit_bvh(o, d, blocks),
        lambda o, d, tm: cuda_rt.any_hit_bvh(o, d, blocks, t_max=tm),
        o1024, d1024)
    names = LAUNCH_NAMES
    classes = {}
    for name, launch in zip(names, launches):
        kind, o, d, tm = launch
        R = o.shape[0]
        os_, ds_, tms = sample_launch(name, launch)
        stats = {}
        e, n, got, plain_s = compare(kind, os_, ds_, tms, blocks, stats)
        parked = int((os_[:, 0] > 1e7).sum())
        found = got if kind == "any" else got[0] >= 0
        classes[name] = {
            "kind": kind, "launch_rays": R, "sample_rays": os_.shape[0],
            "parked_in_sample": parked, "hits_in_sample": int(found.sum()),
            "max_abs_err": e, "rays_not_bit_equal": n,
            "tri_tests_per_ray": stats["tri_tests"] / os_.shape[0],
            "blocks_entered_per_ray": stats["slab_pass"] / os_.shape[0],
            "plain_ms_sample": plain_s * 1e3,
            # the sample's counts scaled to the launch's rays
            "bound": launch_bound(kind, o, d, tm,
                                  stats["tri_tests"] * R / os_.shape[0],
                                  stats["slab_pass"] * R / os_.shape[0])}
        err = max(err, e)
    for name in ("bounce1", "bounce1_shadow"):
        if classes[name]["parked_in_sample"] == 0:
            raise AssertionError(f"{name}: no parked ray in the sample")

    # 7c. the whole primary and primary-shadow launches: the shapes of the
    # kernels line
    entries = []
    for (kind, o, d, tm), name, src_line in (
            (launches[0], "rt_closest_hit_bvh", 1102),
            (launches[1], "rt_any_hit_bvh", 1528)):
        stats = {}
        e, n, got, plain_s = compare(kind, o, d, tm, blocks, stats)
        entries.append({
            "name": name, "route": "cuda",
            "source": "skybox_rt_tpu_torch/csrc/rt_bvh.cu",
            "replaces": f"skybox_rt_tpu/ops/pallas_rt.py:{src_line}",
            "launches": None, "max_abs_err": e, "ms": None,
            "plain_ms": plain_s * 1e3,
            **launch_bound(kind, o, d, tm, stats["tri_tests"],
                           stats["slab_pass"]),
            "library_ms": None,     # no single PyTorch call computes this
            "rays": o.shape[0], "rays_not_bit_equal": n,
            "tri_tests_per_ray": stats["tri_tests"] / o.shape[0]})
        err = max(err, e)
    phase("rt_kernel_vs_plain", small=small, triangles=int(faces.shape[0]),
          blocks=blocks["num_blocks"], pyramid=list(blocks["level_counts"]),
          classes=classes, equal=True, max_abs_err=err)

    # 8. the 256x256 frame against the committed JAX golden
    with np.load(os.path.join(cgltrace.DATA_DIR,
                              "rt_northstar_256.npz")) as z:
        golden = {k: z[k] for k in z.files}
    if int(golden["num_triangles"]) != faces.shape[0]:
        raise AssertionError("the golden was made from another scene")
    frame256, _ = tracer.make_frame_fn(scene, cam, cfg256)
    perm, _ = wavefront.tile_order_perm(SIZE, SIZE, 32)
    cuda_rt.reset_launch_counts()
    img256 = frame256(golden["o"][perm], golden["d"][perm])
    torch.cuda.synchronize()
    counts256 = (cuda_rt.launch_counts["closest_hit_bvh"],
                 cuda_rt.launch_counts["any_hit_bvh"])
    if img256.device != blocks["tri"].device or counts256 != (3, 3):
        raise AssertionError(f"256 frame: device {img256.device}, launches "
                             f"{counts256}, expected (3, 3) on the card")
    img256 = img256.cpu().numpy()
    fig256 = frame_against_golden("256 frame", img256, golden["image"])
    hit256 = img256[..., :3].sum(-1) > 0
    phase("rt_frame_256", size=SIZE, launches=counts256, **fig256)

    # 9. the full-width frame: the main path
    cuda_rt.reset_launch_counts()
    img = frame1024(o1024, d1024)
    torch.cuda.synchronize()
    counts = (cuda_rt.launch_counts["closest_hit_bvh"],
              cuda_rt.launch_counts["any_hit_bvh"])
    if counts != (3, 3) or sum(cuda_rt.launch_counts.values()) != 6:
        raise AssertionError(f"1024 frame launched {cuda_rt.launch_counts}, "
                             f"expected 3 + 3 of the BVH-block kernels")
    if tuple(img.shape) != (RT_SIZE, RT_SIZE, 4) or img.dtype != torch.float32:
        raise AssertionError(f"1024 frame is {tuple(img.shape)} {img.dtype}")
    if not bool(torch.isfinite(img).all()) or not bool((img[..., 3] == 1).all()):
        raise AssertionError("1024 frame: a value is not finite or alpha != 1")
    perm1024, _ = wavefront.tile_order_perm(RT_SIZE, RT_SIZE, 32)
    stride = RT_SIZE * RT_SIZE // RT_SAMPLE
    sample = on_card(perm1024.astype(np.int64))[::stride]
    hit_img = img.reshape(-1, 4)[sample][:, :3].sum(-1) > 0
    prim_plain = cuda_rt.closest_hit_bvh_reference(
        o1024[::stride].contiguous(), d1024[::stride].contiguous(), blocks)[0]
    if not torch.equal(hit_img, prim_plain >= 0):
        raise AssertionError("1024 frame: primary hit mask != plain version")
    hit1024 = img[..., :3].sum(-1) > 0
    phase("rt_frame_1024", rays=RT_SIZE * RT_SIZE, triangles=int(faces.shape[0]),
          launches=counts, finite=True, hit_mask_sample=int(sample.numel()),
          hit_fraction=float(hit1024.float().mean()),
          mean_rgb=[float(x) for x in img[..., :3].mean((0, 1))],
          hit_fraction_256=float(hit256.mean()))
    entries[0]["launches"], entries[1]["launches"] = counts

    # 10. timing (printed, not judged)
    timing = {}
    for name, (kind, o, d, tm) in zip(names, launches):
        if kind == "any":
            ms = median_ms(lambda: cuda_rt.any_hit_bvh(o, d, blocks,
                                                       t_max=tm))
        else:
            ms = median_ms(lambda: cuda_rt.closest_hit_bvh(o, d, blocks))
        timing[name] = {"kernel_ms": ms, "rays": o.shape[0],
                        "mrays_per_s": o.shape[0] / ms / 1e3,
                        "plain_ms_sample": classes[name]["plain_ms_sample"]}
    # ms and bound_ms are those of the widest launch (the primary one);
    # frame_ms and frame_bound_ms sum the kernel's three launches of a frame
    for entry, first in zip(entries, ("primary", "primary_shadow")):
        mine = [n for n in names if classes[n]["kind"] == classes[first]["kind"]]
        entry["ms"] = timing[first]["kernel_ms"]
        entry["launch_ms"] = {n: timing[n]["kernel_ms"] for n in mine}
        entry["frame_ms"] = sum(timing[n]["kernel_ms"] for n in mine)
        entry["frame_bound_ms"] = sum(classes[n]["bound"]["bound_ms"]
                                      for n in mine)
    frame_ms = median_ms(lambda: frame1024(o1024, d1024))
    frame256_ms = median_ms(lambda: frame256(golden["o"][perm],
                                             golden["d"][perm]))
    kernels_ms = sum(t["kernel_ms"] for t in timing.values())
    phase("rt_timing", card=card, reps=REPS, launches=timing,
          frame_1024={"ms": frame_ms, "kernels_ms": kernels_ms,
                      "kernel_share": kernels_ms / frame_ms,
                      "mrays_per_s": RT_SIZE * RT_SIZE * 6 / frame_ms / 1e3},
          frame_256_ms=frame256_ms,
          host_s={"bvh_build_sah": bvh_build_s,
                  "block_set_and_upload": prepare_s,
                  "make_frame_fn_1024": setup_s})
    return entries


def differ(got, want):
    """(rays on which any output of a query differs from `want`, the largest
    |got - want| over the outputs: equal infinities give 0 and a bool counts
    as 0 or 1)."""
    if torch.is_tensor(got):
        got, want = (got,), (want,)
    bad = torch.zeros(got[0].shape, dtype=torch.bool, device=got[0].device)
    err = 0.0
    for g, w in zip(got, want, strict=True):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{g.dtype} {tuple(g.shape)} vs "
                                 f"{w.dtype} {tuple(w.shape)}")
        ne = g != w
        if bool(ne.any()):
            err = max(err, float((g[ne].double() - w[ne].double())
                                 .abs().max()))
        bad |= ne
    return int(bad.sum()), err


def small_scene(textured=False):
    """The small-scene ray-traced workload: the 12,032-triangle sphere field
    (at most tracer.PALLAS_MAX_TRIS, so the default engine takes the
    clustered kernels) with mirror reflectivity 0.35, planar texture
    coordinates and the checkerboard when textured, and its camera."""
    from skybox_rt_tpu_torch.models import scenes
    from skybox_rt_tpu_torch.rt import tracer
    verts, faces, colors = scenes.sphere_field(copies=9, subdiv=3)
    extra = {}
    if textured:
        extra = dict(uvs=scenes.planar_uvs(verts),
                     texture=scenes.checkerboard_texture(**scenes.RT_CHECKER))
    scene = tracer.RTScene(verts=verts, faces=faces, colors=colors,
                           reflectivity=0.35, **extra)
    return scene, northstar_camera()


def small_phases(dev, card) -> list:
    """Phases 11 to 14; returns the three small-scene kernels' entries of
    the kernels line."""
    from skybox_rt_tpu_torch.geom import cgltrace
    from skybox_rt_tpu_torch.models import scenes
    from skybox_rt_tpu_torch.ops import cuda_rt
    from skybox_rt_tpu_torch.rt import bvh as bvh_mod
    from skybox_rt_tpu_torch.rt import intersect, tracer, wavefront

    def on_card(a):
        if a is None or np.ndim(a) == 0:
            return a
        return torch.as_tensor(a, device=dev)

    def pack(verts, faces, bvh, max_tris):
        tri = intersect.triangle_arrays(on_card(verts),
                                        on_card(np.asarray(faces, np.int64)))
        clusters = cuda_rt.prepare_clusters(
            *tri, bvh_mod.build_clusters(bvh, max_tris))
        return clusters, cuda_rt.pack_records(*tri)

    def compare(kind, o, d, tm, clusters, flat, stats=None, flat_plain=True):
        """The clustered and the flat kernel against their plain versions on
        one query, and against each other; raises on any mismatch.
        Returns the figures the phases print and the clustered outputs."""
        if kind == "any":
            got = cuda_rt.any_hit_clustered(o, d, clusters, t_max=tm)
            got_flat = cuda_rt.any_hit_pallas(o, d, flat, t_max=tm)
            want, plain_s = timed(lambda: cuda_rt.any_hit_clustered_reference(
                o, d, clusters, tm, stats=stats))
        else:
            got = cuda_rt.closest_hit_clustered(o, d, clusters, t_max=tm)
            got_flat = cuda_rt.closest_hit_pallas(o, d, flat, t_max=tm)
            want, plain_s = timed(
                lambda: cuda_rt.closest_hit_clustered_reference(
                    o, d, clusters, tm, stats=stats))
        n, err = differ(got, want)
        out = {"rays_differ": n, "max_abs_err": err,
               "plain_ms": plain_s * 1e3}
        if flat_plain:
            tmf = None if tm is None else cuda_rt._per_ray_tmax(
                tm, o.shape[0], dev)
            want_flat, flat_s = timed(
                lambda: cuda_rt.closest_hit_pallas_reference(o, d, flat, tmf))
            if kind == "any":
                want_flat = want_flat[0] >= 0
            out["flat_rays_differ"], out["flat_max_abs_err"] = differ(
                got_flat, want_flat)
            out["flat_plain_ms"] = flat_s * 1e3
        if out["rays_differ"] or out.get("flat_rays_differ"):
            raise AssertionError(f"{kind}: kernel != plain version: {out}")
        # clustered against flat: another algorithm, the same arithmetic
        if kind == "any":
            out["differ_from_flat"] = differ(got, got_flat)[0]
            if out["differ_from_flat"]:
                raise AssertionError(f"any_hit_clustered != any_hit_pallas "
                                     f"on {out['differ_from_flat']} rays")
            return out, got
        out["prims_tied_with_flat"] = scenes.check_clustered_equals_flat(
            [x.cpu().numpy() for x in got],
            [x.cpu().numpy() for x in got_flat])
        out["t_differ_from_flat"] = int((got[1] != got_flat[1]).sum())
        return out, got

    # 11a. the small check scenes, whole
    small = {"cases": 0, "rays_differ": 0, "flat_rays_differ": 0,
             "prims_tied_with_flat": 0}
    for name in sorted(scenes.CLUSTER_CHECK_SCENES):
        verts, faces, max_tris, queries = scenes.cluster_check_queries(name)
        clusters, flat = pack(verts, faces, bvh_mod.build(verts, faces),
                              max_tris)
        for _, kind, o, d, tm in queries:
            out, _ = compare(kind, on_card(o), on_card(d), on_card(tm),
                             clusters, flat)
            small["cases"] += 1
            for k in ("rays_differ", "flat_rays_differ",
                      "prims_tied_with_flat"):
                small[k] += out.get(k, 0)
    # more clusters than the shared-memory stage holds (the tables stay in
    # global memory); rays of one octant, so the plain version walks one row
    verts, faces = scenes.icosphere(subdiv=4)
    clusters, flat = pack(verts, faces, bvh_mod.build(verts, faces), 4)
    if clusters["num_clusters"] <= 768:
        raise AssertionError("the unstaged case must exceed 768 clusters")
    o, d = scenes.aimed_rays(3000, seed=9)
    o, d = on_card(np.abs(o)), on_card(-np.abs(d))
    for kind, tm in (("closest", None), ("any", 3.0)):
        out, _ = compare(kind, o, d, tm, clusters, flat)
        small["cases"] += 1
        small["rays_differ"] += out["rays_differ"]
    small["unstaged_clusters"] = clusters["num_clusters"]

    # the full-width small scene, built once for every later phase
    scene, cam = small_scene()
    verts, faces = scene.verts, scene.faces
    (_, bvh_build_s) = timed(scene.finalize)
    kw = dict(bounces=2, shadows=True)
    cfg1024 = tracer.RTConfig(width=RT_SIZE, height=RT_SIZE, **kw)
    cfg256 = tracer.RTConfig(width=SIZE, height=SIZE, **kw)
    if cfg1024.engine != "pallas" or faces.shape[0] > tracer.PALLAS_MAX_TRIS \
            or tracer.resolve_engine(cfg1024, faces.shape[0]) != "pallas":
        raise AssertionError("the small scene must take the default engine's "
                             "clustered kernels")
    (clusters, flat), prepare_s = timed(
        lambda: pack(verts, faces, scene.bvh, 64))
    (frame1024, (o1024, d1024)), setup_s = timed(
        lambda: tracer.make_frame_fn(scene, cam, cfg1024))
    if o1024.device != clusters["tri"].device:
        raise AssertionError("make_frame_fn did not default to the card")
    C, P = clusters["num_clusters"], clusters["num_prims"]

    def launch_bounds(kind, o, d, tm, tri_tests, slab_tests):
        """Bounds of one launch of the clustered and of the flat kernel:
        rays, records and tables read once, the outputs (prim, t, u, v, or
        one occlusion byte a ray) written once, against the tests the plain
        version counted (flat: every triangle for every ray)."""
        R = o.shape[0]
        written = R if kind == "any" else 16 * R
        moved = nbytes(o, d, tm, clusters["tri"], clusters["table"],
                       clusters["visit"]) + written
        if kind == "closest":
            moved += nbytes(clusters["order"])
        return (bound(moved, tri_tests * MT_OPS + slab_tests * SLAB_OPS),
                bound(nbytes(o, d, tm, flat) + 16 * R, R * P * MT_OPS))

    # 11b. the six launches of the real frame, captured from trace_rays
    launches = capture_launches(
        scene, cfg1024,
        lambda o, d: cuda_rt.closest_hit_clustered(o, d, clusters),
        lambda o, d, tm: cuda_rt.any_hit_clustered(o, d, clusters, t_max=tm),
        o1024, d1024)
    classes = {}
    for name, launch in zip(LAUNCH_NAMES, launches):
        kind, o, d, tm = launch
        R = o.shape[0]
        os_, ds_, tms = sample_launch(name, launch)
        stats = {}
        out, got = compare(kind, os_, ds_, tms, clusters, flat, stats)
        n = os_.shape[0]
        found = got if kind == "any" else got[0] >= 0
        classes[name] = {
            "kind": kind, "launch_rays": R, "sample_rays": n,
            "parked_in_sample": int((os_[:, 0] > 1e7).sum()),
            "hits_in_sample": int(found.sum()), **out,
            "slab_tests_per_ray": stats["slab_tests"] / n,
            "clusters_entered_per_ray": stats["slab_pass"] / n,
            "tri_tests_per_ray": stats["tri_tests"] / n,
            # the sample's counts scaled to the launch's rays
            "bound": launch_bounds(kind, o, d, tm, stats["tri_tests"] * R / n,
                                   stats["slab_tests"] * R / n)[0]}
    for name in ("bounce1", "bounce1_shadow"):
        if classes[name]["parked_in_sample"] == 0:
            raise AssertionError(f"{name}: no parked ray in the sample")

    # 11c. the whole primary and primary-shadow launches: the shapes of the
    # kernels line (the flat kernel's plain version on the primary one only)
    entries, flat_entry = [], None
    for launch, name, src_line in ((launches[0], "rt_closest_hit_clustered",
                                    230),
                                   (launches[1], "rt_any_hit_clustered",
                                    1693)):
        kind, o, d, tm = launch
        stats = {}
        out, _ = compare(kind, o, d, tm, clusters, flat, stats,
                         flat_plain=kind == "closest")
        R = o.shape[0]
        mine, flat_bound = launch_bounds(kind, o, d, tm, stats["tri_tests"],
                                         stats["slab_tests"])
        common = {"route": "cuda",
                  "source": "skybox_rt_tpu_torch/csrc/rt_clustered.cu",
                  "launches": None, "ms": None,
                  "library_ms": None,  # no single PyTorch call computes this
                  "rays": R}
        entries.append({
            "name": name,
            "replaces": f"skybox_rt_tpu/ops/pallas_rt.py:{src_line}",
            **common, "max_abs_err": out["max_abs_err"],
            "plain_ms": out["plain_ms"], **mine,
            "rays_differ": out["rays_differ"],
            "slab_tests_per_ray": stats["slab_tests"] / R,
            "tri_tests_per_ray": stats["tri_tests"] / R})
        if kind == "closest":
            flat_entry = {
                "name": "rt_closest_hit_flat",
                "replaces": "skybox_rt_tpu/ops/pallas_rt.py:112",
                **common, "max_abs_err": out["flat_max_abs_err"],
                "plain_ms": out["flat_plain_ms"], **flat_bound,
                "rays_differ": out["flat_rays_differ"],
                "tri_tests_per_ray": P,
                "prims_tied_with_clustered": out["prims_tied_with_flat"]}
    entries.append(flat_entry)
    phase("rt_clustered_vs_plain", small=small, triangles=P, clusters=C,
          classes=classes, equal=True,
          rays_differ=small["rays_differ"] + small["flat_rays_differ"]
          + sum(c["rays_differ"] + c["flat_rays_differ"]
                for c in classes.values())
          + sum(e["rays_differ"] for e in entries))

    # 12. the 256x256 frames, plain and textured, against the JAX golden
    with np.load(os.path.join(cgltrace.DATA_DIR, "rt_small_256.npz")) as z:
        golden = {k: z[k] for k in z.files}
    if int(golden["num_triangles"]) != P:
        raise AssertionError("the golden was made from another scene")
    perm, _ = wavefront.tile_order_perm(SIZE, SIZE, 32)
    o256, d256 = golden["o"][perm], golden["d"][perm]
    tex_scene, _ = small_scene(textured=True)
    tex_scene.bvh = scene.bvh       # the same geometry: one build
    frame256, _ = tracer.make_frame_fn(scene, cam, cfg256)
    frame256_tex, _ = tracer.make_frame_fn(
        tex_scene, cam, tracer.RTConfig(width=SIZE, height=SIZE,
                                        textured=True, **kw))
    figs = {}
    for key, fn in (("image", frame256), ("image_textured", frame256_tex)):
        cuda_rt.reset_launch_counts()
        img = fn(o256, d256)
        torch.cuda.synchronize()
        counts = (cuda_rt.launch_counts["closest_hit_clustered"],
                  cuda_rt.launch_counts["any_hit_clustered"])
        if img.device != clusters["tri"].device or counts != (3, 3):
            raise AssertionError(f"256 {key}: device {img.device}, launches "
                                 f"{counts}, expected (3, 3) on the card")
        figs[key] = {"launches": counts, **frame_against_golden(
            f"small 256 {key}", img.cpu().numpy(), golden[key])}
    if np.abs(np.subtract(figs["image"]["mean_rgb"],
                          figs["image_textured"]["mean_rgb"])).max() < 0.01:
        raise AssertionError("the texture does not show")
    phase("rt_small_frame_256", size=SIZE, **figs)

    # 13. the full-width frame: the slice's main path, and its primary hits
    # held to the flat kernel (the brute-force oracle on the card)
    cuda_rt.reset_launch_counts()
    img = frame1024(o1024, d1024)
    torch.cuda.synchronize()
    # the tracer launches the clustered pair and nothing else: neither the
    # flat kernel (no engine reaches it) nor the BVH-block kernels
    if cuda_rt.launch_counts != {"closest_hit_clustered": 3,
                                 "any_hit_clustered": 3}:
        raise AssertionError(f"small 1024 frame launched "
                             f"{dict(cuda_rt.launch_counts)}, expected 3 + 3 "
                             f"of the clustered kernels only")
    stride = RT_SIZE * RT_SIZE // RT_SAMPLE
    prim_flat = cuda_rt.closest_hit_pallas(
        o1024[::stride].contiguous(), d1024[::stride].contiguous(), flat)[0]
    torch.cuda.synchronize()
    counts = (cuda_rt.launch_counts["closest_hit_clustered"],
              cuda_rt.launch_counts["any_hit_clustered"],
              cuda_rt.launch_counts["closest_hit_flat"])
    if counts != (3, 3, 1):
        raise AssertionError(f"the oracle check launched the flat kernel "
                             f"{counts[2]} times, expected 1")
    if tuple(img.shape) != (RT_SIZE, RT_SIZE, 4) or img.dtype != torch.float32:
        raise AssertionError(f"1024 frame is {tuple(img.shape)} {img.dtype}")
    if not bool(torch.isfinite(img).all()) or not bool((img[..., 3] == 1).all()):
        raise AssertionError("1024 frame: a value is not finite or alpha != 1")
    perm1024, _ = wavefront.tile_order_perm(RT_SIZE, RT_SIZE, 32)
    sample = on_card(perm1024.astype(np.int64))[::stride]
    hit_img = img.reshape(-1, 4)[sample][:, :3].sum(-1) > 0
    if not torch.equal(hit_img, prim_flat >= 0):
        raise AssertionError("1024 frame: primary hit mask != flat kernel's")
    hit_fraction = float((img[..., :3].sum(-1) > 0).float().mean())
    mean_rgb = [float(x) for x in img[..., :3].mean((0, 1))]
    ref = figs["image"]
    if abs(hit_fraction - ref["hit_fraction"]) > 1e-3 or np.abs(
            np.subtract(mean_rgb, ref["mean_rgb"])).max() > 1e-3:
        raise AssertionError(f"1024 frame: hit fraction {hit_fraction}, mean "
                             f"RGB {mean_rgb} differ from the 256 frame's")
    phase("rt_small_frame_1024", rays=RT_SIZE * RT_SIZE, triangles=P,
          clusters=C, launches=counts, tracer_launches=(3, 3, 0),
          finite=True,
          hit_mask_sample=int(sample.numel()), hit_fraction=hit_fraction,
          mean_rgb=mean_rgb, hit_fraction_256=ref["hit_fraction"],
          mean_rgb_256=ref["mean_rgb"])
    for entry, n in zip(entries, counts):
        entry["launches"] = n
    # the flat kernel's one launch is this script's check of the frame's
    # primary hits, inside the counted run; the tracer makes none
    entries[2]["tracer_launches"] = 0
    entries[2]["launched_by"] = "chip_smoke.py's oracle check of the frame"

    # 14. timing (printed, not judged)
    timing = {}
    for name, (kind, o, d, tm) in zip(LAUNCH_NAMES, launches):
        if kind == "any":
            ms = median_ms(lambda: cuda_rt.any_hit_clustered(
                o, d, clusters, t_max=tm))
        else:
            ms = median_ms(lambda: cuda_rt.closest_hit_clustered(
                o, d, clusters))
        timing[name] = {"kernel_ms": ms, "rays": o.shape[0],
                        "mrays_per_s": o.shape[0] / ms / 1e3,
                        "plain_ms_sample": classes[name]["plain_ms"],
                        "flat_plain_ms_sample":
                            classes[name]["flat_plain_ms"]}
    for entry, first in zip(entries[:2], ("primary", "primary_shadow")):
        mine = [n for n in LAUNCH_NAMES
                if classes[n]["kind"] == classes[first]["kind"]]
        entry["ms"] = timing[first]["kernel_ms"]
        entry["launch_ms"] = {n: timing[n]["kernel_ms"] for n in mine}
        entry["frame_ms"] = sum(timing[n]["kernel_ms"] for n in mine)
        entry["frame_bound_ms"] = sum(classes[n]["bound"]["bound_ms"]
                                      for n in mine)
    entries[2]["ms"] = median_ms(
        lambda: cuda_rt.closest_hit_pallas(o1024, d1024, flat), reps=5,
        warmup=1)
    frame_ms = median_ms(lambda: frame1024(o1024, d1024))
    frame256_ms = median_ms(lambda: frame256(o256, d256))
    kernels_ms = sum(t["kernel_ms"] for t in timing.values())
    phase("rt_small_timing", card=card, reps=REPS, launches=timing,
          flat_primary={"ms": entries[2]["ms"], "reps": 5,
                        "mrays_per_s": RT_SIZE * RT_SIZE / entries[2]["ms"]
                        / 1e3},
          frame_1024={"ms": frame_ms, "kernels_ms": kernels_ms,
                      "kernel_share": kernels_ms / frame_ms,
                      "mrays_per_s": RT_SIZE * RT_SIZE * 6 / frame_ms / 1e3},
          frame_256_ms=frame256_ms,
          host_s={"bvh_build_sah": bvh_build_s,
                  "clusters_and_upload": prepare_s,
                  "make_frame_fn_1024": setup_s})
    return entries


# float operations of one step of the differentiable pipeline's visibility
# kernel (csrc/diff_visibility.cu) at one pixel: three edge functions (2
# multiplies + 2 adds each) and three compares; a covered pixel with the
# depth test adds 2 adds, |den| + compare + select, 2 divides, 2 subtracts,
# 3 multiplies + 2 adds and the compare with the best z.
DIFF_VIS_STEP_OPS = 15
DIFF_VIS_COVERED_OPS = 15
DIFF_SIZE = 1024        # the full-width training step
DIFF_STEPS = 10


def diff_phases(dev, card) -> list:
    """Phases 15 to 19, the training path; returns the two kernels' entries
    of the kernels line."""
    from skybox_rt_tpu_torch.diff import (check, cuda_texgrad, cuda_vis,
                                          optim, pipeline)

    def reset_counts():
        cuda_vis.reset_launch_count()
        cuda_texgrad.reset_launch_count()

    def counts():
        return (cuda_vis.launch_count, cuda_texgrad.launch_count)

    def scene(maker, *args, **kw):
        params, static, cfg = maker(*args, **kw)
        params, static = check.to_device(params, static)
        if params["pos"].device.type != dev.type:
            raise AssertionError("to_device did not default to the card")
        return params, static, cfg

    def vis_inputs(params, static, cfg):
        with torch.no_grad():
            setup = pipeline.prim_setup(params, static["indices"], cfg)
        return (setup, static["tile_pids"],
                static["tile_xy"] * (1 << cfg.tile_logsize))

    # 15. kernel #4 against the plain chunk reduction, equal on every pixel
    def compare_vis(what, params, static, cfg):
        setup, pids, origins = vis_inputs(params, static, cfg)
        got, got_w = pipeline.visibility_slots(setup, pids, origins, cfg)
        want, want_w = pipeline.visibility_slots(setup, pids, origins, cfg,
                                                 engine="xla")
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or got.shape != want.shape:
            raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)}")
        err = int((got.long() - want.long()).abs().max())
        if err or int(got_w) != int(want_w):
            raise AssertionError(
                f"{what}: diff_visibility != plain version on "
                f"{int((got != want).sum())} of {got.numel()} pixels")
        return {"tiles": got.shape[0], "M": pids.shape[1],
                "covered_pixels": int((got >= 0).sum()), "max_abs_err": err}

    reset_counts()
    vis_cases = {}
    for seed in (0, 3):
        for depth_test in (True, False):
            vis_cases[f"random_{seed}_{'z' if depth_test else 'noz'}"] = \
                compare_vis("random", *scene(check.random_triangles, seed=seed,
                                             depth_test=depth_test))
    for tls in (3, 4, 5, 6):
        for depth_test in (True, False):
            vis_cases[f"tile_{tls}_{'z' if depth_test else 'noz'}"] = \
                compare_vis(f"tile_logsize {tls}", *scene(
                    check.random_triangles, n=60, seed=tls, size=128,
                    tile_logsize=tls, depth_test=depth_test))
    vis_cases["coplanar_duplicates"] = compare_vis("duplicates", *scene(
        check.random_triangles, duplicates=12))
    for depth_test in (True, False):
        vis_cases[f"degenerate_{'z' if depth_test else 'noz'}"] = compare_vis(
            "degenerate", *scene(check.random_triangles, degenerate=True,
                                 depth_test=depth_test))
    for size in (512, DIFF_SIZE):
        vis_cases[f"icosphere_{size}"] = compare_vis(
            f"icosphere {size}", *scene(check.train_scene, size))
    if counts() != (len(vis_cases), 0):
        raise AssertionError(f"phase 15 launched {counts()}")
    vis_err = max(c["max_abs_err"] for c in vis_cases.values())
    phase("diff_vis_vs_plain", cases=len(vis_cases), equal=True,
          max_abs_err=vis_err, **vis_cases)

    # 16. kernel #5 against its plain version, bit for bit, and twice
    def compare_acc(what, idx, val, R):
        got = cuda_texgrad.accumulate_rows(idx, val, R)
        again = cuda_texgrad.accumulate_rows(idx, val, R)
        want, plain_s = timed(
            lambda: cuda_texgrad.accumulate_rows_reference(idx, val, R))
        if got.dtype != torch.float32 or tuple(got.shape) != (R, val.shape[1]):
            raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)}")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two launches differ")
        if not torch.equal(got, want):
            raise AssertionError(
                f"{what}: diff_accumulate != plain version, max |diff| "
                f"{float((got - want).abs().max())}")
        exact = torch.zeros((R, val.shape[1]), dtype=torch.float64,
                            device=dev)
        keep = (idx >= 0) & (idx < R)
        exact.index_add_(0, idx[keep].long(), val[keep].double())
        return {"N": idx.numel(), "R": R, "C": val.shape[1],
                "segments": cuda_texgrad.segments(idx.numel()),
                "rows_dropped": int((~keep).sum()),
                "max_abs_err": float((got - want).abs().max()),
                "max_abs_diff_from_float64": float(
                    (got.double() - exact).abs().max()),
                "plain_ms": plain_s * 1e3}

    rng = np.random.default_rng(0)
    idx = rng.integers(-20, 256 + 40, 3000).astype(np.int32)
    val = rng.normal(size=(3000, 16)).astype(np.float32)
    acc_cases = {"small": compare_acc(
        "small", torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev),
        256)}
    if acc_cases["small"]["rows_dropped"] == 0 or int((idx < 0).sum()) == 0:
        raise AssertionError("the small case must drop rows")
    # the calls of one real full-width backward pass, captured
    params, static, cfg = scene(check.train_scene, DIFF_SIZE)
    captured = []
    real_accumulate = pipeline._accumulate_rows

    def recording(idx, val, num_rows):
        out = real_accumulate(idx, val, num_rows)
        captured.append((idx.detach().clone(), val.detach().clone(),
                         num_rows, out.detach().clone()))
        return out

    pipeline._accumulate_rows = recording
    try:
        check.step(params, static, cfg)
    finally:
        pipeline._accumulate_rows = real_accumulate
    T, M = static["tile_pids"].shape
    V, P = params["pos"].shape[0], static["indices"].shape[0]
    th, tw = params["tex"].shape[:2]
    shapes = sorted((i.numel(), r, v.shape[1]) for i, v, r, _ in captured)
    if shapes != sorted([(T * 1024, th * tw, 16), (T * M, P, 27),
                         (3 * P, V, 4), (3 * P, V, 4), (3 * P, V, 2)]):
        raise AssertionError(f"a backward pass accumulated {shapes}")
    # every one of the five is compared; a vertex table is named after the
    # parameter whose gradient it is (the gather's transpose is that
    # parameter's only contribution, so the bits are equal)
    acc_inputs = {}
    for idx, val, R, out in captured:
        C = val.shape[1]
        if C in (16, 27):
            name = {16: "texel", 27: "record"}[C]
        else:
            name = "vertex_" + "".join(
                k for k in ("pos", "color", "uv")
                if params[k].grad.shape == out.shape
                and torch.equal(params[k].grad, out))
        if name in acc_inputs or name == "vertex_":
            raise AssertionError(f"cannot name the captured call {name!r}, "
                                 f"C = {C}")
        acc_inputs[name] = (idx.to(torch.int32), val, R)
        acc_cases[name] = compare_acc(name, *acc_inputs[name])
    if sorted(acc_inputs) != ["record", "texel", "vertex_color",
                              "vertex_pos", "vertex_uv"]:
        raise AssertionError(f"captured {sorted(acc_inputs)}")
    acc_err = max(c["max_abs_err"] for c in acc_cases.values())
    phase("diff_accumulate_vs_plain", equal=True, bit_identical_twice=True,
          max_abs_err=acc_err, **acc_cases)

    # 17. one step at 256x256 against the committed JAX golden
    with np.load(check.GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    figs = {}
    for mode in check.MODES:
        params, static, cfg = scene(check.train_scene, check.GOLDEN_SIZE,
                                    mode)
        slots = int(golden[f"{mode}_slots"])
        if mode != "hard" and pipeline.auto_slots(params, static,
                                                  cfg) != slots:
            raise AssertionError(f"{mode}: auto_slots != the golden's")
        reset_counts()
        loss, img, maxw = check.step(params, static, cfg, slots=slots)
        torch.cuda.synchronize()
        launched = counts()
        K = 1 if mode == "hard" else slots
        if launched != (1 if mode == "hard" else 0, 4 + K):
            raise AssertionError(f"{mode} step launched {launched}")
        if int(maxw) != int(golden[f"{mode}_max_writes"]):
            raise AssertionError(f"{mode}: max_writes {int(maxw)}")
        got = {"image": img.cpu().numpy(), "loss": float(loss)}
        for k in check.PARAM_NAMES:
            got["grad_" + k] = params[k].grad.cpu().numpy()
        figs[mode] = {"launches": launched, "slots": slots,
                      **check.compare_to_golden(mode, got, golden,
                                                prefix=mode + "_")}
        if mode == "hard":
            setup, pids, origins = vis_inputs(params, static, cfg)
            steps, _ = pipeline.visibility_slots(setup, pids, origins, cfg)
            differ, not_ties = check.winner_differences(
                setup["edges"], setup["z"], pids, origins, cfg.tile_logsize,
                steps[..., 0], torch.from_numpy(golden["hard_steps"]).to(dev))
            if not_ties or differ > check.WINNER_SHARE * steps.numel():
                raise AssertionError(f"winner steps: {differ} pixels differ "
                                     f"from the golden, {not_ties} no ties")
            figs[mode]["winner_pixels_differ"] = differ
    phase("diff_step_256", size=check.GOLDEN_SIZE, **figs)

    # 18. the full-width training path: 10 plain SGD steps, then optim.fit
    params, static, cfg = scene(check.train_scene, DIFF_SIZE)
    start = {k: v.detach().clone() for k, v in params.items()}
    grads = []
    for _ in range(2):          # the same parameters twice: the same bits
        check.step(params, static, cfg)
        grads.append({k: v.grad.clone() for k, v in params.items()})
    for k in check.PARAM_NAMES:
        if not torch.equal(grads[0][k], grads[1][k]):
            raise AssertionError(f"two runs' gradients of {k} differ")
    reset_counts()
    losses = []
    for i in range(DIFF_STEPS):
        loss, img, maxw = check.step(params, static, cfg)
        if i == 0 and counts() != (1, 5):
            raise AssertionError(f"one step launched {counts()}")
        with torch.no_grad():
            for p in params.values():
                if not bool(torch.isfinite(p.grad).all()):
                    raise AssertionError("a gradient is not finite")
                p -= 1e-6 * p.grad
        losses.append(float(loss))
    torch.cuda.synchronize()
    sgd_launches = counts()
    if sgd_launches != (DIFF_STEPS, 5 * DIFF_STEPS):
        raise AssertionError(f"{DIFF_STEPS} steps launched {sgd_launches}")
    if not np.isfinite(losses).all() or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"SGD losses not finite and decreasing: "
                             f"{losses}")
    if tuple(img.shape) != (DIFF_SIZE, DIFF_SIZE, 4) or int(maxw) != 1:
        raise AssertionError(f"image {tuple(img.shape)}, max_writes "
                             f"{int(maxw)}")

    def loss_fn(p):
        return check.loss_of(pipeline.render_deferred(p, static, cfg)[0], cfg)

    reset_counts()
    fitted = optim.fit(loss_fn, start, steps=DIFF_STEPS, lr=1e-2)
    torch.cuda.synchronize()
    fit_launches = counts()
    if fit_launches != (DIFF_STEPS, 5 * DIFF_STEPS) or fitted.bad_steps \
            or len(fitted.losses) != DIFF_STEPS \
            or not np.isfinite(fitted.losses).all() \
            or fitted.params["pos"].device.type != dev.type:
        raise AssertionError(f"optim.fit: launches {fit_launches}, bad steps "
                             f"{fitted.bad_steps}, losses {fitted.losses}")
    modes = {}
    for mode in ("alpha", "soft"):
        params, static, cfg = scene(check.train_scene, 512, mode)
        slots = pipeline.auto_slots(params, static, cfg)
        reset_counts()
        loss, img, maxw = check.step(params, static, cfg, slots=slots)
        launched = counts()
        with torch.no_grad():
            oracle = pipeline.render(params, static, cfg)
        finite = all(bool(torch.isfinite(p.grad).all())
                     for p in params.values())
        close = torch.isclose(img, oracle, rtol=1e-4, atol=1e-4)
        if not finite or not bool(torch.isfinite(img).all()) \
                or int(maxw) > slots or launched != (0, 4 + slots) \
                or not bool(close.all()):
            raise AssertionError(
                f"{mode} 512: finite {finite}, max_writes {int(maxw)} of "
                f"{slots}, launches {launched}, "
                f"{int((~close).sum())} values off the oracle")
        modes[mode] = {"slots": slots, "max_writes": int(maxw),
                       "launches": launched, "loss": float(loss),
                       "max_abs_diff_from_render": float(
                           (img - oracle).abs().max())}
    phase("diff_train_1024", size=DIFF_SIZE, steps=DIFF_STEPS, tiles=T, M=M,
          sgd_losses=losses, sgd_launches=sgd_launches,
          fit_losses=fitted.losses, fit_launches=fit_launches,
          gradients_bit_identical_twice=True, modes_512=modes)

    # 19. timing (printed, not judged)
    def covered_steps(setup, pids, origins, cfg):
        """(pixel-steps over real prims, those of them that are covered)."""
        ts = 1 << cfg.tile_logsize
        xs, ys = cuda_vis.tile_coords(ts, origins)
        covered = 0
        for pc, _ in cuda_vis.padded_chunks(pids, 32):
            covered += int(cuda_vis.chunk_edges(setup["edges"], pc, xs,
                                                ys)[3].sum())
        return int((pids >= 0).sum()) * ts * ts, covered

    timing = {}
    params, static, cfg = scene(check.train_scene, DIFF_SIZE)
    setup, pids, origins = vis_inputs(params, static, cfg)
    edges, zs = setup["edges"], setup["z"]
    vis_ms = median_ms(lambda: cuda_vis.visibility_hard(
        edges, zs, pids, origins, cfg.tile_logsize, True))
    vis_plain_ms = median_ms(lambda: cuda_vis.visibility_hard_reference(
        edges, zs, pids, origins, cfg.tile_logsize, True), reps=5, warmup=1)
    steps, covered = covered_steps(setup, pids, origins, cfg)
    vis_bound = bound(nbytes(edges, zs, pids, origins) + 4 * T * 1024,
                      steps * DIFF_VIS_STEP_OPS
                      + covered * DIFF_VIS_COVERED_OPS)
    timing["visibility_1024"] = {
        "kernel_ms": vis_ms, "plain_ms": vis_plain_ms, "T": T, "M": M,
        "pixel_steps": steps, "covered_steps": covered, "bound": vis_bound}
    acc_timing = {}
    for name in ("texel", "record", "vertex_pos", "vertex_uv"):
        idx, val, R = acc_inputs[name]
        N, C = val.shape
        keep = (idx >= 0) & (idx < R)
        # the library call takes no out-of-range row: it gets the kept ones
        idx64, val_kept = idx[keep].long(), val[keep]
        acc_timing[name] = {
            "N": N, "R": R, "C": C,
            "kernel_ms": median_ms(
                lambda: cuda_texgrad.accumulate_rows(idx, val, R)),
            "plain_ms": acc_cases[name]["plain_ms"],
            "library_ms": median_ms(lambda: torch.zeros(
                (R, C), dtype=torch.float32, device=dev).index_add_(
                    0, idx64, val_kept)),
            # the function's bound: idx and val read once, the table
            # written once, one add a kept value's column (the record
            # class's list padding, idx -1, is dropped) ...
            "bound": bound(N * (4 + 4 * C) + 4 * R * C, int(keep.sum()) * C),
            # ... and, beside it, what this owner-computes algorithm adds:
            # one int32 compare a (row, value) pair
            "algorithm_ops": R * N,
            "algorithm_ops_ms": R * N / INT32_OPS_PER_S * 1e3}
    timing["accumulate_1024"] = acc_timing
    for size in (512, DIFF_SIZE):
        params, static, cfg = scene(check.train_scene, size)

        def forward():
            img, _ = pipeline.render_deferred(params, static, cfg)
            return check.loss_of(img, cfg)

        fwd_ms = median_ms(forward)
        step_ms = median_ms(lambda: check.step(params, static, cfg))
        bwd = []
        for _ in range(REPS):
            for p in params.values():
                p.grad = None
            loss = forward()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            loss.backward()
            t1.record()
            t1.synchronize()
            bwd.append(t0.elapsed_time(t1))
        timing[f"step_{size}"] = {
            "forward_ms": fwd_ms, "backward_ms": float(np.median(bwd)),
            "step_ms": step_ms, "mpix_per_s": size * size / step_ms / 1e3}
    phase("diff_timing", card=card, reps=REPS, **timing)

    tex = acc_timing["texel"]
    return [{
        "name": "diff_visibility", "route": "cuda",
        "source": "skybox_rt_tpu_torch/csrc/diff_visibility.cu",
        "replaces": "skybox_rt_tpu/diff/pallas_vis.py:67",
        "launches": sgd_launches[0], "max_abs_err": vis_err, "ms": vis_ms,
        "plain_ms": vis_plain_ms, **vis_bound,
        "library_ms": None,     # no single PyTorch call computes this
        "steps": DIFF_STEPS, "tiles": T, "M": M}, {
        "name": "diff_accumulate", "route": "cuda",
        "source": "skybox_rt_tpu_torch/csrc/diff_accumulate.cu",
        "replaces": "skybox_rt_tpu/diff/pallas_texgrad.py:41",
        "launches": sgd_launches[1], "max_abs_err": acc_err,
        "ms": tex["kernel_ms"], "plain_ms": tex["plain_ms"], **tex["bound"],
        "algorithm_ops": tex["algorithm_ops"],
        "algorithm_ops_ms": tex["algorithm_ops_ms"],
        "library_ms": tex["library_ms"],    # zeros(R, C).index_add_(0, ...)
        "steps": DIFF_STEPS, "shape": "texel table: N, R, C = "
        f"{tex['N']}, {tex['R']}, {tex['C']}",
        "step_ms": {n: c["kernel_ms"] for n, c in acc_timing.items()},
        "step_bound_ms": {n: c["bound"]["bound_ms"]
                          for n, c in acc_timing.items()},
        "step_algorithm_ops_ms": {n: c["algorithm_ops_ms"]
                                  for n, c in acc_timing.items()},
        "step_library_ms": {n: c["library_ms"]
                            for n, c in acc_timing.items()}}]


C3_GOLDEN_SIZE = 128    # the size of the committed JAX golden of config 3
C3_SIZE = 1024          # the full-width config-3 frame


def config3_phases(dev, card) -> list:
    """Phases 20 to 25: the ray-traced CGLTrace frame (config 3), rt.diff and
    the two comparison engines; returns the entries of the kernels line for
    the next-hit-after, streamed and worklist kernels."""
    import math

    from skybox_rt_tpu_torch.diff import cuda_texgrad
    from skybox_rt_tpu_torch.geom import cgltrace
    from skybox_rt_tpu_torch.models import scenes
    from skybox_rt_tpu_torch.ops import cuda_rt
    from skybox_rt_tpu_torch.rt import bvh as bvh_mod
    from skybox_rt_tpu_torch.rt import diff as rt_diff
    from skybox_rt_tpu_torch.rt import frame as frame_mod
    from skybox_rt_tpu_torch.rt import intersect, tracer
    from skybox_rt_tpu_torch.rt import raster_bridge as rb

    def on_card(a):
        return None if a is None else torch.as_tensor(np.array(a), device=dev)

    def start(R):
        return (torch.full((R,), -math.inf, dtype=torch.float32, device=dev),
                torch.full((R,), -1, dtype=torch.int32, device=dev))

    def compare_walks(o, d, tm, blocks, walks, plain_on=None, stats=None):
        """`walks` walks of the kernel fed back into each other; walk k of
        plain_on (all of them when None) against the plain version from the
        same carry, bit for bit.  Returns ([kernel outputs a walk], rays
        that differ, max |diff|, [plain seconds of the compared walks])."""
        tlo, slo = start(o.shape[0])
        outs, bad, err, plain_s = [], 0, 0.0, []
        for k in range(walks):
            got = cuda_rt.closest_hit_bvh_after(o, d, blocks, tlo, slo,
                                                t_max=tm, t_min=1e-6)
            if plain_on is None or k in plain_on:
                want, sec = timed(
                    lambda: cuda_rt.closest_hit_bvh_after_reference(
                        o, d, blocks, tlo, slo, tm, 1e-6,
                        stats=None if stats is None else
                        stats.setdefault(k, {})))
                n, e = differ(got, want)
                bad, err = bad + n, max(err, e)
                plain_s.append(sec)
            outs.append(got)
            tlo, slo = got[2], got[0]
        if bad:
            raise AssertionError(f"closest_hit_bvh_after != plain version on "
                                 f"{bad} rays, max |diff| {err}")
        return outs, bad, err, plain_s

    # 20a. the check soups, whole: every walk against the plain version
    soups = {}
    for name in scenes.AFTER_CHECK_SOUPS:
        v0, e1, e2, tri_block, o, d, tm, walks = scenes.after_check_queries(
            name)
        verts, faces = scenes.soup_mesh(v0, e1, e2)
        blocks = cuda_rt.prepare_bvh_blocks(
            on_card(v0), on_card(e1), on_card(e2), bvh_mod.build_block_set(
                bvh_mod.build_sah(verts, faces), tri_block=tri_block))
        outs, bad, err, _ = compare_walks(on_card(o), on_card(d), on_card(tm),
                                          blocks, walks)
        hits = [int((g[1] >= 0).sum()) for g in outs]
        if hits[0] == 0 or hits[-1] != 0:
            raise AssertionError(f"{name}: hits a walk {hits}")
        first = cuda_rt.closest_hit_bvh(on_card(o), on_card(d), blocks,
                                        t_max=on_card(tm), t_min=1e-6)
        if differ(outs[0][1:], first)[0]:
            raise AssertionError(f"{name}: walk 1 != closest_hit_bvh")
        ts = torch.stack([g[2] for g in outs], 1)
        fin = torch.isfinite(ts[:, 1:])
        soups[name] = {"walks": walks, "hits_a_walk": hits,
                       "rays_differ": bad,
                       "tied_steps": int(((ts[:, 1:] == ts[:, :-1])
                                          & fin).sum())}
        if soups[name]["tied_steps"] == 0:
            raise AssertionError(f"{name}: no hit of equal t was enumerated")

    # 21. the golden's size: the frame against the committed JAX golden and
    # against the port's scan oracle on the card
    with np.load(os.path.join(
            cgltrace.DATA_DIR, f"synth_config3_{C3_GOLDEN_SIZE}.npz")) as z:
        golden = {k: z[k] for k in z.files}
    n = C3_GOLDEN_SIZE
    trace = cgltrace.load_trace(cgltrace.trace_path("synth_config3"))
    img = frame_mod.render_trace_rt_fused(trace, n, n)
    fn, arrays, rays, metas = frame_mod.make_frame_fn(trace, n, n)
    if rays[0].device.type != "cuda":
        raise AssertionError("rt.frame.make_frame_fn did not default to the "
                             "card")
    plan = [(m["draw_index"], m["mode"], m["K"], m["P"]) for m in metas]
    if [p[1] for p in plan] != list(golden["modes"]) \
            or [p[2] for p in plan] != list(golden["K"]) \
            or [p[3] for p in plan] != list(golden["P"]):
        raise AssertionError(f"plan {plan} != the JAX golden's "
                             f"{list(golden['modes'])} {list(golden['K'])}")
    cuda_rt.reset_launch_counts()
    zbuf, color, ovf = fn(arrays, *rays)
    torch.cuda.synchronize()
    want_launches = {
        "closest_hit_bvh": sum(m["mode"] == "winner" for m in metas),
        "closest_hit_bvh_after": sum(
            m["K"] + (m["K"] < m["P"]) for m in metas if m["mode"] == "kslot")}
    if dict(cuda_rt.launch_counts) != want_launches or bool(ovf.any()):
        raise AssertionError(f"{n} frame launched "
                             f"{dict(cuda_rt.launch_counts)}, expected "
                             f"{want_launches}; overflow {ovf.tolist()}")
    if not np.array_equal(color.reshape(n, n, 4).cpu().numpy(), img):
        raise AssertionError("two frames of one plan differ")
    diff = np.abs(img - golden["color"])
    far = (diff > 1e-4).any(-1)
    within = float((diff <= 2e-5).mean())
    margins = frame_mod.fragment_margins(trace, n, n)
    unexplained = int((far & ~(margins < 1e-4)).sum())
    if within < 0.999 or unexplained:
        raise AssertionError(
            f"{n} frame != JAX golden: {within} of the values within 2e-5, "
            f"{unexplained} pixels beyond 1e-4 with no graze or tie")
    zb = zbuf.reshape(n, n).cpu().numpy()
    finite = np.isfinite(golden["zbuf"])
    if not np.array_equal(np.isfinite(zb), finite) or np.abs(
            zb[finite] - golden["zbuf"][finite]).max() > 2e-5:
        raise AssertionError(f"{n} frame: zbuf != JAX golden")
    oracle, oracle_s = timed(lambda: rb.render_trace_rt(
        trace, n, n, engine="brute", camera="perspective"))
    oracle_diff = float(np.abs(img - oracle).max())
    if oracle_diff > 1e-3:
        raise AssertionError(f"{n} frame != scan oracle: {oracle_diff}")
    phase(f"rt_config3_{n}", size=n, plan=plan, launches=want_launches,
          max_abs_diff_jax=float(diff.max()),
          values_beyond_2e5=int((diff > 2e-5).sum()), values=int(diff.size),
          graze_or_tie_pixels_beyond_1e4=int(far.sum()),
          max_abs_diff_scan_oracle=oracle_diff, scan_oracle_s=oracle_s)

    # 22. the full-width frame: the main path.  A new trace object has no
    # hints: the retry converges from K = 1.
    N = C3_SIZE
    trace = cgltrace.load_trace(cgltrace.trace_path("synth_config3"))
    rounds = []
    make = frame_mod.make_frame_fn

    def counting(*a, **kw):
        rounds.append(1)
        return make(*a, **kw)

    frame_mod.make_frame_fn = counting
    try:
        img, first_s = timed(
            lambda: frame_mod.render_trace_rt_fused(trace, N, N))
    finally:
        frame_mod.make_frame_fn = make
    fn, arrays, rays, metas = frame_mod.make_frame_fn(trace, N, N)
    ks = [m["K"] for m in metas]
    # a finer grid meets more rays that pass exactly through a shared edge,
    # where both neighbours count: K may exceed the golden size's, never
    # fall below it
    if len(rounds) > 8 or any(k < g for k, g in zip(ks, golden["K"])) \
            or [m["mode"] for m in metas] != list(golden["modes"]):
        raise AssertionError(f"1024 frame: {len(rounds)} rounds, K {ks}, the "
                             f"golden's {golden['K'].tolist()}")
    want_launches = {
        "closest_hit_bvh": sum(m["mode"] == "winner" for m in metas),
        "closest_hit_bvh_after": sum(
            m["K"] + (m["K"] < m["P"]) for m in metas if m["mode"] == "kslot")}
    torch.cuda.synchronize()
    cuda_rt.reset_launch_counts()
    # a wait for the device or a copy from the host inside the frame raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        zbuf, color, ovf = fn(arrays, *rays)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = dict(cuda_rt.launch_counts)        # read just after the frame
    ovf = ovf.cpu().numpy()                     # the one readback
    if counts != want_launches or ovf.any() \
            or len(ovf) != len(frame_mod.probed_draws(metas)):
        raise AssertionError(f"1024 frame launched {counts}, expected "
                             f"{want_launches}; overflow {ovf.tolist()}")
    color = color.reshape(N, N, 4)
    if color.dtype != torch.float32 or not bool(torch.isfinite(color).all()) \
            or float(color.min()) < 0.0 or float(color.max()) > 1.0:
        raise AssertionError("1024 frame: a value is not finite or leaves "
                             "[0, 1]")
    if not np.array_equal(color.cpu().numpy(), img):
        raise AssertionError("1024 frame: two frames of one plan differ")
    # 1024 / 128 = 8: the golden's pixel centres are not rays of this frame;
    # the mean over each 8 x 8 cell is held to the golden's pixel loosely
    cells = color.reshape(n, N // n, n, N // n, 4).mean((1, 3)).cpu().numpy()
    cell_diff = float(np.abs(cells - golden["color"]).mean())
    if cell_diff > 0.02:
        raise AssertionError(f"1024 frame is not the {n} frame's image: "
                             f"mean |cell - pixel| {cell_diff}")
    (again, _), cached_s = timed(lambda: (frame_mod.make_frame_fn(
        trace, N, N), None))
    if again[0] is not fn:
        raise AssertionError("the second make_frame_fn built a new plan")
    phase("rt_config3_1024", rays=N * N, rounds=len(rounds), K=ks,
          K_at_golden_size=golden["K"].tolist(),
          plan=[(m["draw_index"], m["mode"], m["K"], m["P"]) for m in metas],
          launches=counts, overflow=ovf.tolist(), finite=True,
          no_sync_in_frame=True, mean_rgba=[float(x) for x in
                                            color.mean((0, 1))],
          mean_abs_cell_diff_from_golden=cell_diff,
          host_s={"first_render_with_retry": first_s,
                  "make_frame_fn_cached": cached_s})

    # 20b. every walk of every kslot draw of that frame on a 65,536-ray
    # sample, walk 1 and the last walk on all rays; walk 1 == kernel #2
    nx, ny = rays
    dirs = torch.stack([nx, ny, torch.ones_like(nx)], -1).contiguous()
    eye = torch.zeros_like(dirs)
    stride = N * N // RT_SAMPLE
    ds_, es_ = dirs[::stride].contiguous(), eye[::stride].contiguous()
    draws, largest, entry_stats = {}, None, None
    after_err, after_bad = 0.0, 0
    for meta, arr in zip(metas, arrays):
        if meta["mode"] != "kslot":
            continue
        blocks = arr["blocks"]
        walks = meta["K"] + (meta["K"] < meta["P"])
        stats = {}
        outs, bad, err, plain_s = compare_walks(es_, ds_, None, blocks, walks,
                                                stats=stats)
        full_stats = {}
        full, bad2, err2, full_s = compare_walks(
            eye, dirs, None, blocks, walks, plain_on={0, walks - 1},
            stats=full_stats)
        first = cuda_rt.closest_hit_bvh(eye, dirs, blocks, t_min=1e-6)
        if differ(full[0][1:], first)[0]:
            raise AssertionError(f"draw {meta['draw_index']}: walk 1 != "
                                 f"closest_hit_bvh on the same blocks")
        after_err = max(after_err, err, err2)
        after_bad += bad + bad2
        draws[meta["draw_index"]] = {
            "P": meta["P"], "K": meta["K"], "walks": walks,
            "blocks": blocks["num_blocks"],
            "hits_a_walk_sample": [int((g[1] >= 0).sum()) for g in outs],
            "tri_tests_per_ray": [stats[k]["tri_tests"] / RT_SAMPLE
                                  for k in range(walks)],
            "blocks_entered_per_ray": [stats[k]["slab_pass"] / RT_SAMPLE
                                       for k in range(walks)],
            "plain_ms_sample": [x * 1e3 for x in plain_s],
            "plain_ms_all_rays_first_last": [x * 1e3 for x in full_s],
            "rays_differ": bad + bad2}
        if largest is None or meta["P"] > largest[0]["P"]:
            largest, entry_stats = (meta, arr), (full_stats, full_s)
    phase("rt_after_vs_plain", soups=soups, draws=draws, equal=True,
          sample_rays=RT_SAMPLE, rays_differ=after_bad,
          max_abs_err=after_err)
    meta, arr = largest
    blocks = arr["blocks"]
    st0 = entry_stats[0][0]
    after_entry = {
        "name": "rt_closest_hit_bvh_after", "route": "cuda",
        "source": "skybox_rt_tpu_torch/csrc/rt_bvh.cu",
        "replaces": "skybox_rt_tpu/ops/pallas_rt.py:1323",
        "launches": counts["closest_hit_bvh_after"], "max_abs_err": after_err,
        "ms": None, "plain_ms": entry_stats[1][0] * 1e3,
        **bound(nbytes(eye, dirs, blocks["tri"], blocks["bcnt"],
                       blocks["s2p"], blocks["aabb"]) + (8 + 20) * N * N,
                st0["tri_tests"] * MT_OPS + st0["slab_pass"] * SLAB_OPS),
        "library_ms": None,     # no single PyTorch call computes this
        "rays": N * N, "rays_differ": after_bad,
        "draw": meta["draw_index"], "triangles": meta["P"],
        "tri_tests_per_ray": st0["tri_tests"] / (N * N),
        "blocks_entered_per_ray": st0["slab_pass"] / (N * N)}

    # 23. rt.diff on the card: forward and backward, against the CPU run of
    # the same code, twice
    verts, faces = scenes.multi_sphere(n=4, subdiv=2)
    rng = np.random.default_rng(4)
    vcol = rng.uniform(0.2, 1.0, size=(verts.shape[0], 4)).astype(np.float32)
    o, d = scenes.aimed_rays(16384, seed=21)
    wts = rng.uniform(0.5, 1.5, size=(o.shape[0], 3)).astype(np.float32)
    light = (0.4, 0.8, 0.45)
    bvh = bvh_mod.build(verts, faces)

    def run(which, device):
        v = torch.tensor(verts, device=device, requires_grad=True)
        c = torch.tensor(vcol, device=device, requires_grad=True)
        if which == "lambert":
            img = rt_diff.render_lambert(
                v, faces, c, o, d, light, bvh.as_device_arrays(device),
                device=device)
        else:
            img = rt_diff.render_lambert_soft(v, faces, c, o, d, light, K=4,
                                              device=device)
        (img * torch.as_tensor(wts, device=device)).sum().backward()
        return img.detach(), v.grad, c.grad

    diff_figs = {}
    for which in ("lambert", "lambert_soft"):
        cuda_texgrad.reset_launch_count()
        (img_a, gv_a, gc_a), card_s = timed(lambda: run(which, dev))
        launches = cuda_texgrad.launch_count
        img_b, gv_b, gc_b = run(which, dev)
        if not (torch.equal(gv_a, gv_b) and torch.equal(gc_a, gc_b)):
            raise AssertionError(f"rt.diff {which}: two runs' gradients "
                                 f"differ")
        if cuda_texgrad.launch_count != 2 * launches or launches == 0:
            raise AssertionError(f"rt.diff {which}: accumulation launches "
                                 f"{launches}, then "
                                 f"{cuda_texgrad.launch_count - launches}")
        img_c, gv_c, gc_c = run(which, "cpu")
        fig = {"accumulate_launches": launches, "card_s": card_s,
               "hit_fraction": float((img_a.sum(-1) > 0).float().mean()),
               "max_abs_image_diff_cpu": float(
                   (img_a.cpu() - img_c).abs().max())}
        ok = bool(torch.isfinite(img_a).all()) \
            and fig["max_abs_image_diff_cpu"] <= 2e-5
        for name, g, gc in (("verts", gv_a, gv_c), ("colors", gc_a, gc_c)):
            scale = float(gc.abs().max())
            err = float((g.cpu() - gc).abs().max())
            fig[f"grad_{name}"] = {"max_abs": scale, "max_abs_diff_cpu": err}
            ok = ok and bool(torch.isfinite(g).all()) and scale > 0 \
                and err <= 1e-4 * scale
        if not ok:
            raise AssertionError(f"rt.diff {which} on the card: {fig}")
        diff_figs[which] = fig
    phase("rt_diff", rays=int(o.shape[0]), triangles=int(faces.shape[0]),
          gradients_bit_identical=True, **diff_figs)

    # 24. the streamed and worklist kernels: the check scenes, then the six
    # launches of the small scene's 1024x1024 frame
    def stream_compare(o, d, tm, stream, clusters, flat, stats=None):
        """Both kernels against their plain versions, against each other
        and the clustered kernel (equal on every ray) and the flat one
        (tie-aware); raises on any mismatch."""
        out = {}
        got = cuda_rt.closest_hit_streamed(o, d, stream, t_max=tm)
        want, out["streamed_plain_ms"] = timed(
            lambda: cuda_rt.closest_hit_streamed_reference(
                o, d, stream, tm, stats=None if stats is None else
                stats.setdefault("streamed", {})))
        lists = cuda_rt.active_block_lists(o, d, stream, tm)
        got_w = cuda_rt.closest_hit_worklist(o, d, stream, t_max=tm,
                                             lists=lists)
        want_w, out["worklist_plain_ms"] = timed(
            lambda: cuda_rt.closest_hit_worklist_reference(
                o, d, stream, *lists, tm, stats=None if stats is None else
                stats.setdefault("worklist", {})))
        out["streamed_plain_ms"] *= 1e3
        out["worklist_plain_ms"] *= 1e3
        out["streamed_rays_differ"], e1_ = differ(got, want)
        out["worklist_rays_differ"], e2_ = differ(got_w, want_w)
        out["max_abs_err"] = max(e1_, e2_)
        out["streamed_differ_from_worklist"] = differ(got, got_w)[0]
        out["differ_from_clustered"] = differ(
            got, cuda_rt.closest_hit_clustered(o, d, clusters, t_max=tm))[0]
        if any(out[k] for k in out if "differ" in k):
            raise AssertionError(f"streamed / worklist kernels: {out}")
        out["prims_tied_with_flat"] = scenes.check_clustered_equals_flat(
            [x.cpu().numpy() for x in got],
            [x.cpu().numpy() for x in cuda_rt.closest_hit_pallas(
                o, d, flat, t_max=tm)])
        out["mean_list_length"] = float(lists[1].float().mean())
        return out

    def pack(verts, faces, bvh, tri_block=cuda_rt.STREAM_TRI_BLOCK):
        tri = intersect.triangle_arrays(
            on_card(verts), on_card(np.asarray(faces, np.int64)))
        cl = bvh_mod.build_clusters(bvh, 64)
        return (cuda_rt.prepare_stream_blocks(*tri, order=cl["order"],
                                              tri_block=tri_block),
                cuda_rt.prepare_clusters(*tri, cl), cuda_rt.pack_records(*tri))

    checks = {"cases": 0, "rays_differ": 0, "prims_tied_with_flat": 0}
    for name in sorted(scenes.CLUSTER_CHECK_SCENES):
        verts, faces, _, queries = scenes.cluster_check_queries(name)
        packed = pack(verts, faces, bvh_mod.build(verts, faces), 24)
        for _, _, o, d, tm in queries:
            tm = None if tm is None else cuda_rt._per_ray_tmax(
                on_card(tm) if np.ndim(tm) else tm, o.shape[0], dev)
            out = stream_compare(on_card(o), on_card(d), tm, *packed)
            checks["cases"] += 1
            checks["prims_tied_with_flat"] += out["prims_tied_with_flat"]

    scene, cam = small_scene()
    scene.finalize()
    P = int(scene.faces.shape[0])
    stream, clusters, flat = pack(scene.verts, scene.faces, scene.bvh)
    kw = dict(width=RT_SIZE, height=RT_SIZE, bounces=2, shadows=True)
    base_fn, (o1024, d1024) = tracer.make_frame_fn(scene, cam,
                                                   tracer.RTConfig(**kw))
    launches = capture_launches(
        scene, tracer.RTConfig(**kw),
        lambda o, d: cuda_rt.closest_hit_clustered(o, d, clusters),
        lambda o, d, tm: cuda_rt.any_hit_clustered(o, d, clusters, t_max=tm),
        o1024, d1024)
    classes = {}
    for name, launch in zip(LAUNCH_NAMES, launches):
        os_, ds2, tms = sample_launch(name, launch)
        stats = {}
        out = stream_compare(os_, ds2, tms, stream, clusters, flat, stats)
        classes[name] = {
            "launch_rays": int(launch[1].shape[0]),
            "parked_in_sample": int((os_[:, 0] > 1e7).sum()), **out,
            **{f"{q}_{k}_per_ray": stats[q][k] / RT_SAMPLE
               for q in ("streamed", "worklist")
               for k in ("slab_tests", "tri_tests")}}
    # the whole primary launch: the shapes of the kernels line
    _, o, d, tm = launches[0]
    stats = {}
    primary = stream_compare(o, d, tm, stream, clusters, flat, stats)
    R = o.shape[0]
    moved = nbytes(o, d, stream["tri"], stream["aabb"], stream["order"]) \
        + 16 * R
    lists = cuda_rt.active_block_lists(o, d, stream, tm)
    stream_entries = []
    for q, line, extra in (("streamed", 384, 0),
                           ("worklist", 638, nbytes(*lists))):
        stream_entries.append({
            "name": f"rt_closest_hit_{q}", "route": "cuda",
            "source": "skybox_rt_tpu_torch/csrc/rt_streamed.cu",
            "replaces": f"skybox_rt_tpu/ops/pallas_rt.py:{line}",
            "launches": None, "max_abs_err": primary["max_abs_err"],
            "ms": None, "plain_ms": primary[f"{q}_plain_ms"],
            **bound(moved + extra, stats[q]["tri_tests"] * MT_OPS
                    + stats[q]["slab_tests"] * SLAB_OPS),
            "library_ms": None,     # no single PyTorch call computes this
            "rays": R, "rays_differ": primary[f"{q}_rays_differ"],
            "slab_tests_per_ray": stats[q]["slab_tests"] / R,
            "tri_tests_per_ray": stats[q]["tri_tests"] / R})
    # both engines' full-width frames: 3 + 3 launches of their one kernel
    # (closest, and the closest hit inside the bound as the occlusion
    # query), the image the clustered frame's
    base = base_fn(o1024, d1024)
    frames = {}
    for entry, engine in zip(stream_entries,
                             ("pallas_streamed", "pallas_worklist")):
        fn_e, (oe, de) = tracer.make_frame_fn(
            scene, cam, tracer.RTConfig(engine=engine, **kw))
        torch.cuda.synchronize()
        cuda_rt.reset_launch_counts()
        img_e = fn_e(oe, de)
        torch.cuda.synchronize()
        got_counts = dict(cuda_rt.launch_counts)
        key = entry["name"].removeprefix("rt_")
        if got_counts != {key: 6}:
            raise AssertionError(f"{engine} frame launched {got_counts}, "
                                 f"expected 6 of {key}")
        max_diff = float((img_e - base).abs().max())
        if max_diff != 0.0:
            raise AssertionError(f"{engine} frame != clustered frame: max "
                                 f"|diff| {max_diff}")
        entry["launches"] = 6
        frames[engine] = {"launches": got_counts,
                          "max_abs_diff_clustered_frame": max_diff,
                          "fn": (fn_e, oe, de)}
    phase("rt_streamed_worklist", checks=checks, triangles=P,
          blocks=stream["num_blocks"], tri_block=stream["tri_block"],
          ray_tile=cuda_rt.STREAM_RAY_TILE, classes=classes,
          primary={k: v for k, v in primary.items()},
          frames={e: {k: v for k, v in f.items() if k != "fn"}
                  for e, f in frames.items()},
          equal=True, rays_differ=0)

    # 25. timing (printed, not judged)
    t = {"after_walks_ms": {}, "winner_ms": {}}
    for m, a in zip(metas, arrays):
        if m["mode"] == "winner":
            oo, dd = ((dirs * m["far_d"], -dirs) if m["farthest"]
                      else (eye, dirs))
            t["winner_ms"][m["draw_index"]] = median_ms(
                lambda: cuda_rt.closest_hit_bvh(oo, dd, a["blocks"],
                                                t_min=1e-6))
        elif m["mode"] == "kslot":
            walks = m["K"] + (m["K"] < m["P"])
            outs, _, _, _ = compare_walks(eye, dirs, None, a["blocks"], walks,
                                          plain_on=set())
            carries = [start(N * N)] + [(g[2], g[0]) for g in outs[:-1]]
            t["after_walks_ms"][m["draw_index"]] = [median_ms(
                lambda: cuda_rt.closest_hit_bvh_after(
                    eye, dirs, a["blocks"], tlo, slo, t_min=1e-6))
                for tlo, slo in carries]
    after_entry["ms"] = t["after_walks_ms"][meta["draw_index"]][0]
    after_entry["walk_ms"] = t["after_walks_ms"]
    after_entry["frame_ms"] = sum(sum(v) for v in
                                  t["after_walks_ms"].values())
    scan = next((m, a) for m, a in zip(metas, arrays) if m["mode"] == "scan")
    zb0, c0 = rb.clear_buffers(N * N, dev)
    t["scan_draw_ms"] = median_ms(lambda: rb._scan_run(
        scan[0]["statics"], scan[1], nx, ny, zb0, c0))
    t["scan_triangles"] = scan[0]["P"]
    t["frame_1024_ms"] = median_ms(lambda: fn(arrays, nx, ny))
    frame_mod.render_trace_rt_fused(trace, 512, 512)
    fn5, arr5, rays5, _ = frame_mod.make_frame_fn(trace, 512, 512)
    t["frame_512_ms"] = median_ms(lambda: fn5(arr5, *rays5))
    t["kernels_1024_ms"] = after_entry["frame_ms"] + sum(
        t["winner_ms"].values())
    t["mpix_per_s_1024"] = N * N * len(metas) / t["frame_1024_ms"] / 1e3
    _, o, d, tm = launches[0]
    s_entry, w_entry = stream_entries
    s_entry["ms"] = median_ms(
        lambda: cuda_rt.closest_hit_streamed(o, d, stream))
    w_entry["ms"] = median_ms(
        lambda: cuda_rt.closest_hit_worklist(o, d, stream, lists=lists))
    w_entry["prepass_ms"] = median_ms(
        lambda: cuda_rt.active_block_lists(o, d, stream), reps=5, warmup=1)
    w_entry["with_prepass_ms"] = median_ms(
        lambda: cuda_rt.closest_hit_worklist(o, d, stream), reps=5, warmup=1)
    small = {"streamed_ms": s_entry["ms"], "worklist_ms": w_entry["ms"],
             "worklist_prepass_ms": w_entry["prepass_ms"],
             "worklist_with_prepass_ms": w_entry["with_prepass_ms"],
             "clustered_ms": median_ms(
                 lambda: cuda_rt.closest_hit_clustered(o, d, clusters)),
             "flat_ms": median_ms(
                 lambda: cuda_rt.closest_hit_pallas(o, d, flat), reps=3,
                 warmup=1)}
    for engine, f in frames.items():
        fn_e, oe, de = f["fn"]
        small[f"{engine}_frame_ms"] = median_ms(lambda: fn_e(oe, de), reps=5,
                                                warmup=1)
    small["clustered_frame_ms"] = median_ms(lambda: base_fn(o1024, d1024))
    phase("rt_config3_timing", card=card, reps=REPS, config3=t,
          small_scene_primary=small)
    return [after_entry] + stream_entries


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    dev = torch.device("cuda")
    card = nvidia_smi()
    phase("device", kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=card,
          torch=torch.__version__, cuda=torch.version.cuda)

    sys.path.insert(0, REPO)
    from skybox_rt_tpu_torch import _build
    from skybox_rt_tpu_torch.core import fixed
    from skybox_rt_tpu_torch.core.state import RenderState
    from skybox_rt_tpu_torch.geom import cgltrace
    from skybox_rt_tpu_torch.om.depth_stencil import DepthStencilState
    from skybox_rt_tpu_torch.om.merger import OMState
    from skybox_rt_tpu_torch.ops import cuda_raster, deferred
    from skybox_rt_tpu_torch.ref import driver

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    with open(lib_path + ".log") as f:
        log = f.read().splitlines()
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          library=os.path.relpath(lib_path, REPO), nvcc=log[0],
          ptxas=[ln.strip() for ln in log
                 if "registers" in ln or "spill" in ln])

    trace_file = cgltrace.trace_path("synth_draw3d")

    def draw_inputs(width, height, tls, d):
        trace = cgltrace.load_trace(trace_file)
        rs, texels, b = driver.prepare_drawcalls(trace, width, height, tls,
                                                 device=dev)[d]
        edges, attribs, zattr, tile_pids, tile_xy = \
            deferred.device_arrays(b, dev)
        T = tile_pids.shape[0]
        ts = 1 << tls
        fbd = torch.full((T, ts, ts), -1, dtype=torch.int32, device=dev)
        return rs, (edges, zattr, tile_pids, tile_xy, fbd), b

    def compare(rs, args, tls, K):
        got = cuda_raster.visibility_tiles(rs, *args, tls, fused=K == 0,
                                           blend_slots=K)
        want = cuda_raster.visibility_tiles_reference(
            rs, *args, tls, fused=K == 0, blend_slots=K)
        torch.cuda.synchronize()
        return max_abs_err(got, want)

    # 3. kernel vs plain version
    err, cases = 0, 0
    for d in range(4):
        for tls in cuda_raster.TILE_LOGSIZES:
            rs, args, b = draw_inputs(SIZE, SIZE, tls, d)
            for K in (0, 4, 16):
                err = max(err, compare(rs, args, tls, K))
                cases += 1
    # OM variants over the stencil draw's geometry and seeded ds words:
    # every compare func and stencil op reaches the kernel's ds test
    rs3, args3, _ = draw_inputs(SIZE, SIZE, 5, 3)
    rng = np.random.default_rng(0)
    fbd = rng.integers(0, 2**32, size=tuple(args3[4].shape), dtype=np.uint64)
    args3 = args3[:4] + (fixed.from_numpy_u32(fbd, device=dev),)
    for f in range(8):
        ds = DepthStencilState(
            depth_func=(f + 3) % 8, depth_writemask=f % 2 == 0,
            stencil_front_func=f, stencil_front_zpass=f,
            stencil_front_zfail=(f + 3) % 8, stencil_front_fail=(f + 5) % 8,
            stencil_front_ref=0x2A + f, stencil_front_mask=0xF0 >> (f % 4),
            stencil_back_func=0, stencil_back_zpass=0, stencil_back_zfail=0,
            stencil_back_fail=0, stencil_back_ref=0, stencil_back_mask=0xFF)
        om = OMState(ds=ds, blend=rs3.om.blend, depth_writemask=f % 3 != 0,
                     stencil_front_writemask=(0xFF, 0x3C, 0)[f % 3],
                     stencil_back_writemask=0, cbuf_writemask4=0xF)
        rs = RenderState(flags=rs3.flags, om=om, tex=None,
                         scissor=(3, 5, SIZE - 7, SIZE - 2))
        for K in (0, 4):
            err = max(err, compare(rs, args3, 5, K))
            cases += 1
    rs1k, args1k, b1k = draw_inputs(1024, 1024, 5, TEXTURED_DRAW)
    for K in (0, 4):
        err = max(err, compare(rs1k, args1k, 5, K))
        cases += 1
    phase("kernel_vs_plain", cases=cases, max_abs_err=err, equal=True)

    # 4. the frame through the port's entry points
    with np.load(os.path.join(cgltrace.DATA_DIR,
                              "synth_draw3d_256.npz")) as z:
        golden = z["color"]
    trace = cgltrace.load_trace(trace_file)
    cuda_raster.reset_launch_count()
    fb = driver.render_trace(trace, SIZE, SIZE, mode="deferred", device=dev)
    launches = cuda_raster.launch_count
    ks = trace._blend_k_cache[(SIZE, SIZE, 5)]
    draws = len(ks)
    retries = sum(1 for k in ks.values()
                  if k > deferred.DEFAULT_BLEND_SLOTS)
    if not np.array_equal(fb, golden):
        raise AssertionError(f"render_trace != JAX framebuffer: "
                             f"{int((fb != golden).sum())} pixels differ")
    if launches != draws + retries or launches == 0:
        raise AssertionError(f"kernel launches {launches} != draws {draws} "
                             f"+ blend retries {retries}")
    cuda_raster.reset_launch_count()
    cached = driver.render_trace(trace, SIZE, SIZE, mode="deferred",
                                 device=dev)
    cached_launches = cuda_raster.launch_count
    frame, arrays = driver.compile_frame(trace, SIZE, SIZE, mode="deferred",
                                         device=dev)
    cuda_raster.reset_launch_count()
    framed = fixed.to_numpy_u32(frame(arrays))
    frame_launches = cuda_raster.launch_count
    immediate = driver.render_trace(trace, SIZE, SIZE, mode="immediate",
                                    device=dev)
    for name, img in (("cached", cached), ("compile_frame", framed),
                      ("immediate", immediate)):
        if not np.array_equal(img, golden):
            raise AssertionError(f"{name} frame != JAX framebuffer")
    if cached_launches != draws or frame_launches != draws:
        raise AssertionError(f"cached/compiled frames launched "
                             f"{cached_launches}/{frame_launches}, "
                             f"expected {draws}")
    phase("frame", size=SIZE, draws=draws, blend_k=ks, launches=launches,
          cached_launches=cached_launches, compile_frame_launches=
          frame_launches, equal_to_jax_golden=True, equal_to_immediate=True,
          non_clear_pixels=int((fb != driver.CLEAR_COLOR).sum()))

    # 5. the textured draw alone at 1024x1024
    with open(os.path.join(cgltrace.DATA_DIR, "synth_draw1024.json")) as f:
        want1k = json.load(f)
    rs, texels, b = driver.prepare_drawcalls(
        cgltrace.load_trace(trace_file), 1024, 1024, device=dev)[TEXTURED_DRAW]
    fbc, fbd = driver.clear_framebuffers(1024, 1024, 5, dev)
    c, dsb = deferred.render_drawcall(rs, texels, b, fbc, fbd)
    c, dsb = fixed.to_numpy_u32(c), fixed.to_numpy_u32(dsb)
    got1k = {"color_sha256": hashlib.sha256(c.tobytes()).hexdigest(),
             "ds_sha256": hashlib.sha256(dsb.tobytes()).hexdigest(),
             "non_clear_pixels": int((c != driver.CLEAR_COLOR).sum())}
    for k, v in got1k.items():
        if want1k[k] != v:
            raise AssertionError(f"draw1024 {k}: {v} != {want1k[k]}")
    phase("draw1024", **got1k, equal=True)

    # 6. timing (printed, not judged)
    timings = {}
    for label, (rs, args, b, tls) in {
            "pass1_256": draw_inputs(SIZE, SIZE, 5, TEXTURED_DRAW) + (5,),
            "pass1_1024": (rs1k, args1k, b1k, 5)}.items():
        k_ms = median_ms(lambda: cuda_raster.visibility_tiles(
            rs, *args, tls, fused=True))
        p_ms = median_ms(lambda: cuda_raster.visibility_tiles_reference(
            rs, *args, tls, fused=True), reps=5, warmup=1)
        T, M = b.tile_pids.shape
        # each input read once, each of the four fused outputs written once;
        # one prim step a pixel for every real entry of tile_pids, and the
        # covered pixels' extra work for every step the plain version's
        # coverage mask holds
        steps = int((args[2] >= 0).sum()) << (2 * tls)
        covered = int(sum(cov.sum() for _, cov, *_ in cuda_raster.prim_steps(
            rs, *args, tls, need_grad=False)))
        timings[label] = {"kernel_ms": k_ms, "plain_ms": p_ms, "T": T,
                          "M": M, "pixels": T << (2 * tls),
                          "kernel_mpix_per_s": (T << (2 * tls)) / k_ms / 1e3,
                          "steps": steps, "covered_steps": covered,
                          "bound": bound(
                              nbytes(*args) + 4 * nbytes(args[4]),
                              covered * RASTER_COVERED_FLOAT_OPS,
                              steps * RASTER_STEP_INT_OPS
                              + covered * RASTER_COVERED_INT_OPS)}
    frame_ms = median_ms(lambda: frame(arrays))
    timings["frame_256"] = {
        "ms": frame_ms, "draws": draws,
        "mpix_per_s": SIZE * SIZE * draws / frame_ms / 1e3}
    phase("timing", card=card, reps=REPS, **timings)

    rt_entries = (rt_phases(dev, card) + small_phases(dev, card)
                  + diff_phases(dev, card) + config3_phases(dev, card))

    print(card)
    p256 = timings["pass1_256"]
    print(json.dumps({"kernels": [{
        "name": "raster_visibility", "route": "cuda",
        "source": "skybox_rt_tpu_torch/csrc/raster_visibility.cu",
        "replaces": "skybox_rt_tpu/ops/pallas_raster.py:63",
        "launches": launches, "max_abs_err": err,
        "ms": p256["kernel_ms"], "plain_ms": p256["plain_ms"],
        **p256["bound"],
        "library_ms": None,     # no single PyTorch call computes this
        }] + rt_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
