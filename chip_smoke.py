"""Drive the PyTorch port's six paths on one CUDA card and check them: the
exact-int draw3d raster frame, the ray-traced frame of the large scene, the
ray-traced frame of the small scene, the training step of the differentiable
render, the ray-traced CGLTrace frame (config 3), with the two comparison
engines of the ray tracer beside it, and the apps with the blocked matrix
product; then the stages of the port's benchmark (bench_torch.py), its
command line, and the sharded paths of parallel/ over a torch.distributed
world.  Every raster phase bins its draws with the native C++ engine
(geom.native, built with g++ in phase 2).

    python3 chip_smoke.py

Phases, each printed on its own line; any mismatch raises, so the script
exits non-zero, and only a run where every phase passed prints the final
``{"ok": true, ...}`` line:

  1. device  — needs torch.cuda; prints nvidia-smi's name and power limit
  2. build   — compiles skybox_rt_tpu_torch/csrc/*.cu with nvcc (sm_90a),
               one nvcc per source at the same time, and csrc/binning.cpp
               with g++
  3. kernel  — the CUDA visibility kernel against its plain torch version,
               bit for bit: every draw of the synthetic trace at 256x256,
               fused and K-slot, tile_logsize 3..6, stencil/depth OM
               variants over seeded ds words, the textured draw at
               1024x1024, and seeded random edge coefficients whose values
               wrap (cuda_raster.wrapping_case) at every tile size, K 0 and
               4, under a scissor that leaves some patches outside and cuts
               others
  4. frame   — the 256x256 frame through render_trace and compile_frame,
               bit-equal to the JAX package's committed framebuffer and to
               the port's immediate oracle on the card; the kernel's launch
               count on that run is checked
  5. draw1024 — the textured draw alone at 1024x1024 against its
               committed sha256
  6. timing  — CUDA events, median of 20 after warm-up: kernel (around the
               call, and as a CUDA graph's replay: ``graph_ms``) vs plain
               pass 1 at 256x256 and 1024x1024, beside the pixel steps that
               the warps' cull keeps (``steps``, counted with the plain
               predicate cuda_raster.patch_culled), the cull tests, every
               pixel's steps (``all_steps``, ``all_steps_ops``) and the
               launch's blocks; and the whole 256x256 frame
  7. rt_kernel_vs_plain — the closest-hit and any-hit BVH kernels against
               their plain torch versions, bit for bit: the small check
               scenes whole at leaf sizes 1, 2, 4, 8, 16 and 32, then
               the 184,832-triangle sphere field at the shipped leaf size on
               65,536 rays of each of the six launches of the real
               1024x1024 frame (primary, bounce 1, bounce 2, each with its
               shadow launch; bounce launches hold parked rays), captured
               from the port's trace_rays, and on the whole primary and
               primary-shadow launches.  Tests a ray of each launch at the
               leaves, and ``block_tri_tests_per_ray``, had every entered
               block been tested whole
  8. rt_frame_256 — make_frame_fn at 256x256, 2 bounces, shadows, on the
               default device against the committed JAX golden
               (data/rt_northstar_256.npz, rendered from the same rays):
               atol 1e-4 and >= 99.9 % of values within 2e-5; 3 + 3 launches
  9. rt_frame_1024 — the full-width frame, 1,048,576 rays: finite, alpha 1,
               primary hit mask equal to the plain version's on a 65,536-ray
               sample, 3 + 3 launches and 3 of the shade kernel (the counts
               are set to 0 just before and read just after)
 10. rt_timing — CUDA events, median of 20: each of the six launches'
               kernels alone (around the call, and as a CUDA graph's replay:
               ``graph_ms``, without the host's work around the launch), the
               plain versions on the samples, the tests a ray of phase 7,
               the whole 1024x1024 frame; host seconds of the BVH build and
               the block preparation (printed, not judged)

  11. rt_clustered_vs_plain — the clustered closest-hit, clustered any-hit
               and flat closest-hit kernels against their plain torch
               versions, bit for bit (``rays_differ`` must be 0): the small
               check scenes whole (and one with more clusters than the
               shared-memory stage holds) at cluster group sizes 1, 4, 8
               and 16, then the 12,032-triangle sphere field at the shipped
               group size on 65,536 rays of each of the six launches of its
               real 1024x1024 frame, and on the whole primary and
               primary-shadow launches, with group and cluster slab tests a
               ray (the any hit's too: it walks the same groups).  On the
               same rays the clustered kernels against the flat one:
               occlusion and miss masks equal, every output equal where the
               prims agree, t within rtol 1e-5 where they do not (ties
               across clusters, under 1 % of the hits).  The flat kernel's
               blocks of 128 rays that share one origin (the primary
               sample's all, bounce 1's none: ``flat_blocks_shared``), and
               the flat kernel against its plain version on four blocks of
               primary rays, one with an origin x of -0.0 for the eye's 0.0
               and one with an origin one ulp off (``flat_origin_edges``).
               The flat entry's bound counts the tests' steps the kernel
               runs (ops.cuda_rt.flat_work_counts on the primary sample,
               scaled to the launch)
 12. rt_small_frame_256 — make_frame_fn with the default engine at 256x256,
               2 bounces, shadows, plain and textured, against the committed
               JAX golden (data/rt_small_256.npz): atol 1e-4 and >= 99.9 % of
               values within 2e-5; 3 + 3 launches each
 13. rt_small_frame_1024 — the full-width small-scene frame, 1,048,576 rays:
               finite, alpha 1, hit fraction and mean RGB equal to the 256x256
               frame's to 3 digits, primary hit mask equal to the flat
               kernel's on a 65,536-ray sample.  The counts are set to 0
               just before the frame and read just after it: 3 + 3 clustered
               launches, 3 of the shade kernel and no other; the flat
               kernel's 1 launch that follows
               is this script's oracle check (the tracer reaches that kernel
               through no engine), and its entry says so: ``tracer_launches``
               0, ``launched_by``
 14. rt_small_timing — CUDA events, median of 20 (the flat kernel: of 5):
               each of the six launches' kernels alone (around the call and
               as a CUDA graph's replay), the flat kernel on the primary
               launch (and as a graph's replay, of 5), the plain versions on
               the samples, the whole
               1024x1024 and 256x256 frames
 14b. rt_shade — the shade kernel (csrc/rt_shade.cu) on the benchmark's two
               scenes at 1024x1024, 2 bounces, shadows (the 184,832-triangle
               field untextured, the 12,032-triangle one textured): each of
               a frame's three shade calls, captured from trace_rays, kernel
               against its plain twin bit for bit (outputs and the shadow
               rays handed to the query); the frame bit-equal to the frame
               with rt.tracer.shade_hits patched to the twin; 3 launches a
               frame; CUDA-event medians of 20 of each call with the query's
               answer replayed (the kernel and the torch.where after it,
               around the call and as a graph's replay) and of the twin,
               beside the bound; the kernel's device time a frame under the
               profiler; both frames' medians

  15. diff_vis_vs_plain — the differentiable pipeline's hard-mode visibility
               kernel against the plain chunk reduction (engine="xla") on the
               card, equal on every pixel: random-triangle scenes (seeds 0 and
               3, depth test on and off), tile_logsize 3..6, a scene with
               coplanar duplicates, one with degenerate triangles (w = 1e-30,
               w = 0, zero area), the training icosphere at 512x512 and
               1024x1024, and the warps' cull's edge cases
               (diff.cuda_vis.cull_case: infinite and NaN coefficients,
               zero-area prims, edges exactly 0 at a patch corner) at every
               tile size
 16. diff_accumulate_vs_plain — the row-accumulation kernel against its
               order-exact plain version, bit for bit, and two launches
               bit-identical: (N, R, C) = (3000, 256, 16) with out-of-range
               and negative rows, all five calls of a real 1024x1024
               backward pass, captured (the texel and record tables and the
               pos, color and uv vertex tables), 90 % of the texel table's
               N in one row of 4,096 (skewed), and N = 2,000,000 into
               4,096 rows (long); the largest difference from a float64
               sum is printed
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
 19. diff_timing — CUDA events, median of 20: the visibility kernel (around
               the call and as a CUDA graph's replay) and the plain chunk
               reduction (of 5) at 1024x1024, beside the pixel steps its
               warps' cull keeps, the cull tests and the covered steps
               (diff.cuda_vis.cull_counts), and the bound of every pixel
               step (the earlier one-block-a-tile design's); the accumulation
               kernel, its plain version (one run, from phase 16) and
               ``zeros(R, C).index_add_`` (the library call; it takes only
               the kept rows) on the texel, record, pos and uv tables and
               the skewed and long cases;
               forward, backward and whole step at 512x512 and 1024x1024,
               Mpix/s = size^2 / step time
 19b. diff_shade — the hard one-slot shade's two kernels (csrc/diff_shade.cu)
               at 1024x1024 (T 656, M 56, textured, modulated): each against
               its twin (diff.cuda_shade.shade_*_reference) bit for bit, the
               backward twice alike, the image equal to the plain loop's
               (pipeline.shade_loop) on the card; two steps (check.step)
               alike, 2 launches a step, their four gradients within 1e-4 of
               each one's largest magnitude of a step with the plain loop in
               the kernels' place; CUDA events, median of 20: each kernel
               around the call and as a graph's replay beside its bytes
               bound, the plain loop's forward and its autograd backward
               (its two #5 calls included)
 19c. diff_prim — the triangle set-up's two kernels (csrc/diff_prim.cu) at
               the fit cell's shapes (V 2,562, P 5,120, textured): the
               forward's record, z and corner list equal to the plain
               set-up's (pipeline._prim_setup) on the card, the backward to
               its twin (diff.cuda_prim.prim_backward_reference), bit for
               bit, the backward twice alike; the Function's three gradients
               within 1e-5 of each one's largest magnitude of autograd's
               through the plain set-up; two steps alike, 2 launches a step;
               CUDA events, median of 20: each kernel around the call and as
               a graph's replay beside its bound, the Function's forward and
               backward (its three #5 calls included), and the plain
               set-up's forward and autograd backward

  20. rt_after_vs_plain — the next-hit-after kernel against its plain torch
               version, bit for bit (``rays_differ`` must be 0): the check
               soups whole at leaf sizes 1, 2, 4, 8, 16 and 32 (an exact
               duplicate triangle, a coplanar grid whose rays meet up to eight
               triangles at exactly t = 1, parked rays, a per-ray t_max),
               every walk fed from the one before; then every walk of every
               K-slot draw of the real 1024x1024 config-3 frame on a
               65,536-ray sample, the walks going on past each ray's last
               hit until every ray of the sample has ended, and one more
               (rays with a +inf carry exit at once: the share of them a
               walk is printed); every walk of the frame on all 1,048,576
               rays, whose counted tests give each walk's bound; walk 1
               from (-inf, -1) equal to the closest-hit kernel on the same
               blocks
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
               golden's pixels; a second make_frame_fn returns the cached
               plan; the leaves of each draw's blocks are printed
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
               the flat kernel tie-aware (on the check scenes the flat kernel
               against its plain version too, bit for bit); on the same rays
               the worklist's prepass kernel against its plain version,
               element for element, near to far and in ascending id, and on
               65,536 primary rays against the large scene's records at
               tri_block 64 (2,888 blocks); both engines' 1024x1024 frames:
               3 + 3 launches of their kernel (the closest hit, and the
               closest hit inside the bound as the occlusion query), and for
               the worklist engine 6 of the prepass kernel, image equal to the
               clustered frame's (max |diff| 0).  Beside the tests a ray, the
               kernels' lane efficiency on each whole launch (``lanes``: their
               plain versions' counts over warps of 32 consecutive rays,
               useful triangle tests over the lane-steps run, at the shipped
               ``lane_switch`` and a ray a lane)
  25. rt_config3_timing — CUDA events, median of 20: every walk of every K-slot
               draw (beside its share of ended rays, its tests a ray and its
               bound) and the closest-hit kernel on the ``winner`` draws,
               each around the call and as a CUDA graph's replay; one scan
               draw, the whole frame at 512x512 and 1024x1024; the streamed and
               worklist kernels on the small scene's primary launch (around
               the call and as a CUDA graph's replay) beside the clustered
               and the flat one, the streamed kernel on each of the frame's
               six launches, the worklist's prepass kernel apart (events,
               graph, its plain version of 5, its bound), the flat kernel on
               65,536 rays of bounce 1 (events, graph, its bound), the three
               engines' frames

  26. apps_sgemm_vs_plain — kernel #12 (csrc/apps_sgemm.cu, one fused
               multiply-add a step) against its plain version (an exact fmaf
               emulation), bit for bit: 256x384x128, the ragged 200x72x136
               with block (8, 8, 8), 1x1x1, 130x257x129 and two 128-row
               stripes of 4096^3; and
               against torch.matmul (float32, no TF32) within the forward
               error bound of the two float32 sums, 2 k 2^-24 (|A||B|)_ij
  27. apps_on_card — every app of apps/compute.py (the 22 dogfood cases
               too) and apps/opencl.py against its numpy oracle at the JAX
               tests' sizes and tolerances, and blackscholes on 4,000,000
               options, bfs on a seeded 1,048,576-node graph of 6 edges a
               node; LBM 16x8x8 three steps against the per-cell oracle
               (rtol 2e-5, atol 1e-7), 120x120x150 one step against the same
               code on the host's CPU and ten steps finite with FLAGS and
               margins untouched; om and tex at 64x64 and 1024x1024 against
               closed forms, every texel format and filter at 64x64 equal to
               the CPU run.  The launch count is set to 0 just before and
               read just after: #12 twice (the 256x384x128 and 4096^3
               products)
  28. apps_timing — CUDA events, median of 20: #12 at 4096^3, its plain
               version (one call) and torch.matmul; an LBM step at 120x120x150;
               blackscholes on 4,000,000 options; host milliseconds a draw
               of the native and the numpy binning engines (median of 5) on
               synth_draw3d at 256x256 and 1024x1024
  29. bench_stages — every stage function of bench_torch.py once, in this
               process, on the card, at its full size with one repeat: every
               number it returns finite and positive (its device busy time
               too: the profiler saw the card's kernels), its own checks
               passed (the frame loop's sentinel never rendered and its
               frame equals compile_frame's bit for bit, no K-slot overflow
               in the config-3 frames), and each stage's kernels launched
               (the counts set to 0 after the stage's set-up and read after
               its runs: #1 on the raster stages, exactly draws x frames run;
               #4 and #5 on the hard training steps, exactly 1 + 5 a step
               (bench_torch.expected_launches); #5 on the soft and alpha
               ones, #2 and #3 on the north-star frame, #2 and #6 on the
               config-3 frame)
  30. cli_on_card — the command line on its default device, the card:
               ``render -t synth_draw3d -w 256 -H 256 --mode pallas --perf
               -o``, whose PNG, decoded with zlib (no PIL), equals the
               committed JAX golden (data/synth_draw3d_256.npz); ``info``
               (platform gpu, the card's name); ``rt -w 256 -H 256`` with the
               engines pallas (#7, #8) and pallas_worklist (#11 and its
               prepass), the two PNGs equal; ``fit -w 64 --steps 20`` (#5),
               its last loss below its first
  31. parallel — the sharded paths in a world of one rank over NCCL (formed
               by parallel.mesh.make_mesh on an in-process store, destroyed
               at the end of the phase), the counts set to 0 just before
               each and read just after: render_trace_sharded at 256x256
               bit-equal to the committed JAX golden and to compile_frame's
               frame, #1 launched as often as phase 4's first frame (a fresh
               trace: the blend retry included) and then once a draw, four
               all-reduces a draw's render; make_train_step at 1024x1024
               (grad_buckets 3), three SGD steps (lr 1e-7 on all four
               parameters, from the scene with halved colors, toward its own
               image; finite losses) against the port's
               unsharded steps on the same parameters: loss rtol 1e-6,
               params rtol 1e-5, #4 once and #5 five times a step, five
               all-reduces a step (three buckets, the loss, max_writes);
               render_sharded of the north-star scene (pallas_bvh: #2, #3,
               3 + 3) and of the small scene (pallas: #7, #8, 3 + 3) at
               1024x1024 within atol 1e-6 of make_frame_fn's frame, one
               all-gather each, their blocks and clusters built once; the
               sharded and unsharded times (CUDA events, in turns, their
               medians and the median of their ratios), and the
               host milliseconds of the set-up render_sharded repeats a
               call (shading records, camera rays, tile order); the NCCL
               version; scaling.measure() (a spawned world of each size up
               to the card count); render_trace_sharded in a world of two
               spawned ranks on the one card, gloo carrying the collectives
               of CUDA tensors, equal to the golden
  32. total  — the script's seconds (every phase line carries ``at_s``, the
               seconds since the script started)

The ``kernels`` line gives each kernel's time beside its bound, both terms
of it: ``bound_bytes_ms`` (inputs read once, outputs written once; holds
for any algorithm) and ``bound_ops_ms`` (the operations this algorithm did
on this run's data; for the ray queries, the tests made at the shipped
block size, leaf size or cluster table).  The ray queries' ``ms`` and
``bound_ms`` are those of the primary launch (the any-hit kernels': the
primary shadow launch); ``launch_ms``, ``frame_ms`` and ``frame_bound_ms``
cover the three launches of a frame; ``graph_ms`` and ``frame_graph_ms``
time the BVH-block and clustered launches, and pass 1's 256x256 launch, as
CUDA graph replays, without the host's work around the call.
``sharded_launches`` (#1, #2, #3, #4, #5, #7, #8) are the launches of phase
31's sharded run of the kernel's path.
``max_abs_err`` is the largest |kernel - plain| over every output of the
comparison run (measured; a run that prints the line measured 0, since any
difference raises), and the ray queries add
``rays_differ`` or ``rays_not_bit_equal``, the count of rays behind it.
The training path's two entries give the kernel on the 1024x1024 step's
tensors; ``launches`` are those of the ten SGD steps.  ``diff_accumulate``'s
``ms`` is the texel table's launch (the widest of a step's five) and
``step_ms`` lists the table classes and ``stress_ms`` the skewed and long
cases; its ``library_ms`` is ``index_add_``, which the port never calls on
a CUDA tensor.  Its ``bound_ms`` is the function's own (the bytes, and one
add a kept value's column); the bytes that the counting sort's scratch
moves on top are printed apart, in phase 19 (``sort_scratch_ms``, those
bytes over the memory rate, an estimate), and enter no bound.

The next-hit-after entry gives walk 1 of the largest K-slot draw (the
5,080-triangle shell) on all rays; ``walk_ms`` lists every walk of every such
draw, ``frame_ms`` their sum, ``frame_bound_ms`` the sum of their bounds,
``walk_graph_ms`` and ``frame_graph_ms`` the same as graph replays,
``launches`` the frame's count.  The streamed and
worklist entries give the small scene's primary launch (``graph_ms`` too),
the streamed one its frame's six launches (``launch_ms``,
``launch_graph_ms``, their sums ``frame_ms``, ``frame_graph_ms``), both the
lane switch and lane efficiency of phase 24; the worklist's ``prepass_ms``,
``prepass_graph_ms`` and ``prepass_bound_ms`` are its prepass kernel's,
which has an entry of its own too (``rt_active_block_lists``: a slab test
of every ray against every block).  The flat entry's bound counts the
steps of the tests its kernel runs (``all_pairs_bound_ms``: every pair's
whole test), ``bounce1_sample`` its time on bounce 1's sample.  The visibility
entry adds ``graph_ms`` and the kept pixel steps and cull tests that its
operations term counts.

The script imports no JAX: the references it checks against are committed
files (skybox_rt_tpu_torch/data/).
"""
from __future__ import annotations

import hashlib
import json
import math
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
# visibility_kernel), counted from its body.  Every pixel does for every prim
# that the cull keeps for its patch: three edge functions (2 multiplies + 2
# adds each, 12), three sign compares and three ands with the scissor flag.
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
# The cull of one prim against one warp's patch, in int32: per edge 2 sign
# tests, 4 corner selects, 4 widening multiplies, 4 64-bit adds (2 each), 2
# 64-bit shifts (2 each), a 64-bit compare (2) and the parity and its and
# (26); the or of the three edges (2)
RASTER_CULL_INT_OPS = 80
# float operations of one Möller–Trumbore test (csrc/rt_bvh.cu mt_one and
# the caller's t < bound: two cross products 18, four dot products 20, tvec
# 3, 1 divide, 3 multiplies by 1/det, u + v, |det|, 6 compares) and of one
# slab test (6 subtracts, 6 multiplies, 12 min/max, 1 compare)
MT_OPS = 53
SLAB_OPS = 25
# ... and the same test's steps in the flat kernel (csrc/rt_clustered.cu),
# which stops a test whose outcome is fixed: pv and det with |det|'s compare
# (16) on every pair; tv, qv and t_num (17) a test past det, or once a record
# in a block whose rays share their origin; the t-sign test (2); the
# reciprocal, u and u >= 0 (8) a test the sign test keeps; v, t and the four
# compares left (12) a test with u >= 0.  16 + 17 + 8 + 12 is MT_OPS; the
# sign test comes on top.
FLAT_DET_OPS, FLAT_TERMS_OPS, FLAT_SIGN_OPS = 16, 17, 2
FLAT_U_OPS, FLAT_REST_OPS = 8, 12
# the leaf sizes (rt.tracer.BVH_LEAF_TRIS) the BVH-block kernels are held to
# their plain versions at on the check scenes
LEAF_SWEEP = (1, 2, 4, 8, 16, 32)
# the cluster group sizes (ops.cuda_rt.CLUSTER_GROUP) the clustered kernels
# are held to their plain versions at on the check scenes
GROUP_SWEEP = (1, 4, 8, 16)
# most walks of a next-hit-after enumeration run past the end of its lists
MAX_WALKS = 64
RT_SAMPLE = 65536
RT_SIZE = 1024         # the full-width frame
T0 = time.perf_counter()


def phase(name, **fields):
    """Print one phase's line, with the script's seconds so far."""
    torch.cuda.synchronize()        # a fault in the phase surfaces here
    print(json.dumps({"phase": name, **fields,
                      "at_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


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


def paired_ms(sharded, unsharded, reps=REPS, warmup=WARMUP) -> dict:
    """The two functions in turns (sharded first on even reps, unsharded
    first on odd ones), each call timed with CUDA events: their medians and
    the median of the reps' ratios, so that the host's drift within the call
    falls on both."""
    for _ in range(warmup):
        sharded()
        unsharded()
    times = {sharded: [], unsharded: []}
    for i in range(reps):
        for fn in (sharded, unsharded) if i % 2 == 0 else (unsharded,
                                                           sharded):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[fn].append(start.elapsed_time(end))
    a, b = np.array(times[sharded]), np.array(times[unsharded])
    return {"sharded_ms": float(np.median(a)),
            "unsharded_ms": float(np.median(b)),
            "sharded_over_unsharded": float(np.median(a / b)),
            "reps": reps, "in_turns": True}


def graph_ms(fn, reps=REPS) -> float:
    """Median over `reps` of one replay of fn captured in a CUDA graph,
    timed with CUDA events: the device time of fn's launches without the
    host's work around them (the wrapper's checks, allocations and ctypes
    call, about 0.1 ms, which sets the `median_ms` of a short kernel)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return median_ms(graph.replay, reps)


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


def walk_ops(stats) -> float:
    """Operations of a walk of the BVH-block kernels, counted by its plain
    version: the triangle tests of the leaves entered, and a slab test for
    every entered block and every leaf of one it tested (the pyramid's upper
    levels and the blocks culled are left out: the count is a floor)."""
    return (stats.get("tri_tests", 0) * MT_OPS
            + (stats.get("blocks_entered", 0) + stats.get("slab_tests", 0))
            * SLAB_OPS)


def flat_ops(counts, P) -> float:
    """Operations of the flat kernel from ops.cuda_rt.flat_work_counts:
    the terms staged once a record in each block of shared origin, and each
    test's steps as far as it went."""
    return (counts["shared_blocks"] * P * FLAT_TERMS_OPS
            + counts["pairs"] * FLAT_DET_OPS
            + counts["det_pass_general"] * FLAT_TERMS_OPS
            + counts["det_pass"] * FLAT_SIGN_OPS
            + counts["t_pass"] * FLAT_U_OPS + counts["u_pass"] * FLAT_REST_OPS)


def flat_bound(o, d, tm, flat, counts):
    """Bound of one flat launch over rays o, d: rays, t_max and records read
    once, (prim, t, u, v) written once, against the operations of
    ``counts`` (:func:`flat_ops`); beside it the bound of every pair's whole
    test (the earlier, all-pairs count) and the shares of the pairs that
    went past det, past the t-sign test and past u."""
    P, pairs = flat.shape[0], counts["pairs"]
    moved = nbytes(o, d, tm, flat) + 16 * o.shape[0]
    return {**bound(moved, flat_ops(counts, P)),
            "all_pairs_bound_ms": bound(moved, o.shape[0] * P
                                        * MT_OPS)["bound_ms"],
            "det_pass_share": counts["det_pass"] / pairs,
            "t_pass_share": counts["t_pass"] / pairs,
            "u_pass_share": counts["u_pass"] / pairs,
            "blocks": counts["blocks"],
            "shared_origin_blocks": counts["shared_blocks"]}


def tests_per_ray(stats, rays) -> dict:
    """A walk's tests a ray from its plain version's counts: the leaves'
    slab tests and triangle tests, and beside them
    ``block_tri_tests_per_ray``, the triangle tests had every entered block
    been tested whole (the walk before the leaf level; the any hit's up to
    its first hit)."""
    return {k + "_per_ray": stats.get(k, 0) / rays
            for k in ("tri_tests", "slab_tests", "slab_pass",
                      "blocks_entered", "block_tri_tests")}


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


def rt_phases(dev, card) -> tuple:
    """Phases 7 to 10; returns the two RT kernels' entries of the kernels
    line and the full-width scene with its frame."""
    from skybox_rt_tpu_torch.geom import cgltrace
    from skybox_rt_tpu_torch.models import scenes
    from skybox_rt_tpu_torch.ops import cuda_rt
    from skybox_rt_tpu_torch.rt import bvh as bvh_mod
    from skybox_rt_tpu_torch.rt import intersect, tracer, wavefront

    def on_card(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    def make_blocks(verts, faces, bvh, tri_block,
                    leaf_tris=tracer.BVH_LEAF_TRIS):
        tri = intersect.triangle_arrays(on_card(verts),
                                        on_card(np.asarray(faces, np.int64)))
        bs = bvh_mod.build_block_set(bvh, tri_block=tri_block)
        return cuda_rt.prepare_bvh_blocks(
            *tri, bs, bvh_mod.build_block_leaves(bvh, bs, leaf_tris))

    def compare(kind, o, d, tm, blocks, stats=None):
        """Kernel against plain version on one query; raises unless they
        are bit-equal.  Returns (max |diff| of t/u/v, rays not bit-equal,
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
        if bool(inexact.any()):
            raise AssertionError(f"closest_hit_bvh t/u/v not bit-equal to the "
                                 f"plain version on {int(inexact.sum())} rays")
        return err, 0, got, plain_s

    # 7a. the small check scenes, whole, at every leaf size of the sweep
    err, inexact, cases = 0.0, 0, 0
    for name in sorted(scenes.BVH_CHECK_SCENES):
        verts, faces, tri_block, queries = scenes.bvh_check_queries(name)
        bvh = bvh_mod.build(verts, faces)
        for lt in LEAF_SWEEP:
            blocks = make_blocks(verts, faces, bvh, tri_block, lt)
            for kind, o, d, tm in queries:
                e, n, _, _ = compare(
                    kind, on_card(o), on_card(d),
                    on_card(tm) if kind == "closest" else
                    (tm if np.ndim(tm) == 0 else on_card(tm)), blocks)
                err, inexact, cases = max(err, e), inexact + n, cases + 1
    small = {"cases": cases, "leaf_sizes": list(LEAF_SWEEP),
             "max_abs_err": err, "rays_not_bit_equal": inexact}

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

    def launch_bound(kind, o, d, tm, stats, scale=1.0):
        """Bound of one launch: rays, records, boxes and the leaf table (and
        the closest hit's slot -> prim) read once, the outputs (prim, t, u,
        v, or one occlusion byte a ray) written once, against the tests the
        plain version counted (times ``scale``, a sample's share)."""
        R = o.shape[0]
        moved = nbytes(o, d, tm, blocks["tri"], blocks["aabb"],
                       blocks["leaf_range"], blocks["leaf_table"])
        if kind == "any":
            moved += R
        else:
            moved += 16 * R + nbytes(blocks["s2p"])
        return bound(moved, scale * walk_ops(stats))

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
            **tests_per_ray(stats, os_.shape[0]),
            "plain_ms_sample": plain_s * 1e3,
            # the sample's counts scaled to the launch's rays
            "bound": launch_bound(kind, o, d, tm, stats, R / os_.shape[0])}
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
            **launch_bound(kind, o, d, tm, stats),
            "library_ms": None,     # no single PyTorch call computes this
            "rays": o.shape[0], "rays_not_bit_equal": n,
            **tests_per_ray(stats, o.shape[0])})
        err = max(err, e)
    phase("rt_kernel_vs_plain", small=small, triangles=int(faces.shape[0]),
          blocks=blocks["num_blocks"], pyramid=list(blocks["level_counts"]),
          leaf_tris=tracer.BVH_LEAF_TRIS,
          leaves=int(blocks["leaf_table"].shape[0]),
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
    if counts != (3, 3) or cuda_rt.launch_counts["shade_hits"] != 3 \
            or sum(cuda_rt.launch_counts.values()) != 9:
        raise AssertionError(f"1024 frame launched {cuda_rt.launch_counts}, "
                             f"expected 3 + 3 of the BVH-block kernels and "
                             f"3 of the shade kernel")
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
        cls = classes[name]
        if kind == "any":
            def query():
                return cuda_rt.any_hit_bvh(o, d, blocks, t_max=tm)
        else:
            def query():
                return cuda_rt.closest_hit_bvh(o, d, blocks)
        ms = median_ms(query)
        timing[name] = {
            "kernel_ms": ms, "graph_ms": graph_ms(query), "rays": o.shape[0],
            "mrays_per_s": o.shape[0] / ms / 1e3,
            "plain_ms_sample": cls["plain_ms_sample"],
            "bound_ms": cls["bound"]["bound_ms"],
            **{k: v for k, v in cls.items() if k.endswith("_per_ray")}}
    # ms and bound_ms are those of the widest launch (the primary one);
    # frame_ms and frame_bound_ms sum the kernel's three launches of a frame
    for entry, first in zip(entries, ("primary", "primary_shadow")):
        mine = [n for n in names if classes[n]["kind"] == classes[first]["kind"]]
        entry["ms"] = timing[first]["kernel_ms"]
        entry["launch_ms"] = {n: timing[n]["kernel_ms"] for n in mine}
        entry["frame_ms"] = sum(timing[n]["kernel_ms"] for n in mine)
        entry["graph_ms"] = timing[first]["graph_ms"]
        entry["frame_graph_ms"] = sum(timing[n]["graph_ms"] for n in mine)
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
    # the scene and its frame, for the sharded path of phase 31
    return entries, {"scene": scene, "cam": cam, "cfg": cfg1024,
                     "frame": frame1024, "rays": (o1024, d1024)}


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


def small_phases(dev, card) -> tuple:
    """Phases 11 to 14; returns the three small-scene kernels' entries of
    the kernels line and the full-width small scene with its frame."""
    import math

    from skybox_rt_tpu_torch.geom import cgltrace
    from skybox_rt_tpu_torch.models import scenes
    from skybox_rt_tpu_torch.ops import cuda_rt
    from skybox_rt_tpu_torch.rt import bvh as bvh_mod
    from skybox_rt_tpu_torch.rt import intersect, tracer, wavefront

    def on_card(a):
        if a is None or np.ndim(a) == 0:
            return a
        return torch.as_tensor(a, device=dev)

    def pack(verts, faces, bvh, max_tris, group=None):
        tri = intersect.triangle_arrays(on_card(verts),
                                        on_card(np.asarray(faces, np.int64)))
        clusters = cuda_rt.prepare_clusters(
            *tri, bvh_mod.build_clusters(bvh, max_tris), group=group)
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

    # 11a. the small check scenes, whole, at every cluster group size of the
    # sweep
    small = {"cases": 0, "rays_differ": 0, "flat_rays_differ": 0,
             "prims_tied_with_flat": 0, "group_sizes": list(GROUP_SWEEP)}
    for name in sorted(scenes.CLUSTER_CHECK_SCENES):
        verts, faces, max_tris, queries = scenes.cluster_check_queries(name)
        bvh = bvh_mod.build(verts, faces)
        for group in GROUP_SWEEP:
            clusters, flat = pack(verts, faces, bvh, max_tris, group)
            for _, kind, o, d, tm in queries:
                out, _ = compare(kind, on_card(o), on_card(d), on_card(tm),
                                 clusters, flat,
                                 flat_plain=group == cuda_rt.CLUSTER_GROUP)
                small["cases"] += 1
                for k in ("rays_differ", "flat_rays_differ",
                          "prims_tied_with_flat"):
                    small[k] += out.get(k, 0)
    # more clusters than the shared-memory stage holds (the tables stay in
    # global memory); rays of one octant, so the plain version walks one row
    verts, faces = scenes.icosphere(subdiv=4)
    bvh = bvh_mod.build(verts, faces)
    o, d = scenes.aimed_rays(3000, seed=9)
    o, d = on_card(np.abs(o)), on_card(-np.abs(d))
    for group in GROUP_SWEEP:
        clusters, flat = pack(verts, faces, bvh, 4, group)
        if clusters["num_clusters"] + clusters["num_groups"] <= 768:
            raise AssertionError("the unstaged case must exceed 768 clusters "
                                 "and groups")
        for kind, tm in (("closest", None), ("any", 3.0)):
            out, _ = compare(kind, o, d, tm, clusters, flat,
                             flat_plain=False)
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
        """Bound of one launch of a clustered kernel: rays, records and the
        cluster and group tables read once, the outputs (prim, t, u, v, or
        one occlusion byte a ray) written once, against the tests the plain
        version counted (slab tests of groups and clusters).  The flat
        kernel's: :func:`flat_bound`."""
        R = o.shape[0]
        written = R if kind == "any" else 16 * R
        moved = nbytes(o, d, tm, clusters["tri"], clusters["table"],
                       clusters["visit"], clusters["group_table"],
                       clusters["group_visit"]) + written
        if kind == "closest":
            moved += nbytes(clusters["order"])
        return bound(moved, tri_tests * MT_OPS + slab_tests * SLAB_OPS)

    def slab_tests(stats):
        return stats["slab_tests"] + stats.get("group_slab_tests", 0)

    def per_ray(stats, rays):
        """Tests a ray: the groups', the clusters', the triangles'."""
        return {"group_slab_tests_per_ray":
                    stats.get("group_slab_tests", 0) / rays,
                "groups_entered_per_ray":
                    stats.get("groups_entered", 0) / rays,
                "slab_tests_per_ray": stats["slab_tests"] / rays,
                "clusters_entered_per_ray": stats["slab_pass"] / rays,
                "tri_tests_per_ray": stats["tri_tests"] / rays}

    # 11b. the six launches of the real frame, captured from trace_rays
    launches = capture_launches(
        scene, cfg1024,
        lambda o, d: cuda_rt.closest_hit_clustered(o, d, clusters),
        lambda o, d, tm: cuda_rt.any_hit_clustered(o, d, clusters, t_max=tm),
        o1024, d1024)
    classes, samples = {}, {}
    for name, launch in zip(LAUNCH_NAMES, launches):
        kind, o, d, tm = launch
        R = o.shape[0]
        os_, ds_, tms = samples[name] = sample_launch(name, launch)
        stats = {}
        out, got = compare(kind, os_, ds_, tms, clusters, flat, stats)
        n = os_.shape[0]
        found = got if kind == "any" else got[0] >= 0
        classes[name] = {
            "kind": kind, "launch_rays": R, "sample_rays": n,
            "parked_in_sample": int((os_[:, 0] > 1e7).sum()),
            # the flat kernel's blocks of 128 sample rays, and those whose
            # rays share one origin (the primary's: the camera's eye)
            "flat_blocks_shared": cuda_rt.flat_shared_origin_blocks(os_),
            "hits_in_sample": int(found.sum()), **out,
            **per_ray(stats, n),
            # the sample's counts scaled to the launch's rays
            "bound": launch_bounds(kind, o, d, tm, stats["tri_tests"] * R / n,
                                   slab_tests(stats) * R / n)}
    for name in ("bounce1", "bounce1_shadow"):
        if classes[name]["parked_in_sample"] == 0:
            raise AssertionError(f"{name}: no parked ray in the sample")
    # the primary sample's blocks take the shared-origin path, bounce 1's
    # the general one (but for blocks of parked rays only)
    blocks, shared = classes["primary"]["flat_blocks_shared"]
    blocks_b1, shared_b1 = classes["bounce1"]["flat_blocks_shared"]
    if shared != blocks or shared_b1 == blocks_b1:
        raise AssertionError(f"flat blocks of one origin: {shared} of "
                             f"{blocks} (primary), {shared_b1} of "
                             f"{blocks_b1} (bounce 1)")
    # the flat kernel's shared-origin test compares bits: four blocks of
    # primary rays, block 0 with one origin x of -0.0 for the eye's 0.0,
    # block 1 with one origin y one ulp off, against the plain version
    os_, ds_, _ = samples["primary"]
    oe, de = os_[:512].clone(), ds_[:512].contiguous()
    if oe[0, 0].item() != 0.0 or math.copysign(1.0, oe[0, 0].item()) < 0:
        raise AssertionError("the -0.0 case needs an eye at x = +0.0")
    oe[5, 0] = -0.0
    oe[130, 1] = torch.nextafter(oe[130, 1], torch.tensor(math.inf,
                                                          device=dev))
    origin_edges = {"rays": 512, "blocks_shared":
                    cuda_rt.flat_shared_origin_blocks(oe)}
    origin_edges["rays_differ"], origin_edges["max_abs_err"] = differ(
        cuda_rt.closest_hit_pallas(oe, de, flat),
        cuda_rt.closest_hit_pallas_reference(oe, de, flat))
    if origin_edges["blocks_shared"] != (4, 2) \
            or origin_edges["rays_differ"]:
        raise AssertionError(f"flat kernel at the origin edges: "
                             f"{origin_edges}")

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
        mine = launch_bounds(kind, o, d, tm, stats["tri_tests"],
                             slab_tests(stats))
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
            "rays_differ": out["rays_differ"], **per_ray(stats, R)})
        if kind == "closest":
            # the flat kernel's work counted on the primary sample and
            # scaled to the launch's rays; its blocks are the launch's own
            counts = cuda_rt.flat_work_counts(*samples["primary"][:2], flat)
            scale = R * P / counts["pairs"]
            for k in ("pairs", "det_pass", "det_pass_general", "t_pass",
                      "u_pass"):
                counts[k] *= scale
            counts["blocks"], counts["shared_blocks"] = \
                cuda_rt.flat_shared_origin_blocks(o)
            flat_entry = {
                "name": "rt_closest_hit_flat",
                "replaces": "skybox_rt_tpu/ops/pallas_rt.py:112",
                **common, "max_abs_err": out["flat_max_abs_err"],
                "plain_ms": out["flat_plain_ms"],
                **flat_bound(o, d, tm, flat, counts),
                "work_counted_on": "the 65,536-ray primary sample, scaled",
                "rays_differ": out["flat_rays_differ"],
                "tri_tests_per_ray": P,
                "prims_tied_with_clustered": out["prims_tied_with_flat"]}
    entries.append(flat_entry)
    phase("rt_clustered_vs_plain", small=small, triangles=P, clusters=C,
          groups=clusters["num_groups"],
          cluster_group=clusters["cluster_group"], classes=classes,
          flat_origin_edges=origin_edges, equal=True,
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
    # the tracer launches the clustered pair and the shade kernel and
    # nothing else: neither the flat kernel (no engine reaches it) nor the
    # BVH-block kernels
    if cuda_rt.launch_counts != {"closest_hit_clustered": 3,
                                 "any_hit_clustered": 3, "shade_hits": 3}:
        raise AssertionError(f"small 1024 frame launched "
                             f"{dict(cuda_rt.launch_counts)}, expected 3 + 3 "
                             f"of the clustered kernels and 3 of the shade "
                             f"kernel only")
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
            def query():
                return cuda_rt.any_hit_clustered(o, d, clusters, t_max=tm)
        else:
            def query():
                return cuda_rt.closest_hit_clustered(o, d, clusters)
        ms = median_ms(query)
        cls = classes[name]
        timing[name] = {"kernel_ms": ms, "graph_ms": graph_ms(query),
                        "rays": o.shape[0],
                        "mrays_per_s": o.shape[0] / ms / 1e3,
                        "plain_ms_sample": cls["plain_ms"],
                        "flat_plain_ms_sample": cls["flat_plain_ms"],
                        "bound_ms": cls["bound"]["bound_ms"],
                        **{k: v for k, v in cls.items()
                           if k.endswith("_per_ray")}}
    for entry, first in zip(entries[:2], ("primary", "primary_shadow")):
        mine = [n for n in LAUNCH_NAMES
                if classes[n]["kind"] == classes[first]["kind"]]
        entry["ms"] = timing[first]["kernel_ms"]
        entry["launch_ms"] = {n: timing[n]["kernel_ms"] for n in mine}
        entry["frame_ms"] = sum(timing[n]["kernel_ms"] for n in mine)
        entry["graph_ms"] = timing[first]["graph_ms"]
        entry["frame_graph_ms"] = sum(timing[n]["graph_ms"] for n in mine)
        entry["frame_bound_ms"] = sum(classes[n]["bound"]["bound_ms"]
                                      for n in mine)
    def flat_primary():
        return cuda_rt.closest_hit_pallas(o1024, d1024, flat)
    entries[2]["ms"] = median_ms(flat_primary, reps=5, warmup=1)
    entries[2]["graph_ms"] = graph_ms(flat_primary, reps=5)
    frame_ms = median_ms(lambda: frame1024(o1024, d1024))
    frame256_ms = median_ms(lambda: frame256(o256, d256))
    kernels_ms = sum(t["kernel_ms"] for t in timing.values())
    phase("rt_small_timing", card=card, reps=REPS, launches=timing,
          flat_primary={"ms": entries[2]["ms"],
                        "graph_ms": entries[2]["graph_ms"], "reps": 5,
                        "mrays_per_s": RT_SIZE * RT_SIZE / entries[2]["ms"]
                        / 1e3},
          frame_1024={"ms": frame_ms, "kernels_ms": kernels_ms,
                      "kernel_share": kernels_ms / frame_ms,
                      "mrays_per_s": RT_SIZE * RT_SIZE * 6 / frame_ms / 1e3},
          frame_256_ms=frame256_ms,
          host_s={"bvh_build_sah": bvh_build_s,
                  "clusters_and_upload": prepare_s,
                  "make_frame_fn_1024": setup_s})
    return entries, {"scene": scene, "cam": cam, "cfg": cfg1024,
                     "frame": frame1024, "rays": (o1024, d1024)}


# float operations of one ray of the shade kernel (csrc/rt_shade.cu),
# counted from its body: the hit point 6, the barycentric weight 2, the
# normal's interpolation 15, its length 7 and division 3, the flip 6, the
# albedo 15, the light's length 6 and division 3, ndotl 6, the two colours
# 18, the shadow ray 7.  Textured adds the uv 10, the two taps 12, three
# lerps a channel 27 and the texel's product 3
SHADE_OPS = 94
SHADE_TEX_OPS = 52
# bytes a ray must move whatever the algorithm: o, d, prim, t, u, v read
# (40); rgb, hit, pt, n written (37); the shadow ray written and its answer
# read (25).  The record rows of the hit prims and the texture come on top,
# once each
SHADE_RAY_BYTES = 40 + 37 + 25


def shade_phase(dev, card, large, small) -> dict:
    """Phase 14b: the shade kernel (csrc/rt_shade.cu) on the benchmark's
    two scenes at 1024x1024, 2 bounces, shadows: ``large``, the
    184,832-triangle field untextured, and ``small``'s geometry textured
    (RTScenes with their BVHs built).  Returns the kernels line's entry."""
    from skybox_rt_tpu_torch.ops import cuda_rt
    from skybox_rt_tpu_torch.rt import tracer

    def same(got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            return False
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        return torch.equal(got, want)

    def run_frame(frame, o, d, shade):
        real = tracer.shade_hits
        tracer.shade_hits = shade
        try:
            return frame(o, d)
        finally:
            tracer.shade_hits = real

    tex_scene, cam = small_scene(textured=True)
    tex_scene.bvh = small.bvh       # the same geometry: one build
    got, entry = {}, None
    for label, scene, textured in (("spheres184k", large, False),
                                   ("spheres12k_tex", tex_scene, True)):
        cfg = tracer.RTConfig(width=RT_SIZE, height=RT_SIZE, bounces=2,
                              shadows=True, textured=textured)
        frame, (o, d) = tracer.make_frame_fn(scene, cam, cfg)
        calls = []

        def recorder(scene_arrays, cfg, occluded, *args, bounce=0):
            calls.append((scene_arrays, occluded, (*args, bounce)))
            return cuda_rt.shade_hits(scene_arrays, cfg, occluded, *args,
                                      bounce)

        cuda_rt.reset_launch_counts()
        img = run_frame(frame, o, d, recorder)
        torch.cuda.synchronize()
        launches = cuda_rt.launch_counts["shade_hits"]
        if launches != 3 or len(calls) != 3:
            raise AssertionError(f"{label}: {launches} shade launches, "
                                 f"{len(calls)} calls, expected 3")
        # the frame, and the frame shaded by the twin
        img_twin = run_frame(frame, o, d, cuda_rt.shade_hits_reference)
        if not same(img, img_twin):
            raise AssertionError(f"{label}: the frame differs from the "
                                 f"twin-shaded frame")
        timing = []
        for i, (scene_arrays, occluded, args) in enumerate(calls):
            asked = {}

            def asking(key, occluded=occluded, asked=asked):
                def occ(so, sd, t_max):
                    asked[key] = (so.clone(), sd.clone())
                    return occluded(so, sd, t_max)
                return occ

            outs = [fn(scene_arrays, cfg, asking(key), *args) for key, fn in (
                ("kernel", cuda_rt.shade_hits),
                ("twin", cuda_rt.shade_hits_reference))]
            torch.cuda.synchronize()
            for name, g, w in zip(("rgb", "hit", "pt", "n"), *outs):
                if not same(g, w):
                    raise AssertionError(f"{label} call {i}: {name} differs "
                                         f"from the twin's")
            for g, w in zip(asked["kernel"], asked["twin"]):
                if not same(g, w):
                    raise AssertionError(f"{label} call {i}: the shadow rays "
                                         f"differ from the twin's")
            # timing with the query's answer replayed: the kernel and the
            # torch.where after it, and the twin's launches
            blocked = occluded(*asked["kernel"], 1e8)

            def replay(so, sd, t_max, blocked=blocked):
                return blocked

            def kernel(scene_arrays=scene_arrays, args=args, replay=replay):
                return cuda_rt.shade_hits(scene_arrays, cfg, replay, *args)

            def twin(scene_arrays=scene_arrays, args=args, replay=replay):
                return cuda_rt.shade_hits_reference(scene_arrays, cfg,
                                                    replay, *args)

            R, prim = args[0].shape[0], args[2]
            rows = int(torch.unique(prim.clamp(min=0)).numel())
            tex = scene_arrays.get("texture")
            timing.append({
                "rays": R, "hits": int((prim >= 0).sum()), "rows": rows,
                "kernel_ms": median_ms(kernel), "graph_ms": graph_ms(kernel),
                "plain_ms": median_ms(twin),
                "bound": bound(R * SHADE_RAY_BYTES
                               + rows * scene_arrays["rec"].shape[1] * 4
                               + (0 if tex is None else tex.numel() * 4),
                               R * (SHADE_OPS + textured * SHADE_TEX_OPS))})
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                frame(o, d)
            torch.cuda.synchronize()
        profiled = sum(getattr(e, "device_time_total", 0.0)
                       for e in prof.key_averages()
                       if "shade_hits_kernel" in e.key) / 5 / 1e3
        sums = {k: sum(c[k] for c in timing)
                for k in ("kernel_ms", "graph_ms", "plain_ms")}
        got[label] = {
            "launches": launches, "calls": timing,
            "frame": {**sums, "profiler_kernel_ms": profiled,
                      "bound_ms": sum(c["bound"]["bound_ms"]
                                      for c in timing)},
            "frame_ms": median_ms(lambda: frame(o, d)),
            "frame_twin_ms": median_ms(lambda: run_frame(
                frame, o, d, cuda_rt.shade_hits_reference)),
            "image_equal_to_twin_frame": True}
        if textured:
            first = timing[0]
            entry = {"name": "rt_shade_hits", "route": "cuda",
                     "source": "skybox_rt_tpu_torch/csrc/rt_shade.cu",
                     "replaces": None,   # XLA's fusion of the JAX shade_hits
                     "launches": launches, "max_abs_err": 0,
                     "ms": first["kernel_ms"], "graph_ms": first["graph_ms"],
                     "plain_ms": first["plain_ms"], **first["bound"],
                     "frame_ms": sums["kernel_ms"],
                     "frame_graph_ms": sums["graph_ms"],
                     "library_ms": None}
    phase("rt_shade", card=card, reps=REPS, equal=True, **got)
    return entry


# float operations of one step of the differentiable pipeline's visibility
# kernel (csrc/diff_visibility.cu) at one pixel: three edge functions (2
# multiplies + 2 adds each) and three compares; a covered pixel with the
# depth test adds 2 adds, |den| + compare + select, 2 divides, 2 subtracts,
# 3 multiplies + 2 adds and the compare with the best z.
DIFF_VIS_STEP_OPS = 15
DIFF_VIS_COVERED_OPS = 15
# ... and its cull of one prim for one warp's 8x4 patch: per edge two corner
# selects, 2 multiplies + 2 adds and a compare (7), and the ands of the three
DIFF_VIS_CULL_OPS = 23
DIFF_SIZE = 1024        # the full-width training step
DIFF_STEPS = 10
ACC_STRESS_ROWS = 4096  # kernel #5's stress cases: the texel table's rows
ACC_LONG_N = 2_000_000  # ... and the long case's values
ACC_STEP = ("texel", "record", "vertex_pos", "vertex_uv")   # a step's tables
ACC_STRESS = ("skewed", "long")


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
    # the cull's edge cases (infinite and NaN coefficients, zero-area prims,
    # edges exactly 0 at a patch corner) at every tile size
    for tls in cuda_vis.TILE_LOGSIZES:
        inputs = cuda_vis.cull_case(tls, tls, dev)
        for depth_test in (True, False):
            got = cuda_vis.visibility_hard(*inputs, tls, depth_test)
            want = cuda_vis.visibility_hard_reference(*inputs, tls,
                                                      depth_test)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"cull case {tls}: diff_visibility != plain version on "
                    f"{int((got != want).sum())} of {got.numel()} pixels")
            vis_cases[f"cull_case_{tls}_{'z' if depth_test else 'noz'}"] = {
                "tiles": got.shape[0], "M": inputs[2].shape[1],
                "covered_pixels": int((got >= 0).sum()), "max_abs_err": 0}
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
    # two stress cases at the texel table's width: 90 % of the values in
    # one row (the kernel's first design took 4.23 ms on such a table), and
    # N past SEGMENTS_MAX * SEGMENT_MIN
    for name, n, hot in (("skewed", acc_inputs["texel"][0].numel(), 0.9),
                         ("long", ACC_LONG_N, 0.0)):
        g = torch.Generator(device=dev).manual_seed(n)
        idx = torch.randint(-4, ACC_STRESS_ROWS, (n,), generator=g,
                            device=dev, dtype=torch.int32)
        idx[torch.rand(n, generator=g, device=dev) < hot] = 5
        val = torch.randn((n, 16), generator=g, device=dev)
        acc_inputs[name] = (idx, val, ACC_STRESS_ROWS)
        acc_cases[name] = compare_acc(name, idx, val, ACC_STRESS_ROWS)
    if acc_cases["long"]["segments"][0] != cuda_texgrad.SEGMENTS_MAX:
        raise AssertionError("the long case must reach SEGMENTS_MAX")
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
    timing = {}
    params, static, cfg = scene(check.train_scene, DIFF_SIZE)
    setup, pids, origins = vis_inputs(params, static, cfg)
    edges, zs = setup["edges"].contiguous(), setup["z"]

    def vis():
        return cuda_vis.visibility_hard(edges, zs, pids, origins,
                                        cfg.tile_logsize, True)

    vis_ms, vis_graph_ms = median_ms(vis), graph_ms(vis)
    vis_plain_ms = median_ms(lambda: cuda_vis.visibility_hard_reference(
        edges, zs, pids, origins, cfg.tile_logsize, True), reps=5, warmup=1)
    # the warps' work by the plain cull twin: the pixel steps of the prims
    # each patch keeps, the (patch, prim) cull tests, the covered steps;
    # beside it, the one-block-a-tile design's every-pixel steps
    culls = cuda_vis.cull_counts(edges, pids, origins, cfg.tile_logsize)
    moved = nbytes(edges, zs, pids, origins) + 4 * T * 1024
    vis_bound = bound(moved, culls["kept_steps"] * DIFF_VIS_STEP_OPS
                      + culls["covered_steps"] * DIFF_VIS_COVERED_OPS
                      + culls["cull_tests"] * DIFF_VIS_CULL_OPS)
    timing["visibility_1024"] = {
        "kernel_ms": vis_ms, "graph_ms": vis_graph_ms,
        "plain_ms": vis_plain_ms, "T": T, "M": M, **culls,
        "blocks": T * (1 << (2 * cfg.tile_logsize - 7)), "bound": vis_bound,
        "bound_every_pixel_step": bound(
            moved, culls["all_steps"] * DIFF_VIS_STEP_OPS
            + culls["covered_steps"] * DIFF_VIS_COVERED_OPS)}
    acc_timing = {}
    for name in ACC_STEP + ACC_STRESS:
        idx, val, R = acc_inputs[name]
        N, C = val.shape
        keep = (idx >= 0) & (idx < R)
        # the library call takes no out-of-range row: it gets the kept ones
        idx64, val_kept = idx[keep].long(), val[keep]
        S, _ = cuda_texgrad.segments(N)
        plan = cuda_texgrad.scratch_sizes(N, R, C)
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
            # ... and, beside it, what the counting sort moves on top: the
            # S * R counts zeroed, read and written by the scan, read and
            # advanced by place (5 times); perm written and read; the long
            # rows' partials written and read
            "sort_scratch_bytes": 4 * (5 * S * R + 2 * N)
                                  + 8 * plan["parts"]["partials"]}
        acc_timing[name]["sort_scratch_ms"] = (
            acc_timing[name]["sort_scratch_bytes"] / HBM_BYTES_PER_S * 1e3)
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
        "graph_ms": vis_graph_ms, "plain_ms": vis_plain_ms, **vis_bound,
        "library_ms": None,     # no single PyTorch call computes this
        "steps": DIFF_STEPS, "tiles": T, "M": M,
        "kept_steps": culls["kept_steps"],
        "cull_tests": culls["cull_tests"]}, {
        "name": "diff_accumulate", "route": "cuda",
        "source": "skybox_rt_tpu_torch/csrc/diff_accumulate.cu",
        "replaces": "skybox_rt_tpu/diff/pallas_texgrad.py:41",
        "launches": sgd_launches[1], "max_abs_err": acc_err,
        "ms": tex["kernel_ms"], "plain_ms": tex["plain_ms"], **tex["bound"],
        "library_ms": tex["library_ms"],    # zeros(R, C).index_add_(0, ...)
        "steps": DIFF_STEPS, "shape": "texel table: N, R, C = "
        f"{tex['N']}, {tex['R']}, {tex['C']}",
        "step_ms": {n: acc_timing[n]["kernel_ms"] for n in ACC_STEP},
        "step_bound_ms": {n: acc_timing[n]["bound"]["bound_ms"]
                          for n in ACC_STEP},
        "step_library_ms": {n: acc_timing[n]["library_ms"] for n in ACC_STEP},
        "stress_ms": {n: acc_timing[n]["kernel_ms"] for n in ACC_STRESS},
        "stress_library_ms": {n: acc_timing[n]["library_ms"]
                              for n in ACC_STRESS}}]


# float operations a live pixel of the hard one-slot shade kernels
# (csrc/diff_shade.cu), counted from their bodies, textured and modulated:
# forward, three edge functions (12), den, |den| and its select (4), two
# divides and b2 (4), four colour and two uv interpolations (30), two taps
# (remainder, multiply, subtract, floor, fraction: 10), the bilinear lerps
# (36), the modulation (4) and the composite (12): 112; the backward repeats
# them and adds the texel's and colour's gradients (8), the sampler's
# backward (48 + 6 + 4 weights + 16 rows), the corners' rows and the
# barycentrics' gradients (18 + 24 + 12), their chain to the edges (12) and
# the edge rows (6), and one add a record column to the slot's sum (27)
DIFF_SHADE_FWD_OPS = 112
DIFF_SHADE_BWD_OPS = 112 + 181


def diff_shade_phase(dev, card) -> dict:
    """Phase 19b: the hard one-slot shade (csrc/diff_shade.cu, launched by
    diff/pipeline._ShadeHard) at the fit cell's shapes, the 1024x1024
    training scene (T = 656, M = 56, textured, modulated).  Both kernels
    against their twins (diff/cuda_shade.shade_*_reference) bit for bit,
    the backward twice alike; the image against the plain loop
    (pipeline.shade_loop) on the card bit for bit; a step's four gradients
    through the kernels against the same step with the plain loop in their
    place, within 1e-4 of each one's largest magnitude, and two steps
    alike.  Then CUDA events, median of 20: each kernel around the call and
    as a CUDA graph's replay, beside its bytes bound, and the plain loop's
    forward and backward (autograd's: the one-hot product and the two #5
    calls included, which the kernel path makes outside the kernel).
    Returns the kernels line's entry."""
    from skybox_rt_tpu_torch.diff import check, cuda_shade, pipeline

    def same(got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            return False
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        return torch.equal(got, want)

    params, static, cfg = check.train_scene(DIFF_SIZE)
    params, static = check.to_device(params, static, dev)
    tls = cfg.tile_logsize
    ts = 1 << tls
    with torch.no_grad():
        setup = pipeline.prim_setup(params, static["indices"], cfg)
        origins = pipeline._origins(static, cfg).to(torch.int32)
        steps = pipeline.visibility_slots(setup, static["tile_pids"], origins,
                                          cfg)[0][..., 0].contiguous()
        rec = setup["rec"]
        tex_quad = pipeline._quad_texture(params["tex"].detach()).contiguous()
    pids = static["tile_pids"]
    (T, M), C = pids.shape, rec.shape[1]
    g = torch.randn((T, ts, ts, 4), device=dev,
                    generator=torch.Generator(dev).manual_seed(19))
    args = (rec, tex_quad, pids, steps, origins)

    # the kernels against their twins, bit for bit; the backward twice
    cuda_shade.reset_launch_count()
    img = cuda_shade.shade_forward(*args, tls, cfg.modulate, cfg.background)
    back = cuda_shade.shade_backward(*args, g, tls, cfg.modulate)
    again = cuda_shade.shade_backward(*args, g, tls, cfg.modulate)
    torch.cuda.synchronize()
    if cuda_shade.launch_count != 3:
        raise AssertionError(f"3 calls launched {cuda_shade.launch_count}")
    want_img = cuda_shade.shade_forward_reference(*args, tls, cfg.modulate,
                                                  cfg.background)
    want_back = cuda_shade.shade_backward_reference(*args, g, tls,
                                                    cfg.modulate)
    for name, got, want in (("image", img, want_img),
                            *zip(("grec", "rows", "anchor"), back,
                                 want_back)):
        if not same(got, want):
            raise AssertionError(
                f"diff_shade {name} != twin on "
                f"{int((got != want).sum())} of {got.numel()} values")
    for name, a, b in zip(("grec", "rows", "anchor"), back, again):
        if not same(a, b):
            raise AssertionError(f"two backward launches differ in {name}")
    with torch.no_grad():
        plain = pipeline.shade_loop(pipeline.gather_rows(rec, pids),
                                    tex_quad, steps[..., None], origins, cfg)
    if not same(img, plain):
        raise AssertionError(
            f"diff_shade image != plain loop on "
            f"{int((img != plain).sum())} of {img.numel()} values")

    # a whole step through the kernels and through the plain loop
    def step_grads():
        loss, out, _ = check.step(params, static, cfg)
        return out, {k: p.grad.clone() for k, p in params.items()}

    cuda_shade.reset_launch_count()
    out1, grads1 = step_grads()
    out2, grads2 = step_grads()
    torch.cuda.synchronize()
    step_launches = cuda_shade.launch_count
    if step_launches != 4:
        raise AssertionError(f"two steps launched {step_launches}")
    real_apply = pipeline._ShadeHard.apply
    pipeline._ShadeHard.apply = lambda rec, tq, pids, s, o, c: \
        pipeline.shade_loop(pipeline.gather_rows(rec, pids), tq,
                            s[..., None], o, c)
    try:
        out_plain, grads_plain = step_grads()
    finally:
        pipeline._ShadeHard.apply = real_apply
    grad_err = {}
    for k in check.PARAM_NAMES:
        if not same(grads1[k], grads2[k]):
            raise AssertionError(f"two steps' gradients of {k} differ")
        scale = float(grads_plain[k].abs().max())
        grad_err[k] = float((grads1[k] - grads_plain[k]).abs().max()) / scale
        if not grad_err[k] <= 1e-4:
            raise AssertionError(f"gradient of {k} off the plain loop's by "
                                 f"{grad_err[k]} of its largest magnitude")
    if not same(out1, out2) or not same(out1, out_plain):
        raise AssertionError("the step's image differs")

    # timing (printed, not judged)
    live = int((steps >= 0).sum())
    px = steps.numel()
    fwd_bytes = nbytes(steps, origins, rec, pids, tex_quad) + 16 * px
    bwd_bytes = nbytes(steps, origins, g, rec, pids, tex_quad, *back)
    timing = {
        "forward": {
            "kernel_ms": median_ms(lambda: cuda_shade.shade_forward(
                *args, tls, cfg.modulate, cfg.background)),
            "graph_ms": graph_ms(lambda: cuda_shade.shade_forward(
                *args, tls, cfg.modulate, cfg.background)),
            "bound": bound(fwd_bytes, live * DIFF_SHADE_FWD_OPS)},
        "backward": {
            "kernel_ms": median_ms(lambda: cuda_shade.shade_backward(
                *args, g, tls, cfg.modulate)),
            "graph_ms": graph_ms(lambda: cuda_shade.shade_backward(
                *args, g, tls, cfg.modulate)),
            "bound": bound(bwd_bytes, live * DIFF_SHADE_BWD_OPS)}}
    leaf_rec = rec.clone().requires_grad_(True)
    leaf_tq = tex_quad.clone().requires_grad_(True)

    def plain_forward():
        return pipeline.shade_loop(pipeline.gather_rows(leaf_rec, pids),
                                   leaf_tq, steps[..., None], origins, cfg)

    timing["forward"]["plain_ms"] = median_ms(plain_forward)
    bwd = []
    for _ in range(REPS):
        leaf_rec.grad = leaf_tq.grad = None
        out = plain_forward()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        out.backward(g)
        t1.record()
        t1.synchronize()
        bwd.append(t0.elapsed_time(t1))
    timing["backward"]["plain_ms"] = float(np.median(bwd))
    phase("diff_shade", card=card, reps=REPS, tiles=T, M=M, C=C,
          pixels=px, live_pixels=live, equal=True,
          backward_bit_identical_twice=True, step_launches=step_launches,
          step_grad_rel_err=grad_err, **timing)
    fwd, bwd_t = timing["forward"], timing["backward"]
    return {"name": "diff_shade", "route": "cuda",
            "source": "skybox_rt_tpu_torch/csrc/diff_shade.cu",
            "replaces": None,   # XLA's fusion of the JAX shade_slots
            "launches": step_launches, "max_abs_err": 0,
            "ms": fwd["kernel_ms"], "graph_ms": fwd["graph_ms"],
            "plain_ms": fwd["plain_ms"], **fwd["bound"],
            "backward_ms": bwd_t["kernel_ms"],
            "backward_graph_ms": bwd_t["graph_ms"],
            "backward_plain_ms": bwd_t["plain_ms"],
            "backward_bound_ms": bwd_t["bound"]["bound_ms"],
            "library_ms": None, "tiles": T, "M": M}


# float operations a triangle of the set-up kernels (csrc/diff_prim.cu),
# counted from their bodies.  Forward: three corners' x, y (2 multiplies and
# an add each) and z (a divide, a multiply, an add), 27; the sign's three
# cofactors c (3 each) and det (3 multiplies, 2 adds) and its compare, 15;
# each edge's a, b, c (3 each) times the sign and the offset (add, multiply,
# add), 45.  Backward: the corners without z, 18, the sign, 15; each edge's
# half offset, its two sums and three products by the sign, 18; each
# corner's x, y and w gradients (4 multiplies, 3 adds each), the two scales
# and w's two adds, 75.
DIFF_PRIM_FWD_OPS = 27 + 15 + 45
DIFF_PRIM_BWD_OPS = 18 + 15 + 18 + 75


def diff_prim_phase(dev, card) -> dict:
    """Phase 19c: the triangle set-up (csrc/diff_prim.cu, launched by
    diff/pipeline._PrimSetup) at the fit cell's shapes, the 1024x1024
    training scene (V = 2,562, P = 5,120, textured).  The forward's record,
    z and corner list against the plain set-up (pipeline._prim_setup on the
    card) bit for bit; the backward against its twin
    (diff/cuda_prim.prim_backward_reference) bit for bit and twice alike;
    the Function's three parameter gradients against autograd's through the
    plain set-up, within 1e-5 of each one's largest magnitude; a step
    (check.step) twice alike, 2 launches a step, three #5 calls among its
    five.  Then CUDA events, median of 20: each kernel around the call and
    as a CUDA graph's replay beside its bound (bytes at 3.35 TB/s, each
    input read once and each output written once; operations), the
    Function's backward with its three #5 calls, and the plain set-up's
    forward and its autograd backward (its three #5 calls included).
    Returns the kernels line's entry."""
    from skybox_rt_tpu_torch.diff import (check, cuda_prim, cuda_texgrad,
                                          pipeline)

    def same(got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            return False
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        return torch.equal(got, want)

    params, static, cfg = check.train_scene(DIFF_SIZE)
    params, static = check.to_device(params, static, dev)
    indices = static["indices"]
    P, V = indices.shape[0], params["pos"].shape[0]
    names = ("pos", "color", "uv")
    tables = [params[k].detach() for k in names]
    C = cuda_prim.REC_WIDTH_TEXTURED
    g = torch.randn((P, C), device=dev,
                    generator=torch.Generator(dev).manual_seed(23))
    size = (cfg.width, cfg.height)

    # the kernels against the plain set-up and the twin, bit for bit
    cuda_prim.reset_launch_count()
    rec, z, corner = cuda_prim.prim_forward(*tables, indices, *size,
                                            cfg.near, cfg.far)
    back = cuda_prim.prim_backward(tables[0], indices, g, *size)
    again = cuda_prim.prim_backward(tables[0], indices, g, *size)
    torch.cuda.synchronize()
    if cuda_prim.launch_count != 3:
        raise AssertionError(f"3 calls launched {cuda_prim.launch_count}")

    def plain_setup():
        setup = pipeline._prim_setup(params, indices, cfg)
        return pipeline._record(setup), setup["z"]

    want_rec, want_z = plain_setup()
    want_corner = torch.cat([indices[:, 0], indices[:, 1], indices[:, 2]])
    twin = cuda_prim.prim_backward_reference(tables[0], indices, g, *size)
    for name, got, want in (("rec", rec, want_rec.detach()),
                            ("z", z, want_z.detach()),
                            ("corner", corner, want_corner),
                            *zip(("dpos", "dcol", "duv"), back, twin)):
        if not same(got, want):
            raise AssertionError(
                f"diff_prim {name} != plain on "
                f"{int((got != want).sum())} of {got.numel()} values")
    for name, a, b in zip(("dpos", "dcol", "duv"), back, again):
        if not same(a, b):
            raise AssertionError(f"two backward launches differ in {name}")

    # the Function's gradients against autograd's through the plain set-up
    def grads_of(make):
        for p in params.values():
            p.grad = None
        make()[0].backward(g)
        return {k: params[k].grad.clone() for k in names}

    def kernel_setup():
        return pipeline.prim_setup(params, indices, cfg)["rec"], None

    got, want = grads_of(kernel_setup), grads_of(plain_setup)
    grad_err = {}
    for k in names:
        scale = float(want[k].abs().max())
        grad_err[k] = float((got[k] - want[k]).abs().max()) / scale
        if not grad_err[k] <= 1e-5:
            raise AssertionError(f"gradient of {k} off autograd's by "
                                 f"{grad_err[k]} of its largest magnitude")

    # a whole step, twice
    def step_grads():
        check.step(params, static, cfg)
        return {k: p.grad.clone() for k, p in params.items()}

    cuda_prim.reset_launch_count()
    cuda_texgrad.reset_launch_count()
    grads1, grads2 = step_grads(), step_grads()
    torch.cuda.synchronize()
    step_launches = cuda_prim.launch_count
    if step_launches != 4 or cuda_texgrad.launch_count != 10:
        raise AssertionError(f"two steps launched {step_launches} set-up "
                             f"and {cuda_texgrad.launch_count} #5 kernels")
    for k in check.PARAM_NAMES:
        if not same(grads1[k], grads2[k]):
            raise AssertionError(f"two steps' gradients of {k} differ")

    # timing (printed, not judged)
    fwd_bytes = nbytes(*tables, indices, rec, z, corner)
    bwd_bytes = nbytes(tables[0], indices, g, *back)

    def kernel_fwd():
        return cuda_prim.prim_forward(*tables, indices, *size, cfg.near,
                                      cfg.far)

    def kernel_bwd():
        return cuda_prim.prim_backward(tables[0], indices, g, *size)

    def backward_ms(make):
        times = []
        for _ in range(WARMUP + REPS):
            for p in params.values():
                p.grad = None
            out = make()[0]
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            out.backward(g)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        return float(np.median(times[WARMUP:]))

    timing = {
        "forward": {"kernel_ms": median_ms(kernel_fwd),
                    "graph_ms": graph_ms(kernel_fwd),
                    "bound": bound(fwd_bytes, P * DIFF_PRIM_FWD_OPS),
                    "function_ms": median_ms(kernel_setup),
                    "plain_ms": median_ms(plain_setup)},
        "backward": {"kernel_ms": median_ms(kernel_bwd),
                     "graph_ms": graph_ms(kernel_bwd),
                     "bound": bound(bwd_bytes, P * DIFF_PRIM_BWD_OPS),
                     "function_ms": backward_ms(kernel_setup),
                     "plain_ms": backward_ms(plain_setup)}}
    phase("diff_prim", card=card, reps=REPS, triangles=P, vertices=V, C=C,
          equal=True, backward_bit_identical_twice=True,
          step_launches=step_launches, grad_rel_err=grad_err, **timing)
    fwd, bwd = timing["forward"], timing["backward"]
    return {"name": "diff_prim", "route": "cuda",
            "source": "skybox_rt_tpu_torch/csrc/diff_prim.cu",
            "replaces": None,   # XLA's fusion of the JAX prim_setup
            "launches": step_launches, "max_abs_err": 0,
            "ms": fwd["kernel_ms"], "graph_ms": fwd["graph_ms"],
            "plain_ms": fwd["plain_ms"], **fwd["bound"],
            "backward_ms": bwd["kernel_ms"],
            "backward_graph_ms": bwd["graph_ms"],
            "backward_plain_ms": bwd["plain_ms"],
            "backward_bound_ms": bwd["bound"]["bound_ms"],
            "library_ms": None, "triangles": P}


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

    def walk_bound(blocks, o, d, stats):
        """Bound of one next-hit-after walk: rays and carry read once, the
        records, boxes and leaf table once, (slot, prim, t, u, v) written
        once, against the tests the plain version counted."""
        return bound(nbytes(o, d, blocks["tri"], blocks["s2p"],
                            blocks["aabb"], blocks["leaf_range"],
                            blocks["leaf_table"]) + (8 + 20) * o.shape[0],
                     walk_ops(stats))

    def compare_walks(o, d, tm, blocks, walks, plain_on=None, stats=None,
                      past_end=False):
        """`walks` walks of the kernel fed back into each other (with
        past_end, on until every ray's list has ended, and then one more);
        walk k of plain_on (all of them when None) against the plain version
        from the same carry, bit for bit.  Returns ([kernel outputs a walk],
        rays that differ, max |diff|, [plain seconds of the compared walks],
        [share of the rays that enter each walk with a +inf carry])."""
        tlo, slo = start(o.shape[0])
        outs, bad, err, plain_s, ended = [], 0, 0.0, [], []
        for k in range(MAX_WALKS + 1):
            if k >= walks and (not past_end or ended[-1] == 1.0):
                break
            if k == MAX_WALKS:
                raise AssertionError(f"a ray's list did not end in "
                                     f"{MAX_WALKS} walks")
            ended.append(float((tlo == math.inf).float().mean()))
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
        return outs, bad, err, plain_s, ended

    # 20a. the check soups, whole, at every leaf size of the sweep: every
    # walk against the plain version, past the end of every ray's list
    soups = {}
    for name in scenes.AFTER_CHECK_SOUPS:
        v0, e1, e2, tri_block, o, d, tm, walks = scenes.after_check_queries(
            name)
        verts, faces = scenes.soup_mesh(v0, e1, e2)
        bvh = bvh_mod.build_sah(verts, faces)
        bs = bvh_mod.build_block_set(bvh, tri_block=tri_block)
        for lt in LEAF_SWEEP:
            blocks = cuda_rt.prepare_bvh_blocks(
                on_card(v0), on_card(e1), on_card(e2), bs,
                bvh_mod.build_block_leaves(bvh, bs, lt))
            outs, bad, err, _, ended = compare_walks(
                on_card(o), on_card(d), on_card(tm), blocks, walks,
                past_end=True)
            hits = [int((g[1] >= 0).sum()) for g in outs]
            if hits[0] == 0 or hits[-1] != 0:
                raise AssertionError(f"{name}: hits a walk {hits}")
            first = cuda_rt.closest_hit_bvh(on_card(o), on_card(d), blocks,
                                            t_max=on_card(tm), t_min=1e-6)
            if differ(outs[0][1:], first)[0]:
                raise AssertionError(f"{name}: walk 1 != closest_hit_bvh")
            ts = torch.stack([g[2] for g in outs], 1)
            fin = torch.isfinite(ts[:, 1:])
            soups[f"{name}_leaves{lt}"] = {
                "walks": len(outs), "hits_a_walk": hits,
                "ended_share": ended, "rays_differ": bad,
                "tied_steps": int(((ts[:, 1:] == ts[:, :-1]) & fin).sum())}
            if soups[f"{name}_leaves{lt}"]["tied_steps"] == 0:
                raise AssertionError(f"{name}: no hit of equal t was "
                                     f"enumerated")

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
          leaf_tris=tracer.BVH_LEAF_TRIS,
          leaves={m["draw_index"]: int(a["blocks"]["leaf_table"].shape[0])
                  for m, a in zip(metas, arrays) if "blocks" in a},
          host_s={"first_render_with_retry": first_s,
                  "make_frame_fn_cached": cached_s})

    # 20b. every walk of every kslot draw of that frame on a 65,536-ray
    # sample, on until every ray's list has ended and one more; every walk
    # of the frame on all rays; walk 1 == kernel #2
    nx, ny = rays
    dirs = torch.stack([nx, ny, torch.ones_like(nx)], -1).contiguous()
    eye = torch.zeros_like(dirs)
    stride = N * N // RT_SAMPLE
    ds_, es_ = dirs[::stride].contiguous(), eye[::stride].contiguous()
    draws, largest, entry_stats = {}, None, None
    after_err, after_bad, frame_bound = 0.0, 0, 0.0
    for meta, arr in zip(metas, arrays):
        if meta["mode"] != "kslot":
            continue
        blocks = arr["blocks"]
        walks = meta["K"] + (meta["K"] < meta["P"])
        stats = {}
        outs, bad, err, plain_s, ended = compare_walks(
            es_, ds_, None, blocks, walks, stats=stats, past_end=True)
        full_stats = {}
        full, bad2, err2, full_s, full_ended = compare_walks(
            eye, dirs, None, blocks, walks, stats=full_stats)
        first = cuda_rt.closest_hit_bvh(eye, dirs, blocks, t_min=1e-6)
        if differ(full[0][1:], first)[0]:
            raise AssertionError(f"draw {meta['draw_index']}: walk 1 != "
                                 f"closest_hit_bvh on the same blocks")
        after_err = max(after_err, err, err2)
        after_bad += bad + bad2
        # the bound of each walk of the frame, from its counted tests
        walk_bounds = [walk_bound(blocks, eye, dirs, full_stats[k])
                       for k in range(walks)]
        frame_bound += sum(b["bound_ms"] for b in walk_bounds)
        draws[meta["draw_index"]] = {
            "P": meta["P"], "K": meta["K"], "walks": walks,
            "blocks": blocks["num_blocks"],
            "leaves": int(blocks["leaf_table"].shape[0]),
            "sample_walks_to_the_end": len(outs),
            "hits_a_walk_sample": [int((g[1] >= 0).sum()) for g in outs],
            "ended_share_sample": ended,
            "ended_share": full_ended,
            **{f"{k}_per_ray": [full_stats[w].get(k, 0) / (N * N)
                                for w in range(walks)]
               for k in ("tri_tests", "slab_tests", "blocks_entered",
                         "block_tri_tests")},
            "walk_bound_ms": [b["bound_ms"] for b in walk_bounds],
            "plain_ms_sample": [x * 1e3 for x in plain_s],
            "plain_ms_all_rays": [x * 1e3 for x in full_s],
            "rays_differ": bad + bad2}
        if largest is None or meta["P"] > largest[0]["P"]:
            largest, entry_stats = (meta, arr), (full_stats, full_s)
    phase("rt_after_vs_plain", soups=soups, draws=draws, equal=True,
          leaf_tris=tracer.BVH_LEAF_TRIS, sample_rays=RT_SAMPLE,
          rays_differ=after_bad, max_abs_err=after_err)
    meta, arr = largest
    blocks = arr["blocks"]
    st0 = entry_stats[0][0]
    after_entry = {
        "name": "rt_closest_hit_bvh_after", "route": "cuda",
        "source": "skybox_rt_tpu_torch/csrc/rt_bvh.cu",
        "replaces": "skybox_rt_tpu/ops/pallas_rt.py:1323",
        "launches": counts["closest_hit_bvh_after"], "max_abs_err": after_err,
        "ms": None, "plain_ms": entry_stats[1][0] * 1e3,
        **walk_bound(blocks, eye, dirs, st0),
        "library_ms": None,     # no single PyTorch call computes this
        "rays": N * N, "rays_differ": after_bad,
        "draw": meta["draw_index"], "triangles": meta["P"],
        **tests_per_ray(st0, N * N),
        "frame_bound_ms": frame_bound}

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
    def prepass_compare(o, d, tm, stream):
        """The prepass kernel against its plain version, element for
        element, in both orders; raises on any difference.  Returns the
        near-to-far lists and the plain version's seconds (near to far)."""
        out = {}
        for f2b in (True, False):
            got = cuda_rt.active_block_lists(o, d, stream, tm, f2b)
            want, secs = timed(lambda: cuda_rt.active_block_lists_reference(
                o, d, stream, tm, f2b))
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(
                    f"prepass kernel != plain version (front_to_back {f2b}):"
                    f" {int((got[0] != want[0]).sum())} list entries, "
                    f"{int((got[1] != want[1]).sum())} counts differ")
            out[f2b] = (got, secs)
        return out[True]

    def stream_compare(o, d, tm, stream, clusters, flat, stats=None,
                       flat_plain=False):
        """Both kernels against their plain versions, against each other
        and the clustered kernel (equal on every ray) and the flat one
        (tie-aware; with ``flat_plain`` also against its plain version, bit
        for bit); the prepass kernel against its plain version; raises on
        any mismatch."""
        out = {}
        got = cuda_rt.closest_hit_streamed(o, d, stream, t_max=tm)
        want, out["streamed_plain_ms"] = timed(
            lambda: cuda_rt.closest_hit_streamed_reference(
                o, d, stream, tm, stats=None if stats is None else
                stats.setdefault("streamed", {})))
        lists, prepass_s = prepass_compare(o, d, tm, stream)
        out["prepass_plain_ms"] = prepass_s * 1e3
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
        got_f = cuda_rt.closest_hit_pallas(o, d, flat, t_max=tm)
        if flat_plain:
            out["flat_rays_differ"] = differ(
                got_f, cuda_rt.closest_hit_pallas_reference(o, d, flat,
                                                            tm))[0]
        if any(out[k] for k in out if "differ" in k):
            raise AssertionError(f"streamed / worklist kernels: {out}")
        out["prims_tied_with_flat"] = scenes.check_clustered_equals_flat(
            [x.cpu().numpy() for x in got],
            [x.cpu().numpy() for x in got_f])
        out["mean_list_length"] = float(lists[1].float().mean())
        return out

    def pack(verts, faces, bvh, tri_block=cuda_rt.STREAM_TRI_BLOCK):
        tri = intersect.triangle_arrays(
            on_card(verts), on_card(np.asarray(faces, np.int64)))
        cl = bvh_mod.build_clusters(bvh, 64)
        return (cuda_rt.prepare_stream_blocks(*tri, order=cl["order"],
                                              tri_block=tri_block),
                cuda_rt.prepare_clusters(*tri, cl), cuda_rt.pack_records(*tri))

    def lane_figures(stats):
        """The kernels' lane efficiency from a plain version's counts:
        useful triangle tests over the lane-steps run, at the shipped
        switch and a ray a lane (the earlier design)."""
        useful = stats.get("tri_tests", 0)
        run, ray = stats.get("lane_steps", 0), stats.get("lane_steps_ray", 0)
        return {"lane_efficiency": useful / run if run else None,
                "lane_efficiency_ray_a_lane": useful / ray if ray else None,
                "warp_visits": stats.get("warp_visits", 0)}

    checks = {"cases": 0, "rays_differ": 0, "prims_tied_with_flat": 0,
              "flat_rays_differ": 0, "prepass_lists_equal": True}
    for name in sorted(scenes.CLUSTER_CHECK_SCENES):
        verts, faces, _, queries = scenes.cluster_check_queries(name)
        packed = pack(verts, faces, bvh_mod.build(verts, faces), 24)
        for _, _, o, d, tm in queries:
            tm = None if tm is None else cuda_rt._per_ray_tmax(
                on_card(tm) if np.ndim(tm) else tm, o.shape[0], dev)
            out = stream_compare(on_card(o), on_card(d), tm, *packed,
                                 flat_plain=True)
            checks["cases"] += 1
            checks["prims_tied_with_flat"] += out["prims_tied_with_flat"]
            checks["flat_rays_differ"] += out["flat_rays_differ"]

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
    # the prepass at more than 2,048 blocks: the large scene's records in
    # prim order at the shipped tri_block, on 65,536 of its camera's primary
    # rays (every 16th, so a tile spans two image rows)
    lv, lf, _ = scenes.sphere_field(copies=9, subdiv=5)
    big = cuda_rt.prepare_stream_blocks(*intersect.triangle_arrays(
        on_card(lv), on_card(np.asarray(lf, np.int64))))
    if big["num_blocks"] < 2048:
        raise AssertionError(f"the large case has {big['num_blocks']} "
                             f"blocks")
    lo, ld = tracer.camera_rays(cam, RT_SIZE, RT_SIZE, dev)
    big_lists, big_s = prepass_compare(lo[::16].contiguous(),
                                       ld[::16].contiguous(), None, big)
    big_case = {"triangles": int(lf.shape[0]), "blocks": big["num_blocks"],
                "rays": RT_SAMPLE, "equal": True,
                "mean_list_length": float(big_lists[1].float().mean()),
                "plain_ms": big_s * 1e3}
    del big, big_lists
    # the whole primary launch: the shapes of the kernels line
    _, o, d, tm = launches[0]
    stats = {}
    primary = stream_compare(o, d, tm, stream, clusters, flat, stats)
    R = o.shape[0]
    # the kernels' lanes on each whole launch: a warp is 32 consecutive rays
    # of its launch, which a strided sample does not keep together
    lanes = {"primary": {q: lane_figures(stats[q])
                         for q in ("streamed", "worklist")}}
    for name, (_, lo, ld, ltm) in zip(LAUNCH_NAMES[1:], launches[1:]):
        st = {}
        cuda_rt.closest_hit_streamed_reference(lo, ld, stream, ltm, stats=st)
        lanes[name] = {"streamed": lane_figures(st)}
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
            "tri_tests_per_ray": stats[q]["tri_tests"] / R,
            "lane_switch": cuda_rt.STREAM_LANE_SWITCH,
            **lane_figures(stats[q])})
    # the prepass: rays read once, the lists and counts written once, a
    # slab test of every (ray, block) pair
    NB = stream["num_blocks"]
    prepass_entry = {
        "name": "rt_active_block_lists", "route": "cuda",
        "source": "skybox_rt_tpu_torch/csrc/rt_streamed.cu",
        "replaces": "skybox_rt_tpu/ops/pallas_rt.py:449",
        "launches": None, "max_abs_err": 0, "ms": None,
        "plain_ms": primary["prepass_plain_ms"],
        **bound(nbytes(o, d, tm, stream["aabb"], *lists),
                R * NB * SLAB_OPS),
        "library_ms": None,     # no single PyTorch call computes this
        "rays": R, "blocks": NB,
        "mean_list_length": primary["mean_list_length"],
        "large_case": big_case}
    stream_entries[1]["prepass_bound_ms"] = prepass_entry["bound_ms"]
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
        # the worklist engine's every query runs its prepass kernel first;
        # each of the three shades is one kernel
        want_counts = {key: 6, "shade_hits": 3}
        if engine == "pallas_worklist":
            want_counts["active_block_lists"] = 6
        if got_counts != want_counts:
            raise AssertionError(f"{engine} frame launched {got_counts}, "
                                 f"expected {want_counts}")
        max_diff = float((img_e - base).abs().max())
        if max_diff != 0.0:
            raise AssertionError(f"{engine} frame != clustered frame: max "
                                 f"|diff| {max_diff}")
        entry["launches"] = 6
        if engine == "pallas_worklist":
            prepass_entry["launches"] = got_counts["active_block_lists"]
        frames[engine] = {"launches": got_counts,
                          "max_abs_diff_clustered_frame": max_diff,
                          "fn": (fn_e, oe, de)}
    phase("rt_streamed_worklist", checks=checks, triangles=P,
          blocks=stream["num_blocks"], tri_block=stream["tri_block"],
          ray_tile=cuda_rt.STREAM_RAY_TILE,
          lane_switch=cuda_rt.STREAM_LANE_SWITCH, lanes=lanes,
          classes=classes, prepass_large_case=big_case,
          primary={k: v for k, v in primary.items()},
          frames={e: {k: v for k, v in f.items() if k != "fn"}
                  for e, f in frames.items()},
          equal=True, rays_differ=0)

    # 25. timing (printed, not judged)
    # each launch timed around the wrapper's call and as a CUDA graph's
    # replay (graph_ms)
    t = {"after_walks_ms": {}, "after_walks_graph_ms": {}, "winner_ms": {},
         "winner_graph_ms": {}}
    for m, a in zip(metas, arrays):
        di = m["draw_index"]
        if m["mode"] == "winner":
            oo, dd = ((dirs * m["far_d"], -dirs) if m["farthest"]
                      else (eye, dirs))

            def winner():
                return cuda_rt.closest_hit_bvh(oo, dd, a["blocks"],
                                               t_min=1e-6)
            t["winner_ms"][di] = median_ms(winner)
            t["winner_graph_ms"][di] = graph_ms(winner)
        elif m["mode"] == "kslot":
            walks = m["K"] + (m["K"] < m["P"])
            outs = compare_walks(eye, dirs, None, a["blocks"], walks,
                                 plain_on=set())[0]
            carries = [start(N * N)] + [(g[2], g[0]) for g in outs[:-1]]
            t["after_walks_ms"][di], t["after_walks_graph_ms"][di] = [], []
            for tlo, slo in carries:
                def walk():
                    return cuda_rt.closest_hit_bvh_after(
                        eye, dirs, a["blocks"], tlo, slo, t_min=1e-6)
                t["after_walks_ms"][di].append(median_ms(walk))
                t["after_walks_graph_ms"][di].append(graph_ms(walk))
    # per walk of the frame: the share of rays that enter with a +inf carry
    # (they exit at once) and the tests a ray, at the leaves and had every
    # entered block been tested whole (phase 20, all rays)
    t["after_walks"] = {di: {k: dr[k] for k in (
        "ended_share", "tri_tests_per_ray", "block_tri_tests_per_ray",
        "slab_tests_per_ray", "walk_bound_ms")} for di, dr in draws.items()}
    after_entry["ms"] = t["after_walks_ms"][meta["draw_index"]][0]
    after_entry["walk_ms"] = t["after_walks_ms"]
    after_entry["frame_ms"] = sum(sum(v) for v in
                                  t["after_walks_ms"].values())
    after_entry["graph_ms"] = t["after_walks_graph_ms"][meta["draw_index"]][0]
    after_entry["walk_graph_ms"] = t["after_walks_graph_ms"]
    after_entry["frame_graph_ms"] = sum(sum(v) for v in
                                        t["after_walks_graph_ms"].values())
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

    def streamed_launch(launch):
        _, lo, ld, ltm = launch
        return lambda: cuda_rt.closest_hit_streamed(lo, ld, stream,
                                                    t_max=ltm)

    def worklist():
        return cuda_rt.closest_hit_worklist(o, d, stream, lists=lists)

    # the streamed frame's six launches (the shadow launches as the
    # closest hit inside their bound, as the engine runs them)
    s_entry["launch_ms"] = {n: median_ms(streamed_launch(la))
                            for n, la in zip(LAUNCH_NAMES, launches)}
    s_entry["launch_graph_ms"] = {n: graph_ms(streamed_launch(la))
                                  for n, la in zip(LAUNCH_NAMES, launches)}
    s_entry["ms"] = s_entry["launch_ms"]["primary"]
    s_entry["graph_ms"] = s_entry["launch_graph_ms"]["primary"]
    s_entry["frame_ms"] = sum(s_entry["launch_ms"].values())
    s_entry["frame_graph_ms"] = sum(s_entry["launch_graph_ms"].values())
    w_entry["ms"], w_entry["graph_ms"] = median_ms(worklist), graph_ms(
        worklist)
    def prepass():
        return cuda_rt.active_block_lists(o, d, stream)

    def with_prepass():
        return cuda_rt.closest_hit_worklist(o, d, stream)
    prepass_entry["ms"] = w_entry["prepass_ms"] = median_ms(prepass)
    prepass_entry["graph_ms"] = w_entry["prepass_graph_ms"] = graph_ms(
        prepass)
    w_entry["prepass_plain_ms"] = median_ms(
        lambda: cuda_rt.active_block_lists_reference(o, d, stream), reps=5,
        warmup=1)
    w_entry["with_prepass_ms"] = median_ms(with_prepass)
    w_entry["with_prepass_graph_ms"] = graph_ms(with_prepass)
    # the flat kernel on 65,536 rays of bounce 1, whose blocks differ in
    # origin: the general path, its work counted on the same rays
    ob, db, _ = sample_launch("bounce1", launches[2])

    def flat_bounce():
        return cuda_rt.closest_hit_pallas(ob, db, flat)
    flat_b = {"rays": int(ob.shape[0]), "ms": median_ms(flat_bounce),
              "graph_ms": graph_ms(flat_bounce),
              "bound": flat_bound(ob, db, None, flat,
                                  cuda_rt.flat_work_counts(ob, db, flat))}
    small = {"streamed_ms": s_entry["ms"], "worklist_ms": w_entry["ms"],
             "streamed_graph_ms": s_entry["graph_ms"],
             "worklist_graph_ms": w_entry["graph_ms"],
             "streamed_launch_ms": s_entry["launch_ms"],
             "streamed_launch_graph_ms": s_entry["launch_graph_ms"],
             "worklist_prepass_ms": w_entry["prepass_ms"],
             "worklist_prepass_graph_ms": w_entry["prepass_graph_ms"],
             "worklist_prepass_plain_ms": w_entry["prepass_plain_ms"],
             "worklist_prepass_bound_ms": prepass_entry["bound_ms"],
             "worklist_with_prepass_ms": w_entry["with_prepass_ms"],
             "worklist_with_prepass_graph_ms":
                 w_entry["with_prepass_graph_ms"],
             "flat_bounce1_sample": flat_b,
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
    return [after_entry] + stream_entries + [prepass_entry], flat_b


APPS_GEMM = 4096        # the full-size product: 4096 x 4096 x 4096
# Stripes of rows the plain version computes at the full size (rows of C are
# independent, so a stripe of the kernel's C is held to the plain version of
# the same rows of A)
APPS_GEMM_STRIPES = ((0, 128), (APPS_GEMM - 128, APPS_GEMM))
BS_OPTIONS = 4_000_000  # the NVIDIA BlackScholes sample's OPT_N
BFS_NODES = 1 << 20     # Rodinia graph1MW_6: 1,048,576 nodes, ~6 edges a node
LBM_FULL = (120, 120, 150)  # 2,160,000 cells, 172.8 MB of grid
APPS_TEX = 1024         # om_app and tex_app at 1024x1024


def dogfood_inputs(name, n=256):
    """The JAX test's inputs of a dogfood case, from a seed of its name."""
    import zlib
    r = np.random.default_rng(zlib.crc32(name.encode()))
    if name.startswith("i"):
        return (r.integers(-1000, 1000, size=n).astype(np.int32),
                r.integers(1, 1000, size=n).astype(np.int32))
    return ((r.standard_normal(n) * 4 + 0.5).astype(np.float32),
            (np.abs(r.standard_normal(n)) + 0.5).astype(np.float32))


def lbm_oracle_step(lbm, cfg, grid):
    """One stream-collide step of the reference kernel (tests/opencl/lbm/
    kernel.cl:16-175), cell by cell in numpy, GATHER layout."""
    out = grid.copy()
    d = lbm.DIRS.astype(np.float32)
    for z in range(cfg.size_z):
        for y in range(cfg.size_y):
            for x in range(cfg.size_x):
                f = np.array([grid[cfg.calc_index(x - dx, y - dy, z - dz, e)]
                              for e, (dx, dy, dz) in enumerate(lbm.DIRS)],
                             np.float32)
                fi = cfg.calc_index(x, y, z, lbm.FLAGS)
                flags = grid[fi:fi + 1].view(np.uint32)[0]
                if flags & lbm.OBSTACLE:
                    new = f[lbm.OPPOSITE]
                else:
                    rho = np.float32(f.sum())
                    ux, uy, uz = (d.T @ f) / rho
                    if flags & lbm.ACCEL:
                        ux, uy, uz = (np.float32(0.005), np.float32(0.002),
                                      np.float32(0.0))
                    u2 = np.float32(1.5) * (ux * ux + uy * uy + uz * uz) \
                        - np.float32(1.0)
                    cu = d[:, 0] * ux + d[:, 1] * uy + d[:, 2] * uz
                    new = (np.float32(1.0) - lbm.OMEGA) * f \
                        + lbm.WEIGHTS * (lbm.OMEGA * rho) \
                        * (cu * (np.float32(4.5) * cu + np.float32(3.0)) - u2)
                for e in range(lbm.FLAGS):
                    out[cfg.calc_index(x, y, z, e)] = new[e]
    return out


def close(what, got, want, rtol, atol):
    """Raises unless got is within rtol / atol of want; returns max |diff|."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    if got.dtype.kind in "iub" and want.dtype.kind in "iub":
        if not np.array_equal(got, want):
            raise AssertionError(f"{what}: {int((got != want).sum())} "
                                 "values differ")
        return 0.0
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max |diff| "
                             f"{float(np.abs(got - want).max())} beyond "
                             f"rtol {rtol}, atol {atol}")
    return float(np.abs(got.astype(np.float64) - want).max())


def apps_phases(dev, card) -> list:
    """Phases 26 to 28: kernel #12 against its plain version and the
    library product, every app against its numpy oracle on the card, and
    the timings; returns #12's entry of the kernels line."""
    from skybox_rt_tpu_torch.apps import (compute, cuda_sgemm, lbm, om_app,
                                          opencl, tex_app)
    from skybox_rt_tpu_torch.core import fixed
    from skybox_rt_tpu_torch.geom import binning, cgltrace
    from skybox_rt_tpu_torch.texture import convert

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def gemm_inputs(m, k, n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn((m, k), generator=g, device=dev),
                torch.randn((k, n), generator=g, device=dev))

    # 26. #12 against its plain version, bit for bit, and the library
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 is set: "
                             "the library product would not be float32")
    checks, err = [], 0
    for (m, k, n), block in (((256, 384, 128), (128, 128, 128)),
                             ((200, 72, 136), (8, 8, 8)),
                             ((1, 1, 1), (1, 1, 1)),
                             ((130, 257, 129), (1, 1, 1)),
                             ((APPS_GEMM,) * 3, (128, 128, 128))):
        a, b = gemm_inputs(m, k, n, seed=m + k + n)
        got = compute.sgemm_pallas(a, b, block=block)
        if m == APPS_GEMM:
            for r0, r1 in APPS_GEMM_STRIPES:
                err = max(err, max_abs_err(
                    [got[r0:r1].view(torch.int32)],
                    [cuda_sgemm.sgemm_reference(a[r0:r1], b).view(
                        torch.int32)]))
            rows = sum(r1 - r0 for r0, r1 in APPS_GEMM_STRIPES)
        else:
            err = max(err, max_abs_err(
                [got.view(torch.int32)],
                [cuda_sgemm.sgemm_reference(a, b).view(torch.int32)]))
            rows = m
        # the forward error bound of a k-term float32 dot product, gamma_k
        # = k u (u = 2^-24) times sum |a||b|, once for each of the two sums
        mm = torch.matmul(a, b)
        scale = torch.matmul(a.abs(), b.abs())
        ratio = float(((got - mm).abs() / (2 * k * 2.0 ** -24 * scale)).max())
        if not ratio <= 1.0:
            raise AssertionError(f"sgemm {m}x{k}x{n} vs torch.matmul beyond "
                                 f"2 k u sum|a||b|: ratio {ratio}")
        checks.append({"m": m, "k": k, "n": n, "block": list(block),
                       "rows_vs_plain": rows, "bit_equal": True,
                       "vs_matmul_max_abs": float((got - mm).abs().max()),
                       "vs_matmul_of_bound": ratio})
    phase("apps_sgemm_vs_plain", checks=checks, max_abs_err=err,
          matmul_bound="|kernel - matmul| <= 2 k 2^-24 (|A||B|)_ij")

    # 27. every app on the card against its numpy oracle; the counts are set
    # to 0 just before the apps run and read just after
    cuda_sgemm.reset_launch_count()
    oracle = {}
    r = np.random.default_rng(1)
    x = r.standard_normal(4096).astype(np.float32)
    y = r.standard_normal(4096).astype(np.float32)
    oracle["vecadd"] = close("vecadd", compute.vecadd(cuda(x), cuda(y)).cpu(),
                             x + y, 0, 0)
    a = r.standard_normal((128, 96)).astype(np.float32)
    b = r.standard_normal((96, 64)).astype(np.float32)
    oracle["sgemm"] = close("sgemm", compute.sgemm(cuda(a), cuda(b)).cpu(),
                            a @ b, 1e-5, 1e-4)
    a = r.standard_normal((256, 384)).astype(np.float32)
    b = r.standard_normal((384, 128)).astype(np.float32)
    oracle["sgemm_pallas"] = close(
        "sgemm_pallas", compute.sgemm_pallas(cuda(a), cuda(b)).cpu(), a @ b,
        1e-5, 1e-3)
    ga, gb = gemm_inputs(APPS_GEMM, APPS_GEMM, APPS_GEMM, seed=7)
    big = compute.sgemm_pallas(ga, gb)
    big_ratio = float(((big - torch.matmul(ga, gb)).abs()
                       / (2 * APPS_GEMM * 2.0 ** -24
                          * torch.matmul(ga.abs(), gb.abs()))).max())
    if not big_ratio <= 1.0:
        raise AssertionError(f"sgemm_pallas 4096^3: ratio {big_ratio}")
    oracle["sgemm_pallas_4096_of_bound"] = big_ratio
    h, w = 33, 47
    padded = np.zeros((h + 2, w + 2), np.float32)
    padded[1:-1, 1:-1] = r.standard_normal((h, w)).astype(np.float32)
    wts = r.standard_normal((3, 3)).astype(np.float32)
    ref = np.array([[np.sum(padded[yy:yy + 3, xx:xx + 3] * wts,
                            dtype=np.float32) for xx in range(w)]
                    for yy in range(h)], np.float32)
    oracle["conv3x"] = close("conv3x", compute.conv3x(cuda(padded),
                                                      cuda(wts)).cpu(),
                             ref, 1e-5, 1e-5)
    vol = r.standard_normal((9, 9, 9)).astype(np.float32)
    p = np.pad(vol, 1, mode="edge")
    ref = sum(p[dz:dz + 9, dy:dy + 9, dx:dx + 9] for dz in range(3)
              for dy in range(3) for dx in range(3)) / 27.0
    oracle["stencil3d"] = close("stencil3d", compute.stencil3d(
        cuda(vol)).cpu(), ref, 1e-5, 1e-5)
    xs = r.integers(0, 50, size=257).astype(np.int32)
    oracle["rank_sort"] = close("rank_sort", compute.rank_sort(
        cuda(xs)).cpu(), np.sort(xs, kind="stable"), 0, 0)
    src = r.integers(-20, 20, size=64).astype(np.int32)
    oracle["diverge"] = close("diverge", compute.diverge(cuda(src)).cpu(),
                              compute.diverge_oracle(src), 0, 0)
    for name, (fn, ora) in sorted(compute.DOGFOOD_CASES.items()):
        da, db = dogfood_inputs(name)
        out = fn(cuda(da), cuda(db))
        want = ora(da, db)
        got = (fixed.to_numpy_u32(out) if want.dtype == np.uint32
               else out.cpu().numpy())
        oracle[f"dogfood_{name}"] = close(name, got, want, 1e-5, 1e-5)

    x = r.standard_normal(2048).astype(np.float32)
    y = r.standard_normal(2048).astype(np.float32)
    oracle["saxpy"] = close("saxpy", opencl.saxpy(2.5, cuda(x), cuda(y)).cpu(),
                            2.5 * x + y, 1e-5, 1e-6)
    oracle["dotproduct"] = close("dotproduct", float(opencl.dotproduct(
        cuda(x), cuda(y))), np.dot(x, y), 1e-4, 0)
    oracle["psum_reduce"] = close("psum", float(opencl.psum_reduce(cuda(x))),
                                  x.sum(), 1e-4, 1e-4)
    tm = r.standard_normal((37, 53)).astype(np.float32)
    oracle["transpose"] = close("transpose", opencl.transpose(
        cuda(tm)).cpu(), tm.T, 0, 0)
    bs = {}
    for label, n in (("blackscholes", 4096),
                     ("blackscholes_4M", BS_OPTIONS)):
        S = r.uniform(5.0, 30.0, n).astype(np.float32)
        X = r.uniform(1.0, 100.0, n).astype(np.float32)
        T = r.uniform(0.25, 10.0, n).astype(np.float32)
        call, put = opencl.blackscholes(cuda(S), cuda(X), cuda(T), 0.02, 0.30)
        c_ref, p_ref = opencl.blackscholes_oracle(S, X, T, 0.02, 0.30)
        # atol 1e-4 as the JAX test; rtol 1e-5 for the 1-2 ulp of float32
        # exp / log between numpy and the card on prices up to 100
        oracle[label] = max(close(label + " call", call.cpu(), c_ref, 1e-5,
                                  1e-4),
                            close(label + " put", put.cpu(), p_ref, 1e-5,
                                  1e-4))
        bs[label] = (cuda(S), cuda(X), cuda(T))
    pts = r.standard_normal((1000, 2)).astype(np.float32)
    q = np.array([0.3, -0.2], np.float32)
    dist, idx = opencl.nearn(cuda(pts), cuda(q))
    ref = np.sqrt(((pts - q) ** 2).sum(1))
    oracle["nearn"] = close("nearn", dist.cpu(), ref, 1e-5, 1e-6)
    if int(idx) != int(np.argmin(ref)):
        raise AssertionError("nearn argmin")
    pts = r.standard_normal((500, 3)).astype(np.float32)
    cen = r.standard_normal((7, 3)).astype(np.float32)
    assign = opencl.kmeans_assign(cuda(pts), cuda(cen))
    ref_assign = np.argmin(((pts[:, None] - cen[None]) ** 2).sum(-1), axis=1)
    oracle["kmeans_assign"] = close("kmeans_assign", assign.cpu(),
                                    ref_assign, 0, 0)
    upd = opencl.kmeans_update(cuda(pts), assign, 7).cpu().numpy()
    ref = np.stack([pts[ref_assign == k].mean(0) if (ref_assign == k).any()
                    else np.zeros(3, np.float32) for k in range(7)])
    oracle["kmeans_update"] = close("kmeans_update", upd, ref, 1e-4, 1e-5)
    dense = r.standard_normal((40, 60)).astype(np.float32)
    dense[r.random((40, 60)) > 0.15] = 0.0
    xv = r.standard_normal(60).astype(np.float32)
    rows_, cols_ = np.nonzero(dense)
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(rows_, minlength=40))
                              ]).astype(np.int32)
    oracle["spmv_csr"] = close("spmv", opencl.spmv_csr(
        cuda(dense[rows_, cols_]), cuda(cols_.astype(np.int32)),
        cuda(opencl.expand_row_ptr(row_ptr)), cuda(xv), 40).cpu(),
        dense @ xv, 1e-4, 1e-4)
    bfs_runs = {}
    for label, n, m in (("bfs_200", 200, 600), ("bfs_1M", BFS_NODES,
                                                6 * BFS_NODES)):
        es = r.integers(0, n, m).astype(np.int32)
        ed = r.integers(0, n, m).astype(np.int32)
        t0 = time.perf_counter()
        cost = opencl.bfs(cuda(es), cuda(ed), n).cpu().numpy()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        oracle[label] = close(label, cost, opencl.bfs_oracle(es, ed, n), 0, 0)
        bfs_runs[label] = {"nodes": n, "edges": m, "levels": int(cost.max()),
                           "reached": int((cost >= 0).sum()),
                           "card_s": card_s,
                           "oracle_s": time.perf_counter() - t0}
    A = r.standard_normal((24, 24)).astype(np.float32)
    A += np.eye(24, dtype=np.float32) * (np.abs(A).sum(1).max() + 1.0)
    bb = r.standard_normal(24).astype(np.float32)
    U, c = opencl.gaussian_eliminate(cuda(A), cuda(bb))
    U, c = U.cpu().numpy(), c.cpu().numpy()
    if not np.abs(np.tril(U, -1)).max() < 1e-3:
        raise AssertionError("gaussian: below-diagonal entries remain")
    oracle["gaussian"] = close("gaussian", A @ opencl.back_substitute(U, c),
                               bb, 0, 5e-2)
    src16 = (r.random((16, 16), np.float32) * 100.0).astype(np.float32)
    m9 = r.standard_normal(9).astype(np.float32)
    ref = np.zeros((16, 16), np.float32)
    for yy in range(1, 15):
        for xx in range(1, 15):
            acc = np.float32(0)
            for k, (dy, dx) in enumerate(opencl._TAPS):
                acc = np.float32(acc + np.float32(src16[yy + dy, xx + dx]
                                                  * m9[k]))
            ref[yy, xx] = acc
    oracle["sfilter"] = close("sfilter", opencl.sfilter(
        cuda(src16), cuda(m9)).cpu(), ref, 1e-5, 1e-4)
    A32 = r.standard_normal((32, 32)).astype(np.float32)
    B32 = r.standard_normal((32, 32)).astype(np.float32)
    oracle["sgemm3"] = close("sgemm3", opencl.sgemm3(cuda(A32),
                                                     cuda(B32)).cpu(),
                             A32.astype(np.float64) @ B32, 1e-5, 1e-5)

    # LBM: the JAX test's lattice against the per-cell oracle, three steps
    small = lbm.LBMConfig(16, 8, 8)
    grid = lbm.init_ldc(small)
    step = lbm.make_step(small, device=dev)
    g, want = cuda(grid), grid
    for _ in range(3):
        g = step(g)
        want = lbm_oracle_step(lbm, small, want)
    oracle["lbm_16x8x8"] = close("lbm", g.cpu(), want, 2e-5, 1e-7)
    # and at full size: one step against the same code on the host's CPU,
    # then ten steps finite with FLAGS and margins untouched
    cfg = lbm.LBMConfig(*LBM_FULL)
    grid = lbm.init_ldc(cfg)
    one = lbm.make_step(cfg, device=dev)(cuda(grid)).cpu().numpy()
    oracle["lbm_full_step_vs_cpu"] = close(
        "lbm full step", one, lbm.make_step(cfg, device="cpu")(
            torch.from_numpy(grid)).numpy(), 2e-5, 1e-7)
    out = lbm.run(cfg, steps=10, grid=grid, device=dev)
    _, _, flags_idx = lbm.make_indices(cfg)
    bits, gbits = out.view(np.uint32), grid.view(np.uint32)
    if not (np.isfinite(out).all()
            and np.array_equal(bits[flags_idx], gbits[flags_idx])
            and np.array_equal(bits[:cfg.margin], gbits[:cfg.margin])
            and np.array_equal(bits[-cfg.margin:], gbits[-cfg.margin:])):
        raise AssertionError("lbm full: not finite, or FLAGS / margins moved")
    vel = lbm.velocity_field(cfg, out)
    if not (np.isfinite(vel).all() and np.abs(vel).max() > 1e-4):
        raise AssertionError("lbm full: no flow")

    # om and tex at the JAX tests' sizes and at 1024x1024, against closed
    # forms: the whitebox is white, a blended band is Div255(0xFF a + 0x80)
    # over the black clear, point sampling 1:1 returns the texels, and the
    # two-stage app is the Div255 product of two one-stage runs
    for size in (64, APPS_TEX):
        fb = om_app.run(size, size, device=dev)
        if not (fb == 0xFFFFFFFF).all():
            raise AssertionError(f"om whitebox {size}")
        tasks = 16 if size == 64 else 64
        fb = om_app.run(size, size, blend_enable=True, num_tasks=tasks,
                        device=dev)
        tile_h = size // tasks
        alpha_step = np.float32(255.0) / np.float32(tile_h)
        for task in range(tasks):
            al = int(np.float32(task) * alpha_step) & 0xFF
            e = 0xFF * al + 0x80
            e = (e + (e >> 8)) >> 8
            band = fb[task * tile_h:(task + 1) * tile_h]
            if not ((band >> 16) & 0xFF == e).all():
                raise AssertionError(f"om blend band {task} at {size}")
        rgba = r.integers(0, 256, size=(size, size, 4)).astype(np.uint8)
        texels = convert.rgba_to_texels(rgba, 0)
        for g in (0, 1):
            got = tex_app.run(rgba, filter_g=g, device=dev)
            if not np.array_equal(got, texels):
                raise AssertionError(f"tex g{g} at {size}: not the texels")
        rgba1 = r.integers(0, 256, size=(size, size, 4)).astype(np.uint8)
        prod = (np.stack([(texels.astype(np.uint64) >> s) & 0xFF
                          for s in (24, 16, 8, 0)], -1)
                * np.stack([(convert.rgba_to_texels(rgba1, 0).astype(
                    np.uint64) >> s) & 0xFF for s in (24, 16, 8, 0)], -1)
                + 0x80)
        ch = (prod + (prod >> 8)) >> 8
        want = ((ch[..., 0] << 24) | (ch[..., 1] << 16) | (ch[..., 2] << 8)
                | ch[..., 3]).astype(np.uint32)
        if not np.array_equal(tex_app.run_multitex(rgba, rgba1, device=dev),
                              want):
            raise AssertionError(f"run_multitex at {size}")
    # every format and filter at 64x64 on the card == the CPU run (held to
    # the JAX package bit for bit by tests/test_torch_apps_units.py)
    rgba = r.integers(0, 256, size=(64, 64, 4)).astype(np.uint8)
    for fmt in range(7):
        for g in range(3):
            s = 0.5 if g == 2 else 1.0
            if not np.array_equal(
                    tex_app.run(rgba, fmt=fmt, filter_g=g, scale=s,
                                device=dev),
                    tex_app.run(rgba, fmt=fmt, filter_g=g, scale=s,
                                device="cpu")):
                raise AssertionError(f"tex fmt {fmt} g{g}: card != CPU")
    launches = cuda_sgemm.launch_count
    if launches != 2:
        raise AssertionError(f"sgemm kernel launches {launches}, expected 2")
    phase("apps_on_card", launches={"apps_sgemm": launches},
          max_abs_diff=oracle, bfs=bfs_runs, lbm_full=list(LBM_FULL),
          blackscholes_options=BS_OPTIONS, om_tex_size=APPS_TEX,
          tex_formats_filters=21, equal=True)

    # 28. timing (printed, not judged)
    ga, gb = gemm_inputs(APPS_GEMM, APPS_GEMM, APPS_GEMM, seed=9)
    n3 = APPS_GEMM
    k_ms = median_ms(lambda: cuda_sgemm.sgemm(ga, gb))
    lib_ms = median_ms(lambda: torch.matmul(ga, gb))
    # the plain version emulates fmaf in float64, about 15 operations on
    # (4096, 4096) tensors a step: one call, no warm-up (phase 26 ran it)
    p_ms = median_ms(lambda: cuda_sgemm.sgemm_reference(ga, gb), reps=1,
                     warmup=0)
    gemm_bound = bound(nbytes(ga, gb) + 4 * n3 * n3, 2 * n3 ** 3)
    timing = {"sgemm_4096": {
        "kernel_ms": k_ms, "plain_ms": p_ms, "matmul_ms": lib_ms,
        "kernel_tflops": 2 * n3 ** 3 / k_ms / 1e9,
        "matmul_tflops": 2 * n3 ** 3 / lib_ms / 1e9,
        "of_bound": gemm_bound["bound_ms"] / k_ms, **gemm_bound}}
    gl = cuda(lbm.init_ldc(cfg))
    lstep = lbm.make_step(cfg, device=dev)
    lbm_ms = median_ms(lambda: lstep(gl))
    cells = cfg.size_x * cfg.size_y * cfg.size_z
    timing["lbm_step"] = {"cells": cells, "ms": lbm_ms,
                          "mcells_per_s": cells / lbm_ms / 1e3,
                          "grid_mb": gl.numel() * 4 / 1e6}
    S, X, T = bs["blackscholes_4M"]
    timing["blackscholes_4M_ms"] = median_ms(
        lambda: opencl.blackscholes(S, X, T, 0.02, 0.30))
    trace = cgltrace.load_trace(cgltrace.trace_path("synth_draw3d"))
    host = {}
    for size in (SIZE, 1024):
        for engine, fn in (("native", binning.bin_drawcall),
                           ("numpy", binning.bin_drawcall_py)):
            per_draw = []
            for dc in trace.drawcalls:
                ts = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    fn(dc.pos, dc.indices, dc.color, dc.texcoord, size, size,
                       dc.near, dc.far, 5)
                    ts.append((time.perf_counter() - t0) * 1e3)
                per_draw.append(float(np.median(ts)))
            host[f"{engine}_{size}"] = {"ms_a_draw": per_draw,
                                        "ms_a_frame": sum(per_draw)}
    timing["host_binning"] = host
    phase("apps_timing", card=card, reps=REPS, **timing)

    t = timing["sgemm_4096"]
    return [{
        "name": "apps_sgemm", "route": "cuda",
        "source": "skybox_rt_tpu_torch/csrc/apps_sgemm.cu",
        "replaces": "skybox_rt_tpu/apps/compute.py:56",
        "launches": launches, "max_abs_err": err, "ms": t["kernel_ms"],
        "plain_ms": t["plain_ms"], **gemm_bound,
        "library_ms": t["matmul_ms"],   # torch.matmul, float32 (no TF32)
        "shape": f"{n3} x {n3} x {n3}"}]


#: per stage of bench_torch.py, the kernels (its ``launches`` keys) that the
#: stage must have launched on the card
BENCH_KERNELS = {
    "headline_device": ("raster_visibility",),
    "headline": ("raster_visibility",),
    "draw1024": ("raster_visibility",),
    "fwd_bwd": ("diff_visibility", "diff_accumulate"),
    "fwd_bwd_1024": ("diff_visibility", "diff_accumulate"),
    "fwd_bwd_soft": ("diff_accumulate",),
    "fwd_bwd_alpha": ("diff_accumulate",),
    "rt_northstar": ("rt_closest_hit_bvh", "rt_any_hit_bvh"),
    "rt_config3": ("rt_closest_hit_bvh", "rt_closest_hit_bvh_after"),
}


def _numbers(value, path=""):
    """(path, number) of every number in a stage's JSON, nested ones too."""
    if isinstance(value, bool) or value is None or isinstance(value, str):
        return []
    if isinstance(value, (int, float)):
        return [(path, value)]
    if isinstance(value, dict):
        return [x for k, v in value.items() for x in _numbers(v, f"{path}.{k}")]
    return [x for i, v in enumerate(value) for x in _numbers(v, f"{path}[{i}]")]


def bench_phase(dev, card) -> None:
    """Phase 29: every stage function of bench_torch.py once, in this
    process, on the card, at full size with the fewest repeats."""
    import bench_torch

    for name in ("REPS", "DEVICE_REPS", "DRAW1024_REPS", "FWD_BWD_REPS",
                 "RT_REPS", "CONFIG3_REPS"):
        setattr(bench_torch, name, 1)
    want = bench_torch.expected_launches(dev)
    stages, seconds = {}, {}
    for name, (fn, _) in bench_torch.STAGES.items():
        t0 = time.perf_counter()
        stages[name] = out = fn(dev)
        seconds[name] = time.perf_counter() - t0
        for key, x in _numbers(out):
            # roofline percentages, rates and times are all positive; a
            # device busy time of 0 would mean the profiler saw no kernel
            if not (math.isfinite(x) and x > 0):
                raise AssertionError(f"bench stage {name}: {key} = {x}")
        if any(k.endswith(("_device_busy_ms", "_device_kernels"))
               and v is None for k, v in out.items()):
            raise AssertionError(f"bench stage {name}: no device busy time")
        launched = next((v for k, v in out.items()
                         if k.endswith("_launches")), {})
        for kernel in BENCH_KERNELS.get(name, ()):
            if not launched.get(kernel):
                raise AssertionError(f"bench stage {name} launched no "
                                     f"{kernel}: {launched}")
        for kernel, n in want.get(name, {}).items():
            if launched.get(kernel) != n:
                raise AssertionError(f"bench stage {name}: {kernel} launched "
                                     f"{launched.get(kernel)} times, not {n}")
    if not stages["headline_device"]["loop_frame_equal_to_compile_frame"]:
        raise AssertionError("the frame loop's frame != compile_frame's")
    phase("bench_stages", card=card, seconds=seconds,
          want_launches=want, **stages)


def cli_phase(dev, card, golden) -> None:
    """Phase 30: the command line on the card (its default device)."""
    import contextlib
    import io
    import tempfile

    from skybox_rt_tpu_torch import cli
    from skybox_rt_tpu_torch.diff import cuda_texgrad
    from skybox_rt_tpu_torch.ops import cuda_raster, cuda_rt
    from skybox_rt_tpu_torch.utils import image

    def run(*argv):
        cuda_raster.reset_launch_count()
        cuda_rt.reset_launch_counts()
        cuda_texgrad.reset_launch_count()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(list(argv))
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"cli {argv}: exit {rc}\n{out.getvalue()}")
        return out.getvalue().splitlines(), time.perf_counter() - t0

    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "render.png")
        lines, sec = run("render", "-t", "synth_draw3d", "-w", str(SIZE),
                         "-H", str(SIZE), "--mode", "pallas", "--perf",
                         "-o", png)
        launches = cuda_raster.launch_count
        decoded = image.read_png_rgba(png)       # zlib, no PIL
        if not np.array_equal(decoded, image.framebuffer_to_rgba(golden)):
            raise AssertionError("cli render's PNG != the JAX golden")
        row = next(ln for ln in lines if ln.startswith("frame[pallas]"))
        if launches == 0 or not any(ln.startswith("PERF: ") for ln in lines):
            raise AssertionError(f"cli render: {launches} launches, "
                                 f"{lines}")
        got["render"] = {"seconds": sec, "lines": lines[:2],
                         "roofline_row": row, "raster_visibility": launches,
                         "png_equal_to_jax_golden": True}

        lines, sec = run("info")
        info = json.loads(lines[-1])
        if info["platform"] != "gpu" or \
                info["device_kind"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"cli info: {info}")
        got["info"] = info

        images = {}
        for engine, kernels in (
                ("pallas", ("closest_hit_clustered", "any_hit_clustered")),
                ("pallas_worklist", ("closest_hit_worklist",
                                     "active_block_lists"))):
            out_png = os.path.join(tmp, f"rt_{engine}.png")
            lines, sec = run("rt", "-w", str(SIZE), "-H", str(SIZE),
                             "--engine", engine, "-o", out_png)
            counts = dict(cuda_rt.launch_counts)
            images[engine] = image.read_png_rgba(out_png)
            if images[engine].shape != (SIZE, SIZE, 4) or \
                    not all(counts.get(k) for k in kernels):
                raise AssertionError(f"cli rt {engine}: {counts}")
            got[f"rt_{engine}"] = {"seconds": sec, "line": lines[0],
                                   "launches": counts}
        if not np.array_equal(images["pallas"], images["pallas_worklist"]):
            raise AssertionError("cli rt: the engines' images differ")

        lines, sec = run("fit", "-w", "64", "--steps", "20", "-o",
                         os.path.join(tmp, "fit"))
        fit = json.loads(lines[-1])
        if not (fit["loss_last"] < fit["loss_first"]) or fit["bad_steps"] \
                or cuda_texgrad.launch_count == 0:
            raise AssertionError(f"cli fit: {fit}, "
                                 f"{cuda_texgrad.launch_count} launches")
        got["fit"] = {"seconds": sec, "loss_first": fit["loss_first"],
                      "loss_last": fit["loss_last"],
                      "diff_accumulate": cuda_texgrad.launch_count}
    phase("cli_on_card", card=card, **got)


PARALLEL_STEPS = 3      # sharded training steps at 1024x1024
PARALLEL_LR = 1e-7


def gloo_raster_rank(size):
    """One rank of a world of 2 on the one card, its collectives carried by
    gloo (NCCL takes one rank a card): the sharded 256x256 frame and the
    rank's launches of kernel #1."""
    from skybox_rt_tpu_torch.geom import cgltrace
    from skybox_rt_tpu_torch.ops import cuda_raster
    from skybox_rt_tpu_torch.parallel import draw_shard
    from skybox_rt_tpu_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.make_mesh(2, device="cuda")
    trace = cgltrace.load_trace(cgltrace.trace_path("synth_draw3d"))
    cuda_raster.reset_launch_count()
    fb = draw_shard.render_trace_sharded(trace, size, size, mesh)
    return fb, cuda_raster.launch_count, str(mesh)


def parallel_phase(dev, card, raster, northstar, small) -> dict:
    """Phase 31: the sharded paths of parallel/ in a world of one rank over
    NCCL, formed here by make_mesh and destroyed at the end of the phase;
    the raster frame also in a world of two spawned ranks on the card
    through gloo.  Returns {kernel entry name: launches on the sharded
    paths}."""
    import dataclasses

    import torch.distributed as dist

    from skybox_rt_tpu_torch.diff import check, cuda_texgrad, cuda_vis
    from skybox_rt_tpu_torch.diff import pipeline
    from skybox_rt_tpu_torch.geom import cgltrace
    from skybox_rt_tpu_torch.ops import cuda_raster, cuda_rt
    from skybox_rt_tpu_torch.parallel import draw_shard, overlap, ray_shard
    from skybox_rt_tpu_torch.parallel import mesh as mesh_mod
    from skybox_rt_tpu_torch.parallel import scaling, tile_shard
    from skybox_rt_tpu_torch.ref import driver
    from skybox_rt_tpu_torch.rt import tracer, wavefront

    def reset():
        cuda_raster.reset_launch_count()
        cuda_rt.reset_launch_counts()
        cuda_vis.reset_launch_count()
        cuda_texgrad.reset_launch_count()
        overlap.reset_collective_counts()

    if dist.is_initialized():
        raise AssertionError("a process group exists before phase 31")
    mesh = mesh_mod.make_mesh()
    if dist.get_backend() != "nccl" or mesh.size() != 1:
        raise AssertionError(f"mesh {mesh} over {dist.get_backend()}")
    out, launched = {"mesh": str(mesh), "backend": dist.get_backend(),
                     "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                     "card": card}, {}
    try:
        # a. the tile-striped raster frame (kernel #1): a fresh trace's
        # first frame measures the blend K as phase 4's first frame did
        trace = cgltrace.load_trace(raster["trace_file"])
        reset()
        fb = draw_shard.render_trace_sharded(trace, SIZE, SIZE, mesh)
        first = cuda_raster.launch_count
        collectives = dict(overlap.collective_counts)
        reset()
        cached = draw_shard.render_trace_sharded(trace, SIZE, SIZE, mesh)
        cached_launches = cuda_raster.launch_count
        for name, img in (("first", fb), ("cached", cached)):
            for ref_name, ref in (("JAX golden", raster["golden"]),
                                  ("compile_frame",
                                   raster["compile_frame"])):
                if not np.array_equal(img, ref):
                    raise AssertionError(
                        f"sharded {name} frame != {ref_name}: "
                        f"{int((img != ref).sum())} pixels differ")
        if first != raster["launches"] or cached_launches != raster["draws"]:
            raise AssertionError(
                f"sharded frames launched #1 {first} / {cached_launches} "
                f"times, unsharded {raster['launches']} / {raster['draws']}")
        if collectives != {"all_reduce": 4 * first}:
            raise AssertionError(f"sharded frame collectives {collectives}")
        launched["raster_visibility"] = first

        def sharded_frame():
            return draw_shard.render_trace_sharded(trace, SIZE, SIZE, mesh)

        def unsharded_frame():
            return driver.render_trace(trace, SIZE, SIZE, mode="deferred",
                                       device=dev)

        out["raster_256"] = {
            "equal_to_jax_golden": True, "equal_to_compile_frame": True,
            "launches": first, "cached_launches": cached_launches,
            "collectives": collectives,
            **paired_ms(sharded_frame, unsharded_frame, reps=10)}

        # b. the training step at 1024x1024 (kernels #4 and #5), against the
        # port's unsharded SGD step on the same parameters
        params_np, static_np, cfg = check.train_scene(DIFF_SIZE)
        true, static = check.to_device(params_np, static_np, dev,
                                       requires_grad=False)
        with torch.no_grad():
            target = pipeline.render_deferred(true, static, cfg)[0]
        target = target[:cfg.height, :cfg.width].contiguous()
        start = dict(true, color=true["color"] * 0.5)
        sharded_np = tile_shard.shard_tiles(static_np, 1)
        arrays = {k: torch.as_tensor(v, device=dev)
                  for k, v in sharded_np.items()}
        target_tiles = torch.as_tensor(tile_shard.gather_target_tiles(
            target.cpu().numpy(), sharded_np["tile_xy"], cfg.tile_logsize),
            device=dev)
        step = tile_shard.make_train_step(mesh, cfg, lr=PARALLEL_LR,
                                          grad_buckets=3)

        def unsharded_step(p):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
            img = pipeline.render_deferred(leaves, static, cfg)[0]
            loss = torch.sum((img[:cfg.height, :cfg.width] - target) ** 2)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            return ({k: v.detach() - PARALLEL_LR * g
                     for (k, v), g in zip(leaves.items(), grads)},
                    loss.detach())

        reset()
        p, losses = start, []
        for _ in range(PARALLEL_STEPS):
            p, loss, maxw = step(p, arrays, target_tiles)
            losses.append(loss)
        torch.cuda.synchronize()
        counts = (cuda_vis.launch_count, cuda_texgrad.launch_count)
        collectives = dict(overlap.collective_counts)
        if counts != (PARALLEL_STEPS, 5 * PARALLEL_STEPS):
            raise AssertionError(f"sharded steps launched #4, #5 {counts}")
        # three gradient buckets, the loss and max_writes a step
        if collectives != {"all_reduce": 5 * PARALLEL_STEPS}:
            raise AssertionError(f"sharded steps issued {collectives}")
        q, plain_losses = start, []
        for _ in range(PARALLEL_STEPS):
            q, loss = unsharded_step(q)
            plain_losses.append(loss)
        losses = [float(x) for x in losses]
        plain_losses = [float(x) for x in plain_losses]
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, plain_losses))
        if loss_rel > 1e-6 or not all(np.isfinite(losses)):
            raise AssertionError(f"sharded losses {losses}, unsharded "
                                 f"{plain_losses}")
        param_err = {}
        for k in q:
            a, b = p[k], q[k]
            if not torch.allclose(a, b, rtol=1e-5, atol=0):
                raise AssertionError(f"sharded {k} beyond rtol 1e-5 of the "
                                     f"unsharded step's")
            param_err[k] = float((a - b).abs().max())
        launched["diff_visibility"], launched["diff_accumulate"] = counts
        out["train_1024"] = {
            "steps": PARALLEL_STEPS, "tiles": int(arrays["tile_pids"].shape[0]),
            "losses": losses, "loss_max_rel_diff": loss_rel,
            "params_max_abs_diff": param_err, "max_writes": int(maxw),
            "launches": counts, "collectives": collectives,
            **paired_ms(lambda: step(start, arrays, target_tiles),
                        lambda: unsharded_step(start))}

        # c, d. the ray-sharded frames of the large (#2, #3) and the small
        # (#7, #8) scene at 1024x1024, scenes and blocks built once
        for label, built, engine, names in (
                ("northstar_1024", northstar, "pallas_bvh",
                 ("closest_hit_bvh", "any_hit_bvh")),
                ("small_1024", small, "pallas",
                 ("closest_hit_clustered", "any_hit_clustered"))):
            scene, cam = built["scene"], built["cam"]
            cfg_rt = dataclasses.replace(built["cfg"], engine=engine)
            if tracer.resolve_engine(cfg_rt, scene.faces.shape[0]) != \
                    engine:
                raise AssertionError(f"{label} does not take {engine}")
            intersectors = tracer.make_intersectors(scene, cfg_rt, dev)
            want = built["frame"](*built["rays"])
            reset()
            img = ray_shard.render_sharded(scene, cam, cfg_rt, mesh,
                                           intersectors)
            torch.cuda.synchronize()
            counts = tuple(cuda_rt.launch_counts[n] for n in names)
            collectives = dict(overlap.collective_counts)
            if counts != (3, 3) or cuda_rt.launch_counts["shade_hits"] != 3 \
                    or sum(cuda_rt.launch_counts.values()) != 9:
                raise AssertionError(f"{label} launched "
                                     f"{dict(cuda_rt.launch_counts)}")
            if collectives != {"all_gather": 1}:
                raise AssertionError(f"{label} issued {collectives}")
            diff = float((img - want).abs().max())
            if tuple(img.shape) != (RT_SIZE, RT_SIZE, 4) or not diff <= 1e-6:
                raise AssertionError(f"{label}: {tuple(img.shape)}, max "
                                     f"|diff| {diff} from make_frame_fn's")
            for n, c in zip(names, counts):
                launched["rt_" + n] = c
            # the host work render_sharded repeats a call that make_frame_fn
            # does once (its intersectors are passed in), host clock
            host_ms = {name: timed(fn)[1] * 1e3 for name, fn in (
                ("scene_shade_arrays",
                 lambda: tracer.scene_shade_arrays(scene, cfg_rt, dev)),
                ("camera_rays",
                 lambda: tracer.camera_rays(cam, RT_SIZE, RT_SIZE, dev)),
                ("tile_order_perm",
                 lambda: wavefront.tile_order_perm(RT_SIZE, RT_SIZE, 32)))}
            out[label] = {
                "engine": engine, "launches": counts, "host_ms": host_ms,
                "collectives": collectives, "max_abs_diff": diff,
                **paired_ms(lambda: ray_shard.render_sharded(
                    scene, cam, cfg_rt, mesh, intersectors),
                    lambda: built["frame"](*built["rays"]))}
    finally:
        dist.destroy_process_group()

    # e. the scaling sweep: a spawned world of each size up to the host's
    # card count (one here)
    t0 = time.perf_counter()
    out["scaling"] = {str(n): r for n, r in scaling.measure().items()}
    out["scaling"]["seconds"] = time.perf_counter() - t0

    # f. the raster frame in a world of two ranks on the one card, gloo
    # carrying the CUDA tensors' collectives
    t0 = time.perf_counter()
    fb2, launches2, mesh2 = mesh_mod.spawn(gloo_raster_rank, 2, SIZE,
                                           backend="gloo")
    if not np.array_equal(fb2, raster["golden"]):
        raise AssertionError(f"2-rank gloo frame != JAX golden: "
                             f"{int((fb2 != raster['golden']).sum())} pixels")
    if launches2 != raster["launches"]:
        raise AssertionError(f"a gloo rank launched #1 {launches2} times")
    out["raster_256_gloo_2_ranks"] = {
        "mesh": mesh2, "equal_to_jax_golden": True,
        "rank0_launches": launches2,
        "seconds": time.perf_counter() - t0}
    phase("parallel", **out)
    return launched


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
    from skybox_rt_tpu_torch.geom import native
    t0 = time.perf_counter()
    native_lib = native.build()
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    with open(lib_path + ".log") as f:
        log = f.read().splitlines()
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          native_binning=os.path.relpath(native_lib, REPO),
          native_seconds=round(native_s, 3),
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
    err, cases, states = 0, 0, {}
    for d in range(4):
        for tls in cuda_raster.TILE_LOGSIZES:
            rs, args, b = draw_inputs(SIZE, SIZE, tls, d)
            states[d] = rs
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
    # edge values that wrap (seeded random coefficients), at every tile
    # size, under the depth test and the stencil draw's OM, with a scissor
    # that leaves some patches of the corner tiles outside and cuts others
    wrapping = 0
    for tls in cuda_raster.TILE_LOGSIZES:
        args = cuda_raster.wrapping_case(tls, seed=tls, device=dev)
        for d in (0, 3):
            rs0 = states[d]
            rs = RenderState(flags=rs0.flags, om=rs0.om, tex=rs0.tex,
                             scissor=cuda_raster.WRAP_SCISSOR)
            for K in (0, 4):
                err = max(err, compare(rs, args, tls, K))
                cases += 1
                wrapping += 1
    phase("kernel_vs_plain", cases=cases, wrapping_cases=wrapping,
          max_abs_err=err, equal=True)

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
        def pass1():
            return cuda_raster.visibility_tiles(rs, *args, tls, fused=True)
        k_ms = median_ms(pass1)
        p_ms = median_ms(lambda: cuda_raster.visibility_tiles_reference(
            rs, *args, tls, fused=True), reps=5, warmup=1)
        T, M = b.tile_pids.shape
        # each input read once, each of the four fused outputs written once.
        # The warps' work: a cull test for every (patch, real prim) of a
        # patch inside the scissor, one prim step a pixel for every prim the
        # cull keeps (counted by the plain predicate), and the covered
        # pixels' extra work for every step the plain version's coverage
        # mask holds; ``all_steps_ops`` is the same without the cull (every
        # pixel steps through every real prim of its tile)
        steps, cull_tests, all_steps = cuda_raster.cull_counts(
            args[0], args[2], args[3], tls, rs.scissor)
        covered = int(sum(cov.sum() for _, cov, *_ in cuda_raster.prim_steps(
            rs, *args, tls, need_grad=False)))
        covered_ops = covered * (RASTER_COVERED_FLOAT_OPS
                                 + RASTER_COVERED_INT_OPS)
        patches = (1 << 2 * tls) // (cuda_raster.PATCH_W
                                     * cuda_raster.PATCH_H)
        timings[label] = {"kernel_ms": k_ms, "graph_ms": graph_ms(pass1),
                          "plain_ms": p_ms, "T": T, "M": M,
                          "blocks": T * patches // min(
                              patches, cuda_raster.PATCH_WARPS),
                          "pixels": T << (2 * tls),
                          "kernel_mpix_per_s": (T << (2 * tls)) / k_ms / 1e3,
                          "steps": steps, "all_steps": all_steps,
                          "steps_kept": steps / all_steps,
                          "cull_tests": cull_tests, "covered_steps": covered,
                          "all_steps_ops": all_steps * RASTER_STEP_INT_OPS
                          + covered_ops,
                          "bound": bound(
                              nbytes(*args) + 4 * nbytes(args[4]),
                              covered * RASTER_COVERED_FLOAT_OPS,
                              steps * RASTER_STEP_INT_OPS
                              + cull_tests * RASTER_CULL_INT_OPS
                              + covered * RASTER_COVERED_INT_OPS)}
    frame_ms = median_ms(lambda: frame(arrays))
    timings["frame_256"] = {
        "ms": frame_ms, "draws": draws,
        "mpix_per_s": SIZE * SIZE * draws / frame_ms / 1e3}
    phase("timing", card=card, reps=REPS, **timings)

    large_entries, northstar = rt_phases(dev, card)
    small_entries, small = small_phases(dev, card)
    shade_entry = shade_phase(dev, card, northstar["scene"], small["scene"])
    rt_entries = (large_entries + small_entries + [shade_entry]
                  + diff_phases(dev, card) + [diff_shade_phase(dev, card),
                                              diff_prim_phase(dev, card)])
    config3_entries, flat_bounce = config3_phases(dev, card)
    next(e for e in rt_entries if e["name"] == "rt_closest_hit_flat")[
        "bounce1_sample"] = flat_bounce
    rt_entries = (rt_entries + config3_entries
                  + apps_phases(dev, card))
    bench_phase(dev, card)
    cli_phase(dev, card, golden)
    sharded = parallel_phase(dev, card, {
        "trace_file": trace_file, "golden": golden, "compile_frame": framed,
        "launches": launches, "draws": draws}, northstar, small)

    phase("total", seconds=time.perf_counter() - T0)
    print(card)
    p256 = timings["pass1_256"]
    entries = [{
        "name": "raster_visibility", "route": "cuda",
        "source": "skybox_rt_tpu_torch/csrc/raster_visibility.cu",
        "replaces": "skybox_rt_tpu/ops/pallas_raster.py:63",
        "launches": launches, "max_abs_err": err,
        "ms": p256["kernel_ms"], "graph_ms": p256["graph_ms"],
        "plain_ms": p256["plain_ms"], **p256["bound"],
        "library_ms": None,     # no single PyTorch call computes this
        }] + rt_entries
    for entry in entries:
        if entry["name"] in sharded:
            entry["sharded_launches"] = sharded[entry["name"]]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
