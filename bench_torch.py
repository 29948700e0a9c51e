"""Benchmark of the PyTorch / CUDA port (skybox_rt_tpu_torch) on one card.

The stages of the JAX package's bench.py, run on the port's committed scenes
(the reference traces are absent), each metric named after the scene it
runs:

  window_probe      50 launches of x + 1 on an (8, 128) tensor, and one
                    synchronize round trip
  headline_device   ref.driver.compile_frame_loop on synth_draw3d at 256x256,
                    mode "pallas" (kernel #1): two loop lengths, the frame
                    time their difference quotient; afterwards the sentinel
                    never rendered and the loop's frame equals
                    compile_frame's bit for bit.  The line's ``value``
  headline          compile_frame dispatch runs, roofline from the measured
                    unit traffic (FrameStats(measure_traffic=True))
  draw1024          synth_draw3d's textured draw (d1) alone at 1024x1024,
                    a two-length loop through kernel #1
  fwd_bwd[_1024]    the training step of diff/pipeline (icosphere subdiv 4,
                    hard mode, kernels #4 and #5), SGD steps at two loop
                    lengths, at 512x512 and 1024x1024
  slots_*, fwd_bwd_soft, fwd_bwd_alpha
                    the same in soft and alpha mode at 512x512; the slot
                    count is probed in a process of its own and passed on in
                    SKYBOX_BENCH_SLOTS
  rt_northstar      the 184,832-triangle sphere field at 1024x1024, 2
                    bounces, shadows (kernels #2 and #3)
  rt_config3        rt.frame on the committed synth_config3 trace at 512x512
                    (kernels #2 and #6); the timed frames overflow no K slot

    python3 bench_torch.py                   # every stage, one JSON line
    python3 bench_torch.py --stage headline  # one stage's JSON

Every timed region ends in a synchronize.  Each timed stage also gives
``<key>_device_busy_ms``: the union of its device kernels' intervals over one
frame or step under torch.profiler, which host-bound spread does not move,
with ``<key>_device_kernels``, their count (both None on the CPU), and
``<stage>_launches``, the port's kernel launches counted by their wrappers
over the stage's runs, its set-up not counted.  Each stage runs in a process
of its own; a stage that fails (or a failed nvidia-smi) leaves
``<stage>_error`` (``device_error``) in ``extra`` and the script exits 1.  A stage runs its one mode on the card: nothing falls back
to another mode or to the CPU.  The stage functions take ``device`` (None:
the CUDA card); sizes, loop lengths and repeats are the module constants
below.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from skybox_rt_tpu_torch.core.device import resolve_device, synchronize

SCENE = "synth_draw3d"
SIZE = 256
TILE_LOGSIZE = 5           # the raster stages' 32x32 binning tiles
FRAMES = 20
REPS = 9
# A 256x256 frame takes some 50-120 ms on the card (launch-bound, PERF.md
# section 5), so the two loops of a repeat take seconds.
DEVICE_LOOP_N1 = 10
DEVICE_LOOP_N2 = 50
DEVICE_REPS = 5
DRAW1024_SIZE = 1024
TEXTURED_DRAW = 1          # synth_draw3d's d1, the textured sphere
DRAW1024_N1 = 6
DRAW1024_N2 = 30
DRAW1024_REPS = 3
FWD_BWD_SIZE = 512
FWD_BWD_LARGE = 1024
FWD_BWD_N1 = 5
FWD_BWD_N2 = 15
FWD_BWD_REPS = 3
RT_SIZE = 1024
RT_BOUNCES = 2
RT_REPS = 3
CONFIG3_SIZE = 512
CONFIG3_REPS = 5


def _reset_launches() -> None:
    from skybox_rt_tpu_torch.diff import cuda_texgrad, cuda_vis
    from skybox_rt_tpu_torch.ops import cuda_raster, cuda_rt
    cuda_raster.reset_launch_count()
    cuda_rt.reset_launch_counts()
    cuda_vis.reset_launch_count()
    cuda_texgrad.reset_launch_count()


def _launches() -> dict:
    """The port's kernel launches since _reset_launches, by kernel (the
    wrappers count a launch for CUDA tensors only)."""
    from skybox_rt_tpu_torch.diff import cuda_texgrad, cuda_vis
    from skybox_rt_tpu_torch.ops import cuda_raster, cuda_rt
    out = {"raster_visibility": cuda_raster.launch_count,
           "diff_visibility": cuda_vis.launch_count,
           "diff_accumulate": cuda_texgrad.launch_count,
           **{f"rt_{k}": v for k, v in cuda_rt.launch_counts.items()}}
    return {k: v for k, v in out.items() if v}


def expected_launches(device=None) -> dict:
    """The kernel launches that the raster and hard training stages'
    ``<stage>_launches`` must count on the card, from the constants above:
    draws x frames run, and 1 + 5 a training step."""
    from skybox_rt_tpu_torch.ref import driver

    draws = len(driver.prepare_drawcalls(_trace(), SIZE, SIZE, TILE_LOGSIZE,
                                         device))
    steps = (FWD_BWD_N1 + FWD_BWD_N2) * (1 + FWD_BWD_REPS)
    hard = {"diff_visibility": steps, "diff_accumulate": 5 * steps}
    return {
        "headline_device": {"raster_visibility": draws * (
            DEVICE_LOOP_N1 + DEVICE_LOOP_N2) * (1 + DEVICE_REPS)},
        "headline": {"raster_visibility": draws * (1 + REPS * FRAMES)},
        "draw1024": {"raster_visibility": (
            DRAW1024_N1 + DRAW1024_N2) * (1 + DRAW1024_REPS)},
        "fwd_bwd": hard, "fwd_bwd_1024": hard,
    }


def _busy(key, run, device, per=1) -> dict:
    """``<key>_device_busy_ms``: the milliseconds of one ``run()`` of
    ``per`` frames or steps during which at least one device kernel ran
    (the union of the kernels' intervals under torch.profiler, after a
    first profiled run that pays the tracer's start-up), and
    ``<key>_device_kernels``, their count, both for one frame or step.
    None on the CPU."""
    keys = (f"{key}_device_busy_ms", f"{key}_device_kernels")
    if device.type != "cuda":
        return dict.fromkeys(keys)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize(device)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return dict(zip(keys, (busy / 1e3 / per, len(spans) / per)))


def _roofline_summary(r) -> dict:
    return {"bound_by": r["bound_by"],
            "pct_of_roofline": r["pct_of_roofline"],
            "achieved_gb_per_s": r["achieved_gb_per_s"]}


def _trace(name=SCENE):
    from skybox_rt_tpu_torch.geom import cgltrace
    return cgltrace.load_trace(cgltrace.trace_path(name))


def _stage_window_probe(device=None):
    """Launch latency of a tiny op, and one synchronize round trip."""
    device = resolve_device(device)

    def f(x):
        return x + 1

    y = f(torch.zeros((8, 128), dtype=torch.float32, device=device))
    synchronize(device)
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        y = f(y)
    synchronize(device)
    dispatch_ms = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    y = f(y)
    synchronize(device)
    rtt_ms = (time.perf_counter() - t0) * 1e3
    return {"window_probe_ms": dispatch_ms, "window_rtt_ms": rtt_ms,
            **_busy("window_probe", lambda: f(y), device)}


def _stage_headline_device(device=None):
    """The device-wall 256x256 frame rate: two frame loops (N1, N2 frames),
    each frame data-dependent on the one before through the sentinel count,
    the frame time their difference quotient.  Checks AFTER timing that the
    sentinel never rendered and the loops' final frames equal the
    compile_frame frame bit for bit."""
    from skybox_rt_tpu_torch.core import fixed
    from skybox_rt_tpu_torch.ref import driver

    device = resolve_device(device)
    mode = "pallas"
    trace = _trace()
    loop1, arrays = driver.compile_frame_loop(
        trace, SIZE, SIZE, DEVICE_LOOP_N1, TILE_LOGSIZE, mode, device)
    loop2, _ = driver.compile_frame_loop(
        trace, SIZE, SIZE, DEVICE_LOOP_N2, TILE_LOGSIZE, mode, device)
    # after the set-up, whose blend-slot frame launches kernel #1 too
    _reset_launches()
    fb1 = loop1(arrays)
    fb2 = loop2(arrays)
    synchronize(device)
    num_draws = len(arrays)

    rates, frame_ms = [], []
    for _ in range(DEVICE_REPS):
        t0 = time.perf_counter()
        loop1(arrays)
        synchronize(device)
        t1 = time.perf_counter()
        loop2(arrays)
        synchronize(device)
        t2 = time.perf_counter()
        dt = ((t2 - t1) - (t1 - t0)) / (DEVICE_LOOP_N2 - DEVICE_LOOP_N1)
        frame_ms.append(dt * 1e3)
        rates.append(SIZE * SIZE * num_draws / dt / 1e6)
    launches = _launches()
    busy = _busy("headline_device", lambda: loop1(arrays), device,
                 per=DEVICE_LOOP_N1)

    # verification, after every timed region: z was 0 in every frame
    frame, _ = driver.compile_frame(trace, SIZE, SIZE, TILE_LOGSIZE, mode,
                                    device)
    ref = fixed.to_numpy_u32(frame(arrays))
    if (ref == driver.FRAME_LOOP_SENTINEL).any():
        raise AssertionError("the sentinel color rendered: the loop's "
                             "carry is not provably zero")
    for n, fb in ((DEVICE_LOOP_N1, fb1), (DEVICE_LOOP_N2, fb2)):
        if not np.array_equal(fixed.to_numpy_u32(fb), ref):
            raise AssertionError(f"the {n}-frame loop's frame differs from "
                                 f"the compile_frame frame")
    return {"value": float(np.median(rates)), "device_runs": rates,
            "device_mode": mode, "device_loop_frames": [DEVICE_LOOP_N1,
                                                        DEVICE_LOOP_N2],
            "headline_device_frame_ms": float(np.median(frame_ms)),
            **busy,
            "headline_device_launches": launches,
            "loop_frame_equal_to_compile_frame": True}


def _stage_headline(device=None):
    """compile_frame dispatch: REPS runs of FRAMES frames, each run ending
    in a synchronize; the roofline of the median from the measured unit
    traffic of the same frame."""
    from skybox_rt_tpu_torch.ref import driver
    from skybox_rt_tpu_torch.runtime import perf as perf_mod

    device = resolve_device(device)
    mode = "pallas"
    trace = _trace()
    frame, arrays = driver.compile_frame(trace, SIZE, SIZE, TILE_LOGSIZE,
                                         mode, device)
    _reset_launches()
    frame(arrays)
    synchronize(device)
    num_draws = len(arrays)
    runs = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            frame(arrays)
        synchronize(device)
        elapsed = time.perf_counter() - t0
        runs.append(SIZE * SIZE * num_draws * FRAMES / elapsed / 1e6)
    launches = _launches()
    med = float(np.median(runs))
    busy = _busy("headline_dispatch", lambda: frame(arrays), device)
    stats = driver.FrameStats()
    driver.render_trace(trace, SIZE, SIZE, TILE_LOGSIZE, stats=stats,
                        mode=mode, measure_traffic=True, device=device)
    sec = SIZE * SIZE * num_draws / (med * 1e6)
    r = perf_mod.roofline_from_traffic(stats.traffic, seconds=sec)
    return {"headline_dispatch_mpix_s": med, "dispatch_mode": mode,
            "headline_runs": runs, "headline_best": max(runs),
            "headline_dispatch_frame_ms": sec * 1e3,
            **busy,
            "headline_launches": launches,
            "headline_roofline": _roofline_summary(r)}


def _stage_draw1024(device=None):
    """synth_draw3d's textured draw alone at 1024x1024: a loop of N draws,
    each drawn onto the one before's buffers with its inputs shifted by the
    sentinel count of that color buffer, at two lengths; the best of
    DRAW1024_REPS difference quotients."""
    from skybox_rt_tpu_torch.core import fixed
    from skybox_rt_tpu_torch.ops import deferred
    from skybox_rt_tpu_torch.ref import driver
    from skybox_rt_tpu_torch.runtime import perf as perf_mod

    device = resolve_device(device)
    W = H = DRAW1024_SIZE
    rs, texels, binned = driver.prepare_drawcalls(
        _trace(), W, H, TILE_LOGSIZE, device)[TEXTURED_DRAW]
    if not deferred.deferrable(rs):
        raise AssertionError("the timed draw must be opaque")
    dev_arrays = deferred.device_arrays(binned, device)
    tls = binned.tile_logsize
    fbc, fbd = driver.clear_framebuffers(W, H, tls, device)
    sentinel = fixed.s32(int(driver.FRAME_LOOP_SENTINEL))

    def loop(n):
        c, d = fbc, fbd
        for _ in range(n):
            z = (c == sentinel).sum(dtype=torch.int32)
            c, d, _ = deferred.render_arrays(
                rs, texels, driver.shift_arrays(dev_arrays, z), c, d, tls)
        return c

    _reset_launches()
    loop(DRAW1024_N1)
    loop(DRAW1024_N2)
    synchronize(device)
    best = float("inf")
    for _ in range(DRAW1024_REPS):
        t0 = time.perf_counter()
        loop(DRAW1024_N1)
        synchronize(device)
        t1 = time.perf_counter()
        loop(DRAW1024_N2)
        synchronize(device)
        t2 = time.perf_counter()
        best = min(best, ((t2 - t1) - (t1 - t0))
                   / (DRAW1024_N2 - DRAW1024_N1))
    launches = _launches()
    busy = _busy("draw1024", lambda: loop(1), device)
    counts = deferred.measure_drawcall_counts(rs, binned, fbd)
    traffic = perf_mod.drawcall_traffic(binned, rs, counts=counts)
    r = perf_mod.roofline_from_traffic(traffic, seconds=best)
    return {"draw1024_mpix_s": W * H / best / 1e6,
            "draw1024_ms": best * 1e3,
            **busy,
            "draw1024_launches": launches,
            "draw1024_roofline": _roofline_summary(r)}


def _fwd_bwd(device, mode="hard", probe_slots_only=False, size=None):
    """The training step of bench.py's _fwd_bwd (diff.check.train_scene:
    icosphere subdiv 4, textured, depth test, 32x32 tiles, the loss the sum
    of squares of the image): SGD steps p - 1e-6 g at two loop lengths,
    the best of FWD_BWD_REPS differences.  Returns (Mpix/s, step ms, a
    function that runs one step, launches, (params, static, cfg, slots))
    or, with probe_slots_only, the slot count alone."""
    from skybox_rt_tpu_torch.diff import check, pipeline

    size = size or FWD_BWD_SIZE
    params, static, cfg = check.train_scene(size, mode)
    params, static = check.to_device(params, static, device)
    if mode == "hard":
        slots = 8
    elif probe_slots_only:
        return pipeline.auto_slots(params, static, cfg)
    else:
        # auto_slots reads its count back; the probe runs in a process of
        # its own and main() passes its answer on
        slots = (int(os.environ.get("SKYBOX_BENCH_SLOTS", "0"))
                 or pipeline.auto_slots(params, static, cfg))

    def run(n):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        acc = torch.zeros((), device=device)
        for _ in range(n):
            img, _ = pipeline.render_deferred(p, static, cfg, slots=slots)
            loss = check.loss_of(img, cfg)
            grads = torch.autograd.grad(loss, list(p.values()))
            with torch.no_grad():
                p = {k: (v - 1e-6 * g).requires_grad_(True)
                     for (k, v), g in zip(p.items(), grads)}
            acc = acc + loss.detach()
        return acc

    _reset_launches()
    run(FWD_BWD_N1)
    run(FWD_BWD_N2)
    synchronize(device)
    wall = float("inf")
    for _ in range(FWD_BWD_REPS):
        t0 = time.perf_counter()
        run(FWD_BWD_N1)
        synchronize(device)
        t1 = time.perf_counter()
        acc = run(FWD_BWD_N2)
        synchronize(device)
        t2 = time.perf_counter()
        wall = min(wall, (t2 - t1) - (t1 - t0))
    if not bool(torch.isfinite(acc)):
        raise AssertionError(f"{mode} {size}: the loss is not finite")
    launches = _launches()
    steps = FWD_BWD_N2 - FWD_BWD_N1
    return (size * size * steps / wall / 1e6, wall / steps * 1e3,
            lambda: run(1), launches, (params, static, cfg, slots))


def _fwd_bwd_roofline(scene, step_ms) -> dict:
    from skybox_rt_tpu_torch.runtime import perf as perf_mod

    params, static, cfg, slots = scene
    t = perf_mod.diff_step_traffic(params, static, cfg, slots)
    r = perf_mod.roofline_from_traffic(t, seconds=step_ms / 1e3)
    streams = {k: v for k, v in t.items() if k.endswith("_bytes") and v > 0}
    return {"bound_by": r["bound_by"],
            "pct_of_roofline": r["pct_of_roofline"],
            "bytes_model": r["bytes_model"],
            "modeled_mb_per_step": t["bytes_total"] / 1e6,
            "top_stream": max(streams, key=streams.get)}


def _fwd_bwd_stage(key, device, mode="hard", size=None, roofline=False):
    device = resolve_device(device)
    rate, step_ms, one_step, launches, scene = _fwd_bwd(device, mode,
                                                        size=size)
    out = {f"{key}_mpix_s": rate, f"{key}_step_ms": step_ms,
           **_busy(key, one_step, device), f"{key}_launches": launches}
    if mode != "hard":
        out[f"{key}_slots"] = scene[3]
    if roofline:
        out[f"{key}_roofline"] = _fwd_bwd_roofline(scene, step_ms)
    return out


def _stage_fwd_bwd(device=None):
    return _fwd_bwd_stage(f"fwd_bwd_{FWD_BWD_SIZE}", device, roofline=True)


def _stage_fwd_bwd_1024(device=None):
    return _fwd_bwd_stage(f"fwd_bwd_{FWD_BWD_LARGE}", device,
                          size=FWD_BWD_LARGE, roofline=True)


def _stage_fwd_bwd_soft(device=None):
    return _fwd_bwd_stage(f"fwd_bwd_softedge_{FWD_BWD_SIZE}", device, "soft")


def _stage_fwd_bwd_alpha(device=None):
    return _fwd_bwd_stage(f"fwd_bwd_alpha_{FWD_BWD_SIZE}", device, "alpha")


def _stage_slots_soft(device=None):
    return {"slots": _fwd_bwd(resolve_device(device), "soft",
                              probe_slots_only=True)}


def _stage_slots_alpha(device=None):
    return {"slots": _fwd_bwd(resolve_device(device), "alpha",
                              probe_slots_only=True)}


def _timed_min(run, device, reps) -> float:
    """The least of ``reps`` seconds of one ``run()`` ending in a sync."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _stage_rt_northstar(device=None):
    """The multi-bounce frame over the 184,832-triangle sphere field (the
    default engine: the BVH-block kernels above 15,000 triangles); Mrays/s
    over every launch (primary + shadow + bounces x (closest + shadow))."""
    from skybox_rt_tpu_torch.models import scenes
    from skybox_rt_tpu_torch.rt import tracer

    device = resolve_device(device)
    W = H = RT_SIZE
    verts, faces, colors = scenes.sphere_field(copies=9, subdiv=5)
    scene = tracer.RTScene(verts=verts, faces=faces, colors=colors,
                           reflectivity=0.35)
    cam = tracer.Camera(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0),
                        fov_y_deg=55.0)
    cfg = tracer.RTConfig(width=W, height=H, bounces=RT_BOUNCES,
                          shadows=True)
    frame, (o, d) = tracer.make_frame_fn(scene, cam, cfg, device=device)
    _reset_launches()
    img = frame(o, d)
    synchronize(device)
    launches = _launches()
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("the north-star frame is not finite")
    dt = _timed_min(lambda: frame(o, d), device, RT_REPS)
    key = f"rt_multibounce_{W}"
    return {f"{key}_mrays_s": W * H * (2 + 2 * cfg.bounces) / dt / 1e6,
            f"{key}_ms": dt * 1e3,
            **_busy(key, lambda: frame(o, d), device),
            "rt_northstar_launches": launches}


def _stage_rt_config3(device=None):
    """rt.frame on the committed synth_config3 trace: one
    render_trace_rt_fused converges the K hints, then the frame function
    alone is timed; the timed frames' overflow is read after the loop and
    must be 0."""
    from skybox_rt_tpu_torch.rt import frame as frame_mod

    device = resolve_device(device)
    n = CONFIG3_SIZE
    trace = _trace("synth_config3")
    img = frame_mod.render_trace_rt_fused(trace, n, n, device=device)
    if not np.isfinite(img).all():
        raise AssertionError("the config-3 frame is not finite")
    fn, arrays, rays, metas = frame_mod.make_frame_fn(trace, n, n,
                                                      device=device)
    _reset_launches()
    out = fn(arrays, *rays)
    synchronize(device)
    launches = _launches()
    outs = []
    dt = _timed_min(lambda: outs.append(fn(arrays, *rays)), device,
                    CONFIG3_REPS)
    overflow = [int(o[2].sum()) for o in [out] + outs]
    if any(overflow):
        raise AssertionError(f"K-slot overflow in a timed frame: {overflow}")
    return {f"rt_synth_config3_{n}_ms": dt * 1e3,
            **_busy(f"rt_synth_config3_{n}", lambda: fn(arrays, *rays),
                    device),
            "rt_config3_launches": launches}


STAGES = {
    "window_probe": (_stage_window_probe, 600),
    "headline_device": (_stage_headline_device, 2400),
    "headline": (_stage_headline, 2400),
    "draw1024": (_stage_draw1024, 1200),
    "fwd_bwd": (_stage_fwd_bwd, 1200),
    "fwd_bwd_1024": (_stage_fwd_bwd_1024, 1200),
    "slots_soft": (_stage_slots_soft, 900),
    "fwd_bwd_soft": (_stage_fwd_bwd_soft, 1200),
    "slots_alpha": (_stage_slots_alpha, 900),
    "fwd_bwd_alpha": (_stage_fwd_bwd_alpha, 1200),
    "rt_northstar": (_stage_rt_northstar, 1800),
    "rt_config3": (_stage_rt_config3, 1800),
}

# stages whose result feeds the NEXT stage's environment, not the line
_PROBE_FOR = {"slots_soft": "fwd_bwd_soft", "slots_alpha": "fwd_bwd_alpha"}


def card() -> tuple[str | None, str | None]:
    """(nvidia-smi's name and power limit of the card, None), (None, None)
    where there is no nvidia-smi, or (None, the error) where it fails."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except FileNotFoundError:
        return None, None
    except (OSError, subprocess.SubprocessError) as e:
        return None, f"nvidia-smi: {e}"
    lines = res.stdout.strip().splitlines()
    return (lines[0], None) if lines else (None, "nvidia-smi printed nothing")


def run_stage(name: str, timeout: float, env: dict) -> dict:
    """One stage in a process of its own: its JSON, or {"error", "stderr"}
    when the process fails or its last line is not JSON."""
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--stage", name],
            capture_output=True, text=True, timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        return {"error": f"timeout after {timeout} s"}
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        return {"error": f"exit={proc.returncode}",
                "stderr": proc.stderr.strip()[-300:]}
    try:
        return json.loads(lines[-1])
    except json.JSONDecodeError as e:
        return {"error": f"last line not JSON: {e}",
                "stderr": proc.stderr.strip()[-300:]}


def main() -> int:
    results = {}
    env_extra = {}
    for name, (_, timeout) in STAGES.items():
        env = dict(os.environ)
        env.update(env_extra.pop(name, {}))
        results[name] = run_stage(name, timeout, env)
        if name in _PROBE_FOR:
            r = results.pop(name)
            if "error" in r:
                results[name] = r
            else:
                env_extra[_PROBE_FOR[name]] = {
                    "SKYBOX_BENCH_SLOTS": str(r["slots"])}

    dev = results.get("headline_device", {})
    value = None if "error" in dev else dev.pop("value", None)
    device, device_error = card()
    extra = {"device": device}
    failed = device_error is not None
    if failed:
        extra["device_error"] = device_error
    for name, r in results.items():
        if "error" in r:
            failed = True
            extra[f"{name}_error"] = r["error"]
            if r.get("stderr"):
                extra[f"{name}_stderr"] = r["stderr"]
        else:
            extra.update(r)
    print(json.dumps({
        "metric": f"draw3d_{SCENE}_{SIZE}x{SIZE}_fwd_devicewall",
        "value": value,
        "unit": "Mpix/s",
        "vs_baseline": None,
        "extra": extra,
    }))
    return 1 if failed else 0


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--stage":
        fn, _ = STAGES[sys.argv[2]]
        print(json.dumps(fn()))
        sys.exit(0)
    sys.exit(main())
