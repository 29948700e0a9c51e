"""Where the port's 1024x1024 ray-traced frame spends its time on the card.

    python3 scripts/torch_rt_profile.py                      # needs a CUDA card
    python3 scripts/torch_rt_profile.py --scene small
    python3 scripts/torch_rt_profile.py --tri-block 16 32 64 128
    python3 scripts/torch_rt_profile.py --build-times

Builds the 184,832-triangle sphere field (sphere_field(copies=9, subdiv=5),
reflectivity 0.35), prepares the 2-bounce shadowed frame through
skybox_rt_tpu_torch.rt.tracer.make_frame_fn on the default device, and
prints one JSON line each for:

  * ``frame``    — host-clock and CUDA-event milliseconds of one frame,
                   median of 10 after warm-up;
  * ``profile``  — one frame under torch.profiler (CPU + CUDA activities):
                   device-busy milliseconds (sum of device kernel time), its
                   share of the frame's host-clock time, the two ray-query
                   kernels' part of it, the count of device kernels, and the ten
                   largest by summed device time (a first profiled frame is
                   thrown away: it pays the tracer's start-up);
  * ``stages``   — CUDA-event milliseconds of the frame's stages driven one
                   by one on the frame's own primary rays: closest-hit
                   kernel, shade_hits without its shadow launch, the any-hit
                   kernel, one bounce compaction (key, stable argsort, packed
                   gather).

If the profiler reports no device time, ``profile`` says so and the stage
timings stand alone.  Every line carries the card's name and power limit.

``--tri-block SIZES`` instead sweeps the treelet block size, which
rt.tracer.BVH_TRI_BLOCK fixes at 256 (the JAX package's value): for 256 and
each given size it cuts the scene's BVH into blocks of that size and prints
one JSON line with the block count, the pyramid, the milliseconds of the
primary closest-hit launch and of the whole frame, Mrays/s, and the largest
difference of the image from the size-256 image (the sizes differ only in
which of two equal-t hits wins).  The module constant is set for the run and
restored; nothing in the package reads an option for it.

``--build-times`` instead times the kernels' build both ways into a
temporary directory: one nvcc over all sources, and one nvcc a source
started together plus the link (what skybox_rt_tpu_torch._build does).

``--scene small`` profiles the 12,032-triangle sphere field
(sphere_field(copies=9, subdiv=3)) instead, which the default engine answers
with the clustered kernels: the same three lines, the stages on the clustered
closest-hit and any-hit kernels.

Timer, scenes and camera are chip_smoke.py's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (median_ms, northstar_scene, nvidia_smi,  # noqa: E402
                        small_scene)
from skybox_rt_tpu_torch import _build  # noqa: E402
from skybox_rt_tpu_torch.ops import cuda_rt  # noqa: E402
from skybox_rt_tpu_torch.rt import bvh as bvh_mod  # noqa: E402
from skybox_rt_tpu_torch.rt import intersect, tracer  # noqa: E402

SIZE = 1024


def event_ms(fn):
    return median_ms(fn, reps=10, warmup=2)


def host_ms(fn, reps=10):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def device_triangles(scene, dev):
    return intersect.triangle_arrays(
        torch.as_tensor(scene.verts, device=dev),
        torch.as_tensor(np.asarray(scene.faces, np.int64), device=dev))


def sweep_tri_block(sizes, scene, cam, cfg, dev, card) -> None:
    tri = device_triangles(scene, dev)
    kept = tracer.BVH_TRI_BLOCK
    images = {}
    try:
        for tb in sorted(set(sizes) | {256}, reverse=True):     # 256 first
            tracer.BVH_TRI_BLOCK = tb
            frame, (o, d) = tracer.make_frame_fn(scene, cam, cfg)
            blocks = cuda_rt.prepare_bvh_blocks(
                *tri, bvh_mod.build_block_set(scene.bvh, tri_block=tb))
            images[tb] = frame(o, d)
            frame_ms = event_ms(lambda: frame(o, d))
            print(json.dumps({
                "tri_block": tb, "blocks": blocks["num_blocks"],
                "pyramid": list(blocks["level_counts"]),
                "primary_closest_ms": event_ms(
                    lambda: cuda_rt.closest_hit_bvh(o, d, blocks)),
                "frame_ms": frame_ms,
                "frame_mrays_per_s": SIZE * SIZE * 6 / frame_ms / 1e3,
                "max_abs_diff_from_256": float(
                    (images[tb] - images[256]).abs().max()),
                "card": card}), flush=True)
    finally:
        tracer.BVH_TRI_BLOCK = kept


def build_times(card) -> None:
    nvcc = _build._nvcc()
    srcs = [s for s in _build._sources() if s.endswith(".cu")]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
                        os.path.join(tmp, "one.so"), *srcs], check=True,
                       capture_output=True)
        one = time.perf_counter() - t0
        t0 = time.perf_counter()
        objs = [os.path.join(tmp, f"{i}.o") for i in range(len(srcs))]
        jobs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", obj,
                                  src], stderr=subprocess.DEVNULL)
                for obj, src in zip(objs, srcs)]
        if any(job.wait() for job in jobs):
            raise RuntimeError("nvcc failed")
        subprocess.run([nvcc, "-shared", "-o", os.path.join(tmp, "par.so"),
                        *objs], check=True, capture_output=True)
        together = time.perf_counter() - t0
    print(json.dumps({"build_s": {"one_nvcc_all_sources": one,
                                  "one_nvcc_a_source_together": together},
                      "sources": [os.path.basename(s) for s in srcs],
                      "card": card}), flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tri-block", type=int, nargs="+", metavar="SIZE")
    ap.add_argument("--build-times", action="store_true")
    ap.add_argument("--scene", choices=("northstar", "small"),
                    default="northstar")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_rt_profile: no CUDA device")
    dev = torch.device("cuda")
    card = nvidia_smi()
    if args.build_times:
        build_times(card)
        return 0

    small = args.scene == "small"
    scene, cam = small_scene() if small else northstar_scene()
    scene.finalize()
    cfg = tracer.RTConfig(width=SIZE, height=SIZE, bounces=2, shadows=True)
    engine = tracer.resolve_engine(cfg, scene.faces.shape[0])
    if engine != ("pallas" if small else "pallas_bvh"):
        raise SystemExit(f"scene {args.scene} resolved to engine {engine}")
    if args.tri_block:
        if small:
            raise SystemExit("--tri-block sweeps the BVH-block engine: use "
                             "it with --scene northstar")
        sweep_tri_block(args.tri_block, scene, cam, cfg, dev, card)
        return 0
    frame, (o, d) = tracer.make_frame_fn(scene, cam, cfg)

    def run():
        return frame(o, d)

    ev = event_ms(run)
    print(json.dumps({"frame": {"event_ms": ev, "host_ms": host_ms(run),
                                "mrays_per_s": SIZE * SIZE * 6 / ev / 1e3},
                      "scene": args.scene, "engine": engine,
                      "triangles": int(scene.faces.shape[0]),
                      "card": card}), flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profiled_frame():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        return prof, wall

    profiled_frame()                # the first use pays the tracer's start-up
    prof, wall = profiled_frame()
    # device rows only: an operator's row repeats its kernels' time
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    ours = sum(ms for k, ms, _ in rows
               if ("_clustered_kernel" if small else "_bvh_kernel") in k)
    print(json.dumps({"profile": {
        "device_time_seen": bool(rows), "frame_host_ms_under_profiler": wall,
        "device_busy_ms": busy, "device_busy_share": busy / wall,
        "rt_kernels_ms": ours, "other_kernels_ms": busy - ours,
        "device_kernels": int(sum(r[2] for r in rows)),
        "top": [{"name": k[:60], "ms": ms, "count": n}
                for k, ms, n in rows[:10]]}, "card": card}), flush=True)

    # the stages one by one, on the frame's own primary rays
    tri = device_triangles(scene, dev)
    if small:
        clusters = cuda_rt.prepare_clusters(
            *tri, bvh_mod.build_clusters(scene.bvh))

        def closest(o, d):
            return cuda_rt.closest_hit_clustered(o, d, clusters)

        def occluded(o, d, tm):
            return cuda_rt.any_hit_clustered(o, d, clusters, t_max=tm)
    else:
        blocks = cuda_rt.prepare_bvh_blocks(*tri, bvh_mod.build_block_set(
            scene.bvh, tri_block=tracer.BVH_TRI_BLOCK))

        def closest(o, d):
            return cuda_rt.closest_hit_bvh(o, d, blocks)

        def occluded(o, d, tm):
            return cuda_rt.any_hit_bvh(o, d, blocks, t_max=tm)

    arrays = tracer.scene_shade_arrays(scene, cfg)
    prim, t, u, v = closest(o, d)
    no_shadow = dataclasses.replace(cfg, shadows=False)
    _, hit, pt, n = tracer.shade_hits(arrays, no_shadow, None, o, d, prim, t,
                                      u, v)
    ldir = torch.tensor(cfg.light_dir, device=dev)
    ldir = (ldir / ldir.norm()).expand(o.shape[0], 3).contiguous()
    sh_o = torch.where(hit[:, None], pt + n * 1e-3,
                       torch.tensor(tracer.PARK_O, device=dev))
    tmax = torch.full((o.shape[0],), 1e8, device=dev)
    packed = torch.cat([pt, d, pt, t[:, None], u[:, None]], dim=1)

    def compaction():
        key = tracer._compact_key(hit, pt, d)
        perm = torch.argsort(key, stable=True)
        return packed[perm]

    stages = {
        "closest_hit_kernel": event_ms(lambda: closest(o, d)),
        "shade_hits_no_shadow": event_ms(
            lambda: tracer.shade_hits(arrays, no_shadow, None, o, d, prim, t,
                                      u, v)),
        "any_hit_kernel": event_ms(lambda: occluded(sh_o, ldir, tmax)),
        "compaction_key_argsort_gather": event_ms(compaction),
    }
    print(json.dumps({"stages": stages, "rays": int(o.shape[0]),
                      "scene": args.scene, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
