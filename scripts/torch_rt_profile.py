"""Where the port's 1024x1024 ray-traced frame spends its time on the card.

    python3 scripts/torch_rt_profile.py                      # needs a CUDA card
    python3 scripts/torch_rt_profile.py --scene small
    python3 scripts/torch_rt_profile.py --tri-block 16 32 64 128
    python3 scripts/torch_rt_profile.py --leaf-tris 8 16 32 [--scene config3]
    python3 scripts/torch_rt_profile.py --scene small --cluster-group 4 8 16
    python3 scripts/torch_rt_profile.py --build-times
    python3 scripts/torch_rt_profile.py --scene small --engine pallas_worklist
    python3 scripts/torch_rt_profile.py --scene config3 [--size 512]
    python3 scripts/torch_rt_profile.py --scene config3 --scan-max-prims 0 2 64

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

``--leaf-tris SIZES`` instead sweeps the leaf size inside a block,
rt.tracer.BVH_LEAF_TRIS, which the closest-hit and next-hit-after queries of
the large-scene frame and of the config-3 frame walk: for each size (a size
may be given twice, to see the drift of one call), the large scene's leaf
count, the milliseconds of the frame's three closest-hit launches (each
alone, CUDA events) and of the whole frame, and the largest difference of
the image from the first size's; with ``--scene config3`` the milliseconds
of every next-hit-after walk and closest-hit launch of the frame at
``--size`` (summed), of the whole frame, and the largest difference from the
first size's image.  The module constant is set for the run and restored.

``--cluster-group SIZES`` (with ``--scene small``) instead sweeps the
clusters a group of the clustered closest-hit query holds,
ops.cuda_rt.CLUSTER_GROUP: for each size (a size may be given twice) the
group count, the group and cluster slab tests and the triangle tests a ray
of the primary launch (its plain version's counts on 65,536 of its rays),
the milliseconds of the frame's three closest-hit launches (each alone, CUDA
events and CUDA graph replays) and of the whole frame, and the largest
difference of the image from the first size's (the group size changes the
order in which clusters are met, and so which of two equal-t hits wins).
The module constant is set for the run and restored.

``--build-times`` instead times the kernels' build both ways into a
temporary directory: one nvcc over all sources, and one nvcc a source
started together plus the link (what skybox_rt_tpu_torch._build does).

``--scene small`` profiles the 12,032-triangle sphere field
(sphere_field(copies=9, subdiv=3)) instead, which the default engine answers
with the clustered kernels: the same three lines, the stages on the clustered
closest-hit and any-hit kernels.

``--engine`` (with ``--scene small``) profiles one of the comparison engines
``pallas_streamed`` / ``pallas_worklist`` instead of the default one: the
``frame`` and ``profile`` lines.

``--scene config3`` profiles the ray-traced CGLTrace frame of rt.frame on the
committed trace ``data/synth_config3.npz`` at ``--size`` (1024): the K hints
converge first; then ``frame``, ``profile`` (the BVH-block kernels' part named)
and ``stages``, the CUDA-event milliseconds of every draw's pieces run one by
one (kernel launches, the slot sort, the output merger's replay or composite,
the scan).  ``--scan-max-prims CUTOFFS`` instead sweeps rt.frame's
``_SCAN_MAX_PRIMS`` (2, the JAX package's value): for each cutoff the plan's
modes and K and the frame's milliseconds at ``--size``, and the largest
difference of the image from the first cutoff's.  The module constant is set
for the run and restored.

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

from chip_smoke import (capture_launches, graph_ms,  # noqa: E402
                        median_ms, northstar_scene, nvidia_smi, small_scene)
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
            bs = bvh_mod.build_block_set(scene.bvh, tri_block=tb)
            blocks = cuda_rt.prepare_bvh_blocks(
                *tri, bs, bvh_mod.build_block_leaves(
                    scene.bvh, bs, tracer.BVH_LEAF_TRIS))
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


def sweep_leaf_tris(sizes, scene, cam, cfg, card) -> None:
    kept, first = tracer.BVH_LEAF_TRIS, None
    try:
        for lt in sizes:
            tracer.BVH_LEAF_TRIS = lt
            frame, (o, d) = tracer.make_frame_fn(scene, cam, cfg)
            img = frame(o, d)
            first = img if first is None else first
            bs = bvh_mod.build_block_set(scene.bvh,
                                         tri_block=tracer.BVH_TRI_BLOCK)
            blocks = cuda_rt.prepare_bvh_blocks(
                *device_triangles(scene, o.device), bs,
                bvh_mod.build_block_leaves(scene.bvh, bs, lt))
            launches = capture_launches(
                scene, cfg, lambda o, d: cuda_rt.closest_hit_bvh(o, d, blocks),
                lambda o, d, tm: cuda_rt.any_hit_bvh(o, d, blocks, t_max=tm),
                o, d)
            closest_ms = [event_ms(lambda: cuda_rt.closest_hit_bvh(
                lo, ld, blocks)) for kind, lo, ld, _ in launches
                if kind == "closest"]
            frame_ms = event_ms(lambda: frame(o, d))
            print(json.dumps({
                "leaf_tris": lt, "leaves": int(blocks["leaf_table"].shape[0]),
                "closest_launches_ms": closest_ms,
                "closest_frame_ms": sum(closest_ms),
                "frame_ms": frame_ms,
                "frame_mrays_per_s": SIZE * SIZE * 6 / frame_ms / 1e3,
                "max_abs_diff_from_first": float((img - first).abs().max()),
                "card": card}), flush=True)
    finally:
        tracer.BVH_LEAF_TRIS = kept


def sweep_cluster_group(sizes, scene, cam, cfg, card) -> None:
    kept, first = cuda_rt.CLUSTER_GROUP, None
    try:
        for group in sizes:
            cuda_rt.CLUSTER_GROUP = group
            frame, (o, d) = tracer.make_frame_fn(scene, cam, cfg)
            img = frame(o, d)
            first = img if first is None else first
            clusters = cuda_rt.prepare_clusters(
                *device_triangles(scene, o.device),
                bvh_mod.build_clusters(scene.bvh))
            launches = capture_launches(
                scene, cfg,
                lambda o, d: cuda_rt.closest_hit_clustered(o, d, clusters),
                lambda o, d, tm: cuda_rt.any_hit_clustered(o, d, clusters,
                                                           t_max=tm),
                o, d)
            closest = [(lo, ld) for kind, lo, ld, _ in launches
                       if kind == "closest"]
            stats, stride = {}, o.shape[0] // 65536
            cuda_rt.closest_hit_clustered_reference(
                o[::stride].contiguous(), d[::stride].contiguous(), clusters,
                stats=stats)
            rays = o[::stride].shape[0]
            launch_ms = [event_ms(lambda: cuda_rt.closest_hit_clustered(
                lo, ld, clusters)) for lo, ld in closest]
            launch_graph_ms = [graph_ms(lambda: cuda_rt.closest_hit_clustered(
                lo, ld, clusters)) for lo, ld in closest]
            frame_ms = event_ms(lambda: frame(o, d))
            print(json.dumps({
                "cluster_group": group, "clusters": clusters["num_clusters"],
                "groups": clusters["num_groups"],
                "primary_tests_per_ray": {k: v / rays
                                          for k, v in stats.items()},
                "closest_launches_ms": launch_ms,
                "closest_frame_ms": sum(launch_ms),
                "closest_launches_graph_ms": launch_graph_ms,
                "closest_frame_graph_ms": sum(launch_graph_ms),
                "frame_ms": frame_ms,
                "frame_mrays_per_s": SIZE * SIZE * 6 / frame_ms / 1e3,
                "max_abs_diff_from_first": float((img - first).abs().max()),
                "card": card}), flush=True)
    finally:
        cuda_rt.CLUSTER_GROUP = kept


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


def profile_line(run, names, card) -> None:
    """One run under torch.profiler -> the ``profile`` JSON line; the device
    kernels whose name holds one of the strings ``names`` are summed
    apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profiled():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        return prof, wall

    profiled()                      # the first use pays the tracer's start-up
    prof, wall = profiled()
    # device rows only: an operator's row repeats its kernels' time
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    ours = sum(ms for k, ms, _ in rows if any(s in k for s in names))
    print(json.dumps({"profile": {
        "device_time_seen": bool(rows), "frame_host_ms_under_profiler": wall,
        "device_busy_ms": busy, "device_busy_share": busy / wall,
        "rt_kernels_ms": ours, "other_kernels_ms": busy - ours,
        "device_kernels": int(sum(r[2] for r in rows)),
        "top": [{"name": k[:60], "ms": ms, "count": n}
                for k, ms, n in rows[:10]]}, "card": card}), flush=True)


def bvh_kernel_ms(metas, arrays, nx, ny):
    """CUDA-event milliseconds of a config-3 frame's BVH-block launches, each
    alone on the frame's rays and carries: every next-hit-after walk of the
    K-slot draws and the closest-hit launch of the winner draws."""
    import math
    dirs = torch.stack([nx, ny, torch.ones_like(nx)], -1)
    eye = torch.zeros_like(dirs)
    R = nx.shape[0]
    walks_ms, winner_ms = [], []
    for m, a in zip(metas, arrays):
        if m["mode"] == "winner":
            o, d = ((dirs * m["far_d"], -dirs) if m["farthest"]
                    else (eye, dirs))
            winner_ms.append(event_ms(lambda: cuda_rt.closest_hit_bvh(
                o, d, a["blocks"], t_min=1e-6)))
        elif m["mode"] == "kslot":
            tlo = torch.full((R,), -math.inf, device=nx.device)
            slo = torch.full((R,), -1, dtype=torch.int32, device=nx.device)
            for _ in range(m["K"] + (m["K"] < m["P"])):
                walks_ms.append(event_ms(
                    lambda: cuda_rt.closest_hit_bvh_after(
                        eye, dirs, a["blocks"], tlo, slo, t_min=1e-6)))
                slot, _, tlo, _, _ = cuda_rt.closest_hit_bvh_after(
                    eye, dirs, a["blocks"], tlo, slo, t_min=1e-6)
                slo = slot
    return {"walks": sum(walks_ms), "winner": sum(winner_ms),
            "walk_count": len(walks_ms)}


def config3(args, card) -> int:
    """--scene config3: the ray-traced CGLTrace frame of rt.frame."""
    import math

    from skybox_rt_tpu_torch.geom import cgltrace
    from skybox_rt_tpu_torch.rt import frame as frame_mod
    from skybox_rt_tpu_torch.rt import raster_bridge as rb
    n = args.size

    def prepared():
        # a new trace object has no K hints: the retry converges them
        trace = cgltrace.load_trace(cgltrace.trace_path("synth_config3"))
        img = frame_mod.render_trace_rt_fused(trace, n, n)
        return img, frame_mod.make_frame_fn(trace, n, n)

    if args.leaf_tris:
        kept, first = tracer.BVH_LEAF_TRIS, None
        try:
            for lt in args.leaf_tris:
                tracer.BVH_LEAF_TRIS = lt
                img, (fn, arrays, rays, metas) = prepared()
                first = img if first is None else first
                print(json.dumps({
                    "leaf_tris": lt, "size": n,
                    "kernel_ms": bvh_kernel_ms(metas, arrays, *rays),
                    "frame_ms": event_ms(lambda: fn(arrays, *rays)),
                    "max_abs_diff_from_first": float(
                        np.abs(img - first).max()),
                    "card": card}), flush=True)
        finally:
            tracer.BVH_LEAF_TRIS = kept
        return 0

    if args.scan_max_prims:
        kept, first = frame_mod._SCAN_MAX_PRIMS, None
        try:
            for cutoff in args.scan_max_prims:
                frame_mod._SCAN_MAX_PRIMS = cutoff
                img, (fn, arrays, rays, metas) = prepared()
                first = img if first is None else first
                print(json.dumps({
                    "scan_max_prims": cutoff, "size": n,
                    "plan": [(m["draw_index"], m["mode"], m["K"], m["P"])
                             for m in metas],
                    "frame_ms": event_ms(lambda: fn(arrays, *rays)),
                    "max_abs_diff_from_first": float(
                        np.abs(img - first).max()),
                    "card": card}), flush=True)
        finally:
            frame_mod._SCAN_MAX_PRIMS = kept
        return 0

    _, (fn, arrays, (nx, ny), metas) = prepared()

    def run():
        return fn(arrays, nx, ny)

    ev = event_ms(run)
    print(json.dumps({"frame": {"event_ms": ev, "host_ms": host_ms(run),
                                "mpix_per_s": n * n * len(metas) / ev / 1e3},
                      "scene": "config3", "size": n,
                      "plan": [(m["draw_index"], m["mode"], m["K"], m["P"])
                               for m in metas], "card": card}), flush=True)
    profile_line(run, ("bvh_walk_kernel",), card)

    dirs = torch.stack([nx, ny, torch.ones_like(nx)], -1)
    eye = torch.zeros_like(dirs)
    R, dev = nx.shape[0], nx.device
    zbuf, color = rb.clear_buffers(R, dev)
    stages = {}
    for m, a in zip(metas, arrays):
        di = m["draw_index"]
        if m["mode"] == "scan":
            stages[f"draw{di}_scan"] = event_ms(lambda: rb._scan_run(
                m["statics"], a, nx, ny, zbuf, color))
            continue
        if m["mode"] == "winner":
            o, d = ((dirs * m["far_d"], -dirs) if m["farthest"]
                    else (eye, dirs))
            stages[f"draw{di}_winner_kernel"] = event_ms(
                lambda: cuda_rt.closest_hit_bvh(o, d, a["blocks"],
                                                t_min=1e-6))
            prim, _, u, v = cuda_rt.closest_hit_bvh(o, d, a["blocks"],
                                                    t_min=1e-6)
            stages[f"draw{di}_winner_composite"] = event_ms(
                lambda: rb._winner_composite(
                    m["statics"], True, a["chan"], a["idx"], None,
                    a["zattr"], a["colattr"], a["uvattr"], a["img"], prim, u,
                    v, zbuf, color))
            continue
        walks = m["K"] + (m["K"] < m["P"])

        def walk_all():
            tlo = torch.full((R,), -math.inf, device=dev)
            slo = torch.full((R,), -1, dtype=torch.int32, device=dev)
            slots = []
            for _ in range(walks):
                slot, prim, t, u, v = cuda_rt.closest_hit_bvh_after(
                    eye, dirs, a["blocks"], tlo, slo, t_min=1e-6)
                slots.append((prim, t, u, v))
                tlo, slo = t, slot
            return slots[:m["K"]]

        slots = walk_all()
        stages[f"draw{di}_kslot_{walks}_walks"] = event_ms(walk_all)
        stages[f"draw{di}_kslot_sort_K{m['K']}"] = event_ms(
            lambda: frame_mod._sort_slots_by_prim(slots))
        stages[f"draw{di}_kslot_replay_K{m['K']}"] = event_ms(
            lambda: frame_mod._om_replay(m, a, slots, zbuf, color))
    print(json.dumps({"stages": stages, "rays": R, "scene": "config3",
                      "card": card}), flush=True)
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tri-block", type=int, nargs="+", metavar="SIZE")
    ap.add_argument("--leaf-tris", type=int, nargs="+", metavar="SIZE")
    ap.add_argument("--cluster-group", type=int, nargs="+", metavar="SIZE")
    ap.add_argument("--build-times", action="store_true")
    ap.add_argument("--scene", choices=("northstar", "small", "config3"),
                    default="northstar")
    ap.add_argument("--engine", choices=("pallas_streamed",
                                         "pallas_worklist"))
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--scan-max-prims", type=int, nargs="+",
                    metavar="CUTOFF")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_rt_profile: no CUDA device")
    dev = torch.device("cuda")
    card = nvidia_smi()
    if args.build_times:
        build_times(card)
        return 0

    if args.scene == "config3":
        return config3(args, card)
    small = args.scene == "small"
    if args.engine and not small:
        raise SystemExit("--engine compares engines on --scene small")
    scene, cam = small_scene() if small else northstar_scene()
    scene.finalize()
    cfg = tracer.RTConfig(width=SIZE, height=SIZE, bounces=2, shadows=True,
                          **({"engine": args.engine} if args.engine else {}))
    engine = tracer.resolve_engine(cfg, scene.faces.shape[0])
    if engine != (args.engine or ("pallas" if small else "pallas_bvh")):
        raise SystemExit(f"scene {args.scene} resolved to engine {engine}")
    if args.tri_block:
        if small:
            raise SystemExit("--tri-block sweeps the BVH-block engine: use "
                             "it with --scene northstar")
        sweep_tri_block(args.tri_block, scene, cam, cfg, dev, card)
        return 0
    if args.leaf_tris:
        if small:
            raise SystemExit("--leaf-tris sweeps the BVH-block engine: use "
                             "it with --scene northstar or config3")
        sweep_leaf_tris(args.leaf_tris, scene, cam, cfg, card)
        return 0
    if args.cluster_group:
        if not small or args.engine:
            raise SystemExit("--cluster-group sweeps the clustered kernels: "
                             "use it with --scene small")
        sweep_cluster_group(args.cluster_group, scene, cam, cfg, card)
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

    profile_line(run, {"pallas": ("clustered_kernel<",),
                       "pallas_bvh": ("bvh_walk_kernel",),
                       "pallas_worklist": ("closest_hit_blocks_kernel",
                                           "active_block_lists_kernel")}.get(
                           engine, ("closest_hit_blocks_kernel",)), card)
    if args.engine:
        return 0

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
        bs = bvh_mod.build_block_set(scene.bvh,
                                     tri_block=tracer.BVH_TRI_BLOCK)
        blocks = cuda_rt.prepare_bvh_blocks(
            *tri, bs, bvh_mod.build_block_leaves(scene.bvh, bs,
                                                 tracer.BVH_LEAF_TRIS))

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
