"""Framework CLI — the simx/draw3d host analog (SURVEY §2.4 S12, §2.2 H6).

Counterpart of skybox_rt_tpu.cli.  The reference ships a standalone
simulator CLI (sim/simx/main.cpp:77-126) and per-app hosts with getopt flags
(tests/regression/draw3d/main.cpp:84-136: -t trace -w width -h height
-o output.png -r reference.png -k tilelogsize).  This module provides the
same surface:

  python -m skybox_rt_tpu_torch render -t synth_draw3d -w 256 -H 256 \\
      -o out.png [-r golden.png] [-k 5] [--mode immediate|deferred|pallas] \\
      [--perf]
  python -m skybox_rt_tpu_torch bench  [-t synth_draw3d] [-w 512] [--frames 20]
  python -m skybox_rt_tpu_torch info
  python -m skybox_rt_tpu_torch rt     [-w 256 -H 256] [--engine pallas] \\
      [--spans trace.json]
  python -m skybox_rt_tpu_torch fit    [-w 64] [--steps 200]
  python -m skybox_rt_tpu_torch scale  [-w 256] [--iters 10] [--artifact P]

Every command runs on the CUDA card unless ``--device`` names another torch
device (``--device cpu``).  `render` prints the reference's frame report
("Total elapsed time ..." draw3d/main.cpp:360-378) and PASSED/FAILED on
golden compare (main.cpp:505-514).  `scale` runs parallel.scaling's sweep
of the sharded train step over worlds of ranks (one process a rank; on the
card a card a rank, on the CPU 1 and 2 gloo ranks).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_render(args) -> int:
    from .core.device import synchronize
    from .geom import cgltrace
    from .ref import driver
    from .runtime.device import Device
    from .runtime import perf as perf_mod
    from .utils import image

    trace = cgltrace.load_cached(cgltrace.trace_path(args.trace))

    dev = Device(args.device)
    stats = driver.FrameStats()

    t0 = time.perf_counter()
    fb = driver.render_trace(
        trace, args.width, args.height,
        tile_logsize=args.tile_logsize, stats=stats, mode=args.mode,
        measure_traffic=args.perf, device=dev.device)
    elapsed_ms = (time.perf_counter() - t0) * 1e3

    # the reference's per-frame report (draw3d/main.cpp:360-378); cycles
    # and instructions have no counterpart, so report draw/prim/tile counts
    print(f"Total elapsed time: {elapsed_ms:.0f} ms")
    print(f"drawcalls={stats.drawcalls}, prims={stats.prims_binned}, "
          f"tiles={stats.tiles}")

    if args.perf:
        dev.perf.count("drawcalls", stats.drawcalls)
        dev.perf.count("prims_binned", stats.prims_binned)
        dev.perf.count("tiles", stats.tiles)
        for k, v in stats.traffic.items():
            if k in ("tiles", "prims"):      # already counted above
                continue
            dev.perf.count(k, int(v))
        dev.perf.add_time("frame_ms", elapsed_ms)
        dev.dump_perf()

        # roofline placement of the prepared frame against the H100's
        # peaks, bytes from the MEASURED per-unit traffic model above
        mode = args.mode if args.mode != "immediate" else "deferred"
        frame, arrays = driver.compile_frame(
            trace, args.width, args.height,
            tile_logsize=args.tile_logsize, mode=mode, device=dev.device)
        frame(arrays)
        synchronize(dev.device)
        t0 = time.perf_counter()
        n = 10
        for _ in range(n):
            frame(arrays)
        synchronize(dev.device)
        dt = (time.perf_counter() - t0) / n
        r = perf_mod.roofline_from_traffic(stats.traffic, seconds=dt)
        print(perf_mod.format_roofline_table(
            {f"frame[{mode}] {args.width}x{args.height}": r}))

    if args.output:
        image.save_framebuffer_png(args.output, fb)

    if args.reference:
        errors, maxdiff = image.compare_to_golden(fb, args.reference)
        if errors == 0:
            print("PASSED!")
            return 0
        print(f"FAILED! - {errors} errors (max channel diff {maxdiff})")
        return 1
    return 0


def _cmd_bench(args) -> int:
    from .core.device import resolve_device, synchronize
    from .geom import cgltrace
    from .ref import driver

    device = resolve_device(args.device)
    trace = cgltrace.load_cached(cgltrace.trace_path(args.trace))
    frame, arrays = driver.compile_frame(trace, args.width, args.width,
                                         tile_logsize=args.tile_logsize,
                                         mode=args.mode, device=device)
    frame(arrays)
    synchronize(device)

    t0 = time.perf_counter()
    for _ in range(args.frames):
        frame(arrays)
    synchronize(device)
    elapsed = time.perf_counter() - t0

    pixels = args.width * args.width * len(arrays) * args.frames
    mpix_s = pixels / elapsed / 1e6
    print(json.dumps({
        "scene": args.trace, "size": args.width, "frames": args.frames,
        "tile_logsize": args.tile_logsize, "mode": args.mode,
        "ms_per_frame": elapsed / args.frames * 1e3,
        "mpix_s": mpix_s,
    }))
    return 0


def _cmd_info(args) -> int:
    from .runtime.device import Device

    caps = Device(args.device).caps
    print(json.dumps({
        "platform": caps.platform,
        "num_devices": caps.num_devices,
        "device_kind": caps.device_kind,
        "memory_per_device": caps.memory_per_device,
        "isa": {  # VX_ISA_EXT_RASTER/TEX/OM analog (vortex.h:44-52)
            "raster": caps.has_raster, "tex": caps.has_tex,
            "om": caps.has_om, "rt": caps.has_rt,
        },
    }))
    return 0


def build_parser() -> argparse.ArgumentParser:
    from .core import constants as C
    p = argparse.ArgumentParser(prog="skybox_rt_tpu_torch")
    # every command takes --device, before or after its own flags
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA "
                             "card; 'cpu' runs the kernels' plain versions)")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", parents=[common],
                       help="render a cgltrace scene")
    r.add_argument("-t", "--trace", required=True,
                   help="scene name (synth_draw3d) or path to a trace")
    r.add_argument("-w", "--width", type=int, default=256)
    r.add_argument("-H", "--height", type=int, default=256)
    r.add_argument("-o", "--output", default=None, help="output PNG")
    r.add_argument("-r", "--reference", default=None,
                   help="golden PNG to compare against (tolerance 1; "
                        "reads it through PIL)")
    r.add_argument("-k", "--tile-logsize", type=int, default=5)
    r.add_argument("--mode", choices=("immediate", "deferred", "pallas"),
                   default="deferred",
                   help="deferred/pallas are the exact fast path (pass 1 "
                        "the CUDA kernel on the card); immediate is the "
                        "oracle")
    r.add_argument("--perf", action="store_true",
                   help="dump perf counters (vx_dump_perf analog)")
    r.set_defaults(fn=_cmd_render)

    b = sub.add_parser("bench", parents=[common], help="throughput benchmark")
    b.add_argument("-t", "--trace", default="synth_draw3d")
    b.add_argument("-w", "--width", type=int, default=512)
    b.add_argument("--frames", type=int, default=20)
    b.add_argument("--tile-logsize", type=int,
                   default=C.RASTER_TILE_LOGSIZE, choices=range(3, 8),
                   help="raster tile log2 size (the reference sweep's "
                        "rtile axis, perf/graphics/run.sh)")
    b.add_argument("--mode", default="deferred",
                   choices=("immediate", "deferred", "pallas"))
    b.set_defaults(fn=_cmd_bench)

    i = sub.add_parser("info", parents=[common],
                       help="device capabilities (vx_dev_caps)")
    i.set_defaults(fn=_cmd_info)

    s = sub.add_parser("scale", parents=[common],
                       help="mesh scaling-efficiency sweep "
                            "(perf/graphics/run.sh analog)")
    s.add_argument("-w", "--width", type=int, default=256)
    s.add_argument("--iters", type=int, default=10)
    s.add_argument("--artifact", default=None, metavar="PATH",
                   help="also append BENCH_r*.json-shaped lines "
                        "({metric, value, unit, vs_baseline} per mesh "
                        "size)")
    s.set_defaults(fn=_cmd_scale)

    t = sub.add_parser("rt", parents=[common],
                       help="ray-trace a procedural scene")
    t.add_argument("-w", "--width", type=int, default=256)
    t.add_argument("-H", "--height", type=int, default=256)
    t.add_argument("-o", "--output", default="rt_out.png")
    t.add_argument("--scene", choices=("sphere", "sphere-plane",
                                       "sphere-field"),
                   default="sphere-plane",
                   help="sphere-field = the 184,832-triangle "
                        "multi-object scene")
    t.add_argument("--bounces", type=int, default=1)
    t.add_argument("--no-shadows", action="store_true")
    t.add_argument("--engine",
                   choices=("pallas", "pallas_bvh", "pallas_worklist",
                            "bvh", "brute"),
                   default="pallas")
    t.add_argument("--spans", default=None, metavar="PATH",
                   help="trace the render's rt.* stages and write them as "
                        "a Chrome trace (utils.tracing.export_chrome_trace)")
    t.set_defaults(fn=_cmd_rt)

    f = sub.add_parser("fit", parents=[common],
                       help="inverse-rendering demo: recover vertex "
                            "colors from a target image")
    f.add_argument("-w", "--width", type=int, default=64)
    f.add_argument("--steps", type=int, default=200)
    f.add_argument("--lr", type=float, default=2e-2)
    f.add_argument("-o", "--out-prefix", default="fit")
    f.add_argument("--checkpoint-dir", default=None)
    f.set_defaults(fn=_cmd_fit)
    return p


def _save_float_image(path: str, img) -> None:
    """(H, W, 4) float RGBA in [0, 1], row 0 = bottom -> an 8-bit PNG."""
    import numpy as np

    from .utils import image

    arr = np.clip(img.detach().cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
    image.write_png_rgba(path, arr[::-1])


def _cmd_fit(args) -> int:
    import torch

    from .core.device import resolve_device
    from .diff import binning as dbin
    from .diff import optim, pipeline
    from .models import scenes

    device = resolve_device(args.device)
    size = args.width
    params, indices = scenes.triangle()
    params = {k: torch.from_numpy(v).to(device) for k, v in params.items()}
    cfg = pipeline.DiffRenderConfig(width=size, height=size, tile_logsize=4)
    static = {k: torch.from_numpy(v).to(device) for k, v in dbin.bin_static(
        params["pos"].cpu().numpy(), indices, size, size,
        tile_logsize=4).items()}

    # ground truth: recolored triangle
    truth = dict(params)
    truth["color"] = params["color"] * torch.tensor(
        [[0.2, 0.9, 0.4, 1.0]], device=device)
    target = pipeline.render_cropped(truth, static, cfg)

    start = {"color": params["color"] * 0.5}

    def loss_fn(p, static, target):
        img = pipeline.render_cropped({**params, **p}, static, cfg)
        return torch.mean((img - target) ** 2)

    def save(img, name):
        _save_float_image(f"{args.out_prefix}_{name}.png", img)

    save(target, "target")
    with torch.no_grad():
        save(pipeline.render_cropped({**params, **start}, static, cfg),
             "before")

    res = optim.fit(loss_fn, start, static, target, steps=args.steps,
                    lr=args.lr, checkpoint_dir=args.checkpoint_dir)
    with torch.no_grad():
        save(pipeline.render_cropped({**params, **res.params}, static, cfg),
             "after")
    print(json.dumps({
        "loss_first": res.losses[0] if res.losses else None,
        "loss_last": res.losses[-1] if res.losses else None,
        "bad_steps": res.bad_steps,
        "resumed_from": res.resumed_from,
        "outputs": [f"{args.out_prefix}_{n}.png"
                    for n in ("target", "before", "after")],
    }))
    return 0


def _cmd_rt(args) -> int:
    import numpy as np

    from .models import scenes as scn
    from .rt import tracer

    if args.scene == "sphere-field":
        verts, faces, colors = scn.sphere_field(copies=9, subdiv=5)
        scene = tracer.RTScene(verts=verts, faces=faces, colors=colors,
                               reflectivity=0.35)
        cam = tracer.Camera(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0),
                            fov_y_deg=55.0)
        return _run_rt(args, scene, cam)
    verts, faces = scn.icosphere(subdiv=3)
    colors = np.tile(np.array([[0.8, 0.3, 0.25, 1.0]], np.float32),
                     (verts.shape[0], 1))
    if args.scene == "sphere-plane":
        pv, pf = scn.mesh_grid_plane(n=8, y=-1.0, half=4.0)
        pc = np.tile(np.array([[0.55, 0.6, 0.65, 1.0]], np.float32),
                     (pv.shape[0], 1))
        faces = np.concatenate([faces, pf + verts.shape[0]])
        verts = np.concatenate([verts, pv])
        colors = np.concatenate([colors, pc])

    scene = tracer.RTScene(verts=verts.astype(np.float32),
                           faces=faces.astype(np.int32),
                           colors=colors, reflectivity=0.3)
    cam = tracer.Camera(eye=(0.0, 0.6, 3.2), look_at=(0.0, -0.1, 0.0))
    return _run_rt(args, scene, cam)


def _run_rt(args, scene, cam) -> int:
    from .utils import tracing

    if not args.spans:
        return _render_rt(args, scene, cam)
    tracing.reset_stages()
    with tracing.enable():
        rc = _render_rt(args, scene, cam)
    tracing.export_chrome_trace(args.spans)
    print(f"wrote {args.spans}")
    return rc


def _render_rt(args, scene, cam) -> int:
    from .core.device import resolve_device, synchronize
    from .rt import tracer

    device = resolve_device(args.device)
    cfg = tracer.RTConfig(width=args.width, height=args.height,
                          bounces=args.bounces,
                          shadows=not args.no_shadows, engine=args.engine,
                          background=(0.05, 0.07, 0.1, 1.0))
    t0 = time.perf_counter()
    frame, (o, d) = tracer.make_frame_fn(scene, cam, cfg, device=device)
    img = frame(o, d)
    synchronize(device)
    dt = time.perf_counter() - t0
    img = frame(o, d)             # steady state: the prepared frame alone
    synchronize(device)
    dt2 = time.perf_counter() - t0 - dt
    rays = args.width * args.height * (
        1 + (1 if cfg.shadows else 0) + args.bounces)
    print(f"rendered in {dt*1e3:.1f} ms (incl. setup); steady-state "
          f"{dt2*1e3:.1f} ms/frame, ~{rays/1e6:.2f}M rays/frame")

    _save_float_image(args.output, img)
    print(f"wrote {args.output}")
    return 0


def _cmd_scale(args) -> int:
    from .parallel import scaling

    results = scaling.measure(size=args.width, iters=args.iters,
                              device=args.device)
    print(json.dumps({str(k): v for k, v in results.items()}, indent=1))
    if args.artifact:
        # BENCH_r*.json-shaped lines (one per mesh size): vs_baseline is
        # scaling efficiency vs the 1-rank arm
        with open(args.artifact, "a") as f:
            for n, r in results.items():
                f.write(json.dumps({
                    "metric": f"train_step_{args.width}x{args.width}"
                              f"_mesh{n}",
                    "value": round(r["ms"], 3),
                    "unit": "ms/step",
                    "vs_baseline": round(r["efficiency"], 3),
                }) + "\n")
        print(f"wrote {args.artifact}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
