"""Time kernel #4 (hard visibility), kernels #10 / #11 (streamed and
worklist closest hit, and the worklist's prepass) and kernel #9 (the flat
closest hit) of one checkout of the port on the card, so that two checkouts
can be compared in turns within one machine.

    python3 scripts/torch_kernel_ab.py [--root DIR] [--lane-switch N ...]

``--root`` is the checkout whose ``skybox_rt_tpu_torch`` and
``chip_smoke.py`` are imported (default: this one); run it for two
checkouts in turns (A, B, B, A) from one command to compare them.  Prints
one JSON line, every number a CUDA-event median of 20 after warm-up
(``*_graph_ms``: one replay of a CUDA graph that holds the launch, without
the wrapper's host work):

  * ``visibility`` — #4 on the 1024x1024 training step's inputs
    (check.train_scene(1024): T = 656 tiles, M = 56), depth test on;
  * ``streamed``   — #10 on each of the six launches of the small scene's
    1024x1024 2-bounce shadowed frame (sphere_field(copies=9, subdiv=3),
    captured from the port's trace_rays; the shadow launches as the
    closest hit inside their bound, as the ``pallas_streamed`` engine runs
    them), their sum, and the ``pallas_streamed`` frame (median of 5);
  * ``worklist``   — #11 on the primary launch, its lists made once; the
    prepass (``active_block_lists``) alone on the primary launch and on
    bounce 1 (``prepass_graph_ms`` only where the prepass is a kernel); the
    ``pallas_worklist`` frame (median of 5);
  * ``flat``       — #9 on the primary launch (1,048,576 rays sharing the
    camera's origin; median of 5) and on 65,536 rays of bounce 1 (origins
    that differ; chip_smoke.sample_launch).

``--lane-switch N ...`` (a checkout whose ops.cuda_rt has
STREAM_LANE_SWITCH) adds ``lane_switch``: #10's six launches as graph
replays, and #11's primary, at each value of the module constant, set for
the run and restored.  The line carries the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--lane-switch", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from skybox_rt_tpu_torch.diff import check, cuda_vis, pipeline
    from skybox_rt_tpu_torch.ops import cuda_rt
    from skybox_rt_tpu_torch.rt import tracer

    if not cuda_vis.__file__.startswith(root):
        raise AssertionError(f"imported {cuda_vis.__file__}, not {root}")
    out = {"root": root, "card": cs.nvidia_smi()}

    params, static, cfg = check.train_scene(cs.DIFF_SIZE)
    params, static = check.to_device(params, static, requires_grad=False)
    with torch.no_grad():
        setup = pipeline.prim_setup(params, static["indices"], cfg)
    edges = setup["edges"].contiguous()    # a view of the record, or not
    pids = static["tile_pids"]
    origins = static["tile_xy"] * (1 << cfg.tile_logsize)

    def vis():
        return cuda_vis.visibility_hard(edges, setup["z"], pids, origins,
                                        cfg.tile_logsize, True)

    out["visibility"] = {"T": pids.shape[0], "M": pids.shape[1],
                         "ms": cs.median_ms(vis), "graph_ms": cs.graph_ms(vis)}

    scene, cam = cs.small_scene()
    scene.finalize()
    kw = dict(width=cs.RT_SIZE, height=cs.RT_SIZE, bounces=2, shadows=True)
    _, (o, d) = tracer.make_frame_fn(scene, cam, tracer.RTConfig(**kw))
    from skybox_rt_tpu_torch.rt import bvh as bvh_mod
    from skybox_rt_tpu_torch.rt import intersect
    tri = intersect.triangle_arrays(
        torch.as_tensor(scene.verts, device=o.device),
        torch.as_tensor(scene.faces, device=o.device).long())
    cl = bvh_mod.build_clusters(scene.bvh, 64)
    clusters = cuda_rt.prepare_clusters(*tri, cl)
    stream = cuda_rt.prepare_stream_blocks(*tri, order=cl["order"])
    launches = cs.capture_launches(
        scene, tracer.RTConfig(**kw),
        lambda o, d: cuda_rt.closest_hit_clustered(o, d, clusters),
        lambda o, d, tm: cuda_rt.any_hit_clustered(o, d, clusters, t_max=tm),
        o, d)
    _, o1, d1, _ = launches[0]
    lists = cuda_rt.active_block_lists(o1, d1, stream)

    def streamed_launch(launch):
        _, lo, ld, tm = launch
        return lambda: cuda_rt.closest_hit_streamed(lo, ld, stream, t_max=tm)

    def worklist():
        return cuda_rt.closest_hit_worklist(o1, d1, stream, lists=lists)

    def six_graph():
        return {n: cs.graph_ms(streamed_launch(la))
                for n, la in zip(cs.LAUNCH_NAMES, launches)}

    s = {"blocks": stream["num_blocks"], "tri_block": stream["tri_block"],
         "ms": {n: cs.median_ms(streamed_launch(la))
                for n, la in zip(cs.LAUNCH_NAMES, launches)},
         "graph_ms": six_graph()}
    s["six_ms"] = sum(s["ms"].values())
    s["six_graph_ms"] = sum(s["graph_ms"].values())
    fn_e, (oe, de) = tracer.make_frame_fn(
        scene, cam, tracer.RTConfig(engine="pallas_streamed", **kw))
    s["frame_ms"] = cs.median_ms(lambda: fn_e(oe, de), reps=5, warmup=1)
    out["streamed"] = s
    _, o2, d2, _ = launches[2]
    kernel_prepass = hasattr(cuda_rt, "active_block_lists_reference")

    def prepass(lo, ld):
        return lambda: cuda_rt.active_block_lists(lo, ld, stream)

    w = {"primary_ms": cs.median_ms(worklist),
         "primary_graph_ms": cs.graph_ms(worklist)}
    for name, (lo, ld) in (("primary", (o1, d1)), ("bounce1", (o2, d2))):
        w[f"prepass_{name}_ms"] = cs.median_ms(prepass(lo, ld))
        w[f"prepass_{name}_graph_ms"] = (cs.graph_ms(prepass(lo, ld))
                                         if kernel_prepass else None)
    fn_w, (ow, dw) = tracer.make_frame_fn(
        scene, cam, tracer.RTConfig(engine="pallas_worklist", **kw))
    w["frame_ms"] = cs.median_ms(lambda: fn_w(ow, dw), reps=5, warmup=1)
    out["worklist"] = w

    flat = cuda_rt.pack_records(*tri)
    os_, ds_, _ = cs.sample_launch("bounce1", launches[2])

    def flat_bounce():
        return cuda_rt.closest_hit_pallas(os_, ds_, flat)

    out["flat"] = {
        "primary_ms": cs.median_ms(
            lambda: cuda_rt.closest_hit_pallas(o1, d1, flat), reps=5,
            warmup=1),
        "bounce1_sample_rays": int(os_.shape[0]),
        "bounce1_sample_ms": cs.median_ms(flat_bounce),
        "bounce1_sample_graph_ms": cs.graph_ms(flat_bounce)}

    if args.lane_switch:
        keep = cuda_rt.STREAM_LANE_SWITCH
        sweep = {}
        try:
            for sw in args.lane_switch:
                cuda_rt.STREAM_LANE_SWITCH = sw
                six = six_graph()
                sweep[sw] = {"streamed_graph_ms": six,
                             "streamed_six_graph_ms": sum(six.values()),
                             "worklist_primary_graph_ms":
                                 cs.graph_ms(worklist)}
        finally:
            cuda_rt.STREAM_LANE_SWITCH = keep
        out["lane_switch"] = {"shipped": keep, "sweep": sweep}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
