"""Where the port's differentiable training step spends its time on the card.

    python3 scripts/torch_diff_profile.py               # needs a CUDA card
    python3 scripts/torch_diff_profile.py --size 512

Builds the training workload of skybox_rt_tpu_torch.diff.check.train_scene
(the subdiv-4 icosphere, 5,120 triangles, hard mode, textured and modulated)
at --size x --size (default 1024) on the default device and prints one JSON
line each for:

  * ``step``     — host-clock and CUDA-event milliseconds of one forward +
                   backward of render_deferred, median of 10 after warm-up,
                   and Mpix/s = size^2 / step;
  * ``profile``  — one step under torch.profiler (CPU + CUDA activities):
                   device-busy milliseconds (sum of device kernel time), its
                   share of the step's host-clock time, the hand-written
                   kernels' part of it (diff_visibility, diff_shade's forward
                   and backward, and the passes of diff_accumulate over its
                   five calls, also pass by pass with their launch counts),
                   the count of
                   device kernels, and the ten largest by summed device time
                   (a first profiled step is thrown away);
  * ``stages``   — CUDA-event milliseconds of the step's stages driven one by
                   one on the step's own tensors: prim_setup, the visibility
                   kernel, the shade forward (shade_slots, assembly, loss),
                   the whole backward, each class of _accumulate_rows (texel,
                   record, vertex tables; inputs captured from a real
                   backward), the one-slot shade's two kernels
                   (diff.cuda_shade), and beside them the plain loop's
                   one-hot product of gather_tile_rows' backward, which the
                   hard mode no longer runs.

If the profiler reports no device time, ``profile`` says so and the stage
timings stand alone.  Every line carries the card's name and power limit.
Timer and card line are chip_smoke.py's.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import median_ms, nvidia_smi  # noqa: E402
from skybox_rt_tpu_torch.diff import (  # noqa: E402
    check, cuda_shade, cuda_texgrad, pipeline)


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


def backward_ms(make_loss, reps=10):
    """Median CUDA-event milliseconds of ``make_loss().backward()``, the
    forward outside the timed span."""
    times = []
    for _ in range(reps + 2):
        loss = make_loss()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        loss.backward()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times[2:]))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_diff_profile: no CUDA device")
    card = nvidia_smi()
    size = args.size
    params, static, cfg = check.train_scene(size)
    params, static = check.to_device(params, static)
    T, M = static["tile_pids"].shape

    def run():
        return check.step(params, static, cfg)

    ev = event_ms(run)
    print(json.dumps({"step": {"event_ms": ev, "host_ms": host_ms(run),
                               "mpix_per_s": size * size / ev / 1e3},
                      "size": size, "tiles": T, "M": M, "card": card}),
          flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profiled_step():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        return prof, wall

    profiled_step()
    prof, wall = profiled_step()
    # device rows only: an operator's row repeats its kernels' time
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    # the accumulation kernel's passes live in the namespace diff_accumulate
    # of csrc/diff_accumulate.cu: diff_accumulate::count_kernel(...), ...
    ours = {name: sum(ms for k, ms, _ in rows if part in k)
            for name, part in (("diff_visibility", "diff_visibility_kernel"),
                               ("diff_shade_forward",
                                "diff_shade_forward_kernel"),
                               ("diff_shade_backward",
                                "diff_shade_backward_kernel"),
                               ("diff_accumulate", "diff_accumulate::"))}
    passes = {}
    for k, ms, n in rows:
        m = re.search(r"diff_accumulate::(\w+)", k)
        if m:
            ms0, n0 = passes.get(m.group(1), (0.0, 0))
            passes[m.group(1)] = (ms0 + ms, n0 + n)
    print(json.dumps({"profile": {
        "device_time_seen": bool(rows), "step_host_ms_under_profiler": wall,
        "device_busy_ms": busy, "device_busy_share": busy / wall,
        "our_kernels_ms": ours, "other_kernels_ms": busy - sum(ours.values()),
        "diff_accumulate_passes": {k: {"ms": ms, "count": n}
                                   for k, (ms, n) in sorted(passes.items())},
        "device_kernels": int(sum(r[2] for r in rows)),
        "top": [{"name": k[:60], "ms": ms, "count": n}
                for k, ms, n in rows[:10]]}, "card": card}), flush=True)

    # the stages one by one, on the step's own tensors
    origins = static["tile_xy"] * (1 << cfg.tile_logsize)
    with torch.no_grad():
        setup0 = pipeline.prim_setup(params, static["indices"], cfg)
        slot_steps, _ = pipeline.visibility_slots(
            setup0, static["tile_pids"], origins, cfg)

    def setup_only():
        with torch.no_grad():
            return pipeline.prim_setup(params, static["indices"], cfg)

    def shade_loss():
        setup = pipeline.prim_setup(params, static["indices"], cfg)
        tiles = pipeline.shade_slots(setup, static["tile_pids"], slot_steps,
                                     origins, cfg)
        return check.loss_of(pipeline._assemble(tiles, static["tile_xy"],
                                                cfg), cfg)

    def step_loss():
        for p in params.values():
            p.grad = None
        img, _ = pipeline.render_deferred(params, static, cfg)
        return check.loss_of(img, cfg)

    captured = {}
    real_accumulate = pipeline._accumulate_rows

    def recording(idx, val, num_rows):
        name = {16: "texel", 27: "record", 4: "vertex"}.get(val.shape[1])
        if name and name not in captured:
            captured[name] = (idx.detach().clone(), val.detach().clone(),
                              num_rows)
        return real_accumulate(idx, val, num_rows)

    pipeline._accumulate_rows = recording
    try:
        run()
    finally:
        pipeline._accumulate_rows = real_accumulate

    rec_tile = torch.randn((T, M, 27), device=origins.device,
                           requires_grad=True)
    picked = pipeline.gather_tile_rows(rec_tile, slot_steps[..., 0]
                                       .clamp(min=0))
    g = torch.randn_like(picked)
    P = setup0["edges"].shape[0]
    shade_args = (
        torch.cat([setup0["edges"].reshape(P, 9),
                   setup0["color"].reshape(P, 12),
                   setup0["uv"].reshape(P, 6)], 1),
        pipeline._quad_texture(params["tex"].detach()), static["tile_pids"],
        slot_steps[..., 0].contiguous(), origins.to(torch.int32))
    g_tiles = torch.randn((*slot_steps.shape[:3], 4), device=origins.device)

    stages = {
        "prim_setup_forward": event_ms(setup_only),
        "visibility_kernel": event_ms(lambda: pipeline.visibility_slots(
            setup0, static["tile_pids"], origins, cfg)),
        "setup_shade_assemble_loss_forward": event_ms(shade_loss),
        "whole_forward": event_ms(step_loss),
        "whole_backward": backward_ms(step_loss),
        "shade_forward_kernel": event_ms(lambda: cuda_shade.shade_forward(
            *shade_args, cfg.tile_logsize, cfg.modulate, cfg.background)),
        "shade_backward_kernel": event_ms(lambda: cuda_shade.shade_backward(
            *shade_args, g_tiles, cfg.tile_logsize, cfg.modulate)),
        "plain_onehot_product_backward": event_ms(
            lambda: picked.backward(g, retain_graph=True)),
    }
    for name, (idx, val, R) in sorted(captured.items()):
        stages[f"accumulate_{name}"] = {
            "N": idx.numel(), "R": R, "C": val.shape[1],
            "ms": event_ms(lambda: cuda_texgrad.accumulate_rows(idx, val, R))}
    print(json.dumps({"stages": stages, "size": size, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
