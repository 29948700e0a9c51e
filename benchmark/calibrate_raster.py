"""Readings that the exact-integer raster cell's limits in benchmark/limits/
are set from; the benchmark's own runs never run this.

    python3 benchmark/calibrate_raster.py --workload synth_draw3d.raster_256 \
        --seeds 1 2 3 [--control-seeds 4 5 6] [--frames 20] [--device cuda]

benchmark/calibrate.py reads the ray-traced entries' keys (a float image,
the shading's background, the reference's rays), so the raster entry, whose
step gives 32-bit ARGB words, brings this script of its own.  For each of
``--seeds`` it sets the program up as a run does, runs
harness.WARMUP_ITERS frames, keeps the next frame's output and the output
of the ``--frames``-th after it (the first and the last output the check
compares), and prints for each the numbers the check compares (the
program's readings: the lower end of a limit).  Beside them it prints
those of four faults, each against the same reference frame: one 32 x 32
tile at the frame's middle with its colours inverted (planted in the
output), and three frames of the program on a trace that a fault has
changed: the blended draw left out, point filtering in place of bilinear,
and the stencil draw's zpass op ignored (KEEP in its register).  For each
of ``--control-seeds`` it prints the numbers of the control: the plain
reference with its interpolation, texel weights and blend in float32, the
precision below the configuration's exact integers (the upper end).  One
JSON line a reading.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.entries import raster_frame  # noqa: E402

#: the trace's enums that the faults set (cocogfx CGLTrace)
FILTER_NEAREST = 1
STENCIL_KEEP = 0


def tile_inverted(out, tile=32):
    """The frame with one tile's colours inverted, alpha kept (the tile at
    the middle of the frame, where the scene is)."""
    bad = out.clone()
    y, x = out.shape[0] // 2, out.shape[1] // 2
    bad[y:y + tile, x:x + tile] ^= 0x00FFFFFF
    return bad


def _drop_blended(trace):
    trace.drawcalls = [d for d in trace.drawcalls
                       if not d.states.blend_enabled]
    return trace


def _restate(trace, keep, **states):
    """``trace`` with ``states`` set on the draws that ``keep`` picks."""
    trace.drawcalls = [
        dataclasses.replace(d, states=dataclasses.replace(d.states, **states))
        if keep(d) else d for d in trace.drawcalls]
    return trace


#: name -> what a fault does to the program's trace
TRACE_FAULTS = {
    "fault_blend_draw_left_out": _drop_blended,
    "fault_point_filter": lambda t: _restate(
        t, lambda d: d.states.texture_enabled,
        texture_magfilter=FILTER_NEAREST),
    # the host programs the trace's zfail op into the zpass register
    "fault_stencil_zpass_ignored": lambda t: _restate(
        t, lambda d: d.states.stencil_test, stencil_zfail=STENCIL_KEEP),
}


def fault_frame(cell, fault):
    """The program's frame of the cell's inputs on a trace that ``fault``
    (a TRACE_FAULTS value) changed."""
    from skybox_rt_tpu_torch.ref import driver

    tr = cell.traffic
    trace = fault(raster_frame.program_trace(cell.config, cell.inputs))
    frame, arrays = driver.compile_frame(
        trace, tr["width"], tr["height"], tile_logsize=tr["tile_logsize"],
        mode=tr["mode"], device=cell.device)
    return frame(arrays)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    r = harness.resolve(args.workload)
    entry, config, traffic = r["entry"], r["config"], r["traffic"]
    device = torch.device(args.device)

    def emit(**kw):
        print(json.dumps({"workload": args.workload, **kw}), flush=True)

    for seed in args.seeds:
        cell = entry.setup(config, traffic, seed, device)
        for _ in range(harness.WARMUP_ITERS):
            cell.step()
        kept = [cell.step()]
        for _ in range(args.frames):
            out = cell.step()
        kept.append(out)
        t0 = time.perf_counter()
        want = entry.reference(config, traffic, cell.inputs, device)
        reference_s = time.perf_counter() - t0
        for which, out in zip(("first", "last"), kept):
            emit(seed=seed, output=which, side="program",
                 reference_s=reference_s, **entry.frame_numbers(out, want))
            emit(seed=seed, output=which, side="fault_tile_inverted",
                 **entry.frame_numbers(tile_inverted(out), want))
        for name, fault in TRACE_FAULTS.items():
            emit(seed=seed, side=name,
                 **entry.frame_numbers(fault_frame(cell, fault), want))
        cell.release()
        del cell, kept, out
        gc.collect()
    for seed in args.control_seeds:
        inputs = entry.make_inputs(config, seed)
        want = entry.reference(config, traffic, inputs, device)
        t0 = time.perf_counter()
        low = entry.reference(config, traffic, inputs, device, control=True)
        emit(seed=seed, side="control", dtype="float32",
             control_s=time.perf_counter() - t0,
             **entry.frame_numbers(low, want))
    return 0


if __name__ == "__main__":
    sys.exit(main())
