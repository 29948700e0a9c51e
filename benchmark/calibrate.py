"""Readings that the limits in benchmark/limits/ are set from; the
benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 \
        [--control-seeds 4 5 6] [--device cuda]

For each of ``--seeds`` it sets the program up as a run does, renders one
frame after a warm-up one, and prints the numbers the check compares (the
program's readings: the lower end of a limit), and beside them the same
numbers for two faults planted in that image (half of the rays left out,
one 32 x 32 tile's colours altered).  For each of ``--control-seeds`` it
prints the numbers of the control: the plain reference computed in
bfloat16, the precision below the configuration's float32, in the
program's place (the upper end).  One JSON line a reading.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from benchmark import compare, harness  # noqa: E402

#: the precision one below the configuration's: bfloat16 for a float32
#: computation that runs no TF32 matrix product
CONTROL_DTYPE = {"float32": torch.bfloat16}


def half_left_out(img, background):
    """The image with the upper half of its rows never traced."""
    out = img.clone()
    out[img.shape[0] // 2:] = torch.as_tensor(background, dtype=img.dtype,
                                              device=img.device)
    return out


def tile_altered(img, tile=32):
    """The image with one tile's colours inverted (the tile at the middle of
    the image, where the scene is)."""
    out = img.clone()
    y, x = img.shape[0] // 2, img.shape[1] // 2
    out[y:y + tile, x:x + tile, :3] = 1.0 - out[y:y + tile, x:x + tile, :3]
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    r = harness.resolve(args.workload)
    entry = r["entry"]
    device = torch.device(args.device)
    bg = r["config"]["shading"]["background"]

    def emit(**kw):
        print(json.dumps({"workload": args.workload, **kw}), flush=True)

    for seed in args.seeds:
        cell = entry.setup(r["config"], r["traffic"], seed, device)
        cell.step()
        img = cell.step()
        cell.release()
        gc.collect()
        t0 = time.perf_counter()
        want, _ = entry.reference(r["config"], r["traffic"], cell.inputs,
                                  device)
        ref_s = time.perf_counter() - t0
        emit(seed=seed, side="program", ref_s=ref_s,
             **compare.image_numbers(img, want))
        emit(seed=seed, side="fault_half_left_out",
             **compare.image_numbers(half_left_out(img, bg), want))
        emit(seed=seed, side="fault_tile_altered",
             **compare.image_numbers(tile_altered(img), want))
        del cell, img, want
        gc.collect()
    dtype = CONTROL_DTYPE[r["config"]["precision"]]
    for seed in args.control_seeds:
        inputs = entry.make_inputs(r["config"], seed)
        want, _ = entry.reference(r["config"], r["traffic"], inputs, device)
        t0 = time.perf_counter()
        low, _ = entry.reference(r["config"], r["traffic"], inputs, device,
                                 dtype)
        emit(seed=seed, side="control", dtype=str(dtype),
             control_s=time.perf_counter() - t0,
             **compare.image_numbers(low, want))
        del inputs, want, low
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
