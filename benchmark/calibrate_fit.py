"""Readings that the training cell's limits in benchmark/limits/ are set
from; the benchmark's own runs never run this.

    python3 benchmark/calibrate_fit.py --workload icosphere_train.fit100_1024 \
        --seeds 1 2 3 [--control-seeds 4 5 6] [--steps 60] [--device cuda]

benchmark/calibrate.py reads the ray-traced entries' keys (the shading's
background, a step's image, the reference's rays), so a training entry,
whose step gives parameters, an image, a loss and gradients, brings this
script of its own.  For each seed it sets the program up as a run does,
runs harness.WARMUP_ITERS steps, keeps the next step's output and the
output of the ``--steps``-th after it (the first and the last output the
check compares).  For each of ``--seeds`` it prints for each output the
numbers the check compares (the program's readings: the lower end of a
limit), the update's error alone (fit_step.update_error) and the same
error with the reference's gradients in the program's place, the number of
rows whose allowance the rounding probe widens past GRAD_TOL
(fit_step.probe_moves), and beside them those of three faults planted in
that output: the texture's gradient zeroed, one 32 x 32 tile of the image
at its middle with its colours inverted, and the state left unchanged (the
optimizer's step skipped).  For each of ``--control-seeds`` it prints, for
both outputs, the numbers of the control: the plain reference computed in
bfloat16, the precision below the configuration's float32, and one Adam
step of its gradients in bfloat16, in the program's place, from the
output's starting parameters and moments (the upper end).  One JSON line a
reading.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from benchmark import calibrate, harness  # noqa: E402
from benchmark.entries import fit_step  # noqa: E402


def grad_zeroed(out, name="tex"):
    return {**out, "grads": {**out["grads"],
                             name: torch.zeros_like(out["grads"][name])}}


def tile_altered(out):
    return {**out, "image": calibrate.tile_altered(out["image"])}


def state_unchanged(out, shapes):
    """The output of a step whose optimizer left the parameters as they
    were."""
    n = sum(math.prod(shapes[k]) for k in fit_step.PARAMS)
    return {**out, "after": out["state"][:n].clone()}


def control(out, cell, dtype, entry=fit_step):
    """``out`` with the plain reference in ``dtype`` in the program's place:
    its image, loss and gradients from the output's starting parameters, and
    one Adam step of those gradients in ``dtype``."""
    start, moments, _ = entry.unpack(out, cell.shapes)
    low = entry.reference(cell.config, cell.traffic, cell.inputs["faces"],
                          start, cell.target, dtype)
    opt = cell.config["optimizer"]
    after = []
    for k, t in zip(entry.PARAMS, out["adam_steps"]):
        m, v = moments[k] if moments[k] is not None else (None, None)
        after.append(entry.adam_step(
            start[k].to(dtype), low["grad_" + k],
            None if m is None else m.to(dtype),
            None if v is None else v.to(dtype), int(t or 0),
            entry.learning_rate(cell.config, k), tuple(opt["betas"]),
            opt["eps"]).to(torch.float32).reshape(-1))
    return {**out, "after": torch.cat(after), "image": low["image"],
            "loss": low["loss"], "ok": True,
            "grads": {k: low["grad_" + k] for k in entry.PARAMS}}


def off_rows(out, want, moves, entry=fit_step):
    """Each gradient's rows nearest to their allowance or past it: [row,
    error, probe move] over the largest magnitude, the five worst by error
    less allowance."""
    rows = {}
    for k in entry.PARAMS:
        w = want["grad_" + k].to(torch.float64)
        scale = float(w.abs().max())
        err = (out["grads"][k].to(torch.float64) - w).abs().reshape(
            -1, w.shape[-1]).amax(1) / scale
        move = moves[k].to(torch.float64) / scale
        excess = err - entry.GRAD_TOL - entry.PROBE_SLACK * move
        worst = torch.argsort(excess, descending=True)[:5].tolist()
        rows[k] = [[i, float(err[i]), float(move[i])] for i in worst]
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    r = harness.resolve(args.workload)
    entry, config, traffic = r["entry"], r["config"], r["traffic"]
    device = torch.device(args.device)

    def emit(**kw):
        print(json.dumps({"workload": args.workload, **kw}), flush=True)

    dtype = calibrate.CONTROL_DTYPE[config["precision"]]
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        cell = entry.setup(config, traffic, seed, device)
        for _ in range(harness.WARMUP_ITERS):
            cell.step()
        kept = [cell.step()]
        for _ in range(args.steps):
            out = cell.step()
        kept.append(out)
        del out
        cell.release()
        gc.collect()
        for which, out in zip(("first", "last"), kept):
            start, moments, after = entry.unpack(out, cell.shapes)
            ref_args = (config, traffic, cell.inputs["faces"], start,
                        cell.target)
            want = entry.reference(*ref_args)
            moves = entry.probe_moves(*ref_args, want)

            def numbers(o):
                return entry.fit_numbers(o, want, moves, cell.target, config,
                                         cell.shapes)
            if seed in args.seeds:
                t0 = time.perf_counter()
                got = cell.numbers(out)
                check_s = time.perf_counter() - t0
                moved = {k: int((entry.PROBE_SLACK * v > entry.GRAD_TOL
                                 * float(want["grad_" + k].abs().max())).sum())
                         for k, v in moves.items()}
                update = {
                    name: entry.update_error(
                        start, moments, out["adam_steps"], grads, after,
                        config)
                    for name, grads in (
                        ("update_err", out["grads"]),
                        ("update_err_ref_grads",
                         {k: want["grad_" + k] for k in entry.PARAMS}))}
                emit(seed=seed, output=which, side="program", check_s=check_s,
                     rows_widened=moved, off_rows=off_rows(out, want, moves),
                     **update, **got)
                for name, fault in (
                        ("fault_tex_grad_zeroed", grad_zeroed),
                        ("fault_tile_altered", tile_altered),
                        ("fault_state_unchanged",
                         lambda o: state_unchanged(o, cell.shapes))):
                    emit(seed=seed, output=which, side=name,
                         **numbers(fault(out)))
            if seed in args.control_seeds:
                t0 = time.perf_counter()
                low = control(out, cell, dtype, entry)
                control_s = time.perf_counter() - t0
                emit(seed=seed, output=which, side="control", dtype=str(dtype),
                     control_s=control_s, **numbers(low))
                del low
        del cell, kept
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
