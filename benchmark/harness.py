"""One run of one cell: set-up, a closed loop of iterations for the window,
the check against the plain reference, and the result line.

Everything about a cell is found by name under the benchmark's folder:

  BENCHMARK.json              the cells, their configurations and metrics
  <config file>               sizes of a configuration; its ``entry`` names
                              benchmark/entries/<entry>.py, which builds the
                              program's iteration and the reference check
  traffic/<traffic>.json      the traffic mix's parameters
  limits/<workload>.json      the limit of each number the check compares
  metrics/<metric>.py         a metric's reader: read(ctx)

The loop has one client: an iteration is one call of the entry's ``step``
followed by a synchronize, and the next starts when it returns.
``--trace 0`` reports the end-to-end metrics; ``--trace 1`` runs the same
loop and reports the per-layer ones, read from three stretches of the
window, one after the other:

  plain   PLAIN_ITERS iterations before any profiler has run in the
          process, timed by the host clock alone: the wall time of an
          iteration that no profiler slows
  device  STRETCH_ITERS iterations under torch.profiler recording CUDA
          activity alone; the metrics read its device operations
  host    STRETCH_ITERS iterations recording host operations too; only the
          breakdown's idle gaps read it

A run fails (exit 4, no result) where a metric that the cell lists reads
nothing, or where the traced stretch holds no launch of a kernel that the
configuration's ``required_kernels`` names.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: iterations of the cell's own shape run in set-up, before the window
WARMUP_ITERS = 3
#: iterations of the window before the first stretch starts
STRETCH_START = 3
#: iterations of the unprofiled stretch: a quarter second or more of wall
PLAIN_ITERS = 100
#: iterations each profiled stretch holds
STRETCH_ITERS = 20


def parse_args(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def resolve(workload: str, root: str = ROOT) -> dict:
    """The spec, cell, configuration, traffic, limits and entry module of
    ``workload``, found by name under ``root``."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = _json(os.path.join(root, config_entry["file"]))
    bench = os.path.join(root, "benchmark")
    return {
        "spec": spec, "cell": cell, "config": config,
        "traffic": _json(os.path.join(bench, "traffic",
                                      cell["traffic"] + ".json")),
        "limits": _json(os.path.join(bench, "limits", workload + ".json")),
        "entry": importlib.import_module(
            f"benchmark.entries.{config['entry']}"),
        "metrics_dir": os.path.join(bench, "metrics"),
    }


def cell_metrics(spec: dict, workload: str, group: str) -> list:
    """The metrics of ``group`` ("end_to_end" or "per_layer") that
    ``workload`` reports."""
    return [m for m in spec[group]
            if workload in m.get("workloads", [workload])]


def load_reader(metrics_dir: str, name: str):
    path = os.path.join(metrics_dir, name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


class Context:
    """What a metric's reader may read: the window's iteration latencies
    (``lat``, seconds), its wall time (``window_s``) and ``setup_s``; the
    device stretch (``trace``, a profiling.Trace, None without a device
    trace) and the plain stretch's seconds an iteration (``plain_iter_s``);
    the entry cell's ``prepare_s`` and ``info``; the device fields
    (``device``)."""

    def __init__(self, lat, window_s, setup_s, trace, prepare_s, info,
                 device, plain_iter_s=None):
        self.lat, self.window_s, self.setup_s = lat, window_s, setup_s
        self.trace, self.prepare_s = trace, prepare_s
        self.info, self.device = info, device
        self.plain_iter_s = plain_iter_s


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiler(host: bool):
    """A profiler of device activity, and of host operations with ``host``."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    # each stretch is a profiler run of its own
    warnings.filterwarnings("ignore", message="Profiler clears events")
    return profile(activities=[ProfilerActivity.CUDA]
                   + ([ProfilerActivity.CPU] if host else []))


def run(args, root: str = ROOT, device=None, t_start=None):
    """One run; returns (exit code, result dict or None).  ``device`` None
    means the CUDA card, and the run refuses to go on without enough of
    them; the CPU tests pass a CPU device."""
    import torch

    from . import nojax, peaks, profiling

    t_start = time.perf_counter() if t_start is None else t_start
    found = nojax.source_findings()
    if found:
        print(f"benchmark sources import forbidden modules: {found}",
              file=sys.stderr)
        return 2, None
    r = resolve(args.workload, root)
    chips = r["cell"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print(f"needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 1, None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    traced = bool(args.trace) and on_card

    cell = r["entry"].setup(r["config"], r["traffic"], args.seed, device)
    for _ in range(WARMUP_ITERS):
        cell.step()
        _sync(device)
    gc.collect()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    # (kind, iterations) of each stretch, back to back from STRETCH_START
    plan = [("plain", PLAIN_ITERS), ("device", STRETCH_ITERS),
            ("host", STRETCH_ITERS)] if traced else []
    lat, outputs, done = [], [], {}
    open_until = None
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    while True:
        if open_until is None and len(done) < len(plan) and \
                len(lat) == STRETCH_START + sum(n for _, n in
                                                plan[:len(done)]):
            kind, n = plan[len(done)]
            prof = None if kind == "plain" else _profiler(kind == "host")
            if prof is not None:
                prof.__enter__()
            open_until, s0 = len(lat) + n, time.perf_counter()
        a = time.perf_counter()
        out = cell.step()
        _sync(device)
        b = time.perf_counter()
        lat.append(b - a)
        if len(lat) == open_until:
            if prof is not None:
                prof.__exit__(None, None, None)
            done[kind] = (b - s0 if prof is None else
                          profiling.from_profiler(prof, n, b - s0))
            open_until = None
        if not outputs:
            outputs.append(out)
        if b >= deadline and len(done) == len(plan):
            break
    trace, host_trace = done.get("device"), done.get("host")
    plain_iter_s = done["plain"] / PLAIN_ITERS if traced else None
    window_s = b - t0
    outputs.append(out)
    del out

    dev = {"platform": "gpu" if on_card else device.type,
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": chips,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if on_card else 0)}
    if on_card:
        dev.update(peaks.smi())
    if trace is not None:
        dev["busy_s"] = profiling.busy_us(trace.device_ops) / 1e6
        dev["window_s"] = trace.wall_s

    cell.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = cell.check(outputs)
    del outputs
    checks = {k: {"value": v, "limit": r["limits"][k]}
              for k, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    ctx = Context(lat, window_s, setup_s, trace, cell.prepare_s, cell.info,
                  dev, plain_iter_s)
    group = "per_layer" if args.trace else "end_to_end"
    metrics, missing = {}, []
    for m in cell_metrics(r["spec"], args.workload, group):
        value = load_reader(r["metrics_dir"], m["name"]).read(ctx)
        if value is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace is not None:
        missing += [f"a launch of {k}" for k in
                    r["config"].get("required_kernels", ())
                    if not any(k in n for n, _, _ in trace.device_ops)]
    if missing:
        print(f"the cell's run read nothing for: {', '.join(missing)}",
              file=sys.stderr)
        return 4, None

    line = {"correct": correct, "attempted": len(lat),
            "failed": 0 if correct else len(lat), "metrics": metrics,
            "device": dev,
            # mean iteration of each quarter of the window: shows a warm-up
            # or a drift inside it
            "window_quarters_ms": _quarters_ms(lat)}
    if trace is not None:
        line["breakdown"] = {
            "device_ops": profiling.top(profiling.by_name(trace.device_ops)),
            "idle_gaps": profiling.top(profiling.idle_gaps(host_trace))}
    line["checks"] = checks

    bad = nojax.loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3, None
    return 0, line


def _quarters_ms(lat):
    n = len(lat)
    cuts = [n * k // 4 for k in range(5)]
    return [sum(lat[a:b]) / (b - a) * 1e3 if b > a else None
            for a, b in zip(cuts, cuts[1:])]


def main(argv=None, t_start=None):
    args = parse_args(argv)
    rc, line = run(args, t_start=t_start)
    if line is None:
        return rc
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return rc
