"""Tracing / profiling — the debug-trace + scope-analyzer analog
(SURVEY §5a/§5c).

Counterpart of skybox_rt_tpu.utils.tracing.  The reference has three
observation layers: --debug=N logs with per-instruction UUIDs
(sim/simx/debug.h, emulator.cpp:191-197), MPM perf counters, and the FPGA
scope analyzer capturing signal windows to VCD (runtime/common/scope.cpp).
Under PyTorch those map to:

  * stage(name): torch.profiler.record_function + host wall-clock
    accounting — stage names appear as ranges in profiler traces
  * profile(logdir): a torch.profiler window that writes a Chrome trace
    into logdir — the scope-analyzer analog (open it in Perfetto or
    chrome://tracing instead of a VCD viewer)
  * trace_log(level, ...): leveled stderr logging gated by
    SKYBOX_DEBUG=N, the --debug=N analog
"""
from __future__ import annotations

import collections
import contextlib
import os
import sys
import time

import torch

_stage_ms: collections.Counter = collections.Counter()
_stage_calls: collections.Counter = collections.Counter()

DEBUG_LEVEL = int(os.environ.get("SKYBOX_DEBUG", "0"))


@contextlib.contextmanager
def stage(name: str, sync: bool = False):
    """Named pipeline stage: a profiler range that accumulates host wall
    time.  sync=True waits for the card's queued work before the clock is
    read (costs pipelining — keep False in production paths)."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if sync and torch.cuda.is_available():
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3
    _stage_ms[name] += dt
    _stage_calls[name] += 1
    if DEBUG_LEVEL >= 2:        # no message is formatted with tracing off
        trace_log(2, f"stage {name}: {dt:.3f} ms")


def stage_report() -> dict:
    """Per-stage accumulated host time (the vx_dump_perf table analog)."""
    return {
        name: {"ms": _stage_ms[name], "calls": _stage_calls[name]}
        for name in sorted(_stage_ms)
    }


def reset_stages():
    _stage_ms.clear()
    _stage_calls.clear()


@contextlib.contextmanager
def profile(logdir: str):
    """Capture a profiler window (scope-analyzer analog): the host's
    operators and, on the card, its kernels, written as a Chrome trace
    ``<logdir>/trace.json``."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def trace_log(level: int, msg: str, file=None):
    """Leveled debug logging (the DT/DP macro analog, --debug=N)."""
    if DEBUG_LEVEL >= level:
        print(f"[skybox:{level}] {msg}", file=file or sys.stderr)
