"""Tracing / profiling — the debug-trace + scope-analyzer analog
(SURVEY §5a/§5c).

Counterpart of skybox_rt_tpu.utils.tracing.  The reference has three
observation layers: --debug=N logs with per-instruction UUIDs
(sim/simx/debug.h, emulator.cpp:191-197), MPM perf counters, and the FPGA
scope analyzer capturing signal windows to VCD (runtime/common/scope.cpp).
Under PyTorch those map to:

  * stage(name, **attrs): the port's one span recorder, in two tiers.
    Always: the stage's host time and calls add to per-name aggregates
    (stage_report) — two clock reads, nothing else.  While tracing is on,
    also: a span record in an in-memory buffer (name, id, parent, frame id,
    host start and end, attributes) and, while a torch profiler records, a
    ``_RecordFunctionFast`` range of the same name on the profiler's clock
    (an ordinary CPU operation, never a user annotation, so no device-typed
    event spans the kernels under it).  A stage made with ``stream=True``,
    and every stage inside ``enable()``, also records a timing CUDA event
    at each end on the current stream where the card is in use.  Tracing
    is on inside ``enable()`` and while any torch profiler records.  A
    stage made with ``frame=True`` opens a new frame id; the buffer keeps
    MAX_FRAMES frames and MAX_LOOSE_SPANS spans outside a frame after it
    was last cleared, and counts the rest (counters
    ``tracing.frames_dropped`` and ``tracing.spans_dropped``).
  * count(name, n): the program's counters
  * spans() / export_chrome_trace(path): the buffer, device-stream times
    resolved with one synchronize; as a Chrome trace, host spans on one
    track and device-stream spans on another
  * profile(logdir): a torch.profiler window that writes a Chrome trace
    into logdir — the scope-analyzer analog (open it in Perfetto or
    chrome://tracing instead of a VCD viewer)
  * trace_log(level, ...): leveled stderr logging gated by
    SKYBOX_DEBUG=N, the --debug=N analog
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
from time import perf_counter_ns

import torch
from torch.autograd import profiler as _autograd_profiler

from ..runtime.perf import PerfCounters

DEBUG_LEVEL = int(os.environ.get("SKYBOX_DEBUG", "0"))
#: frames the span buffer keeps after it was last cleared
MAX_FRAMES = 256
#: spans outside any frame the span buffer keeps after it was last cleared
MAX_LOOSE_SPANS = 4096
#: the frame id inside a frame the buffer does not keep
_DROPPED = -1

# absent from older torch builds: no profiler range is opened there
_RecordFunctionFast = getattr(torch._C._profiler, "_RecordFunctionFast",
                              None)


class _Span:
    __slots__ = ("name", "id", "parent", "frame", "start_ns", "end_ns",
                 "attrs", "events", "stream")

    def as_dict(self) -> dict:
        start_ms, ms = self.stream or (None, None)
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "frame": self.frame, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "attrs": dict(self.attrs),
                "stream_start_ms": start_ms, "stream_ms": ms}


class Recorder:
    """The aggregates, the counters and the span buffer of one process."""

    def __init__(self):
        #: depth of enable()
        self.enabled = 0
        self._local = threading.local()
        #: timing CUDA events free for reuse: a span's return here once
        #: spans() has read them
        self.pool = []
        self.clear()

    def clear(self):
        #: every stage's host ms (``times_ms``) and calls (``counters``,
        #: under the stage's name), beside the program's counters; summed
        #: without a lock, so exact while one thread at a time runs stages
        self.perf = PerfCounters()
        self.buffer = []
        self.loose = 0
        # next() on a count is atomic under the interpreter lock: span and
        # frame ids stay unique across threads
        self.span_ids, self.frame_ids = itertools.count(), itertools.count()
        #: the first CUDA event since the buffer was cleared and its host
        #: clock: the origin of every span's device-stream start
        self.origin = None

    def _thread(self):
        loc = self._local
        if not hasattr(loc, "stack"):
            loc.stack, loc.frame = [], None
        return loc

    def _event(self):
        return (self.pool.pop() if self.pool
                else torch.cuda.Event(enable_timing=True))

    def open(self, name: str, attrs: dict, frame: bool, stream: bool):
        """A span record for a stage opened while tracing is on, with its
        start event where it records events; None inside a frame the buffer
        does not keep, or past MAX_LOOSE_SPANS outside a frame."""
        loc = self._thread()
        if frame:
            loc.frame = next(self.frame_ids)
            if loc.frame >= MAX_FRAMES:
                loc.frame = _DROPPED
                self.perf.count("tracing.frames_dropped")
        if loc.frame == _DROPPED:
            return None
        if loc.frame is None:
            if self.loose >= MAX_LOOSE_SPANS:
                self.perf.count("tracing.spans_dropped")
                return None
            self.loose += 1
        s = _Span()
        s.name, s.attrs, s.frame = name, attrs, loc.frame
        s.id = next(self.span_ids)
        s.parent = loc.stack[-1].id if loc.stack else None
        s.events = s.stream = None
        loc.stack.append(s)
        self.buffer.append(s)
        if (stream or self.enabled) and torch.cuda.is_initialized():
            # both ends on the stream current at the start
            cuda_stream = torch.cuda.current_stream()
            ev = self._event()
            ev.record(cuda_stream)
            if self.origin is None:
                self.origin = (ev, perf_counter_ns())
            s.events = (ev, self._event(), cuda_stream)
        return s

    def close(self, s, end_ns: int, frame: bool):
        """Ends the span ``s`` (None where it was not stored) and, for a
        frame stage, the frame."""
        loc = self._thread()
        if frame:
            loc.frame = None
        if s is None:
            return
        s.end_ns = end_ns
        if s.events is not None:
            s.events[1].record(s.events[2])
        loc.stack.pop()

    def resolve(self):
        """Device-stream (start from origin, duration) in ms of every span
        with events; one synchronize, none where all are resolved."""
        pending = [s for s in self.buffer if s.events is not None]
        if not pending:
            return
        torch.cuda.synchronize()
        ref = self.origin[0]
        for s in pending:
            a, b, _ = s.events
            s.stream = (ref.elapsed_time(a), a.elapsed_time(b))
            s.events = None
            if a is not ref:
                self.pool.append(a)
            self.pool.append(b)


_REC = Recorder()


class stage:
    """``with stage(name, **attrs) as attrs:`` a named span of the pipeline.
    Its host time always adds to stage_report(); while tracing is on it is
    also recorded (module docstring).  ``frame=True`` marks the stage that
    opens a frame id; ``stream=True`` a stage whose device-stream time is
    read, so it records its CUDA events whenever tracing is on.  The dict
    it yields is the span's attributes: entries set inside the block are
    kept, so a value known only at the end (a count read back) is recorded
    too.  sync=True waits for the card's queued work before the end is
    read (costs pipelining — keep False in production paths)."""

    __slots__ = ("name", "sync", "frame", "stream", "attrs", "t0", "span",
                 "fast")

    def __init__(self, name: str, sync: bool = False, frame: bool = False,
                 stream: bool = False, **attrs):
        self.name, self.sync, self.attrs = name, sync, attrs
        self.frame, self.stream = frame, stream

    def __enter__(self):
        self.span = self.fast = None
        if _REC.enabled or _autograd_profiler._is_profiler_enabled:
            self._open()
        self.t0 = perf_counter_ns()
        if self.span is not None:
            self.span.start_ns = self.t0
        return self.attrs

    def _open(self):
        if _autograd_profiler._is_profiler_enabled and \
                _RecordFunctionFast is not None:
            self.fast = _RecordFunctionFast(self.name)
            self.fast.__enter__()
        self.span = _REC.open(self.name, self.attrs, self.frame, self.stream)

    def __exit__(self, exc_type, exc, tb):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = perf_counter_ns()
        perf = _REC.perf
        perf.times_ms[self.name] += (t1 - self.t0) / 1e6
        perf.counters[self.name] += 1
        if self.span is not None or self.frame:
            _REC.close(self.span, t1, self.frame)
        if self.fast is not None:
            self.fast.__exit__(exc_type, exc, tb)
        if DEBUG_LEVEL >= 2:        # no message is formatted with tracing off
            trace_log(2, f"stage {self.name}: {(t1 - self.t0) / 1e6:.3f} ms")


@contextlib.contextmanager
def enable():
    """Tracing on for the block, profiler or not."""
    _REC.enabled += 1
    try:
        yield
    finally:
        _REC.enabled -= 1


def count(name: str, n=1):
    """Add n to the counter ``name``, a name no stage has (no device read:
    n is a host value)."""
    _REC.perf.count(name, n)


def counter_report() -> dict:
    """The program's counters (count()), without the stages' calls."""
    perf = _REC.perf
    return {k: v for k, v in perf.counters.items() if k not in perf.times_ms}


def stage_report() -> dict:
    """Per-stage accumulated host time (the vx_dump_perf table analog)."""
    perf = _REC.perf
    return {name: {"ms": ms, "calls": perf.counters[name]}
            for name, ms in sorted(perf.times_ms.items())}


def reset_stages():
    """Clear the aggregates, the counters and the span buffer."""
    _REC.clear()


def spans() -> list:
    """The buffer's spans in the order they opened, as dicts: name, id,
    parent (the innermost stage open on the thread), frame (None outside a
    frame), start_ns / end_ns (host perf_counter_ns), attrs, and
    stream_start_ms / stream_ms: where the current stream reached the
    span's start event, from the buffer's first event, and the time between
    its start and end events (None without events).  Resolving waits for
    the card once."""
    _REC.resolve()
    return [s.as_dict() for s in _REC.buffer]


def export_chrome_trace(path: str):
    """Write spans() as a Chrome trace (chrome://tracing, Perfetto): host
    spans on track "host", device-stream spans on track "stream", the
    stream's track placed from the host time of the buffer's first event."""
    out = spans()
    origin_ns = [_REC.origin[1]] if _REC.origin is not None else []
    t_base = min([s["start_ns"] for s in out] + origin_ns, default=0)
    origin_us = (origin_ns[0] - t_base) / 1e3 if origin_ns else 0.0
    events = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
               "args": {"name": track}}
              for tid, track in ((0, "host"), (1, "stream"))]
    for s in out:
        args = {**s["attrs"], "frame": s["frame"], "id": s["id"],
                "parent": s["parent"]}
        events.append({"ph": "X", "name": s["name"], "pid": 0, "tid": 0,
                       "ts": (s["start_ns"] - t_base) / 1e3,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": args})
        if s["stream_ms"] is not None:
            events.append({"ph": "X", "name": s["name"], "pid": 0, "tid": 1,
                           "ts": origin_us + s["stream_start_ms"] * 1e3,
                           "dur": s["stream_ms"] * 1e3, "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"counters": counter_report()}}, f)


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
