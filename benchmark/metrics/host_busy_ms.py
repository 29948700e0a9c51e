"""Host milliseconds a frame inside the stage ``rt.frame`` less its
``rt.sync`` stages (the bounces' ``.item()``), over the device stretch:
the first harness.STRETCH_ITERS frames of the program's span buffer
(``skybox_rt_tpu_torch.utils.tracing.spans``), which are the first frames a
profiler records, CUDA activity alone.  The profiler, and the recorder's
own spans, slow the host there against an unprofiled frame (PERF.md §3).

The helpers here serve the other readers of the program's recorder.  A
reader returns None where the buffer holds no frame, or where a stage or
counter that the cell's frame must run never opened, so the run fails
(exit 4) and a renamed or moved span cannot read as a gain.  A program
whose tracing keeps no span buffer (one older than the recorder) cannot
record these numbers; there each reader returns PLACEHOLDER, because
harness.py fails a run whose listed metric reads None."""
from benchmark import harness

#: what a reader returns on a program without the span buffer: no reading
PLACEHOLDER = 0.0


def recorder():
    """The program's tracing module, or None where it has no span buffer."""
    from skybox_rt_tpu_torch.utils import tracing
    return tracing if hasattr(tracing, "spans") else None


def device_stretch(tracing):
    """(the spans of the device stretch's frames, their number of frames)."""
    spans = tracing.spans()
    frames = set(sorted({s["frame"] for s in spans if s["frame"] is not None})
                 [:harness.STRETCH_ITERS])
    return [s for s in spans if s["frame"] in frames], len(frames)


def host_ms(spans, name):
    """Host ms of the spans ``name``; None where none opened."""
    ns = [s["end_ns"] - s["start_ns"] for s in spans if s["name"] == name]
    return sum(ns) / 1e6 if ns else None


def read(ctx):
    tracing = recorder()
    if tracing is None:
        return PLACEHOLDER
    spans, n = device_stretch(tracing)
    frame, sync = host_ms(spans, "rt.frame"), host_ms(spans, "rt.sync")
    if not n or sync is None:
        return None
    return (frame - sync) / n
