"""The readers of the program's spans and counters (metrics/bvh_build_s,
host_busy_ms, sync_wait_ms, bounce_ray_use_pct, shade_stream_ms,
compact_stream_ms) on a synthetic record (CPU): each reads its number from
the stage aggregates, the device stretch's frames of the span buffer or
the counters; None where the buffer holds no frame or the stage or
counter it reads never opened, so the run fails; the placeholder on a
program whose tracing keeps no span buffer."""
import pytest

from benchmark import harness
from benchmark.metrics import (bounce_ray_use_pct, bvh_build_s,
                               compact_stream_ms, host_busy_ms,
                               shade_stream_ms, sync_wait_ms)
from skybox_rt_tpu_torch.utils import tracing

READERS = (bvh_build_s, host_busy_ms, sync_wait_ms, bounce_ray_use_pct,
           shade_stream_ms, compact_stream_ms)
FRAME_READERS = (host_busy_ms, sync_wait_ms, shade_stream_ms,
                 compact_stream_ms)
MS = 1_000_000


def _span(name, id_, parent, frame, ms, stream_ms=None):
    return {"name": name, "id": id_, "parent": parent, "frame": frame,
            "start_ns": 0, "end_ns": int(ms * MS), "attrs": {},
            "stream_start_ms": 0.0 if stream_ms is not None else None,
            "stream_ms": stream_ms}


def _buffer(frames, leave_out=()):
    """Frame f (k = f + 1): rt.frame 10 k ms of host, two rt.sync of k ms
    each, rt.shade 3 k ms of stream with a k ms rt.occlusion child,
    rt.compact k / 2 ms of stream; a prepare span outside the frames."""
    out = [_span("rt.prepare", 10_000, None, None, 99.0)]
    for f in range(frames):
        k, i = f + 1, 10 * f
        out += [_span("rt.frame", i, None, f, 10.0 * k),
                _span("rt.sync", i + 1, i, f, 1.0 * k),
                _span("rt.sync", i + 2, i, f, 1.0 * k),
                _span("rt.shade", i + 3, i, f, 1.0, 3.0 * k),
                _span("rt.occlusion", i + 4, i + 3, f, 0.5, 1.0 * k),
                _span("rt.compact", i + 5, i, f, 0.4, 0.5 * k)]
    return [s for s in out if s["name"] not in leave_out]


@pytest.fixture
def record(monkeypatch):
    """Installs a buffer of ``frames`` frames, the stage aggregates and
    the counters."""
    def install(frames, counters=None, leave_out=(), bvh_ms=1500.0):
        spans = _buffer(frames, leave_out)
        report = {"rt.frame": {"ms": 1e6, "calls": 1000}}
        if bvh_ms is not None:
            report["rt.prepare.bvh"] = {"ms": bvh_ms, "calls": 1}
        monkeypatch.setattr(tracing, "spans", lambda: spans)
        monkeypatch.setattr(tracing, "stage_report", lambda: report)
        monkeypatch.setattr(tracing, "counter_report",
                            lambda: dict(counters or {}))
    return install


def test_readers_read_the_device_stretch(record):
    # the device stretch, then the host stretch: only the first is read
    record(frames=2 * harness.STRETCH_ITERS,
           counters={"rt.rays_live": 300, "rt.rays_launched": 1200})
    mean_k = (harness.STRETCH_ITERS + 1) / 2
    assert bvh_build_s.read(None) == pytest.approx(1.5)
    assert host_busy_ms.read(None) == pytest.approx(8.0 * mean_k)
    assert sync_wait_ms.read(None) == pytest.approx(2.0 * mean_k)
    assert bounce_ray_use_pct.read(None) == pytest.approx(25.0)
    assert shade_stream_ms.read(None) == pytest.approx(2.0 * mean_k)
    assert compact_stream_ms.read(None) == pytest.approx(0.5 * mean_k)


@pytest.mark.parametrize("reader", FRAME_READERS, ids=lambda m: m.__name__)
def test_no_recorded_frame_reads_none(record, reader):
    record(frames=0)
    assert reader.read(None) is None


@pytest.mark.parametrize("reader, leave_out", [
    (bvh_build_s, None),
    (host_busy_ms, ("rt.sync",)),
    (sync_wait_ms, ("rt.sync",)),
    (bounce_ray_use_pct, None),
    (shade_stream_ms, ("rt.shade",)),
    (shade_stream_ms, ("rt.occlusion",)),
    (compact_stream_ms, ("rt.compact",)),
], ids=lambda v: getattr(v, "__name__", str(v)))
def test_a_stage_or_counter_never_opened_reads_none(record, reader,
                                                    leave_out):
    """A renamed or moved span fails the run instead of reading 0."""
    record(frames=3, leave_out=leave_out or (), bvh_ms=None)
    assert reader.read(None) is None


def test_a_span_without_stream_time_reads_none(record, monkeypatch):
    record(frames=3)
    spans = [dict(s, stream_ms=None) for s in tracing.spans()]
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    assert shade_stream_ms.read(None) is None
    assert compact_stream_ms.read(None) is None


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__)
def test_a_program_without_the_span_buffer_reads_the_placeholder(
        monkeypatch, reader):
    monkeypatch.delattr(tracing, "spans")
    assert reader.read(None) == host_busy_ms.PLACEHOLDER


def test_readers_of_the_real_recorder():
    """An empty recorder reads None; frames under enable() are read, the
    frames after it are not."""
    tracing.reset_stages()
    try:
        assert host_busy_ms.read(None) is None
        with tracing.enable():
            with tracing.stage("rt.frame", frame=True):
                with tracing.stage("rt.sync", bounce=1):
                    pass
        with tracing.stage("rt.frame", frame=True):
            with tracing.stage("rt.sync", bounce=1):
                pass
        (frame,) = [s for s in tracing.spans() if s["name"] == "rt.frame"]
        (sync,) = [s for s in tracing.spans() if s["name"] == "rt.sync"]
        assert host_busy_ms.read(None) == pytest.approx(
            (frame["end_ns"] - frame["start_ns"]
             - sync["end_ns"] + sync["start_ns"]) / MS)
        assert sync_wait_ms.read(None) == pytest.approx(
            (sync["end_ns"] - sync["start_ns"]) / MS)
        assert shade_stream_ms.read(None) is None
        assert bvh_build_s.read(None) is None
    finally:
        tracing.reset_stages()
