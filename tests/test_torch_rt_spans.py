"""The ray-traced frame's spans and counters (``utils.tracing`` stages in
``rt/tracer``), on the CPU with both intersector families forced: the
BVH-block engine (``pallas_bvh``) and the clustered one (``pallas`` under
15,000 triangles), each running its kernels' plain versions.

Tracing off leaves the span buffer empty and only the aggregates count;
``tracing.enable()`` or a recording torch profiler stores each frame's
span tree under one frame id; the live-ray counter matches a count made
without the tracer; the image is the same bit for bit either way; the
profiler's ranges are plain CPU operations, never user annotations.  The
``cuda`` test checks on the card that no device event carries a span.
"""
import json

import pytest
import torch

from skybox_rt_tpu_torch import cli
from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.rt import intersect, tracer
from skybox_rt_tpu_torch.utils import tracing

torch.set_num_threads(1)

ENGINES = ("pallas_bvh", "pallas")
W, H = 48, 40
FRAME_CHILDREN = {"rt.closest", "rt.shade", "rt.accumulate", "rt.sync",
                  "rt.compact", "rt.unsort"}
#: the stages whose device-stream time the benchmark reads
STREAM_STAGES = {"rt.shade", "rt.occlusion", "rt.compact"}
PREPARE_CHILDREN = {"rt.prepare.bvh", "rt.prepare.engine",
                    "rt.prepare.shade_arrays", "rt.prepare.rays"}


def _scene():
    verts, faces, colors = scenes.sphere_field(copies=4, subdiv=1)
    return tracer.RTScene(verts=verts, faces=faces, colors=colors,
                          reflectivity=0.35)


CAM = tracer.Camera(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0),
                    fov_y_deg=55.0)


def _cfg(engine, bounces=2):
    return tracer.RTConfig(width=W, height=H, bounces=bounces, shadows=True,
                           engine=engine)


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracing.reset_stages()
    yield
    tracing.reset_stages()


@pytest.fixture(scope="module", params=ENGINES)
def prepared(request):
    """(engine, frame, o, d) of a 2-bounce frame, prepared once."""
    frame, (o, d) = tracer.make_frame_fn(_scene(), CAM, _cfg(request.param),
                                         device="cpu")
    return request.param, frame, o, d


def test_tracing_off_counts_only_the_aggregates(prepared):
    _, frame, o, d = prepared
    for _ in range(2):
        frame(o, d)
    assert tracing.spans() == []
    report = tracing.stage_report()
    assert report["rt.frame"]["calls"] == 2
    assert report["rt.sync"]["calls"] == 2 * 2
    assert report["rt.frame"]["ms"] > report["rt.sync"]["ms"] > 0
    assert set(tracing.counter_report()) == {"rt.rays_live",
                                             "rt.rays_launched"}


def _check_frame(spans, frame_id, bounces):
    mine = [s for s in spans if s["frame"] == frame_id]
    top = [s for s in mine if s["name"] == "rt.frame"]
    assert len(top) == 1 and top[0]["parent"] is None
    by_id = {s["id"]: s for s in mine}
    names = [s["name"] for s in mine]
    for name in ("rt.closest", "rt.shade", "rt.occlusion", "rt.accumulate"):
        assert names.count(name) == 1 + bounces, name
        assert sorted(s["attrs"]["bounce"] for s in mine
                      if s["name"] == name) == list(range(bounces + 1))
    for name in ("rt.compact", "rt.sync"):
        assert names.count(name) == bounces, name
    assert names.count("rt.unsort") == 1
    for s in mine:
        if s["name"] in FRAME_CHILDREN:
            assert s["parent"] == top[0]["id"], s
        elif s["name"] == "rt.occlusion":
            shade = by_id[s["parent"]]
            assert shade["name"] == "rt.shade"
            assert shade["attrs"]["bounce"] == s["attrs"]["bounce"]
        else:
            assert s["name"] == "rt.frame"
        assert top[0]["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= top[0]["end_ns"]
    widths = {s["attrs"]["bounce"]: s["attrs"]["width"] for s in mine
              if s["name"] == "rt.closest"}
    assert widths[0] == W * H
    live = [s["attrs"]["live"] for s in mine if s["name"] == "rt.sync"]
    assert all(0 <= n <= W * H for n in live)
    return live, [widths[b] for b in range(1, bounces + 1)]


@pytest.mark.parametrize("engine", ENGINES)
def test_enable_records_each_frames_span_tree(engine):
    scene, cfg = _scene(), _cfg(engine)
    with tracing.enable():
        frame, (o, d) = tracer.make_frame_fn(scene, CAM, cfg, device="cpu")
        for _ in range(2):
            frame(o, d)
    frame(o, d)                     # off again: aggregated, not stored
    spans = tracing.spans()
    prepare = [s for s in spans if s["frame"] is None]
    root = [s for s in prepare if s["name"] == "rt.prepare"]
    assert len(root) == 1 and root[0]["parent"] is None
    assert root[0]["attrs"] == {"engine": engine,
                                "triangles": len(scene.faces)}
    assert {s["name"] for s in prepare} == PREPARE_CHILDREN | {"rt.prepare"}
    assert all(s["parent"] == root[0]["id"] for s in prepare
               if s["name"] in PREPARE_CHILDREN)
    assert {s["frame"] for s in spans} == {None, 0, 1}
    live, widths = zip(*(_check_frame(spans, f, cfg.bounces)
                         for f in (0, 1)))
    assert live[0] == live[1] and widths[0] == widths[1]
    counters = tracing.counter_report()
    assert counters["rt.rays_live"] == 3 * sum(live[0])
    assert counters["rt.rays_launched"] == 3 * sum(widths[0])
    assert tracing.stage_report()["rt.frame"]["calls"] == 3
    assert all(s["stream_ms"] is None for s in spans)   # no card here


@pytest.mark.parametrize("engine", ENGINES)
def test_live_rays_match_an_independent_hit_count(engine):
    frame, (o, d) = tracer.make_frame_fn(_scene(), CAM, _cfg(engine, 1),
                                         device="cpu")
    tracing.reset_stages()
    frame(o, d)
    scene = _scene()
    tri = intersect.triangle_arrays(
        torch.as_tensor(scene.verts, dtype=torch.float32),
        torch.as_tensor(scene.faces, dtype=torch.int64))
    prim = intersect.closest_hit_bruteforce(o, d, *tri)[0]
    hits = int((prim >= 0).sum())
    assert 0 < hits < W * H
    assert tracing.counter_report()["rt.rays_live"] == hits


def test_image_is_bit_identical_with_tracing_on(prepared):
    _, frame, o, d = prepared
    off = frame(o, d)
    with tracing.enable():
        on = frame(o, d)
    assert torch.equal(on, off)
    assert len({s["frame"] for s in tracing.spans()}) == 1


@pytest.mark.parametrize("engine", ENGINES)
def test_profiler_turns_tracing_on_with_plain_cpu_ranges(engine):
    from torch.profiler import ProfilerActivity, profile

    # one sphere at 16 x 16: the profiler records every op of the
    # kernels' plain versions
    verts, faces, colors = scenes.sphere_field(copies=1, subdiv=1)
    frame, (o, d) = tracer.make_frame_fn(
        tracer.RTScene(verts=verts, faces=faces, colors=colors,
                       reflectivity=0.35), CAM,
        tracer.RTConfig(width=16, height=16, bounces=2, shadows=True,
                        engine=engine), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frame(o, d)
    spans = tracing.spans()
    assert {s["frame"] for s in spans} == {0}
    names = {s["name"] for s in spans}
    assert FRAME_CHILDREN | {"rt.frame", "rt.occlusion"} == names
    ranges = [e for e in prof.events() if e.name.startswith("rt.")]
    assert {e.name for e in ranges} == names
    assert len(ranges) == len(spans)
    assert not any(e.is_user_annotation for e in ranges)
    frame(o, d)                     # the profiler has stopped: not stored
    assert len(tracing.spans()) == len(spans)


def test_buffer_keeps_the_first_frames_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_FRAMES", 3)
    with tracing.enable():
        for _ in range(5):
            with tracing.stage("rt.frame", frame=True):
                with tracing.stage("rt.closest", bounce=0):
                    pass
        with tracing.stage("rt.prepare"):
            pass
    spans = tracing.spans()
    assert [s["frame"] for s in spans] == [0, 0, 1, 1, 2, 2, None]
    assert spans[-1]["parent"] is None
    assert tracing.counter_report() == {"tracing.frames_dropped": 2}
    assert tracing.stage_report()["rt.closest"]["calls"] == 5


def test_buffer_bounds_the_spans_outside_a_frame(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_LOOSE_SPANS", 2)
    with tracing.enable():
        for _ in range(3):
            with tracing.stage("optim_step"):
                pass
        with tracing.stage("rt.frame", frame=True):
            with tracing.stage("rt.closest", bounce=0):
                pass
        with tracing.stage("optim_step"):
            pass
    spans = tracing.spans()
    assert [(s["name"], s["frame"]) for s in spans] == [
        ("optim_step", None), ("optim_step", None), ("rt.frame", 0),
        ("rt.closest", 0)]
    assert tracing.counter_report() == {"tracing.spans_dropped": 2}
    assert tracing.stage_report()["optim_step"]["calls"] == 4


def test_only_a_frame_stage_opens_a_frame():
    with tracing.enable():
        with tracing.stage("rt.frame"):
            pass
        with tracing.stage("raster.frame", frame=True):
            with tracing.stage("raster.bin"):
                pass
    assert [(s["name"], s["frame"]) for s in tracing.spans()] == [
        ("rt.frame", None), ("raster.frame", 0), ("raster.bin", 0)]


def test_threads_keep_their_own_parents_and_unique_ids():
    import sys
    import threading

    def work():
        for _ in range(20):
            with tracing.stage("rt.frame", frame=True):
                for b in range(3):
                    with tracing.stage("rt.closest", bounce=b):
                        pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.enable():
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    spans = tracing.spans()
    assert len(spans) == 8 * 20 * 4
    assert len({s["id"] for s in spans}) == len(spans)
    by_id = {s["id"]: s for s in spans}
    frames = [s for s in spans if s["name"] == "rt.frame"]
    assert sorted(s["frame"] for s in frames) == list(range(8 * 20))
    for s in spans:
        if s["name"] == "rt.closest":
            parent = by_id[s["parent"]]
            assert parent["name"] == "rt.frame"
            assert parent["frame"] == s["frame"]


def test_stage_records_a_value_set_inside_it():
    with tracing.enable():
        with tracing.stage("rt.sync", bounce=1) as attrs:
            attrs["live"] = 7
    assert tracing.spans()[0]["attrs"] == {"bounce": 1, "live": 7}


def test_cli_rt_writes_the_spans_as_a_chrome_trace(capsys, tmp_path):
    path = tmp_path / "spans.json"
    rc = cli.main(["rt", "--device", "cpu", "-w", str(W), "-H", str(H),
                   "--scene", "sphere", "--bounces", "1",
                   "-o", str(tmp_path / "rt.png"), "--spans", str(path)])
    assert rc == 0
    assert f"wrote {path}" in capsys.readouterr().out
    trace = json.loads(path.read_text())
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    host = [e["name"] for e in spans if e["tid"] == 0]
    assert host.count("rt.frame") == 2 and host.count("rt.sync") == 2
    assert {"rt.prepare", "rt.prepare.bvh"} <= set(host)
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in spans)
    assert trace["otherData"]["counters"]["rt.rays_launched"] > 0
    assert not [e for e in spans if e["tid"] == 1]    # no card here


@pytest.mark.cuda
@pytest.mark.parametrize("host", [False, True])
def test_no_device_event_carries_a_span_on_the_card(host):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frame, (o, d) = tracer.make_frame_fn(_scene(), CAM, _cfg("pallas"),
                                         device="cuda")
    off = frame(o, d)
    torch.cuda.synchronize()
    tracing.reset_stages()
    pool = len(tracing._REC.pool)
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if host else [])
    with profile(activities=activities) as prof:
        on = frame(o, d)
        torch.cuda.synchronize()
    assert torch.equal(on, off)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert device
    assert not [e.name for e in device if e.name.startswith("rt.")]
    assert not [e.name for e in device if e.is_user_annotation]
    spans = tracing.spans()
    assert {s["frame"] for s in spans} == {0}
    # under a profiler alone only the stages that a reader times on the
    # stream record events
    timed = [s for s in spans if s["name"] in STREAM_STAGES]
    assert {s["name"] for s in timed} == STREAM_STAGES
    assert all(s["stream_ms"] is not None and s["stream_ms"] >= 0
               and s["stream_start_ms"] >= 0 for s in timed)
    assert all(s["stream_ms"] is None for s in spans if s not in timed)
    # events come from the pool and go back to it once read, all but the
    # buffer's origin: a traced frame creates only those the pool lacks
    pool = max(pool, 2 * len(timed)) - 1
    assert len(tracing._REC.pool) == pool
    tracing.reset_stages()
    with tracing.enable():              # inside enable() every stage
        frame(o, d)
    spans = tracing.spans()
    assert all(s["stream_ms"] is not None for s in spans)
    assert len(tracing._REC.pool) == max(pool, 2 * len(spans)) - 1
