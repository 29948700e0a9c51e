"""The exact-integer raster frame's stages and counters (``utils.tracing``
stages in ``ref/driver`` and ``ops/deferred``, counters ``raster.*``), on
the CPU in mode ``deferred`` at the committed trace's 256 x 256, where pass
1 runs kernel #1's plain version.

A traced ``compile_frame`` records ``raster.prepare`` and its three
children once; each frame then opens one ``raster.frame`` holding, for each
of the four draws, one ``raster.tiles`` with a ``raster.visibility`` and a
``raster.shade`` inside; ``raster.blend_slots`` adds the blended draw's K
each frame.  Tracing on or off, the image is the committed golden bit for
bit, and a frame's output is not changed by the frames after it.  The
``cuda`` tests count kernel #1's launches, ``raster.vis_kernel``, on the
card, where compile_frame replays the draws captured as CUDA graphs
(``raster.prepare.capture``) inside the same stages.
"""
import collections
import os

import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch.geom import cgltrace
from skybox_rt_tpu_torch.ref import driver
from skybox_rt_tpu_torch.utils import tracing

torch.set_num_threads(1)

W = H = 256
DRAWS = 4
GOLDEN = os.path.join(cgltrace.DATA_DIR, "synth_draw3d_256.npz")
PREPARE_CHILDREN = {"raster.prepare.bin", "raster.prepare.upload",
                    "raster.prepare.blend_k"}
DRAW_STAGES = ("raster.tiles", "raster.visibility", "raster.shade")


def _trace():
    return cgltrace.load_trace(cgltrace.trace_path("synth_draw3d"))


def _golden():
    with np.load(GOLDEN) as z:
        return z["color"]


def _words(fb):
    return fb.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def run():
    """compile_frame traced, then three frames: off, on, off."""
    tracing.reset_stages()
    with tracing.enable():
        frame, arrays = driver.compile_frame(_trace(), W, H, mode="deferred",
                                             device="cpu")
    prepare = tracing.spans()
    tracing.reset_stages()
    first = frame(arrays)
    kept = first.clone()
    with tracing.enable():
        traced = frame(arrays)
    last = frame(arrays)
    out = {"prepare": prepare, "spans": tracing.spans(),
           "counters": tracing.counter_report(),
           "stages": tracing.stage_report(), "first": first, "kept": kept,
           "traced": traced, "last": last}
    tracing.reset_stages()
    return out


def test_prepare_records_its_three_children(run):
    spans = run["prepare"]
    root = [s for s in spans if s["name"] == "raster.prepare"]
    assert len(root) == 1 and root[0]["parent"] is None
    assert root[0]["frame"] is None
    assert root[0]["attrs"] == {"mode": "deferred", "width": W, "height": H}
    children = [s for s in spans if s["name"] in PREPARE_CHILDREN]
    assert {s["name"] for s in children} == PREPARE_CHILDREN
    assert all(s["parent"] == root[0]["id"] for s in children)
    # the frame that measures K draws inside .blend_k, outside any frame
    blend_k = [s for s in children if s["name"] == "raster.prepare.blend_k"]
    inside = [s for s in spans if s["name"] == "raster.tiles"]
    assert inside and all(s["parent"] == blend_k[0]["id"] for s in inside)
    assert all(s["frame"] is None for s in spans)


def test_frame_opens_one_span_tree(run):
    spans = run["spans"]
    assert {s["frame"] for s in spans} == {0}
    names = collections.Counter(s["name"] for s in spans)
    assert names == {"raster.frame": 1, **{n: DRAWS for n in DRAW_STAGES}}
    by_id = {s["id"]: s for s in spans}
    top = [s for s in spans if s["name"] == "raster.frame"][0]
    assert top["parent"] is None
    for s in spans:
        if s["name"] == "raster.tiles":
            assert s["parent"] == top["id"]
        elif s["name"] in ("raster.visibility", "raster.shade"):
            assert by_id[s["parent"]]["name"] == "raster.tiles"
        assert top["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= top["end_ns"]
    assert all(s["stream_ms"] is None for s in spans)   # no card here


def test_counters_and_aggregates(run):
    trace = _trace()
    driver.render_trace(trace, W, H, mode="deferred", device="cpu")
    ks = trace._blend_k_cache[(W, H, 5)]
    blended = [d for d, dc in enumerate(trace.drawcalls)
               if dc.states.blend_enabled]
    assert len(blended) == 1 and ks[blended[0]] > 0
    # three frames ran; kernel #1's plain version counts no launch
    assert run["counters"] == {"raster.blend_slots": 3 * ks[blended[0]]}
    stages = run["stages"]
    assert stages["raster.frame"]["calls"] == 3
    assert all(stages[n]["calls"] == 3 * DRAWS for n in DRAW_STAGES)


def test_images_are_the_golden_and_frames_do_not_alias(run):
    golden = _golden()
    for key in ("first", "traced", "last"):
        np.testing.assert_array_equal(_words(run[key]), golden)
    # the later frames wrote buffers of their own
    assert torch.equal(run["first"], run["kept"])
    assert run["first"].data_ptr() != run["last"].data_ptr()


def test_render_trace_and_frame_loop_open_a_frame_each():
    trace = _trace()
    tracing.reset_stages()
    with tracing.enable():
        driver.render_trace(trace, W, H, mode="deferred", device="cpu")
        loop, arrays = driver.compile_frame_loop(trace, W, H, 2,
                                                 device="cpu")
        out = loop(arrays)
    np.testing.assert_array_equal(_words(out), _golden())
    spans = [s for s in tracing.spans() if s["frame"] is not None]
    frames = [s for s in spans if s["name"] == "raster.frame"]
    assert [s["frame"] for s in frames] == [0, 1, 2]
    # render_trace's first frame of a trace measures the blended draw's K:
    # it draws that draw again once the first K overflows
    for f, draws in ((0, DRAWS + 1), (1, DRAWS), (2, DRAWS)):
        assert collections.Counter(s["name"] for s in spans
                                   if s["frame"] == f) == {
            "raster.frame": 1, **{n: draws for n in DRAW_STAGES}}
    tracing.reset_stages()


@pytest.mark.cuda
def test_kernel_launches_a_frame_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel #1 has no CPU build")
    frame, arrays = driver.compile_frame(_trace(), W, H, mode="deferred",
                                         device="cuda")
    tracing.reset_stages()
    with tracing.enable():
        for _ in range(2):
            out = frame(arrays)
    spans = tracing.spans()
    assert tracing.counter_report()["raster.vis_kernel"] == 2 * DRAWS
    np.testing.assert_array_equal(_words(out.cpu()), _golden())
    stream = [s["stream_ms"] for s in spans
              if s["name"] in ("raster.visibility", "raster.shade")]
    assert len(stream) == 2 * 2 * DRAWS and all(ms > 0 for ms in stream)
    tracing.reset_stages()


@pytest.mark.cuda
def test_graphed_frame_on_the_card():
    """The captured frame: its own output tensor each frame, the golden
    image, the eager frame's image for other arrays, and no launch while
    capturing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel #1 has no CPU build")
    from skybox_rt_tpu_torch.ops import cuda_raster
    cuda_raster.reset_launch_count()
    driver.render_trace(_trace(), W, H, mode="deferred", device="cuda")
    measuring = cuda_raster.launch_count     # the frame that measures K
    tracing.reset_stages()
    with tracing.enable():
        frame, arrays = driver.compile_frame(_trace(), W, H, mode="deferred",
                                             device="cuda")
    prepare = tracing.spans()
    capture = [s for s in prepare if s["name"] == "raster.prepare.capture"]
    root = [s for s in prepare if s["name"] == "raster.prepare"]
    assert len(capture) == 1 and capture[0]["parent"] == root[0]["id"]
    # the K-measuring frame launched; the capture did not
    assert tracing.counter_report()["raster.vis_kernel"] == measuring
    cuda_raster.reset_launch_count()
    first = frame(arrays)
    kept = first.clone()
    second = frame(arrays)
    eager = frame(tuple(arrays))            # not the captured arrays
    torch.cuda.synchronize()
    assert cuda_raster.launch_count == 3 * DRAWS
    assert torch.equal(first, kept)
    assert first.data_ptr() != second.data_ptr()
    for out in (first, second, eager):
        np.testing.assert_array_equal(_words(out.cpu()), _golden())
    tracing.reset_stages()
