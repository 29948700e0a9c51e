"""The exact-integer raster cell: its plain reference against the committed
golden and the port's deferred frame, the control, planted faults, a run
with its timed path broken, the lookups by name and the metrics' readers
(CPU; one test runs the cell on the card and skips without one)."""
import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import calibrate_raster, harness
from benchmark.entries import raster_frame
from benchmark.metrics import (raster_host_busy_ms,
                               raster_shade_stream_ms,
                               raster_visibility_roofline_pct,
                               raster_visibility_stream_ms)
from benchmark.reference import raster_reference

torch.set_num_threads(1)

WORKLOAD = "synth_draw3d.raster_256"
SEEDS = (2 ** 33 + 26, 7)
GOLDEN = os.path.join(harness.ROOT, "skybox_rt_tpu_torch", "data",
                      "synth_draw3d_256.npz")


def resolved():
    return harness.resolve(WORKLOAD)


def passes(numbers):
    lim = resolved()["limits"]
    return all(numbers[k] <= lim[k] for k in lim)


@pytest.fixture(scope="module", params=SEEDS)
def framed(request):
    """A cell on the CPU at the cell's own size, and its first frame."""
    r = resolved()
    cell = raster_frame.setup(r["config"], r["traffic"], request.param,
                              torch.device("cpu"))
    return cell, cell.step()


def test_reference_is_the_golden_bit_for_bit():
    config = resolved()["config"]
    draws, textures = raster_reference.load(raster_frame.trace_path(config))
    img = raster_reference.render(draws, textures, 256, 256)
    with np.load(GOLDEN) as z:
        np.testing.assert_array_equal(img.numpy().view(np.uint32),
                                      z["color"])


def test_inputs_follow_the_seed():
    config = resolved()["config"]
    a, b = (raster_frame.make_inputs(config, s) for s in SEEDS)
    again = raster_frame.make_inputs(config, SEEDS[0])
    draws, textures = raster_reference.load(raster_frame.trace_path(config))
    for d, ca, cb, c2 in zip(draws, a["colors"], b["colors"],
                             again["colors"]):
        assert ca.shape == d.color.shape and (ca == c2).all()
        assert not (ca == cb).all()
        lo = 0.25 if d.states["blend_enabled"] else 0.0
        hi = 0.75 if d.states["blend_enabled"] else 1.0
        assert lo <= ca[:, 3].min() and ca[:, 3].max() <= hi
    for tid, t in textures.items():
        assert a["texels"][tid].shape == t.pixels.shape
        assert (a["texels"][tid] == again["texels"][tid]).all()
        assert not (a["texels"][tid] == b["texels"][tid]).all()


def test_port_equals_the_reference(framed):
    cell, out = framed
    n = cell.check([out])
    assert n == {"bad_px_pct": 0.0, "mean_abs_err": 0.0}
    assert passes(n)


def test_control_is_not_correct(framed):
    cell, _ = framed
    r = resolved()
    want = raster_frame.reference(r["config"], r["traffic"], cell.inputs,
                                  "cpu")
    low = raster_frame.reference(r["config"], r["traffic"], cell.inputs,
                                 "cpu", control=True)
    assert not passes(raster_frame.frame_numbers(low, want))


@pytest.mark.parametrize("fault", sorted(calibrate_raster.TRACE_FAULTS))
def test_planted_fault(framed, fault):
    """Each fault fails the check, but for the stencil draw's zpass op: the
    trace's INCR saturates on the cleared stencil (0xFF), so ignoring it
    changes no word of the colour buffer, nor of the depth-stencil one."""
    cell, out = framed
    want = raster_frame.reference(cell.config, cell.traffic, cell.inputs,
                                  "cpu")
    bad = calibrate_raster.fault_frame(
        cell, calibrate_raster.TRACE_FAULTS[fault])
    numbers = raster_frame.frame_numbers(bad, want)
    if fault == "fault_stencil_zpass_ignored":
        assert torch.equal(bad, out)
    else:
        assert not passes(numbers), numbers
    assert not passes(raster_frame.frame_numbers(
        calibrate_raster.tile_inverted(out), want))


def test_cell_files_found_by_name():
    r = resolved()
    assert r["entry"] is raster_frame
    assert r["config"]["precision"] == "exact-int"
    assert r["limits"] == {"bad_px_pct": 0, "mean_abs_err": 0}
    assert r["traffic"] == {"width": 256, "height": 256, "tile_logsize": 5,
                            "mode": "deferred", "draws": 4}
    names = {m["name"] for m in harness.cell_metrics(
        r["spec"], WORKLOAD, "per_layer")}
    assert names == {"prepare_s", "kernels_per_iter", "device_idle_pct",
                     "raster_host_busy_ms", "raster_visibility_stream_ms",
                     "raster_shade_stream_ms",
                     "raster_visibility_roofline_pct"}
    for name in names:
        assert callable(harness.load_reader(r["metrics_dir"], name).read)


def tiny_root(tmp_path):
    """A copy of the benchmark whose raster cell runs on the CPU."""
    root = tmp_path / "root"
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    return str(root)


def run_cell(root):
    args = argparse.Namespace(workload=WORKLOAD, seed=SEEDS[0],
                              seconds=0.01, trace=0)
    return harness.run(args, root=root, device="cpu")


@pytest.mark.parametrize("fault", [None, "blend_fold_skipped",
                                   "point_filtered"])
def test_run_and_broken_timed_path(tmp_path, monkeypatch, fault):
    from skybox_rt_tpu_torch.ops import deferred
    from skybox_rt_tpu_torch.texture import sampler

    if fault == "blend_fold_skipped":
        # the blended draw's fragments overwrite in place of blending
        monkeypatch.setattr(deferred.blend_mod, "blend",
                            lambda state, src, dst: src)
    elif fault == "point_filtered":
        sample = sampler.sample

        def point(st, *a, **k):
            import dataclasses
            return sample(dataclasses.replace(st, filter=0), *a, **k)
        monkeypatch.setattr(sampler, "sample", point)
    rc, line = run_cell(tiny_root(tmp_path))
    assert rc == 0
    assert line["correct"] is (fault is None), line["checks"]
    assert set(line["metrics"]) == {"setup_s", "iter_ms", "iter_p95_ms"}


def test_roofline_bytes_and_kernel_name():
    vis = [[10, 1024, 3], [2, 4096, 17]]
    assert raster_visibility_roofline_pct.visibility_bytes(vis) == (
        10 * 52 + 1024 * (8 + 12) + 2 * 52 + 4096 * (8 + 68))
    from benchmark import profiling
    name = "(anonymous namespace)::visibility_kernel((anonymous " \
        "namespace)::VisParams)"
    other = "(anonymous namespace)::diff_visibility_kernel(float const*)"
    trace = profiling.Trace([(name, 0.0, 10.0), (other, 10.0, 50.0)], [], 2,
                            1.0)
    ctx = harness.Context([0.1], 0.1, 1.0, trace, 0.0,
                          {"visibility": vis}, {})
    bound_s = raster_visibility_roofline_pct.visibility_bytes(vis) / 3.35e12
    assert raster_visibility_roofline_pct.read(ctx) == pytest.approx(
        100.0 * bound_s / (10e-6 / 2))
    assert raster_visibility_roofline_pct.read(
        harness.Context([0.1], 0.1, 1.0, trace, 0.0, {}, {})) is None


def test_check_counts_the_kernels_work(framed):
    cell, out = framed
    cell.check([out])
    assert cell.info["blend_slots"] == 16
    assert [w for _, _, w in cell.info["visibility"]] == [3, 3, 17, 3]
    lists = [dev[3] for _, dev in cell.arrays]
    assert [v[:2] for v in cell.info["visibility"]] == [
        [int((p >= 0).sum()), p.shape[0] * 32 * 32] for p in lists]


def test_span_readers_on_traced_frames(framed):
    """On the CPU the frame stage has host time; the device-stream readers
    have nothing to read."""
    from skybox_rt_tpu_torch.utils import tracing

    cell, _ = framed
    tracing.reset_stages()
    with tracing.enable():
        cell.step()
    assert raster_host_busy_ms.read(None) > 0
    for reader in (raster_visibility_stream_ms, raster_shade_stream_ms):
        assert reader.read(None) is None
    tracing.reset_stages()
    assert raster_host_busy_ms.read(None) is None


def test_program_without_the_stages_fails_at_set_up(monkeypatch):
    from skybox_rt_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "stage_report", lambda: {})
    r = resolved()
    with pytest.raises(RuntimeError, match="raster.prepare"):
        raster_frame.setup(r["config"], r["traffic"], SEEDS[0],
                           torch.device("cpu"))


@pytest.mark.cuda
def test_traced_run_on_the_card_reads_every_metric():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", WORKLOAD,
         "--seed", str(2 ** 32 + 26), "--seconds", "3", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    names = {m["name"] for m in harness.cell_metrics(
        resolved()["spec"], WORKLOAD, "per_layer")}
    assert set(line["metrics"]) == names
    assert all(m["value"] is not None for m in line["metrics"].values())
