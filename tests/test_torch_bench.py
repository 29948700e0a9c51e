"""bench_torch.py, the port's benchmark, on the CPU at a tiny size.

Its stages cover bench.py's (read from bench.py's source; JAX does not run).
With the sizes, loop lengths and repeats monkeypatched small, the raster and
training stage functions return their keys on the CPU; ``main`` prints one
line of bench.py's shape, with the headline loop's rate as ``value`` and the
slot probe's count passed on to its stage; and a stage that fails leaves
``<stage>_error`` in ``extra`` and makes ``main`` return 1.  The raster
stages run synth_draw3d at 64x64 with 8x8 tiles, which keeps the plain
pass-1 loop short on the CPU.
"""
import ast
import json
import math
import os
from unittest import mock

import pytest
import torch

import bench_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"SIZE": 64, "TILE_LOGSIZE": 3, "FRAMES": 1, "REPS": 1,
         "DEVICE_LOOP_N1": 1, "DEVICE_LOOP_N2": 2, "DEVICE_REPS": 1,
         "DRAW1024_SIZE": 64, "DRAW1024_N1": 1, "DRAW1024_N2": 2,
         "DRAW1024_REPS": 1, "FWD_BWD_SIZE": 64, "FWD_BWD_LARGE": 32,
         "FWD_BWD_N1": 1, "FWD_BWD_N2": 2, "FWD_BWD_REPS": 1}


@pytest.fixture
def small(monkeypatch):
    for k, v in SMALL.items():
        assert hasattr(bench_torch, k), k
        monkeypatch.setattr(bench_torch, k, v)


def _jax_bench_stages():
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "STAGES"
                for t in node.targets):
            return [k.value for k in node.value.keys]
    raise AssertionError("bench.py has no STAGES")


def test_stages_cover_the_jax_bench():
    want = _jax_bench_stages()
    assert len(want) == 12
    assert list(bench_torch.STAGES) == want
    assert set(bench_torch._PROBE_FOR) <= set(want)


def _finite_positive(x):
    return isinstance(x, float) and math.isfinite(x) and x > 0


@pytest.mark.parametrize("stage,keys", [
    ("headline", ["headline_dispatch_mpix_s", "headline_roofline",
                  "headline_dispatch_device_busy_ms", "headline_launches"]),
    ("draw1024", ["draw1024_mpix_s", "draw1024_roofline",
                  "draw1024_device_busy_ms", "draw1024_launches"]),
    ("fwd_bwd", ["fwd_bwd_64_mpix_s", "fwd_bwd_64_roofline",
                 "fwd_bwd_64_device_busy_ms", "fwd_bwd_64_launches"]),
    ("fwd_bwd_1024", ["fwd_bwd_32_mpix_s", "fwd_bwd_32_roofline"]),
    ("fwd_bwd_alpha", ["fwd_bwd_alpha_64_mpix_s", "fwd_bwd_alpha_64_slots"]),
])
def test_stage_returns_its_keys_on_the_cpu(small, stage, keys):
    out = bench_torch.STAGES[stage][0]("cpu")
    json.dumps(out)
    assert set(keys) <= set(out)
    assert _finite_positive(out[keys[0]])
    for k, v in out.items():
        if k.endswith(("_device_busy_ms", "_device_kernels")):
            assert v is None          # no device kernel on the CPU
        if k.endswith("_launches"):
            assert v == {}            # wrappers count card launches only
        if k.endswith("_roofline"):
            assert v["bound_by"] == "hbm" and v["pct_of_roofline"] > 0


def _in_process(name, timeout, env):
    with mock.patch.dict(os.environ, env, clear=True):
        return bench_torch.STAGES[name][0]("cpu")


def test_main_prints_one_line_of_the_bench_shape(small, monkeypatch, capsys):
    monkeypatch.setattr(bench_torch, "STAGES", {
        k: bench_torch.STAGES[k] for k in (
            "window_probe", "headline_device", "slots_soft",
            "fwd_bwd_soft")})
    monkeypatch.setattr(bench_torch, "run_stage", _in_process)
    assert bench_torch.main() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert line["metric"] == "draw3d_synth_draw3d_64x64_fwd_devicewall"
    assert line["unit"] == "Mpix/s" and line["vs_baseline"] is None
    assert _finite_positive(line["value"])
    extra = line["extra"]
    assert "device" in extra and not any(k.endswith("_error") for k in extra)
    assert extra["loop_frame_equal_to_compile_frame"] is True
    assert extra["device_loop_frames"] == [1, 2]
    assert "slots" not in extra
    assert extra["fwd_bwd_softedge_64_slots"] >= 2
    for k in ("window_probe_ms", "window_rtt_ms",
              "fwd_bwd_softedge_64_mpix_s"):
        assert _finite_positive(extra[k]), k


def test_failed_stage_is_recorded_and_exits_1(monkeypatch, capsys):
    """The stage's own process runs it on the default device, the CUDA
    card; without one it fails, and so does the run."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the stage would run")
    monkeypatch.setattr(bench_torch, "STAGES", {
        "window_probe": bench_torch.STAGES["window_probe"],
        "slots_alpha": bench_torch.STAGES["slots_alpha"]})
    assert bench_torch.main() == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    extra = line["extra"]
    assert line["value"] is None
    for stage in ("window_probe", "slots_alpha"):
        assert extra[f"{stage}_error"] == "exit=1"
        assert "no CUDA device" in extra[f"{stage}_stderr"]


@pytest.mark.parametrize("stage", ["headline_device", "headline",
                                   "draw1024"])
def test_raster_stage_counts_its_runs_alone(small, monkeypatch, stage):
    """Kernel #1's wrapper counted here as on the card: the stage's
    ``<stage>_launches`` holds the draws of its timed runs, as
    expected_launches has them, and none of its set-up frame."""
    from skybox_rt_tpu_torch.ops import cuda_raster

    calls = {"n": 0, "before_reset": 0}
    visibility_tiles = cuda_raster.visibility_tiles

    def counted(*args, **kw):
        calls["n"] += 1
        return visibility_tiles(*args, **kw)

    def reset():
        calls["before_reset"] += calls["n"]
        calls["n"] = 0

    monkeypatch.setattr(cuda_raster, "visibility_tiles", counted)
    monkeypatch.setattr(bench_torch, "_reset_launches", reset)
    monkeypatch.setattr(bench_torch, "_launches",
                        lambda: {"raster_visibility": calls["n"]})
    out = bench_torch.STAGES[stage][0]("cpu")
    want = bench_torch.expected_launches("cpu")[stage]
    assert out[f"{stage}_launches"] == want
    if stage != "draw1024":           # the blend-slot set-up frame ran
        assert calls["before_reset"] > 0


def test_failed_nvidia_smi_is_recorded_and_exits_1(small, monkeypatch,
                                                   capsys):
    def fails(*args, **kw):
        raise bench_torch.subprocess.CalledProcessError(9, args[0])

    monkeypatch.setattr(bench_torch, "STAGES", {
        "window_probe": bench_torch.STAGES["window_probe"]})
    monkeypatch.setattr(bench_torch, "run_stage", _in_process)
    monkeypatch.setattr(bench_torch.subprocess, "run", fails)
    assert bench_torch.main() == 1
    extra = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "extra"]
    assert extra["device"] is None
    assert "nvidia-smi" in extra["device_error"]
    assert _finite_positive(extra["window_probe_ms"])


@pytest.mark.parametrize("stdout", ["not json\n", "{\"cut\": \n"])
def test_stage_printing_no_json_is_an_error(monkeypatch, stdout):
    monkeypatch.setattr(
        bench_torch.subprocess, "run",
        lambda *a, **kw: bench_torch.subprocess.CompletedProcess(
            a[0], 0, stdout=stdout, stderr="why"))
    r = bench_torch.run_stage("window_probe", 10, {})
    assert r["error"].startswith("last line not JSON") and r["stderr"] == "why"
