"""The port's command line on the CPU (``--device cpu``), beside the JAX
package's.

``render`` prints the JAX package's frame report, counters and roofline
table, writes a PNG that decodes to ``ref.driver.render_trace``'s frame and
passes against a golden that the JAX package rendered and wrote; ``info``,
``bench`` and ``fit`` print the JAX package's keys (``fit``'s losses the JAX
package's at rtol 1e-4); ``rt`` renders with the default clustered engine
and the worklist engine; ``python -m skybox_rt_tpu_torch`` runs in a process
of its own.  The raster commands run synth_draw3d with 8x8 tiles (``-k 3``),
which keeps the plain pass-1 loop short on the CPU.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from skybox_rt_tpu import cli as jax_cli
from skybox_rt_tpu.geom import cgltrace as jax_cgltrace
from skybox_rt_tpu.ref import driver as jax_driver
from skybox_rt_tpu.runtime import perf as jax_perf
from skybox_rt_tpu.utils import image as jax_image
from skybox_rt_tpu_torch import cli
from skybox_rt_tpu_torch.geom import cgltrace
from skybox_rt_tpu_torch.ref import driver
from skybox_rt_tpu_torch.utils import image

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the keys of the JAX package's `bench` line (skybox_rt_tpu/cli.py)
BENCH_KEYS = ["scene", "size", "frames", "tile_logsize", "mode",
              "ms_per_frame", "mpix_s"]


def _run(capsys, *argv):
    rc = cli.main([*argv, "--device", "cpu"])
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def jax_frame_64():
    with np.load(cgltrace.trace_path("synth_draw3d")) as z:
        trace = jax_cgltrace._from_npz(z)
    stats = jax_driver.FrameStats()
    fb = np.asarray(jax_driver.render_trace(trace, 64, 64, 3, stats=stats,
                                            mode="deferred",
                                            measure_traffic=True))
    return fb, stats


def test_render_perf_png_and_golden(capsys, tmp_path, jax_frame_64):
    want, stats = jax_frame_64
    golden = str(tmp_path / "golden.png")
    jax_image.save_framebuffer_png(golden, want)
    out_png = str(tmp_path / "f.png")
    rc, out = _run(capsys, "render", "-t", "synth_draw3d", "-w", "64",
                   "-H", "64", "-k", "3", "--mode", "deferred", "--perf",
                   "-o", out_png, "-r", golden)
    assert rc == 0, out
    lines = out.splitlines()
    assert lines[0].startswith("Total elapsed time: ")
    assert lines[1] == (f"drawcalls={stats.drawcalls}, "
                        f"prims={stats.prims_binned}, tiles={stats.tiles}")
    perf = {ln.split()[1] for ln in lines if ln.startswith("PERF: ")
            and not ln.startswith("PERF: ---")}
    assert perf == ({"drawcalls", "prims_binned", "tiles", "frame_ms"}
                    | set(stats.traffic) - {"tiles", "prims"})
    header = jax_perf.format_roofline_table({}).splitlines()[0]
    row = lines[lines.index(header) + 1]
    assert row.startswith("frame[deferred] 64x64") and row.split()[-2] == "hbm"
    assert lines[-1] == "PASSED!"
    got = image.read_png_rgba(out_png)
    fb = driver.render_trace(cgltrace.load_trace(
        cgltrace.trace_path("synth_draw3d")), 64, 64, 3, mode="deferred",
        device="cpu")
    np.testing.assert_array_equal(got, image.framebuffer_to_rgba(fb))
    np.testing.assert_array_equal(fb, want)


def test_render_against_another_golden_fails(capsys, tmp_path, jax_frame_64):
    golden = str(tmp_path / "golden.png")
    jax_image.save_framebuffer_png(golden, jax_frame_64[0] ^ 0x00400000)
    rc, out = _run(capsys, "render", "-t", "synth_draw3d", "-w", "64",
                   "-H", "64", "-k", "3", "-r", golden)
    assert rc == 1
    assert out.splitlines()[-1].startswith("FAILED! - ")


def test_info_prints_the_jax_keys(capsys):
    rc, out = _run(capsys, "info")
    assert rc == 0
    got = json.loads(out)
    assert jax_cli.main(["info"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert list(got) == list(want) and got["isa"] == want["isa"]
    assert got["platform"] == "cpu" and got["num_devices"] == 1


def test_bench_prints_the_jax_keys(capsys):
    rc, out = _run(capsys, "bench", "-w", "32", "--frames", "2",
                   "--tile-logsize", "3")
    assert rc == 0
    got = json.loads(out)
    assert list(got) == BENCH_KEYS
    assert got["scene"] == "synth_draw3d" and got["frames"] == 2
    assert got["mpix_s"] > 0 and got["ms_per_frame"] > 0


@pytest.mark.parametrize("engine", ["pallas", "pallas_worklist"])
def test_rt_engines(capsys, tmp_path, engine):
    out_png = str(tmp_path / f"{engine}.png")
    rc, out = _run(capsys, "rt", "-w", "32", "-H", "32", "--engine", engine,
                   "-o", out_png)
    assert rc == 0
    assert out.splitlines()[0].startswith("rendered in ")
    assert out.splitlines()[-1] == f"wrote {out_png}"
    rgba = image.read_png_rgba(out_png)
    assert rgba.shape == (32, 32, 4) and (rgba[..., 3] == 255).all()
    assert len(np.unique(rgba[..., :3].reshape(-1, 3), axis=0)) > 10


def test_rt_engines_render_the_same_image(capsys, tmp_path):
    images = []
    for engine in ("pallas", "pallas_worklist"):
        path = str(tmp_path / f"{engine}.png")
        _run(capsys, "rt", "-w", "32", "-H", "32", "--engine", engine,
             "-o", path)
        images.append(image.read_png_rgba(path))
    np.testing.assert_array_equal(images[0], images[1])


def test_fit_prints_the_jax_keys_and_losses(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc, out = _run(capsys, "fit", "-w", "32", "--steps", "5")
    assert rc == 0
    got = json.loads(out)
    assert jax_cli.main(["fit", "-w", "32", "--steps", "5", "-o",
                         "jax"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert list(got) == list(want)
    assert got["loss_last"] < got["loss_first"]
    assert got["bad_steps"] == 0 and got["resumed_from"] == 0
    for k in ("loss_first", "loss_last"):
        assert got[k] == pytest.approx(want[k], rel=1e-4)
    for path in got["outputs"]:
        rgba = image.read_png_rgba(path)
        assert rgba.shape == (32, 32, 4)


def test_scale_waits_for_parallel():
    """`scale`, which waited for the port of parallel/, parses as the JAX
    package's command does, with --device beside (the sweep itself:
    tests/test_torch_parallel_rt.py)."""
    got = vars(cli.build_parser().parse_args(["scale"]))
    want = vars(jax_cli.build_parser().parse_args(["scale"]))
    assert got.pop("device") is None
    assert got.pop("fn") is cli._cmd_scale
    want.pop("fn")
    assert got == want


def test_module_runs_in_a_process_of_its_own():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "skybox_rt_tpu_torch",
                          "info", "--device", "cpu"], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout)["platform"] == "cpu"
