"""The port's utils (tracing, image) and models.obj against the JAX
package's, on the CPU.

``diff.optim.fit`` runs each step inside ``tracing.stage("optim_step")``, as
the JAX package's does (with the step's own stages inside it), and
``trace_log`` prints only at or under SKYBOX_DEBUG.  ``framebuffer_to_rgba`` and ``compare_to_golden`` give the
JAX package's answers on seeded framebuffers; the port's PNG writer (the
standard library's zlib, no PIL) writes files that PIL reads back to the
same array.  An OBJ written by either package loads the same arrays in
both.
"""
import io
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from skybox_rt_tpu.models import obj as jax_obj
from skybox_rt_tpu.utils import image as jax_image
from skybox_rt_tpu_torch.diff import binning, optim, pipeline
from skybox_rt_tpu_torch.models import obj, scenes
from skybox_rt_tpu_torch.utils import image, tracing

torch.set_num_threads(1)


def _framebuffer(seed, h=13, w=21):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=(h, w), dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("steps", [1, 4])
def test_fit_runs_each_step_in_a_stage(steps):
    full, indices = scenes.triangle()
    cfg = pipeline.DiffRenderConfig(width=16, height=16, tile_logsize=3)
    static = {k: torch.from_numpy(v) for k, v in binning.bin_static(
        full["pos"], indices, 16, 16, tile_logsize=3).items()}
    full = {k: torch.from_numpy(v) for k, v in full.items()}

    def loss_fn(p, static):
        img = pipeline.render_cropped({**full, **p}, static, cfg)
        return torch.mean(img ** 2)

    tracing.reset_stages()
    res = optim.fit(loss_fn, {"color": full["color"]}, static, steps=steps)
    report = tracing.stage_report()
    # the step's stages (diff.optim.FitLoop, the render's prim set-up and
    # the row accumulations of its backward); report is sorted by name
    assert list(report) == ["diff.accumulate", "diff.backward", "diff.optim",
                            "diff.prim_setup", "diff.sync", "optim_step"]
    assert report["optim_step"]["calls"] == steps == len(res.losses)
    assert report["optim_step"]["ms"] > 0
    tracing.reset_stages()
    assert tracing.stage_report() == {}


def test_stage_is_a_profiler_range():
    from torch.profiler import profile
    with profile() as prof:
        with tracing.stage("bench_stage", sync=True):
            torch.ones(4).sum()
    assert "bench_stage" in {e.key for e in prof.key_averages()}
    assert tracing.stage_report()["bench_stage"]["calls"] >= 1


@pytest.mark.parametrize("debug", [0, 1, 2])
def test_trace_log_prints_at_or_under_the_level(monkeypatch, debug):
    monkeypatch.setattr(tracing, "DEBUG_LEVEL", debug)
    out = io.StringIO()
    for level in (1, 2, 3):
        tracing.trace_log(level, f"message {level}", file=out)
    assert out.getvalue().splitlines() == [
        f"[skybox:{level}] message {level}" for level in (1, 2, 3)
        if level <= debug]


def test_profile_writes_a_chrome_trace(tmp_path):
    with tracing.profile(str(tmp_path / "trace")):
        with tracing.stage("profiled"):
            torch.arange(16).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_framebuffer_to_rgba_as_jax(seed):
    fb = _framebuffer(seed)
    got = image.framebuffer_to_rgba(fb)
    np.testing.assert_array_equal(got, jax_image.framebuffer_to_rgba(fb))
    assert got.dtype == np.uint8 and got.shape == fb.shape + (4,)


@pytest.mark.parametrize("seed", [0, 1])
def test_png_writer_reads_back_through_pil(tmp_path, seed):
    fb = _framebuffer(seed)
    path = str(tmp_path / "fb.png")
    image.save_framebuffer_png(path, fb)
    with Image.open(path) as im:
        assert im.mode == "RGBA"
        np.testing.assert_array_equal(np.asarray(im),
                                      image.framebuffer_to_rgba(fb))
    np.testing.assert_array_equal(image.read_png_rgba(path),
                                  image.framebuffer_to_rgba(fb))
    np.testing.assert_array_equal(image.load_png_argb(path), fb[::-1])
    # the JAX package's writer (PIL) writes what the stdlib reader reads
    jax_path = str(tmp_path / "jax.png")
    jax_image.save_framebuffer_png(jax_path, fb)
    np.testing.assert_array_equal(image.load_png_argb(jax_path), fb[::-1])


def test_png_reader_refuses_other_filters(tmp_path):
    """The reader reads what the writer writes (filter type 0 on every
    row) and refuses a row with another filter, which PIL may write."""
    rgba = np.zeros((6, 5, 4), np.uint8)
    rgba[..., 0] = np.arange(5) * 40
    rgba[..., 3] = 255
    path = str(tmp_path / "ramp.png")
    image.write_png_rgba(path, rgba)
    np.testing.assert_array_equal(image.read_png_rgba(path), rgba)
    Image.fromarray(rgba, "RGBA").save(path, optimize=True)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), rgba)
    with pytest.raises(ValueError, match="row filter"):
        image.read_png_rgba(path)


@pytest.mark.parametrize("tolerance", [0, 1, 40])
def test_compare_to_golden_as_jax(tmp_path, tolerance):
    fb = _framebuffer(0)
    golden = str(tmp_path / "golden.png")
    jax_image.save_framebuffer_png(golden, fb)
    noisy = fb.copy()
    rng = np.random.default_rng(5)
    idx = rng.integers(0, fb.size, 30)
    noisy.reshape(-1)[idx] ^= rng.integers(1, 64, 30).astype(np.uint32)
    for got in (fb, noisy):
        assert image.compare_to_golden(got, golden, tolerance) == \
            jax_image.compare_to_golden(got, golden, tolerance)
    assert image.compare_to_golden(fb, golden, tolerance) == (0, 0)


def _obj_file(path):
    with open(path, "w") as f:
        f.write("# a quad and a triangle with uv and normals\n"
                "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\n"
                "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                "vn 0 0 1\nvn 0 1 0\n"
                "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
                "f -1//2 -4//2 -3//2\n")


def _assert_same_obj(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if a[k] is None:
            assert b[k] is None, k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k


@pytest.mark.parametrize("writer", ["file", "port", "jax"])
def test_obj_loads_the_same_in_both(tmp_path, writer):
    path = str(tmp_path / "mesh.obj")
    if writer == "file":
        _obj_file(path)
    else:
        verts, faces = scenes.icosphere(subdiv=1)
        (obj if writer == "port" else jax_obj).save_obj(path, verts, faces)
    got = obj.load_obj(path)
    _assert_same_obj(got, jax_obj.load_obj(path))
    assert got["faces"].shape[1] == 3
    if writer == "file":
        assert got["faces"].shape == (3, 3)
        assert got["uvs"] is not None and got["normals"] is not None


def test_load_png_argb_names_pil_when_it_is_absent(tmp_path, monkeypatch):
    path = str(tmp_path / "fb.png")
    image.save_framebuffer_png(path, _framebuffer(0))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        image.load_png_argb(path)
    image.read_png_rgba(path)      # the stdlib reader needs no PIL


def test_stage_formats_no_message_with_tracing_off(monkeypatch):
    def refuses(*args, **kw):
        raise AssertionError("trace_log called with tracing off")

    monkeypatch.setattr(tracing, "DEBUG_LEVEL", 0)
    monkeypatch.setattr(tracing, "trace_log", refuses)
    with tracing.stage("quiet"):
        pass
    assert tracing.stage_report()["quiet"]["calls"] >= 1
