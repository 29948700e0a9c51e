"""The port's whole draw3d frame against the JAX package, on the CPU.

Both packages read the committed synthetic trace
(skybox_rt_tpu_torch/data/synth_draw3d.npz).  The port's deferred and
immediate frames must equal the JAX package's deferred frame bit for bit
(exact-int path, so the tolerance is exact equality).  The committed JAX
goldens that chip_smoke.py checks the card against are regenerated here
from the JAX package and must equal the committed files.

Regenerate the goldens with
``PYTHONPATH=. python tests/test_torch_frame.py --write``.
"""
import hashlib
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch
import pytest

from skybox_rt_tpu.geom import cgltrace as jax_cgltrace
from skybox_rt_tpu.ops import deferred as jax_deferred
from skybox_rt_tpu.ref import driver as jax_driver
from skybox_rt_tpu.ref import renderer as jax_renderer
from skybox_rt_tpu_torch import interop
from skybox_rt_tpu_torch.core import fixed
from skybox_rt_tpu_torch.geom import cgltrace
from skybox_rt_tpu_torch.ops import deferred
from skybox_rt_tpu_torch.ref import driver, renderer

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

TRACE = cgltrace.trace_path("synth_draw3d")
GOLDEN_256 = os.path.join(cgltrace.DATA_DIR, "synth_draw3d_256.npz")
GOLDEN_1024 = os.path.join(cgltrace.DATA_DIR, "synth_draw1024.json")
DRAW_1024 = 1          # the textured draw, as bench.py times its scene's draw


def _jax_trace():
    with np.load(TRACE) as z:
        return jax_cgltrace._from_npz(z)


@pytest.fixture(scope="module")
def jax_frame_256():
    return np.asarray(jax_driver.render_trace(_jax_trace(), 256, 256,
                                              mode="deferred"))


def jax_draw1024():
    """d1 alone, binned and drawn at 1024x1024 by the JAX package's deferred
    path: {color_sha256, ds_sha256, non_clear_pixels}."""
    W = H = 1024
    rs, texels, binned = jax_driver.prepare_drawcalls(
        _jax_trace(), W, H)[DRAW_1024]
    fbc = jnp.full((H, W), jax_driver.CLEAR_COLOR, jnp.uint32)
    fbd = jnp.full((H, W), jax_driver.CLEAR_DEPTH, jnp.uint32)
    c, d = jax_deferred.render_drawcall(rs, texels, binned, fbc, fbd)
    c, d = np.asarray(c, np.uint32), np.asarray(d, np.uint32)
    return draw1024_record(c, d)


def draw1024_record(color: np.ndarray, ds: np.ndarray) -> dict:
    return {"width": 1024, "height": 1024, "draw": DRAW_1024,
            "tile_logsize": 5,
            "color_sha256": hashlib.sha256(color.tobytes()).hexdigest(),
            "ds_sha256": hashlib.sha256(ds.tobytes()).hexdigest(),
            "non_clear_pixels": int((color != 0xFF000000).sum())}


def port_draw1024(device="cpu"):
    W = H = 1024
    trace = cgltrace.load_trace(TRACE)
    rs, texels, binned = driver.prepare_drawcalls(
        trace, W, H, device=device)[DRAW_1024]
    fbc, fbd = driver.clear_framebuffers(W, H, 5, device)
    c, d = deferred.render_drawcall(rs, texels, binned, fbc, fbd)
    return draw1024_record(fixed.to_numpy_u32(c), fixed.to_numpy_u32(d))


def test_golden_256_matches_jax(jax_frame_256):
    with np.load(GOLDEN_256) as z:
        np.testing.assert_array_equal(z["color"], jax_frame_256)


def test_golden_1024_matches_jax():
    with open(GOLDEN_1024) as f:
        assert json.load(f) == jax_draw1024()


def test_port_draw1024_matches_golden():
    with open(GOLDEN_1024) as f:
        assert port_draw1024() == json.load(f)


@pytest.mark.parametrize("mode", ["deferred", "immediate", "pallas"])
def test_frame_256_bit_exact(jax_frame_256, mode):
    got = driver.render_trace(cgltrace.load_trace(TRACE), 256, 256,
                              mode=mode, device="cpu")
    assert got.dtype == np.uint32 and got.shape == (256, 256)
    np.testing.assert_array_equal(got, jax_frame_256)


@pytest.mark.parametrize("fn", ["render_trace", "compile_frame"])
def test_mode_defaults_match_jax(fn):
    """A caller that passes no mode takes the same path in both packages."""
    import inspect
    got = inspect.signature(getattr(driver, fn)).parameters["mode"].default
    want = inspect.signature(getattr(jax_driver, fn)).parameters[
        "mode"].default
    assert got == want == "immediate"


@pytest.mark.parametrize("fn", ["render_trace", "compile_frame"])
def test_pallas_interpret_is_refused(fn):
    """The Pallas interpreter has no counterpart: the message points at the
    plain version on the CPU."""
    with pytest.raises(ValueError, match='device="cpu"'):
        getattr(driver, fn)(cgltrace.load_trace(TRACE), 32, 32,
                            mode="pallas_interpret", device="cpu")
    with pytest.raises(ValueError):
        getattr(driver, fn)(cgltrace.load_trace(TRACE), 32, 32,
                            mode="mosaic", device="cpu")


def test_compile_frame_bit_exact(jax_frame_256):
    frame, arrays = driver.compile_frame(cgltrace.load_trace(TRACE), 256,
                                         256, mode="deferred", device="cpu")
    np.testing.assert_array_equal(fixed.to_numpy_u32(frame(arrays)),
                                  jax_frame_256)


@pytest.mark.parametrize("start,end", [(1, 2), (2, 3), (0, 0)])
def test_draw_subsets(start, end):
    ref = np.asarray(jax_driver.render_trace(
        _jax_trace(), 256, 256, start_draw=start, end_draw=end,
        mode="deferred"))
    trace = cgltrace.load_trace(TRACE)
    for mode in ("deferred", "immediate"):
        got = driver.render_trace(trace, 256, 256, start_draw=start,
                                  end_draw=end, mode=mode, device="cpu")
        np.testing.assert_array_equal(got, ref, err_msg=mode)


def test_non_square_non_tile_multiple():
    """100x75 pads to tile multiples; 16x16 tiles keep the per-tile prim
    lists short enough for the CPU."""
    ref = np.asarray(jax_driver.render_trace(_jax_trace(), 100, 75,
                                             tile_logsize=4,
                                             mode="deferred"))
    got = driver.render_trace(cgltrace.load_trace(TRACE), 100, 75,
                              tile_logsize=4, mode="deferred", device="cpu")
    assert got.shape == (75, 100)
    np.testing.assert_array_equal(got, ref)


def test_blend_k_cache_and_stale_hint():
    """The blended draw's K grows past DEFAULT_BLEND_SLOTS, is cached on the
    trace, and a stale (too small) cached K is caught at frame end and the
    frame re-rendered exactly."""
    trace = cgltrace.load_trace(TRACE)
    key = (64, 64, 5)

    def render():
        return driver.render_trace(trace, 64, 64, start_draw=2, end_draw=2,
                                   mode="deferred", device="cpu")

    ref = render()
    ks = trace._blend_k_cache[key]
    assert ks[2] > deferred.DEFAULT_BLEND_SLOTS
    trace._blend_k_cache[key] = {2: 1}
    np.testing.assert_array_equal(render(), ref)
    assert trace._blend_k_cache[key] == ks


def test_measure_drawcall_counts_match_jax():
    jt = _jax_trace()
    pt = cgltrace.load_trace(TRACE)
    jdraws = jax_driver.prepare_drawcalls(jt, 256, 256)
    pdraws = driver.prepare_drawcalls(pt, 256, 256, device="cpu")
    jfbd = jnp.full((256, 256), jax_driver.CLEAR_DEPTH, jnp.uint32)
    jfbc = jnp.full((256, 256), jax_driver.CLEAR_COLOR, jnp.uint32)
    pfbc, pfbd = driver.clear_framebuffers(256, 256, 5, "cpu")
    for (jrs, jtex, jb), (prs, ptex, pb) in zip(jdraws, pdraws):
        assert interop.render_state_from_reference(jrs) == prs
        want = jax_deferred.measure_drawcall_counts(jrs, jb, jfbd)
        assert deferred.measure_drawcall_counts(prs, pb, pfbd) == want
        jfbc, jfbd = jax_deferred.render_drawcall(jrs, jtex, jb, jfbc, jfbd)
        pfbc, pfbd = deferred.render_drawcall(prs, ptex, pb, pfbc, pfbd)


def test_immediate_drawcall_matches_jax_oracle():
    """One drawcall through each package's immediate oracle from a seeded
    (non-clear) framebuffer, comparing color and ds words."""
    jt = _jax_trace()
    jrs, jtex, jb = jax_driver.prepare_drawcalls(jt, 64, 64)[3]
    rng = np.random.default_rng(5)
    c0 = rng.integers(0, 2**32, size=(64, 64), dtype=np.uint64)
    d0 = rng.integers(0, 2**32, size=(64, 64), dtype=np.uint64)
    c0, d0 = c0.astype(np.uint32), d0.astype(np.uint32)
    jc, jd = jax_renderer.render_drawcall(jrs, jtex, jb, jnp.asarray(c0),
                                          jnp.asarray(d0))
    pc, pd = renderer.render_drawcall(
        interop.render_state_from_reference(jrs),
        interop.texels_from_reference(jtex),
        interop.binned_from_reference(jb),
        fixed.from_numpy_u32(c0), fixed.from_numpy_u32(d0))
    np.testing.assert_array_equal(fixed.to_numpy_u32(pc), np.asarray(jc))
    np.testing.assert_array_equal(fixed.to_numpy_u32(pd), np.asarray(jd))


def _write_goldens():
    color = np.asarray(jax_driver.render_trace(_jax_trace(), 256, 256,
                                               mode="deferred"), np.uint32)
    np.savez_compressed(GOLDEN_256, color=color)
    with open(GOLDEN_1024, "w") as f:
        json.dump(jax_draw1024(), f, indent=1, sort_keys=True)
        f.write("\n")
    print(GOLDEN_256, GOLDEN_1024)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_frame.py --write")
    import jax
    jax.config.update("jax_platforms", "cpu")
    _write_goldens()
