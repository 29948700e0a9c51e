"""The port's frame statistics and frame loop against the JAX package's, on
the CPU.

``render_trace(stats=, measure_traffic=)`` fills a FrameStats that must equal
the JAX package's field for field and key for key, in the immediate and
deferred modes, with and without the measured traffic; a stale blend-slot
hint makes the frame render again, and that retry counts nothing twice.
``compile_frame_loop``'s last frame equals compile_frame's and the JAX
package's loop bit for bit, and the sentinel never renders.  Everything runs
on synth_draw3d at 64x64 with 8x8 tiles (tile_logsize 3), which keeps the
plain pass-1 loop over a tile's primitives short on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from skybox_rt_tpu.geom import cgltrace as jax_cgltrace
from skybox_rt_tpu.ref import driver as jax_driver
from skybox_rt_tpu_torch.core import fixed
from skybox_rt_tpu_torch.geom import cgltrace
from skybox_rt_tpu_torch.ref import driver

torch.set_num_threads(1)

SIZE = 64
TLS = 3
BLENDED_DRAW = 2       # synth_draw3d's alpha-blended draw (K 4 -> 16)


def _traces():
    path = cgltrace.trace_path("synth_draw3d")
    with np.load(path) as z:
        jax_trace = jax_cgltrace._from_npz(z)
    return jax_trace, cgltrace.load_trace(path)


def _stats(mod, trace, mode, measure, device=None):
    stats = mod.FrameStats()
    kw = {} if device is None else {"device": device}
    fb = mod.render_trace(trace, SIZE, SIZE, TLS, stats=stats, mode=mode,
                          measure_traffic=measure, **kw)
    return np.asarray(fb), stats


@pytest.mark.parametrize("mode", ["immediate", "deferred"])
@pytest.mark.parametrize("measure", [False, True])
def test_frame_stats_as_jax(mode, measure):
    jax_trace, trace = _traces()
    want_fb, want = _stats(jax_driver, jax_trace, mode, measure)
    got_fb, got = _stats(driver, trace, mode, measure, "cpu")
    np.testing.assert_array_equal(got_fb, want_fb)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.drawcalls == 4 and got.prims_binned > 0 and got.tiles > 0
    measured = "fragments" in got.traffic
    assert measured == measure
    assert all(type(v) is int for v in got.traffic.values())


def test_retry_counts_each_draw_once():
    """A cached blend-slot count too small for the blended draw: the frame
    finds the overflow at its end and renders again without the stats, as
    the JAX package does, so each draw is counted once."""
    jax_trace, trace = _traces()
    for t in (jax_trace, trace):
        t._blend_k_cache = {(SIZE, SIZE, TLS): {BLENDED_DRAW: 1}}
    want_fb, want = _stats(jax_driver, jax_trace, "deferred", True)
    got_fb, got = _stats(driver, trace, "deferred", True, "cpu")
    np.testing.assert_array_equal(got_fb, want_fb)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.drawcalls == 4
    assert trace._blend_k_cache[(SIZE, SIZE, TLS)][BLENDED_DRAW] > 1


@pytest.fixture(scope="module")
def frames():
    jax_trace, trace = _traces()
    frame, arrays = driver.compile_frame(trace, SIZE, SIZE, TLS,
                                         mode="deferred", device="cpu")
    return jax_trace, trace, fixed.to_numpy_u32(frame(arrays))


@pytest.mark.parametrize("n", [1, 3])
def test_frame_loop_equals_the_frame_and_jax(frames, n):
    jax_trace, trace, want = frames
    loop, arrays = driver.compile_frame_loop(trace, SIZE, SIZE, n, TLS,
                                             mode="deferred", device="cpu")
    got = loop(arrays)
    assert got.dtype == torch.int32 and tuple(got.shape) == (SIZE, SIZE)
    got = fixed.to_numpy_u32(got)
    np.testing.assert_array_equal(got, want)
    jax_loop, jax_arrays = jax_driver.compile_frame_loop(
        jax_trace, SIZE, SIZE, n, TLS, mode="deferred")
    np.testing.assert_array_equal(got, np.asarray(jax_loop(jax_arrays)))
    assert driver.FRAME_LOOP_SENTINEL == jax_driver.FRAME_LOOP_SENTINEL
    assert not (got == driver.FRAME_LOOP_SENTINEL).any()


@pytest.mark.parametrize("n", [1, 2])
def test_frame_loop_carries_the_sentinel_count(monkeypatch, n):
    """With the clear color set to the sentinel and no draw, frame 1 counts
    z = 64 sentinel pixels in the cleared buffer and clears to sentinel ^ 64;
    frame 2 counts none and clears to the sentinel: each frame depends on
    the one before, in both packages alike."""
    jax_trace, trace = _traces()
    for t in (jax_trace, trace):
        t.drawcalls = []
    for mod in (driver, jax_driver):
        monkeypatch.setattr(mod, "CLEAR_COLOR", driver.FRAME_LOOP_SENTINEL)
    loop, arrays = driver.compile_frame_loop(trace, 8, 8, n, TLS,
                                             mode="deferred", device="cpu")
    got = fixed.to_numpy_u32(loop(arrays))
    sen = int(driver.FRAME_LOOP_SENTINEL)
    np.testing.assert_array_equal(got, sen ^ 64 if n == 1 else sen)
    jax_loop, jax_arrays = jax_driver.compile_frame_loop(
        jax_trace, 8, 8, n, TLS, mode="deferred")
    np.testing.assert_array_equal(got, np.asarray(jax_loop(jax_arrays)))


@pytest.mark.parametrize("z", [0, 7])
def test_shift_arrays_moves_the_first_four_alone(z):
    from skybox_rt_tpu_torch.ops import deferred
    _, trace = _traces()
    _, _, binned = driver.prepare_drawcalls(trace, SIZE, SIZE, TLS, "cpu")[0]
    dev_arrays = deferred.device_arrays(binned, "cpu")
    got = driver.shift_arrays(dev_arrays, torch.tensor(z, dtype=torch.int32))
    assert len(got) == len(dev_arrays)
    for a, b in zip(got[:4], dev_arrays[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b + z)
    assert all(a is b for a, b in zip(got[4:], dev_arrays[4:]))
