"""rt.raster_bridge: the port against the JAX package, function by function
and on the whole synthetic config-3 trace (both packages read the same bytes
of ``data/synth_config3.npz``).

Tolerances.  Host geometry (``_screen_triangles``, ``_winner_tris``), the
blend factors and the depth funcs: exactly equal.  Texture fetches: 1e-6 (a
lerp of values in [0, 1]).  Composites, scans and whole images: the port's
float renderer repeats the JAX arithmetic, but XLA's CPU code contracts
multiply-adds and eager torch does not, so values agree to 2e-5; a ray that
grazes an edge could gain or lose a whole fragment, which would show as a
pixel far beyond that: the images here have none (asserted: every value
within 1e-4, >= 99.9 % within 2e-5).
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skybox_rt_tpu.geom import cgltrace as jax_cgltrace
from skybox_rt_tpu.rt import raster_bridge as jax_rb
from skybox_rt_tpu_torch.core import constants as C
from skybox_rt_tpu_torch.geom import cgltrace
from skybox_rt_tpu_torch.rt import raster_bridge as rb

torch.set_num_threads(1)

SIZE = 64
SMALL = 24
NUM_DRAWS = 7


def _both(name):
    """(port trace, JAX trace) of a committed npz, from the same bytes."""
    path = cgltrace.trace_path(name)
    with np.load(path, allow_pickle=False) as z:
        return cgltrace.load_npz(path), jax_cgltrace._from_npz(z)


@pytest.fixture(scope="module")
def traces():
    return _both("synth_config3")


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, what)
    d = np.abs(got[finite] - want[finite])
    if d.size:
        print(f"{what}: max |diff| {d.max():.3e}, beyond 2e-5: "
              f"{int((d > 2e-5).sum())} of {d.size}")
        assert d.max() <= 1e-4, what
        assert (d <= 2e-5).mean() >= 0.999, what


@pytest.mark.parametrize("di", range(NUM_DRAWS))
def test_screen_triangles_and_winner_tris(traces, di):
    trace, jtrace = traces
    geo = rb._screen_triangles(trace.drawcalls[di], SIZE, SIZE)
    jgeo = jax_rb._screen_triangles(jtrace.drawcalls[di], SIZE, SIZE)
    assert geo.keys() == jgeo.keys()
    for k in geo:
        np.testing.assert_array_equal(geo[k], jgeo[k], err_msg=k)
    st, jst = trace.drawcalls[di].states, jtrace.drawcalls[di].states
    key, jkey = rb._depth_key(geo, st), jax_rb._depth_key(jgeo, jst)
    assert (key is None) == (jkey is None)
    if key is not None:
        np.testing.assert_array_equal(key, jkey)
    np.testing.assert_array_equal(rb._winner_tris(geo, key),
                                  jax_rb._winner_tris(jgeo, jkey))
    assert rb._scan_statics(st, trace.drawcalls[di]) == \
        jax_rb._scan_statics(jst, jtrace.drawcalls[di])


def test_screen_triangles_rejects():
    """Behind-the-eye and zero-area triangles are dropped; none left: None."""
    import types
    pos = np.array([[0, 0, 0, 1], [1, 0, 0, 1], [0, 1, 0, 1],
                    [0, 0, 0, -1], [2, 2, 0, 1]], np.float32)
    idx = np.array([[0, 1, 2], [0, 1, 3], [0, 0, 1], [0, 4, 4]], np.int32)
    dc = types.SimpleNamespace(pos=pos, indices=idx, near=0.0, far=1.0,
                               color=np.ones((5, 4), np.float32),
                               texcoord=np.zeros((5, 2), np.float32))
    geo, jgeo = (m._screen_triangles(dc, 16, 16) for m in (rb, jax_rb))
    np.testing.assert_array_equal(geo["indices"], [[0, 1, 2]])
    np.testing.assert_array_equal(geo["indices"], jgeo["indices"])
    dc.indices = idx[1:]
    assert rb._screen_triangles(dc, 16, 16) is None
    assert jax_rb._screen_triangles(dc, 16, 16) is None


@pytest.mark.parametrize("repeat", [True, False], ids=["repeat", "clamp"])
@pytest.mark.parametrize("bilinear", [True, False], ids=["bilinear", "point"])
def test_sample_texture_wrap(repeat, bilinear):
    rng = np.random.default_rng(7)
    tex = rng.uniform(0, 1, size=(16, 8, 4)).astype(np.float32)
    u = rng.uniform(-1.5, 2.5, size=4000).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, size=4000).astype(np.float32)
    # texel centres and borders exactly
    u[:64] = (np.arange(64) / 16 - 1.0).astype(np.float32)
    v[:64] = (np.arange(64) / 32 - 0.5).astype(np.float32)
    got = rb._sample_texture_wrap(torch.as_tensor(tex), torch.as_tensor(u),
                                  torch.as_tensor(v), repeat, bilinear)
    want = jax_rb._sample_texture_wrap(jnp.asarray(tex), jnp.asarray(u),
                                       jnp.asarray(v), repeat, bilinear)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("factor", sorted(rb._BLEND_FACTORS))
def test_blend_factors(factor):
    assert sorted(rb._BLEND_FACTORS) == sorted(jax_rb._BLEND_FACTORS)
    rng = np.random.default_rng(factor)
    s = rng.uniform(0, 1, size=(500, 4)).astype(np.float32)
    d = rng.uniform(0, 1, size=(500, 4)).astype(np.float32)
    got = rb._BLEND_FACTORS[factor](torch.as_tensor(s), torch.as_tensor(d))
    want = jax_rb._BLEND_FACTORS[factor](jnp.asarray(s), jnp.asarray(d))
    assert tuple(got.shape) == (500, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("func", range(8))
def test_depth_pass(func):
    rng = np.random.default_rng(func)
    z = rng.integers(0, 4, size=300).astype(np.float32)
    zbuf = rng.integers(0, 4, size=300).astype(np.float32)
    zbuf[::7] = np.inf
    got = rb._depth_pass(func, torch.as_tensor(z), torch.as_tensor(zbuf))
    want = jax_rb._depth_pass(func, jnp.asarray(z), jnp.asarray(zbuf))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _seeded_buffers(R, seed):
    """A z-buffer and a color buffer that earlier draws might have left:
    depth in the trace's range with holes at +inf, colors in [0, 1]."""
    rng = np.random.default_rng(seed)
    zbuf = rng.uniform(0.2, 0.8, size=R).astype(np.float32)
    zbuf[rng.random(R) < 0.3] = np.inf
    return zbuf, rng.uniform(0, 1, size=(R, 4)).astype(np.float32)


@pytest.mark.parametrize("di", range(NUM_DRAWS))
def test_scan_drawcall_matches_jax(traces, di):
    """The submission-order scan of every draw (whatever path the renderer
    would give it) over seeded buffers, at 24x24."""
    trace, jtrace = traces
    dc, jdc = trace.drawcalls[di], jtrace.drawcalls[di]
    geo = rb._screen_triangles(dc, SMALL, SMALL)
    jgeo = jax_rb._screen_triangles(jdc, SMALL, SMALL)
    if di in (1, 2):        # 5,000 triangles: a sixth of them is enough
        for g in (geo, jgeo):
            g["indices"] = g["indices"][::6]
    _, _, nx, ny = rb.pixel_rays(SMALL, SMALL, "cpu")
    zbuf, color = _seeded_buffers(SMALL * SMALL, di)
    z, c = rb._scan_drawcall(geo, dc.states, dc, trace, nx, ny,
                             torch.as_tensor(zbuf), torch.as_tensor(color))
    jz, jc = jax_rb._scan_drawcall(
        jgeo, jdc.states, jdc, jtrace, jnp.asarray(nx.numpy()),
        jnp.asarray(ny.numpy()), jnp.asarray(zbuf), jnp.asarray(color))
    assert np.abs(c.numpy() - color).max() > 0.05       # the draw shows
    _close(z.numpy(), np.asarray(jz), f"draw {di} zbuf")
    _close(c.numpy(), np.asarray(jc), f"draw {di} color")
    if not dc.states.depth_writemask or not dc.states.depth_test:
        np.testing.assert_array_equal(z.numpy(), zbuf)
    if di == 6:             # alpha is masked out of the write
        np.testing.assert_array_equal(c.numpy()[:, 3], color[:, 3])


@pytest.mark.parametrize("perspective", [True, False],
                         ids=["perspective", "screen"])
@pytest.mark.parametrize("di", range(NUM_DRAWS))
def test_winner_composite_matches_jax(traces, di, perspective):
    """The winner-path composite of every draw's state on the same hits (the
    JAX brute-force winner's prim, u, v) over seeded buffers."""
    trace, jtrace = traces
    dc, jdc = trace.drawcalls[di], jtrace.drawcalls[di]
    st = dc.states
    jgeo = jax_rb._screen_triangles(jdc, SMALL, SMALL)
    geo = rb._screen_triangles(dc, SMALL, SMALL)
    px, py, nx, ny = rb.pixel_rays(SMALL, SMALL, "cpu")
    jn = [jnp.asarray(a.numpy()) for a in (px, py, nx, ny)]
    if perspective:
        farthest = st.depth_func in (C.CGL_COMPARE_GREATER,
                                     C.CGL_COMPARE_GEQUAL)
        prim, u, v = jax_rb._persp_hit(jgeo, jn[2], jn[3], farthest, "brute")
        zattr = geo["clip"][:, 2:4].astype(np.float32)
        mine = rb._persp_hit(geo, nx, ny, farthest, "brute")
    else:
        key = jax_rb._depth_key(jgeo, jdc.states)
        prim, u, v = jax_rb._closest_hit(jax_rb._winner_tris(jgeo, key),
                                         jn[0], jn[1], "brute")
        zattr = geo["xy_z"][:, 2:3].astype(np.float32)
        mine = rb._closest_hit(rb._winner_tris(geo, key), px, py, "brute")
    prim, u, v = (np.array(a) for a in (prim, u, v))
    # the port's own winner: the same misses, the same prim on >= 99 %
    np.testing.assert_array_equal(mine[0].numpy() < 0, prim < 0)
    assert (mine[0].numpy() == prim).mean() >= 0.99
    assert (prim >= 0).mean() > 0.03

    statics = rb._scan_statics(st, dc)
    zbuf, color = _seeded_buffers(SMALL * SMALL, 10 + di)
    img = rb._texture_image(trace, dc, st, "cpu")
    z, c = rb._winner_composite(
        statics, perspective, rb._channel_mask(statics[11], "cpu"),
        torch.as_tensor(geo["indices"]), torch.as_tensor(geo["rhw"]),
        torch.as_tensor(zattr), torch.as_tensor(geo["color"]),
        torch.as_tensor(geo["uv"]), img, torch.as_tensor(prim),
        torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(zbuf),
        torch.as_tensor(color))
    jz, jc = jax_rb._winner_composite_jit(
        jax_rb._scan_statics(jdc.states, jdc), perspective,
        jnp.asarray(jgeo["indices"]), jnp.asarray(jgeo["rhw"]),
        jnp.asarray(zattr), jnp.asarray(jgeo["color"]),
        jnp.asarray(jgeo["uv"]), jnp.asarray(img.numpy()), jnp.asarray(prim),
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(zbuf), jnp.asarray(color))
    _close(z.numpy(), np.asarray(jz), f"draw {di} zbuf")
    _close(c.numpy(), np.asarray(jc), f"draw {di} color")


@pytest.mark.parametrize("camera,engine", [
    ("screen", "brute"), ("screen", "bvh"), ("perspective", "brute"),
    ("perspective", "bvh")])
def test_render_trace_rt_matches_jax(traces, camera, engine):
    trace, jtrace = traces
    got = rb.render_trace_rt(trace, SIZE, SIZE, engine=engine, camera=camera,
                             device="cpu")
    want = jax_rb.render_trace_rt(jtrace, SIZE, SIZE, engine=engine,
                                  camera=camera)
    assert got.shape == (SIZE, SIZE, 4) and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert (got[..., :3].max(-1) > 0.5).mean() > 0.1
    _close(got, want, f"{camera} {engine}")


def test_render_subset_and_engines_agree(traces):
    """start_draw / end_draw, and the three engines of the screen camera
    (the BVH-block kernel's plain version among them) on the winner draws."""
    trace, _ = traces
    kw = dict(camera="screen", start_draw=1, end_draw=3, device="cpu")
    a = rb.render_trace_rt(trace, 32, 32, engine="brute", **kw)
    for engine in ("bvh", "pallas_bvh"):
        b = rb.render_trace_rt(trace, 32, 32, engine=engine, **kw)
        np.testing.assert_allclose(a, b, atol=2e-5, err_msg=engine)
    assert np.abs(a - rb.render_trace_rt(
        trace, 32, 32, engine="brute", camera="screen", start_draw=1,
        end_draw=2, device="cpu")).max() > 0.05
    assert len(rb._ENGINE_PREP_CACHE) <= 256


@pytest.mark.parametrize("camera", ["screen", "perspective"])
def test_on_stencil_raise_and_skip(camera):
    """synth_draw3d's last draw has the stencil test on."""
    trace, jtrace = _both("synth_draw3d")
    assert trace.drawcalls[3].states.stencil_test
    with pytest.raises(NotImplementedError, match="stencil"):
        rb.render_trace_rt(trace, 16, 16, engine="brute", camera=camera,
                           device="cpu")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = rb.render_trace_rt(trace, 16, 16, engine="brute", camera=camera,
                                 on_stencil="skip", device="cpu")
    assert any("stencil" in str(w.message) for w in seen)
    three = rb.render_trace_rt(trace, 16, 16, engine="brute", camera=camera,
                               end_draw=3, device="cpu")
    np.testing.assert_array_equal(got, three)


def test_framebuffer_to_float_and_scene_by_name():
    fb = np.array([[0xFF102030, 0x00000000], [0x80FFFFFF, 0x01020304]],
                  np.uint32)
    np.testing.assert_array_equal(rb.framebuffer_to_float(fb),
                                  jax_rb.framebuffer_to_float(fb))
    trace, _ = _both("synth_config3")
    by_name = rb.render_scene_rt("synth_config3", 16, 16, engine="brute",
                                 end_draw=2, device="cpu")
    np.testing.assert_array_equal(by_name, rb.render_trace_rt(
        trace, 16, 16, engine="brute", end_draw=2, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rb.render_trace_rt(trace, 16, 16)
