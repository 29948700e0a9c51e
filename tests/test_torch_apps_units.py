"""The unit apps (om, tex, raster) and the texture conversion and units of
the port against the JAX package, on the CPU.  Every output here is an
ARGB word or a texel, so the tolerance is exact equality.

Inputs are seeded numpy images (the reference's PNGs are not in the
repository) and the committed synthetic trace.  ``raster_app.run`` reads a
trace by name through ``cgltrace.load_cached``; the JAX module's lookup
points at the absent reference assets, so for this test pytest's
``monkeypatch`` points the JAX module's ``cgltrace.load_cached`` at the
committed npz (as tests/test_torch_frame.py loads it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skybox_rt_tpu.apps import om_app as jom_app
from skybox_rt_tpu.apps import raster_app as jraster_app
from skybox_rt_tpu.apps import tex_app as jtex_app
from skybox_rt_tpu.geom import cgltrace as jcgltrace
from skybox_rt_tpu.texture import convert as jconvert
from skybox_rt_tpu.texture import mipmap as jmipmap
from skybox_rt_tpu.texture import sampler as jsampler
from skybox_rt_tpu.texture import units as junits
from skybox_rt_tpu_torch import interop
from skybox_rt_tpu_torch.apps import om_app, raster_app, tex_app
from skybox_rt_tpu_torch.core import constants as C
from skybox_rt_tpu_torch.core import fixed
from skybox_rt_tpu_torch.geom import cgltrace
from skybox_rt_tpu_torch.texture import convert, units

torch.set_num_threads(1)

FORMATS = list(range(7))


def _rgba(seed, h=64, w=64):
    return np.random.default_rng(seed).integers(
        0, 256, size=(h, w, 4)).astype(np.uint8)


@pytest.mark.parametrize("size", [8, 32, 64])
def test_om_whitebox(size):
    got = om_app.run(size, size, device="cpu")
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jom_app.run(size, size))
    assert (got == 0xFFFFFFFF).all()


@pytest.mark.parametrize("kw", [
    dict(blend_enable=True, num_tasks=16),
    dict(blend_enable=True, depth_enable=True, num_tasks=7,
         color=0x80C0FFEE),
    dict(depth_enable=True, depth=0x123456, color=0x12345678)])
def test_om_blend_and_depth_bands(kw):
    got = om_app.run(64, 48, device="cpu", **kw)
    np.testing.assert_array_equal(got, jom_app.run(64, 48, **kw))


@pytest.mark.parametrize("fmt", FORMATS)
def test_convert(fmt):
    rgba = _rgba(fmt)
    texels = convert.rgba_to_texels(rgba, fmt)
    np.testing.assert_array_equal(texels, jconvert.rgba_to_texels(rgba, fmt))
    np.testing.assert_array_equal(convert.texels_to_bytes(texels, fmt),
                                  jconvert.texels_to_bytes(texels, fmt))


@pytest.mark.parametrize("g", [0, 1, 2])
@pytest.mark.parametrize("fmt", FORMATS)
def test_tex_app(fmt, g):
    """Every format through every filter; g2 minifies by 2 so its second
    lod and the host's frac take part."""
    rgba = _rgba(10 + fmt)
    scale = 0.5 if g == 2 else 1.0
    got = tex_app.run(rgba, fmt=fmt, filter_g=g, scale=scale, device="cpu")
    want = jtex_app.run(rgba, fmt=fmt, filter_g=g, scale=scale)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wrap", [C.TEX_WRAP_REPEAT, C.TEX_WRAP_MIRROR])
def test_tex_app_wraps_and_scale(wrap):
    rgba = _rgba(20, 32, 64)
    got = tex_app.run(rgba, filter_g=2, wrap=wrap, scale=0.25, device="cpu")
    np.testing.assert_array_equal(
        got, jtex_app.run(rgba, filter_g=2, wrap=wrap, scale=0.25))


def test_run_multitex():
    """Two stages of different sizes and the Div255 modulation."""
    rgba0 = _rgba(30)
    rgba1 = _rgba(31, 32, 16)
    got = tex_app.run_multitex(rgba0, rgba1, device="cpu")
    np.testing.assert_array_equal(got, jtex_app.run_multitex(rgba0, rgba1))
    got = tex_app.run_multitex(rgba0, rgba1, fmt=C.TEX_FORMAT_R5G6B5,
                               wrap=C.TEX_WRAP_MIRROR, device="cpu")
    np.testing.assert_array_equal(got, jtex_app.run_multitex(
        rgba0, rgba1, fmt=C.TEX_FORMAT_R5G6B5, wrap=C.TEX_WRAP_MIRROR))


def test_units_bind_and_sample():
    """Two bound stages of different formats sample as the JAX units do, on
    the states carried across with interop."""
    rgba = _rgba(40)
    jstages, tables = [], []
    for fmt, filt in ((C.TEX_FORMAT_A8R8G8B8, C.TEX_FILTER_POINT),
                      (C.TEX_FORMAT_L8, C.TEX_FILTER_BILINEAR)):
        level0 = jconvert.texels_to_bytes(jconvert.rgba_to_texels(rgba, fmt),
                                          fmt)
        chain, offs = jmipmap.generate_mipmaps(level0, fmt, 64, 64)
        jstages.append(jsampler.TextureState(
            format=fmt, log_width=6, log_height=6, filter=filt,
            wrap_u=C.TEX_WRAP_CLAMP, wrap_v=C.TEX_WRAP_REPEAT,
            mip_offsets=tuple(offs)))
        tables.append(jsampler.make_texel_array(fmt, chain))
    ju = junits.bind(*jstages)
    pu = interop.texture_units_from_reference(ju)
    assert pu == units.bind(*pu.states)
    r = np.random.default_rng(41)
    uu = r.integers(-(1 << 23), 1 << 24, size=257).astype(np.int32)
    vv = r.integers(-(1 << 23), 1 << 24, size=257).astype(np.int32)
    ptables = [interop.texels_from_reference(tb) for tb in tables]
    jtables = [jnp.asarray(tb) for tb in tables]
    for stage in (0, 1):
        for lod in (0, 2):
            got = units.sample(pu, ptables, stage, torch.from_numpy(uu),
                               torch.from_numpy(vv), lod=lod)
            want = junits.sample(ju, jtables, stage, jnp.asarray(uu),
                                 jnp.asarray(vv), lod=lod)
            np.testing.assert_array_equal(fixed.to_numpy_u32(got),
                                          np.asarray(want, np.uint32))
    assert units.STAGE_COUNT == junits.STAGE_COUNT
    with pytest.raises(ValueError):
        units.bind(*pu.states, pu.states[0])      # > STAGE_COUNT
    with pytest.raises(ValueError):
        units.bind(pu.states[0], None).state(1)


@pytest.mark.parametrize("size", [64, 128])
def test_raster_app(size, monkeypatch):
    path = cgltrace.trace_path("synth_draw3d")

    def jax_load(p, cache_dir=None):
        with np.load(p) as z:
            return jcgltrace._from_npz(z)

    monkeypatch.setattr(jcgltrace, "load_cached", jax_load)
    monkeypatch.setattr(jcgltrace, "trace_path", lambda name: path)
    got = raster_app.run("synth_draw3d", size, size)
    want = jraster_app.run("synth_draw3d", size, size)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert (got == raster_app.WHITE).sum() > size      # something covered
