"""Texture sampler of the port against skybox_rt_tpu.texture.sampler.sample.

7 formats x 3 wraps x point/bilinear x flat/quad texel layouts (the quad
layout exists for point and for bilinear CLAMP/REPEAT, where
quad_supported holds), on random coordinates plus coordinates dense at
texel edges, from numpy seeds.  Exact equality.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skybox_rt_tpu.texture import mipmap as jmipmap
from skybox_rt_tpu.texture import sampler as jsampler
from skybox_rt_tpu_torch.core import constants as C
from skybox_rt_tpu_torch.core import fixed
from skybox_rt_tpu_torch.texture import mipmap, sampler

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

FORMATS = list(range(7))
WRAPS = [C.TEX_WRAP_CLAMP, C.TEX_WRAP_REPEAT, C.TEX_WRAP_MIRROR]
FILTERS = [C.TEX_FILTER_POINT, C.TEX_FILTER_BILINEAR]
ONE = 1 << C.TEX_FXD_FRAC
LOG_W, LOG_H = 4, 3


def _cases():
    for fmt, wrap, filt in itertools.product(FORMATS, WRAPS, FILTERS):
        layouts = ["flat", "quad"]
        if filt == C.TEX_FILTER_BILINEAR and wrap == C.TEX_WRAP_MIRROR:
            layouts = ["flat"]           # quad_supported is False there
        for layout in layouts:
            yield fmt, wrap, filt, layout


def _coords(seed, n=4096):
    rng = np.random.default_rng(seed)
    u = rng.integers(-ONE, 2 * ONE, size=n, dtype=np.int64)
    v = rng.integers(-ONE, 2 * ONE, size=n, dtype=np.int64)
    dx, dy = (ONE >> 1) >> LOG_W, (ONE >> 1) >> LOG_H
    eu = np.concatenate([np.arange(0, ONE, ONE >> LOG_W) + o
                         for o in (0, 1, -1, dx, -dx, dx - 1, -dx + 1)])
    ev = np.concatenate([np.arange(0, ONE, ONE >> LOG_H) + o
                         for o in (0, 1, -1, dy, -dy, dy - 1, -dy + 1)])
    k = min(len(eu), len(ev))
    u = np.concatenate([u, eu[:k], np.full(k, 7 << 10),
                        [2 ** 31 - 1, -(2 ** 31)]])
    v = np.concatenate([v, np.full(k, 5 << 10), ev[:k],
                        [-(2 ** 31), 2 ** 31 - 1]])
    return u.astype(np.int32), v.astype(np.int32)


@pytest.mark.parametrize("fmt,wrap,filt,layout", list(_cases()))
def test_sample_bit_exact(fmt, wrap, filt, layout):
    rng = np.random.default_rng(100 * fmt + 10 * wrap + filt)
    stride = C.TEX_FORMAT_STRIDE[fmt]
    pixels = rng.integers(0, 256, size=(1 << LOG_W) * (1 << LOG_H) * stride,
                          dtype=np.uint8)
    chain, offsets = mipmap.generate_mipmaps(pixels, fmt, 1 << LOG_W,
                                             1 << LOG_H)
    jchain, joffsets = jmipmap.generate_mipmaps(pixels, fmt, 1 << LOG_W,
                                                1 << LOG_H)
    np.testing.assert_array_equal(chain, jchain)
    assert offsets == joffsets

    st = sampler.TextureState(format=fmt, log_width=LOG_W, log_height=LOG_H,
                              filter=filt, wrap_u=wrap, wrap_v=wrap,
                              mip_offsets=tuple(offsets))
    jst = jsampler.TextureState(**dataclasses.asdict(st))
    flat = sampler.make_texel_array(fmt, chain)
    np.testing.assert_array_equal(flat, jsampler.make_texel_array(fmt, jchain))
    texels = flat
    if layout == "quad":
        texels = sampler.make_texel_quad_array(st, flat)
        np.testing.assert_array_equal(
            texels, jsampler.make_texel_quad_array(jst, flat))
        st = dataclasses.replace(st, quad=True)
        jst = dataclasses.replace(jst, quad=True)

    u, v = _coords(fmt + wrap)
    want = np.asarray(jsampler.sample(jst, jnp.asarray(texels),
                                      jnp.asarray(u), jnp.asarray(v)))
    got = sampler.sample(st, fixed.from_numpy_u32(texels),
                         torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(fixed.to_numpy_u32(got), want)


@pytest.mark.parametrize("wrap", WRAPS)
def test_texture_wrap(wrap):
    u, _ = _coords(wrap)
    want = np.asarray(jsampler.texture_wrap(jnp.asarray(u), wrap))
    np.testing.assert_array_equal(
        sampler.texture_wrap(torch.from_numpy(u), wrap).numpy(), want)
