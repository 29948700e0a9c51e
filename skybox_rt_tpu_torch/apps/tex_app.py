"""Texture-unit demo app — tests/regression/tex analog.

Counterpart of skybox_rt_tpu.apps.tex_app.  Replicates the reference
host+kernel (tex/main.cpp + tex/kernel.cpp): load an image, convert to a
texel format, build the mip chain (host numpy, texture.convert /
texture.mipmap), then sample every destination pixel at (x+0.5)/w,
(y+0.5)/h through the sampler on ``device``, with the host's lod/frac
selection (main.cpp "minification" fixed16 math) and the kernel's filter
modes:

  g0: point     g1: bilinear     g2: two-lod bilinear + Lerp8888(frac)

Texels and colors are int32 patterns on the device (core.fixed); results
leave as numpy uint32, (H, W) ARGB, top-down like the goldens.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core import fixed
from ..core.device import resolve_device
from ..om.blend import div255
from ..texture import convert, mipmap
from ..texture import sampler as sampler_mod
from ..texture import units as units_mod

F32 = np.float32


def _log2floor(x: int) -> int:
    return max(x.bit_length() - 1, 0)


def _pixel_coords(fu: np.ndarray, fv: np.ndarray, dev):
    """Float32 pixel-center u (dst_w,) and v (dst_h,) cast to fixed23 with
    TFixed truncation, as (dst_h, dst_w) int32 tensors on dev."""
    dst_w, dst_h = fu.shape[0], fv.shape[0]
    xu = np.trunc(fu * F32(1 << C.TEX_FXD_FRAC)).astype(np.int64).astype(
        np.int32)
    xv = np.trunc(fv * F32(1 << C.TEX_FXD_FRAC)).astype(np.int64).astype(
        np.int32)
    uu = torch.from_numpy(xu).to(dev)[None, :].expand(dst_h, dst_w)
    vv = torch.from_numpy(xv).to(dev)[:, None].expand(dst_h, dst_w)
    return uu, vv


def _texture(rgba: np.ndarray, fmt: int, filt: int, wrap: int, dev):
    """(TextureState, int32 texel table on dev) of a power-of-two image."""
    h, w = rgba.shape[:2]
    if (w & (w - 1)) or (h & (h - 1)):
        raise ValueError(f"texture {w}x{h} is not a power of two")
    level0 = convert.texels_to_bytes(convert.rgba_to_texels(rgba, fmt), fmt)
    chain, mip_offsets = mipmap.generate_mipmaps(level0, fmt, w, h)
    st = sampler_mod.TextureState(
        format=fmt, log_width=_log2floor(w), log_height=_log2floor(h),
        filter=filt, wrap_u=wrap, wrap_v=wrap,
        mip_offsets=tuple(mip_offsets))
    texels = fixed.from_numpy_u32(sampler_mod.make_texel_array(fmt, chain),
                                  device=dev)
    return st, texels


def run(rgba: np.ndarray, fmt: int = C.TEX_FORMAT_A8R8G8B8,
        filter_g: int = 0, wrap: int = C.TEX_WRAP_CLAMP,
        scale: float = 1.0, device=None) -> np.ndarray:
    """rgba: (H, W, 4) uint8 top-down source image (power-of-two dims),
    sampled on ``device`` (None: the CUDA card).  Returns (dst_h, dst_w)
    uint32 ARGB, top-down (matches the goldens)."""
    dev = resolve_device(device)
    src_h, src_w = rgba.shape[:2]
    st, texels = _texture(
        rgba, fmt, C.TEX_FILTER_BILINEAR if filter_g else C.TEX_FILTER_POINT,
        wrap, dev)

    dst_w = int(src_w * scale)
    dst_h = int(src_h * scale)

    # host lod selection (tex/main.cpp:206-218): fixed16 minification
    width_ratio = F32(1 << st.log_width) / F32(dst_w)
    height_ratio = F32(1 << st.log_height) / F32(dst_h)
    minification = max(width_ratio, height_ratio)
    j = int(np.trunc(F32(max(minification, F32(1.0))) * F32(1 << 16)))
    lod = min(_log2floor(j) - 16, C.TEX_LOD_MAX)
    frac = (j - (1 << (lod + 16))) >> (lod + 16 - 8)

    # kernel u/v generation (tex/kernel.cpp:62-66): times the reciprocal
    fu = (np.arange(dst_w, dtype=F32) + F32(0.5)) * (F32(1.0) / F32(dst_w))
    fv = (np.arange(dst_h, dtype=F32) + F32(0.5)) * (F32(1.0) / F32(dst_h))
    uu, vv = _pixel_coords(fu, fv, dev)
    color = sampler_mod.sample(st, texels, uu, vv, lod=lod)
    if filter_g == 2:
        lodn = min(lod + 1, C.TEX_LOD_MAX)
        c1 = sampler_mod.sample(st, texels, uu, vv, lod=lodn)
        # the masks drop the sign bits an arithmetic >> 8 brings in
        l0, h0 = (color & 0x00FF00FF), ((color >> 8) & 0x00FF00FF)
        l1, h1 = (c1 & 0x00FF00FF), ((c1 >> 8) & 0x00FF00FF)
        cl = sampler_mod.lerp8888(l0, l1, frac)
        ch = sampler_mod.lerp8888(h0, h1, frac)
        color = sampler_mod.pack8888(cl, ch)
    return fixed.to_numpy_u32(color)


def run_multitex(rgba0: np.ndarray, rgba1: np.ndarray,
                 fmt: int = C.TEX_FORMAT_A8R8G8B8,
                 wrap: int = C.TEX_WRAP_CLAMP, device=None) -> np.ndarray:
    """Two-stage sampling through texture.units (the vx_tex(stage, ...)
    surface, VX_TEX_STAGE_COUNT=2) on ``device`` (None: the CUDA card):
    stage 0 modulated by stage 1 (lightmap-style), channelwise Div255
    multiply (cocogfx Mul8888 as used by the blender's color-factor path,
    graphics.cpp:600-620).  Sources may have different power-of-two sizes;
    each stage samples at its own bilinear-centered u/v.  Returns (H0, W0)
    uint32 ARGB."""
    dev = resolve_device(device)
    stages = [_texture(rgba, fmt, C.TEX_FILTER_BILINEAR, wrap, dev)
              for rgba in (rgba0, rgba1)]
    units = units_mod.bind(*(st for st, _ in stages))
    texel_arrays = [t for _, t in stages]

    dst_h, dst_w = rgba0.shape[:2]
    fu = (np.arange(dst_w, dtype=F32) + F32(0.5)) / F32(dst_w)
    fv = (np.arange(dst_h, dtype=F32) + F32(0.5)) / F32(dst_h)
    uu, vv = _pixel_coords(fu, fv, dev)
    c0 = units_mod.sample(units, texel_arrays, 0, uu, vv, lod=0)
    c1 = units_mod.sample(units, texel_arrays, 1, uu, vv, lod=0)

    def chan(shift):
        a = (c0 >> shift) & 0xFF
        b = (c1 >> shift) & 0xFF
        return div255(a.to(torch.int64) * b + 0x80) << shift

    return fixed.to_numpy_u32(chan(24) | chan(16) | chan(8) | chan(0))
