"""Texture sampling: wrap modes, addressing, formats, point/bilinear filter.

Counterpart of skybox_rt_tpu.texture.sampler, the exact port of the
reference sampler (sim/common/graphics.cpp:36-314) on fixed-point u/v with
TEX_FXD_FRAC = 23 fraction bits.  The texture is a flat mip-chain table of
texels stored as int32 patterns on the device (core.fixed); fetches are
gathers into it with the index clamped to the table, as the JAX package's
``mode="clip"`` gather does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import constants as C
from ..core.fixed import i32, u32

FRAC = C.TEX_FXD_FRAC            # 23
ONE = 1 << FRAC
MASK = ONE - 1
HALF = ONE >> 1


@dataclasses.dataclass(frozen=True)
class TextureState:
    """Static per-stage sampler configuration (the TEX DCR block,
    VX_types.vh:332-343)."""
    format: int            # VX_TEX_FORMAT_*
    log_width: int
    log_height: int
    filter: int            # VX_TEX_FILTER_*
    wrap_u: int            # VX_TEX_WRAP_*
    wrap_v: int
    mip_offsets: tuple     # byte offsets per lod into the mip-chain buffer
    quad: bool = False     # texel table is the (N, 4) 2x2 quad table


def texture_wrap(data: torch.Tensor, wrap: int) -> torch.Tensor:
    """TextureWrap (graphics.cpp:36-53) on raw fixed23 int32 data."""
    data = data.to(torch.int32)
    if wrap == C.TEX_WRAP_CLAMP:
        ret = data.clamp(0, MASK)
    elif wrap == C.TEX_WRAP_REPEAT:
        ret = data
    elif wrap == C.TEX_WRAP_MIRROR:
        # (data << (31-F)) >> 31 is all ones exactly when bit F is set
        ret = data ^ -((data >> FRAC) & 1)
    else:
        raise ValueError(f"bad wrap {wrap}")
    return ret & MASK


def unpack8888(fmt: int, texel: torch.Tensor):
    """Format decode to the (lo, hi) 16.16 channel pair layout
    lo = (r<<16)|b, hi = (a<<16)|g used by Lerp8888 (graphics.cpp:72-122).
    Returns int64 values."""
    t = u32(texel)
    if fmt == C.TEX_FORMAT_A8R8G8B8:
        r = (t >> 16) & 0xFF
        g = (t >> 8) & 0xFF
        b = t & 0xFF
        a = t >> 24
    elif fmt == C.TEX_FORMAT_R5G6B5:
        r = ((t >> 8) & 0xF8) | ((t >> 13) & 0x07)
        g = ((t >> 3) & 0xFC) | ((t >> 9) & 0x03)
        b = ((t << 3) & 0xF8) | ((t >> 2) & 0x07)
        a = torch.full_like(t, 0xFF)
    elif fmt == C.TEX_FORMAT_A1R5G5B5:
        r = ((t >> 7) & 0xF8) | ((t >> 12) & 0x07)
        g = ((t >> 2) & 0xF8) | ((t >> 7) & 0x07)
        b = ((t << 3) & 0xF8) | ((t >> 2) & 0x07)
        a = ((t >> 15) & 1) * 0xFF      # sign of (int32)(t << 16), as 0xFF
    elif fmt == C.TEX_FORMAT_A4R4G4B4:
        r = ((t >> 4) & 0xF0) | ((t >> 8) & 0x0F)
        g = (t & 0xF0) | ((t >> 4) & 0x0F)
        b = ((t << 4) & 0xF0) | (t & 0x0F)
        a = ((t >> 8) & 0xF0) | ((t >> 12) & 0x0F)
    elif fmt == C.TEX_FORMAT_A8L8:
        r = t & 0xFF
        g = r
        b = r
        a = (t >> 8) & 0xFF
    elif fmt == C.TEX_FORMAT_L8:
        r = t & 0xFF
        g = r
        b = r
        a = torch.full_like(t, 0xFF)
    elif fmt == C.TEX_FORMAT_A8:
        r = torch.full_like(t, 0xFF)
        g = r
        b = r
        a = t & 0xFF
    else:
        raise ValueError(f"bad format {fmt}")
    lo = ((r << 16) + b) & 0xFFFFFFFF
    hi = ((a << 16) + g) & 0xFFFFFFFF
    return lo, hi


def lerp8888(a, b, f) -> torch.Tensor:
    """Dual-channel lerp with the +0x00800080 rounding bias
    (graphics.h:82-86) on u32 values; returns int64 values."""
    a = u32(torch.as_tensor(a))
    b = u32(torch.as_tensor(b))
    f = u32(torch.as_tensor(f))
    p = (a * ((0xFF - f) & 0xFFFFFFFF) + b * f + 0x00800080) & 0xFFFFFFFF
    q = (p >> 8) & 0x00FF00FF
    return (((p + q) & 0xFFFFFFFF) >> 8) & 0x00FF00FF


def pack8888(lo, hi) -> torch.Tensor:
    """(lo, hi) channel pairs -> packed word, as int32 patterns."""
    return i32((u32(hi) << 8) | u32(lo))


def make_texel_array(fmt: int, mip_chain: np.ndarray) -> np.ndarray:
    """View a flat uint8 mip-chain byte buffer at the texel stride.

    Returns a numpy uint32 array of texels; mip offsets (bytes) divide the
    stride because every level is width*height*stride bytes.
    """
    stride = C.TEX_FORMAT_STRIDE[fmt]
    buf = np.asarray(mip_chain, np.uint8)
    if stride == 1:
        return buf.astype(np.uint32)
    if stride == 2:
        return buf.view("<u2").astype(np.uint32)
    return buf.view("<u4").copy()


def quad_supported(st: TextureState) -> bool:
    """True when the 2x2 quad-table path is exact for this state.

    For REPEAT the +d bilinear neighbor index is always (x0+1) mod W, and
    for CLAMP it is min(x0+1, W-1) except where its weight is zero, so a
    precomputed per-texel 2x2 row replaces the 4 fetches with one.  MIRROR
    reflects the sub-texel fraction at segment ends (graphics.cpp:44-49)
    and keeps the flat 4-fetch path.
    """
    return (st.filter == C.TEX_FILTER_BILINEAR
            and st.wrap_u in (C.TEX_WRAP_CLAMP, C.TEX_WRAP_REPEAT)
            and st.wrap_v in (C.TEX_WRAP_CLAMP, C.TEX_WRAP_REPEAT))


def make_texel_quad_array(st: TextureState, texels: np.ndarray) -> np.ndarray:
    """(N,) uint32 flat mip chain -> (N, 4) uint32 quad table whose row i
    holds [t00, t01, t10, t11], the 2x2 bilinear footprint anchored at
    texel i of its mip level (see quad_supported)."""
    stride = C.TEX_FORMAT_STRIDE[st.format]
    flat = np.asarray(texels, np.uint32)
    out = np.zeros((flat.shape[0], 4), np.uint32)

    def nbr(idx, n, wrap):
        if wrap == C.TEX_WRAP_REPEAT:
            return (idx + 1) % n
        return np.minimum(idx + 1, n - 1)

    for lod, off in enumerate(st.mip_offsets):
        base = off // stride
        w = 1 << max(st.log_width - lod, 0)
        h = 1 << max(st.log_height - lod, 0)
        if base + w * h > flat.shape[0]:
            break
        level = flat[base:base + w * h].reshape(h, w)
        x1 = nbr(np.arange(w), w, st.wrap_u)
        y1 = nbr(np.arange(h), h, st.wrap_v)
        out[base:base + w * h, 0] = level.ravel()
        out[base:base + w * h, 1] = level[:, x1].ravel()
        out[base:base + w * h, 2] = level[y1, :].ravel()
        out[base:base + w * h, 3] = level[np.ix_(y1, x1)].ravel()
        if w == 1 and h == 1:
            break
    return out


def _fetch(st: TextureState, texels: torch.Tensor, offset: torch.Tensor,
           lod: int) -> torch.Tensor:
    """Gather texels (or quad rows) at per-lod texel offsets; the index is
    clamped to the table, like the JAX package's mode="clip" take."""
    stride = C.TEX_FORMAT_STRIDE[st.format]
    base = st.mip_offsets[lod] // stride
    idx = (offset.to(torch.int64) + base).clamp(0, texels.shape[0] - 1)
    return texels[idx]


def sample(st: TextureState, texels: torch.Tensor, u: torch.Tensor,
           v: torch.Tensor, lod: int = 0) -> torch.Tensor:
    """TextureSampler::read (graphics.cpp:253-313); u, v raw fixed23 int32.

    texels: int32 patterns, (N,) flat or (N, 4) when st.quad.  lod is
    static (the draw3d shader samples lod 0, draw3d/kernel.cpp:152-156).
    Returns packed ARGB as int32 patterns.
    """
    log_w = max(st.log_width - lod, 0)
    log_h = max(st.log_height - lod, 0)
    u = u.to(torch.int32)
    v = v.to(torch.int32)

    if st.filter == C.TEX_FILTER_BILINEAR:
        delta_x = HALF >> log_w
        delta_y = HALF >> log_h
        # u -/+ delta wraps in int32 like the reference's int arithmetic
        u0 = texture_wrap(i32(u.to(torch.int64) - delta_x), st.wrap_u)
        u1 = texture_wrap(i32(u.to(torch.int64) + delta_x), st.wrap_u)
        v0 = texture_wrap(i32(v.to(torch.int64) - delta_y), st.wrap_v)
        v1 = texture_wrap(i32(v.to(torch.int64) + delta_y), st.wrap_v)

        # wrapped coords are < 2^23, so the << 8 stays inside int32
        x0s = (u0 << 8) >> (FRAC - log_w)
        y0s = (v0 << 8) >> (FRAC - log_h)
        x0 = x0s >> 8
        y0 = y0s >> 8

        if st.quad:
            q = _fetch(st, texels, x0 + (y0 << log_w), lod)
            t00, t01, t10, t11 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        else:
            x1 = u1 >> (FRAC - log_w)
            y1 = v1 >> (FRAC - log_h)
            t00 = _fetch(st, texels, x0 + (y0 << log_w), lod)
            t01 = _fetch(st, texels, x1 + (y0 << log_w), lod)
            t10 = _fetch(st, texels, x0 + (y1 << log_w), lod)
            t11 = _fetch(st, texels, x1 + (y1 << log_w), lod)

        alpha = x0s & 0xFF
        beta = y0s & 0xFF
        l00, h00 = unpack8888(st.format, t00)
        l01, h01 = unpack8888(st.format, t01)
        l10, h10 = unpack8888(st.format, t10)
        l11, h11 = unpack8888(st.format, t11)
        c01l = lerp8888(l00, l01, alpha)
        c01h = lerp8888(h00, h01, alpha)
        c23l = lerp8888(l10, l11, alpha)
        c23h = lerp8888(h10, h11, alpha)
        return pack8888(lerp8888(c01l, c23l, beta),
                        lerp8888(c01h, c23h, beta))

    if st.filter == C.TEX_FILTER_POINT:
        x = texture_wrap(u, st.wrap_u) >> (FRAC - log_w)
        y = texture_wrap(v, st.wrap_v) >> (FRAC - log_h)
        t = _fetch(st, texels, x + (y << log_w), lod)
        if st.quad:
            t = t[..., 0]
        lo, hi = unpack8888(st.format, t)
        return pack8888(lo, hi)
    raise ValueError(f"bad filter {st.filter}")
