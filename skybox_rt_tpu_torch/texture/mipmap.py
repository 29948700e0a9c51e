"""Mip-chain generation (cocogfx GenerateMipmaps analog, used at
draw3d/main.cpp:297).  Counterpart of skybox_rt_tpu.texture.mipmap: numpy
host code, copied as is.

The draw3d shader always samples lod 0 (kernel.cpp:152-156), so only the
level-0 slice affects golden parity; deeper levels are generated with a
2x2 box filter in ARGB8888 space and re-encoded, for the standalone tex
demo path (tests/regression/tex).
"""
from __future__ import annotations

import numpy as np

from ..core import constants as C


def _decode_rgba(fmt: int, texels: np.ndarray) -> np.ndarray:
    """uint32 texel values -> (N, 4) uint8 [a, r, g, b]."""
    t = texels.astype(np.uint32)
    if fmt == C.TEX_FORMAT_A8R8G8B8:
        a, r, g, b = t >> 24, (t >> 16) & 0xFF, (t >> 8) & 0xFF, t & 0xFF
    elif fmt == C.TEX_FORMAT_R5G6B5:
        r = ((t >> 8) & 0xF8) | ((t >> 13) & 0x07)
        g = ((t >> 3) & 0xFC) | ((t >> 9) & 0x03)
        b = ((t << 3) & 0xF8) | ((t >> 2) & 0x07)
        a = np.full_like(t, 0xFF)
    elif fmt == C.TEX_FORMAT_A1R5G5B5:
        r = ((t >> 7) & 0xF8) | ((t >> 12) & 0x07)
        g = ((t >> 2) & 0xF8) | ((t >> 7) & 0x07)
        b = ((t << 3) & 0xF8) | ((t >> 2) & 0x07)
        a = np.where(t & 0x8000, 0xFF, 0)
    elif fmt == C.TEX_FORMAT_A4R4G4B4:
        r = ((t >> 4) & 0xF0) | ((t >> 8) & 0x0F)
        g = (t & 0xF0) | ((t >> 4) & 0x0F)
        b = ((t << 4) & 0xF0) | (t & 0x0F)
        a = ((t >> 8) & 0xF0) | ((t >> 12) & 0x0F)
    elif fmt == C.TEX_FORMAT_A8L8:
        r = g = b = t & 0xFF
        a = (t >> 8) & 0xFF
    elif fmt == C.TEX_FORMAT_L8:
        r = g = b = t & 0xFF
        a = np.full_like(t, 0xFF)
    elif fmt == C.TEX_FORMAT_A8:
        r = g = b = np.full_like(t, 0xFF)
        a = t & 0xFF
    else:
        raise ValueError(fmt)
    return np.stack([a, r, g, b], -1).astype(np.uint32)


def _encode(fmt: int, argb: np.ndarray) -> np.ndarray:
    """(N, 4) uint [a,r,g,b] -> uint32 texel values."""
    a, r, g, b = (argb[..., i] for i in range(4))
    if fmt == C.TEX_FORMAT_A8R8G8B8:
        return (a << 24) | (r << 16) | (g << 8) | b
    if fmt == C.TEX_FORMAT_R5G6B5:
        return ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3)
    if fmt == C.TEX_FORMAT_A1R5G5B5:
        return ((a >> 7) << 15) | ((r >> 3) << 10) | ((g >> 3) << 5) | (b >> 3)
    if fmt == C.TEX_FORMAT_A4R4G4B4:
        return ((a >> 4) << 12) | ((r >> 4) << 8) | ((g >> 4) << 4) | (b >> 4)
    if fmt == C.TEX_FORMAT_A8L8:
        return ((a & 0xFF) << 8) | (r & 0xFF)
    if fmt == C.TEX_FORMAT_L8:
        return r & 0xFF
    if fmt == C.TEX_FORMAT_A8:
        return a & 0xFF
    raise ValueError(fmt)


def generate_mipmaps(pixels: np.ndarray, vx_format: int,
                     width: int, height: int):
    """Build the flat mip-chain byte buffer + per-level byte offsets.

    pixels: raw uint8 bytes of level 0 (width*height*stride).
    Returns (mip_chain uint8 array, offsets list[int]).
    """
    stride = C.TEX_FORMAT_STRIDE[vx_format]
    buf = np.asarray(pixels, np.uint8)
    if stride == 1:
        level = buf.astype(np.uint32)
    elif stride == 2:
        level = buf.view("<u2").astype(np.uint32)
    else:
        level = buf.view("<u4").astype(np.uint32)
    level = level.reshape(height, width)

    chain = [buf]
    offsets = [0]
    off = buf.size
    w, h = width, height
    while w > 1 or h > 1:
        nw, nh = max(w // 2, 1), max(h // 2, 1)
        argb = _decode_rgba(vx_format, level)
        # 2x2 box average (rounded)
        if w > 1 and h > 1:
            q = (argb[0::2, 0::2] + argb[0::2, 1::2]
                 + argb[1::2, 0::2] + argb[1::2, 1::2] + 2) >> 2
        elif w > 1:
            q = (argb[:, 0::2] + argb[:, 1::2] + 1) >> 1
        else:
            q = (argb[0::2] + argb[1::2] + 1) >> 1
        level = _encode(vx_format, q.astype(np.uint32))
        if stride == 1:
            raw = level.astype(np.uint8).tobytes()
        elif stride == 2:
            raw = level.astype("<u2").tobytes()
        else:
            raw = level.astype("<u4").tobytes()
        chain.append(np.frombuffer(raw, np.uint8))
        offsets.append(off)
        off += len(raw)
        w, h = nw, nh

    return np.concatenate(chain), offsets


def texture_rgba_float(pixels: np.ndarray, vx_format: int,
                       width: int, height: int) -> np.ndarray:
    """Decode raw level-0 texel bytes -> (H, W, 4) float32 RGBA in [0, 1]
    (the float-texture form the RT path samples)."""
    stride = C.TEX_FORMAT_STRIDE[vx_format]
    buf = np.asarray(pixels, np.uint8)[:height * width * stride]
    if stride == 1:
        t = buf.astype(np.uint32)
    elif stride == 2:
        t = buf.view("<u2").astype(np.uint32)
    else:
        t = buf.view("<u4").astype(np.uint32)
    argb = _decode_rgba(vx_format, t.reshape(height, width))
    rgba = argb[..., [1, 2, 3, 0]].astype(np.float32) / 255.0
    return rgba
