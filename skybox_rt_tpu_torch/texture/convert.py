"""RGBA8888 -> device texel-format conversion (cocogfx LoadImage/ConvertTo
analog, used by the tex test host at tests/regression/tex/main.cpp:160-168).

Counterpart of skybox_rt_tpu.texture.convert, copied: host numpy, both
packages give the same texel words and bytes.

The cocogfx converter lives in the absent submodule; its per-format rules
were re-derived empirically from the checked-in golden pairs
(toad.png vs toad_ref_f0..f6.png — each golden is the converted texture
point-sampled 1:1, so the conversion is directly observable):

  R5G6B5    : r>>3, g>>2, b>>3             (truncation)
  A1R5G5B5  : a = (alpha != 0), rgb >> 3
  A4R4G4B4  : all channels >> 4
  A8L8      : L = red channel, A = alpha
  L8        : L = red channel
  A8        : A = alpha
"""
from __future__ import annotations

import numpy as np

from ..core import constants as C


def rgba_to_texels(rgba: np.ndarray, fmt: int) -> np.ndarray:
    """(H, W, 4) uint8 RGBA -> (H, W) uint32 texel values in `fmt`."""
    x = rgba.astype(np.uint32)
    r, g, b, a = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    if fmt == C.TEX_FORMAT_A8R8G8B8:
        return (a << 24) | (r << 16) | (g << 8) | b
    if fmt == C.TEX_FORMAT_R5G6B5:
        return ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3)
    if fmt == C.TEX_FORMAT_A1R5G5B5:
        a1 = (a != 0).astype(np.uint32)
        return (a1 << 15) | ((r >> 3) << 10) | ((g >> 3) << 5) | (b >> 3)
    if fmt == C.TEX_FORMAT_A4R4G4B4:
        return ((a >> 4) << 12) | ((r >> 4) << 8) | ((g >> 4) << 4) | (b >> 4)
    if fmt == C.TEX_FORMAT_A8L8:
        return (a << 8) | r
    if fmt == C.TEX_FORMAT_L8:
        return r
    if fmt == C.TEX_FORMAT_A8:
        return a
    raise ValueError(f"bad format {fmt}")


def texels_to_bytes(texels: np.ndarray, fmt: int) -> np.ndarray:
    """(H, W) uint32 texels -> flat little-endian uint8 byte buffer at the
    format stride (the device texture memory image)."""
    stride = C.TEX_FORMAT_STRIDE[fmt]
    t = np.ascontiguousarray(texels)
    if stride == 1:
        return t.astype(np.uint8).ravel()
    if stride == 2:
        return t.astype("<u2").view(np.uint8).ravel()
    return t.astype("<u4").view(np.uint8).ravel()
