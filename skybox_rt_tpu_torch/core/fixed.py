"""Exact int32 fixed-point arithmetic on torch tensors.

Counterpart of skybox_rt_tpu.core.fixed.  The reference rasterizer is built
on cocogfx ``TFixed<16>`` (edge coefficients) and ``TFixed<24>``
(attributes / barycentrics) stored in int32 (graphics.h:24-33); its
interpolator is the 48-bit product ``((int64)a*b >> 24) + c``
(draw3d/kernel.cpp:48-54).  Torch has a native int64, so that product is
one multiply here (the JAX package's 16-bit limbs stood in for the int64
that TPUs lack).

Representation of u32 words (colors, depth-stencil words, texels):
  * STORED as int32 tensors holding the 32-bit pattern.  This is what the
    CUDA kernel reads and writes, and what framebuffers, ds buffers and
    texel tables hold on every device.
  * COMPUTED in int64: an op that needs unsigned semantics (compare,
    right shift, add, product, invert) widens with :func:`u32` to a value
    in [0, 2^32), and every result narrows back with :func:`i32`, which
    wraps mod 2^32.  Signed int32 wraparound (edge sums, the ``*255``
    channel products) is computed the same way: int64, then :func:`i32`.
  * At the public boundary, :func:`to_numpy_u32` gives numpy ``uint32``,
    so tests compare with the JAX package like with like.
"""
from __future__ import annotations

import numpy as np
import torch

EDGE_FRAC = 16  # FloatE = TFixed<16>
ATTR_FRAC = 24  # FloatA = TFixed<24>

INT_MIN = -(2 ** 31)
_U32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor holding u32 bit patterns -> int64 value in [0, 2^32)."""
    return x.to(torch.int64) & _U32


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int64 holding the signed int32 value of its low 32 bits."""
    return ((x + 2 ** 31) & _U32) - 2 ** 31


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 tensor of its low 32 bits (wraps mod 2^32)."""
    return wrap_i32(x.to(torch.int64)).to(torch.int32)


def s32(v: int) -> int:
    """Python int u32 pattern -> the signed int32 Python int of the same bits."""
    v &= _U32
    return v - 2 ** 32 if v >= 2 ** 31 else v


def to_numpy_u32(x: torch.Tensor) -> np.ndarray:
    """u32 words (int32 patterns or int64 values) -> numpy uint32."""
    return i32(x).cpu().numpy().view(np.uint32)


def from_numpy_u32(a, device=None) -> torch.Tensor:
    """numpy uint32 (or any integer array of u32 values) -> int32 patterns."""
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32)).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def to_fixed_np(x, frac: int, dtype=np.int32):
    """float -> fixed-point data, C-cast semantics (truncation toward zero).

    Matches cocogfx ``TFixed<F>(float)``: ``static_cast<int32>(x * (1<<F))``.
    Host-side (numpy) variant used by binning; inputs are normalized so
    |x| < 2^(31-F).
    """
    scaled = np.asarray(x, np.float32) * np.float32(1 << frac)
    return np.trunc(scaled).astype(np.int64).astype(dtype)


def to_fixed(x, frac: int) -> torch.Tensor:
    """float32 -> fixed data (int32), truncation toward zero: the tensor
    variant of :func:`to_fixed_np`, for |x| < 2^(31-frac)."""
    scaled = torch.as_tensor(x, dtype=torch.float32) * float(1 << frac)
    return torch.trunc(scaled).to(torch.int32)


def to_fixed_x86(x: torch.Tensor, frac: int) -> torch.Tensor:
    """float32 -> fixed data with x86 ``cvttss2si`` cast semantics.

    Truncate toward zero; NaN or out-of-int32-range results become INT_MIN
    (what the reference produces on x86 for the degenerate all-zero
    barycentric case).  The test is explicit: a torch cast of such values
    gives INT_MIN on the CPU only by accident, and saturates on CUDA.
    """
    scaled = x.to(torch.float32) * float(1 << frac)
    tr = torch.trunc(scaled)
    bad = torch.isnan(tr) | (tr >= 2.0 ** 31) | (tr < -(2.0 ** 31))
    safe = torch.where(bad, torch.zeros_like(tr), tr).to(torch.int32)
    return torch.where(bad, torch.full_like(safe, INT_MIN), safe)


def fixed_to_float(data: torch.Tensor, frac: int) -> torch.Tensor:
    """fixed data -> float32: ``static_cast<float>(TFixed<F>)`` = data / 2^F.

    int32 -> float32 rounds to nearest even, as the C cast does; the 2^-F
    scale is an exact power of two.
    """
    return data.to(torch.int32).to(torch.float32) * (2.0 ** -frac)


def mul_shift(a: torch.Tensor, b: torch.Tensor, shift: int) -> torch.Tensor:
    """int32 result of ``(int64)a * (int64)b >> shift`` (0 < shift < 32).

    Arithmetic shift of the exact 64-bit product, truncated to the low 32
    bits — what the reference's ``imadd`` stores into an int32.
    """
    if not 0 < shift < 32:
        raise ValueError(f"shift {shift} out of (0, 32)")
    a = torch.as_tensor(a)
    b = torch.as_tensor(b)
    return i32((a.to(torch.int64) * b.to(torch.int64)) >> shift)


def imadd24(a, b, c) -> torch.Tensor:
    """``((int64)a * b >> 24) + c`` in int32, the add wrapping too.

    Reference: draw3d/kernel.cpp:48-59 (``imadd``/``multadd_fx`` with s=3).
    """
    return i32(mul_shift(a, b, 24).to(torch.int64)
               + torch.as_tensor(c).to(torch.int64))


def interpolate24(attr_x, attr_y, attr_z, dx, dy) -> torch.Tensor:
    """Fixed24 barycentric interpolation ``(x*dx>>24 + z) + (y*dy>>24)``
    (INTERPOLATE_i, draw3d/kernel.cpp:56-59)."""
    return imadd24(attr_y, dy, imadd24(attr_x, dx, attr_z))
