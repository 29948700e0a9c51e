"""Color blending: 15 blend funcs, 6 blend modes, 16 logic ops.

Counterpart of skybox_rt_tpu.om.blend: exact port of
graphics.cpp:366-524,600-636 on unpacked ARGB channels.  Channels are int64
values; packed colors arrive and leave as int32 patterns (core.fixed).
``Div255`` is the (v + (v>>8)) >> 8 identity which, with the caller's +0x80
bias, rounds /255 correctly for v <= 0xFF00 (cocogfx color.hpp).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import constants as C
from ..core.fixed import i32, u32


@dataclasses.dataclass(frozen=True)
class BlendState:
    """Configured Blender (graphics.cpp:603-620)."""
    mode_rgb: int
    mode_a: int
    src_rgb: int
    src_a: int
    dst_rgb: int
    dst_a: int
    const_color: int
    logic_op: int

    @property
    def enabled(self) -> bool:
        return not (self.mode_rgb == C.OM_BLEND_MODE_ADD
                    and self.mode_a == C.OM_BLEND_MODE_ADD
                    and self.src_rgb == C.OM_BLEND_FUNC_ONE
                    and self.src_a == C.OM_BLEND_FUNC_ONE
                    and self.dst_rgb == C.OM_BLEND_FUNC_ZERO
                    and self.dst_a == C.OM_BLEND_FUNC_ZERO)


def _unpack(c64: torch.Tensor):
    """int64 u32 value -> (a, r, g, b) int64 channels."""
    return (c64 >> 24, (c64 >> 16) & 0xFF, (c64 >> 8) & 0xFF, c64 & 0xFF)


def div255(v: torch.Tensor) -> torch.Tensor:
    """Rounded unsigned /255 given the caller's +0x80 bias (cocogfx Div255)."""
    v = u32(v)
    return ((v + (v >> 8)) >> 8) & 0xFFFFFFFF


def blend_func(func: int, src, dst, cst):
    """DoBlendFunc (graphics.cpp:405-475).  src/dst/cst are (a,r,g,b) tuples
    of int64 channel tensors; returns an (a,r,g,b) tuple."""
    sa, sr, sg, sb = src
    da, dr, dg, db = dst
    ca, cr, cg, cb = cst
    full = torch.full_like(sa, 0xFF)
    zero = torch.zeros_like(sa)
    if func == C.OM_BLEND_FUNC_ZERO:
        return (zero, zero, zero, zero)
    if func == C.OM_BLEND_FUNC_ONE:
        return (full, full, full, full)
    if func == C.OM_BLEND_FUNC_SRC_RGB:
        return (sa, sr, sg, sb)
    if func == C.OM_BLEND_FUNC_ONE_MINUS_SRC_RGB:
        # faithful to the reference, whose ONE_MINUS_SRC_RGB alpha slot is
        # 0xff - src.a (graphics.cpp:418-424)
        return (0xFF - sa, 0xFF - sr, 0xFF - sg, 0xFF - sb)
    if func == C.OM_BLEND_FUNC_DST_RGB:
        return (da, dr, dg, db)
    if func == C.OM_BLEND_FUNC_ONE_MINUS_DST_RGB:
        return (0xFF - da, 0xFF - dr, 0xFF - dg, 0xFF - db)
    if func == C.OM_BLEND_FUNC_SRC_A:
        return (sa, sa, sa, sa)
    if func == C.OM_BLEND_FUNC_ONE_MINUS_SRC_A:
        v = 0xFF - sa
        return (v, v, v, v)
    if func == C.OM_BLEND_FUNC_DST_A:
        return (da, da, da, da)
    if func == C.OM_BLEND_FUNC_ONE_MINUS_DST_A:
        v = 0xFF - da
        return (v, v, v, v)
    if func == C.OM_BLEND_FUNC_CONST_RGB:
        return (ca, cr, cg, cb)
    if func == C.OM_BLEND_FUNC_ONE_MINUS_CONST_RGB:
        return (0xFF - ca, 0xFF - cr, 0xFF - cg, 0xFF - cb)
    if func == C.OM_BLEND_FUNC_CONST_A:
        return (ca, ca, ca, ca)
    if func == C.OM_BLEND_FUNC_ONE_MINUS_CONST_A:
        # faithful reference quirk: uses cst r/g/b, not a (graphics.cpp:463-469)
        return (0xFF - ca, 0xFF - cr, 0xFF - cg, 0xFF - cb)
    if func == C.OM_BLEND_FUNC_ALPHA_SAT:
        factor = torch.minimum(sa, 0xFF - da)
        return (full, factor, factor, factor)
    raise ValueError(f"bad blend func {func}")


def logic_op(op: int, src, dst) -> torch.Tensor:
    """DoLogicOp (graphics.cpp:366-403) on packed u32; returns int32 patterns.

    Bitwise ops act on the 32-bit patterns directly, so int32 is exact here.
    """
    s = i32(torch.as_tensor(src))
    d = i32(torch.as_tensor(dst))
    ops = {
        C.OM_LOGIC_OP_CLEAR: lambda: torch.zeros_like(s),
        C.OM_LOGIC_OP_AND: lambda: s & d,
        C.OM_LOGIC_OP_AND_REVERSE: lambda: s & ~d,
        C.OM_LOGIC_OP_COPY: lambda: s,
        C.OM_LOGIC_OP_AND_INVERTED: lambda: ~s & d,
        C.OM_LOGIC_OP_NOOP: lambda: d,
        C.OM_LOGIC_OP_XOR: lambda: s ^ d,
        C.OM_LOGIC_OP_OR: lambda: s | d,
        C.OM_LOGIC_OP_NOR: lambda: ~(s | d),
        C.OM_LOGIC_OP_EQUIV: lambda: ~(s ^ d),
        C.OM_LOGIC_OP_INVERT: lambda: ~d,
        C.OM_LOGIC_OP_OR_REVERSE: lambda: s | ~d,
        C.OM_LOGIC_OP_COPY_INVERTED: lambda: ~s,
        C.OM_LOGIC_OP_OR_INVERTED: lambda: ~s | d,
        C.OM_LOGIC_OP_NAND: lambda: ~(s & d),
        C.OM_LOGIC_OP_SET: lambda: torch.full_like(s, -1),
    }
    return torch.broadcast_to(ops[op](), torch.broadcast_shapes(s.shape,
                                                                d.shape))


def _blend_mode(mode: int, lop: int, src, dst, s, d, src_packed, dst_packed):
    """DoBlendMode (graphics.cpp:477-524) per channel tuple."""
    def add(x, fx, y, fy):
        return div255(torch.clamp(x * fx + y * fy + 0x80, max=0xFF00))

    def sub(x, fx, y, fy):
        # max(int, 0): channel products are < 2^16, so no int32 wrap occurs
        return div255(torch.clamp(x * fx - y * fy + 0x80, min=0))

    if mode == C.OM_BLEND_MODE_ADD:
        return tuple(add(x, fx, y, fy) for x, fx, y, fy in zip(src, s, dst, d))
    if mode == C.OM_BLEND_MODE_SUB:
        return tuple(sub(x, fx, y, fy) for x, fx, y, fy in zip(src, s, dst, d))
    if mode == C.OM_BLEND_MODE_REV_SUB:
        return tuple(sub(y, fy, x, fx) for x, fx, y, fy in zip(src, s, dst, d))
    if mode == C.OM_BLEND_MODE_MIN:
        return tuple(torch.minimum(x, y) for x, y in zip(src, dst))
    if mode == C.OM_BLEND_MODE_MAX:
        return tuple(torch.maximum(x, y) for x, y in zip(src, dst))
    if mode == C.OM_BLEND_MODE_LOGICOP:
        return _unpack(u32(logic_op(lop, src_packed, dst_packed)))
    raise ValueError(f"bad blend mode {mode}")


def blend(state: BlendState, src_color, dst_color) -> torch.Tensor:
    """Blender::blend (graphics.cpp:622-636) on packed ARGB words; returns
    int32 patterns."""
    src_color = torch.as_tensor(src_color)
    dst_color = torch.as_tensor(dst_color)
    src64 = u32(src_color)
    dst64 = u32(dst_color)
    src64, dst64 = torch.broadcast_tensors(src64, dst64)
    src = _unpack(src64)
    dst = _unpack(dst64)
    cst = tuple(torch.full_like(src64, v)
                for v in _unpack_int(state.const_color))

    s_rgb = blend_func(state.src_rgb, src, dst, cst)
    s_a = blend_func(state.src_a, src, dst, cst)
    d_rgb = blend_func(state.dst_rgb, src, dst, cst)
    d_a = blend_func(state.dst_a, src, dst, cst)
    rgb = _blend_mode(state.mode_rgb, state.logic_op, src, dst, s_rgb, d_rgb,
                      src64, dst64)
    a = _blend_mode(state.mode_a, state.logic_op, src, dst, s_a, d_a,
                    src64, dst64)
    # result = (a.a, rgb.r, rgb.g, rgb.b), each channel shifted as a u32
    return i32((a[0] << 24) | (rgb[1] << 16) | (rgb[2] << 8) | rgb[3])


def _unpack_int(c: int):
    c &= 0xFFFFFFFF
    return (c >> 24, (c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF)
