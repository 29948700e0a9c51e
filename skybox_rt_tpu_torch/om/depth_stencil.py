"""Depth + stencil test, exact port of graphics.cpp:320-364,530-596.

Counterpart of skybox_rt_tpu.om.depth_stencil.  The depth-stencil word packs
24-bit depth (low) and 8-bit stencil (high) in one u32; funcs and ops are
static per drawcall, so they resolve to straight-line tensor code.  u32
words arrive as int32 patterns and are widened to int64 (core.fixed).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import constants as C
from ..core.fixed import i32, u32


@dataclasses.dataclass(frozen=True)
class DepthStencilState:
    """Configured DepthTencil (graphics.cpp:534-562)."""
    depth_func: int
    depth_writemask: bool
    stencil_front_func: int
    stencil_front_zpass: int
    stencil_front_zfail: int
    stencil_front_fail: int
    stencil_front_ref: int
    stencil_front_mask: int
    stencil_back_func: int
    stencil_back_zpass: int
    stencil_back_zfail: int
    stencil_back_fail: int
    stencil_back_ref: int
    stencil_back_mask: int

    @property
    def depth_enabled(self) -> bool:
        # enable inference: graphics.cpp:553
        return not (self.depth_func == C.OM_DEPTH_FUNC_ALWAYS
                    and not self.depth_writemask)

    def stencil_enabled(self, is_backface: bool) -> bool:
        f, zp, zf = ((self.stencil_back_func, self.stencil_back_zpass,
                      self.stencil_back_zfail) if is_backface else
                     (self.stencil_front_func, self.stencil_front_zpass,
                      self.stencil_front_zfail))
        return not (f == C.OM_DEPTH_FUNC_ALWAYS
                    and zp == C.OM_STENCIL_OP_KEEP
                    and zf == C.OM_STENCIL_OP_KEEP)


def compare(func: int, a, b) -> torch.Tensor:
    """DoCompare (graphics.cpp:320-341): unsigned compare, static func."""
    a = u32(torch.as_tensor(a))
    b = u32(torch.as_tensor(b))
    if func == C.OM_DEPTH_FUNC_NEVER:
        return torch.zeros(torch.broadcast_shapes(a.shape, b.shape),
                           dtype=torch.bool, device=a.device)
    if func == C.OM_DEPTH_FUNC_LESS:
        return a < b
    if func == C.OM_DEPTH_FUNC_EQUAL:
        return a == b
    if func == C.OM_DEPTH_FUNC_LEQUAL:
        return a <= b
    if func == C.OM_DEPTH_FUNC_GREATER:
        return a > b
    if func == C.OM_DEPTH_FUNC_NOTEQUAL:
        return a != b
    if func == C.OM_DEPTH_FUNC_GEQUAL:
        return a >= b
    if func == C.OM_DEPTH_FUNC_ALWAYS:
        return torch.ones(torch.broadcast_shapes(a.shape, b.shape),
                          dtype=torch.bool, device=a.device)
    raise ValueError(f"bad depth func {func}")


def _stencil_op64(op: int, ref: int, val: torch.Tensor) -> torch.Tensor:
    """DoStencilOp on an int64 u32 value; result is an int64 u32 value."""
    if op == C.OM_STENCIL_OP_KEEP:
        return val
    if op == C.OM_STENCIL_OP_ZERO:
        return torch.zeros_like(val)
    if op == C.OM_STENCIL_OP_REPLACE:
        return torch.full_like(val, ref & 0xFFFFFFFF)
    if op == C.OM_STENCIL_OP_INCR:
        return torch.where(val < 0xFF, val + 1, val)
    if op == C.OM_STENCIL_OP_DECR:
        return torch.where(val > 0, val - 1, val)
    if op == C.OM_STENCIL_OP_INVERT:
        return val ^ 0xFFFFFFFF                  # 32-bit ~val
    if op == C.OM_STENCIL_OP_INCR_WRAP:
        return (val + 1) & 0xFF
    if op == C.OM_STENCIL_OP_DECR_WRAP:
        return (val - 1) & 0xFF
    raise ValueError(f"bad stencil op {op}")


def stencil_op(op: int, ref: int, val) -> torch.Tensor:
    """DoStencilOp (graphics.cpp:343-364), static op; returns int32 patterns."""
    return i32(_stencil_op64(op, ref, u32(torch.as_tensor(val))))


def test(state: DepthStencilState, is_backface: bool, depth,
         dst_depthstencil):
    """DepthTencil::test (graphics.cpp:564-596), vectorized.

    depth: u32 per-pixel depth (full register; masked to 24 bits here);
    dst_depthstencil: u32 buffer words.  Returns (passed bool,
    depth-stencil result as int32 patterns).
    """
    depth = u32(torch.as_tensor(depth))
    dst = u32(torch.as_tensor(dst_depthstencil))

    depth_val = dst & C.OM_DEPTH_MASK
    stencil_val = dst >> C.OM_DEPTH_BITS
    depth_ref = depth & C.OM_DEPTH_MASK

    if is_backface:
        s_func, s_ref, s_mask = (state.stencil_back_func,
                                 state.stencil_back_ref,
                                 state.stencil_back_mask)
        op_zpass, op_zfail, op_fail = (state.stencil_back_zpass,
                                       state.stencil_back_zfail,
                                       state.stencil_back_fail)
    else:
        s_func, s_ref, s_mask = (state.stencil_front_func,
                                 state.stencil_front_ref,
                                 state.stencil_front_mask)
        op_zpass, op_zfail, op_fail = (state.stencil_front_zpass,
                                       state.stencil_front_zfail,
                                       state.stencil_front_fail)

    sref_m = torch.full_like(stencil_val, (s_ref & s_mask) & 0xFFFFFFFF)
    sval_m = stencil_val & (s_mask & 0xFFFFFFFF)

    s_passed = compare(s_func, sref_m, sval_m)
    d_passed = compare(state.depth_func, depth_ref, depth_val)
    passed = s_passed & d_passed

    r_zpass = _stencil_op64(op_zpass, s_ref, stencil_val)
    r_zfail = _stencil_op64(op_zfail, s_ref, stencil_val)
    r_fail = _stencil_op64(op_fail, s_ref, stencil_val)
    stencil_result = torch.where(
        s_passed, torch.where(d_passed, r_zpass, r_zfail), r_fail)

    result = (stencil_result << C.OM_DEPTH_BITS) | depth_ref
    return passed, i32(result)
