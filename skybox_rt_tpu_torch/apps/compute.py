"""Compute / SIMT regression apps — the reference's general-purpose suite
(tests/regression/{vecaddx,sgemmx,sgemm2x,conv3x,stencil3d,sort,diverge}
and the dogfood op-conformance cases, tests/regression/dogfood/testcases.h).

Counterpart of skybox_rt_tpu.apps.compute.  Every function takes tensors and
runs on their device; the numpy oracles mirror the reference hosts' CPU
verify() loops.  ``sgemm_pallas`` is the one kernel: the hand-written CUDA
product of ``csrc/apps_sgemm.cu`` (apps.cuda_sgemm) for CUDA tensors, its
plain version for CPU tensors.  The BAR/GBAR barrier case needs a device
mesh and is not here.

Departures from the JAX module: integer results wrap in int32 as JAX's do,
computed here in int64 and wrapped (core.fixed) where a compare follows;
``ftou`` returns its u32 words as int32 patterns (core.fixed), as the port
stores every u32 word.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import fixed
from . import cuda_sgemm


# ---------------------------------------------------------------------------
# vecaddx — tests/regression/vecaddx/kernel.cpp:9 (dst = src0 + src1)
# ---------------------------------------------------------------------------

def vecadd(x, y):
    return x + y


# ---------------------------------------------------------------------------
# sgemmx — tests/regression/sgemmx/kernel.cpp:14-19 (naive row*col loop)
# ---------------------------------------------------------------------------

def sgemm(a, b):
    """One library matrix product, as the JAX package leaves it to XLA.  On
    a card it is full float32 only while
    ``torch.backends.cuda.matmul.allow_tf32`` is False, torch's default."""
    return torch.matmul(a, b)


# ---------------------------------------------------------------------------
# sgemm2x — tests/regression/sgemm2x/kernel.cpp:11-50: tiles of A/B staged
# through __local_mem with __syncthreads: the CUDA kernel of
# csrc/apps_sgemm.cu, which stages them in shared memory.
# ---------------------------------------------------------------------------

def sgemm_pallas(a, b, block=(128, 128, 128)):
    """Blocked float32 matmul; block=(bm, bn, bk) must divide the shapes
    (ValueError otherwise), as the JAX entry asserts.  The kernel's own
    tiles do not depend on it, and neither does the result: every element
    is one fused multiply-add a k, in ascending k (apps.cuda_sgemm)."""
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = block
    if m % bm or n % bn or k % bk:
        raise ValueError(f"block {tuple(block)} does not divide "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    return cuda_sgemm.sgemm(a, b)


# ---------------------------------------------------------------------------
# conv3x — tests/regression/conv3x/kernel.cpp:20-35: 3x3 convolution over a
# zero-padded (w+2, h+2) input, as nine shifted adds.
# ---------------------------------------------------------------------------

def conv3x(padded, weights):
    """padded: (H+2, W+2) float32; weights: (3, 3) -> (H, W)."""
    h, w = padded.shape[0] - 2, padded.shape[1] - 2
    out = torch.zeros((h, w), dtype=torch.float32, device=padded.device)
    for dy in range(3):
        for dx in range(3):
            out = out + padded[dy:dy + h, dx:dx + w] * weights[dy, dx]
    return out


# ---------------------------------------------------------------------------
# stencil3d — tests/regression/stencil3d/kernel.cpp:16-52: mean of the 27
# clamped-index neighbors.  Edge-clamping == edge-replicate padding.
# ---------------------------------------------------------------------------

def stencil3d(vol):
    """vol: (S, S, S) float32 -> 27-point clamped-neighborhood mean."""
    p = torch.nn.functional.pad(vol[None, None], (1,) * 6,
                                mode="replicate")[0, 0]
    s = vol.shape[0]
    out = torch.zeros_like(vol)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                out = out + p[dz:dz + s, dy:dy + s, dx:dx + s]
    return out / 27.0


# ---------------------------------------------------------------------------
# sort — tests/regression/sort/kernel.cpp:9-17: per-lane stable rank count
# (pos = #{i : x[i] < x[j] or (x[i]==x[j] and i<j)}), scatter to dst[pos].
# ---------------------------------------------------------------------------

def rank_sort(x):
    n = x.shape[0]
    i = torch.arange(n, device=x.device)
    lt = x[None, :] < x[:, None]                       # [j, i]: x_i < x_j
    tie = (x[None, :] == x[:, None]) & (i[None, :] < i[:, None])
    pos = (lt | tie).sum(dim=1)
    # the ranks are a permutation: every position is written once
    return torch.zeros_like(x).scatter_(0, pos, x)


# ---------------------------------------------------------------------------
# diverge — tests/regression/diverge/kernel.cpp:8-77: a cascade of
# divergent branches, a data-dependent loop, a switch, selects and min/max,
# all predicated; the `for (i < task_id) value += src[i]` loop is an
# exclusive prefix sum.
# ---------------------------------------------------------------------------

def diverge(src):
    """src: (N,) int32; returns the reference kernel's dst array (int32,
    wrapping as the int32 kernel does)."""
    n = src.shape[0]
    s = src.to(torch.int64)
    tid = torch.arange(n, dtype=torch.int64, device=src.device)
    value = s + 2                                       # "none taken" branch

    # nested diverge: tid>1 ? (tid>2 ? +6 : +5) : (tid>0 ? +4 : +3)
    value = value + torch.where(tid > 1, torch.where(tid > 2, 6, 5),
                                torch.where(tid > 0, 4, 3))
    value = value + 7                                   # "all taken" branch

    # loop: value += sum(src[0:tid])  -> exclusive prefix sum
    value = value + torch.cumsum(s, 0) - s

    # switch (tid): 0:+1, 1:-1, 2:*3, 3:*5, default: unchanged
    value = torch.where(tid == 0, value + 1,
                        torch.where(tid == 1, value - 1,
                                    torch.where(tid == 2, value * 3,
                                                torch.where(tid == 3,
                                                            value * 5,
                                                            value))))

    # select: tid>5 ? src[0] : tid   (tid >= 0 always)
    value = value + torch.where(tid > 5, s[0], tid)

    # sequential min/max accumulation, on the wrapped int32 value
    value = fixed.wrap_i32(value)
    value = fixed.wrap_i32(value + torch.minimum(s, value))
    value = fixed.wrap_i32(value + torch.maximum(s, value))
    return value.to(torch.int32)


def diverge_oracle(src: np.ndarray) -> np.ndarray:
    """Scalar CPU oracle, line-for-line with the reference kernel."""
    src = np.asarray(src, np.int32)
    out = np.empty_like(src)
    for tid in range(len(src)):
        value = int(src[tid]) + 2
        if tid > 1:
            value += 6 if tid > 2 else 5
        else:
            value += 4 if tid > 0 else 3
        value += 7
        for i in range(tid):
            value += int(src[i])
        if tid == 0:
            value += 1
        elif tid == 1:
            value -= 1
        elif tid == 2:
            value *= 3
        elif tid == 3:
            value *= 5
        value += int(src[0]) if tid > 5 else tid
        value += min(int(src[tid]), value)
        value += max(int(src[tid]), value)
        out[tid] = np.int32(value)
    return out


# ---------------------------------------------------------------------------
# dogfood — tests/regression/dogfood/testcases.h:876-899: the ALU / FPU /
# convert / clamp / trig op-conformance cases.  Each entry is
# (torch_fn, numpy_oracle); both take (a, b) arrays.  The reference's two
# BAR/GBAR cases need a mesh and are not among them.
# ---------------------------------------------------------------------------

def _ftou(a, b):
    # the u32 word of a float in [0, 2^32), as an int32 pattern
    return fixed.i32((a.abs() + b.abs()).to(torch.int64))


def _utof(a, b):
    s = a + b
    if s.is_floating_point():
        return s.to(torch.float32)
    return fixed.u32(fixed.i32(s.to(torch.int64))).to(torch.float32)


def _trunc_div_oracle(a, b):
    return (np.sign(a) * np.sign(b) * (np.abs(a) // np.abs(b))).astype(a.dtype)


DOGFOOD_CASES = {
    "iadd":  (lambda a, b: a + b,            lambda a, b: a + b),
    "imul":  (lambda a, b: a * b,            lambda a, b: a * b),
    # RISC-V idiv truncates toward zero; numpy's // floors — oracle uses
    # trunc division like the reference's verify loop.
    "idiv":  (lambda a, b: torch.div(a, b, rounding_mode="trunc"),
              _trunc_div_oracle),
    "idiv_mul": (lambda a, b: torch.div(a, b, rounding_mode="trunc") * b,
                 lambda a, b: _trunc_div_oracle(a, b) * b),
    "fadd":  (lambda a, b: a + b,            lambda a, b: a + b),
    "fsub":  (lambda a, b: a - b,            lambda a, b: a - b),
    "fmul":  (lambda a, b: a * b,            lambda a, b: a * b),
    "fmadd": (lambda a, b: a * b + b,        lambda a, b: a * b + b),
    "fmsub": (lambda a, b: a * b - b,        lambda a, b: a * b - b),
    "fnmadd": (lambda a, b: -(a * b) - b,    lambda a, b: -(a * b) - b),
    "fnmsub": (lambda a, b: -(a * b) + b,    lambda a, b: -(a * b) + b),
    "fnmadd_madd": (lambda a, b: (-(a * b) - b) + (a * b + b),
                    lambda a, b: (-(a * b) - b) + (a * b + b)),
    "fdiv":  (lambda a, b: a / b,            lambda a, b: a / b),
    "fdiv2": (lambda a, b: (a / b) / (b / a),
              lambda a, b: (a / b) / (b / a)),
    "fsqrt": (lambda a, b: torch.sqrt(torch.abs(a * b)),
              lambda a, b: np.sqrt(np.abs(a * b))),
    "ftoi":  (lambda a, b: (a + b).to(torch.int32),
              lambda a, b: (a + b).astype(np.int32)),
    "ftou":  (_ftou,
              lambda a, b: (np.abs(a) + np.abs(b)).astype(np.uint32)),
    "itof":  (lambda a, b: (a + b).to(torch.float32),
              lambda a, b: (a + b).astype(np.float32)),
    "utof":  (_utof,
              lambda a, b: (a + b).astype(np.float32)),
    # fclamp — testcases.h:720: fmin(fmax(1.0, a), b)
    "fclamp": (lambda a, b: torch.minimum(torch.clamp(a, min=1.0), b),
               lambda a, b: np.minimum(np.maximum(1.0, a), b)),
    "iclamp": (lambda a, b: torch.minimum(torch.clamp(a, min=1), b),
               lambda a, b: np.minimum(np.maximum(1, a), b)),
    # trigo — testcases.h:786-789: ref = a*b, sin() on every 4th lane
    "trigo": (lambda a, b: torch.where(
                  torch.arange(a.shape[0], device=a.device) % 4 == 0,
                  torch.sin(a * b), a * b),
              lambda a, b: np.where(np.arange(a.shape[0]) % 4 == 0,
                                    np.sin(a * b), a * b)),
}
