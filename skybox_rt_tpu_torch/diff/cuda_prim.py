"""Triangle set-up of the differentiable pipeline: the CUDA kernels' wrappers
and the plain twin of their backward.

The kernels, ``csrc/diff_prim.cu`` (a forward and a backward), replace no
Pallas TPU kernel: the JAX package sets its triangles up in plain jnp and
leaves the fusion, and its transpose, to XLA.  ``diff/pipeline._PrimSetup``
launches them where ``prim_setup`` gets CUDA tensors, in every mode (the
set-up's arithmetic does not depend on the mode); CPU tensors run the plain
``pipeline._prim_setup``, which is the forward's plain version.  The source
says how they are laid out and what bounds them.

  * :func:`prim_forward` launches the forward on the current stream, or
    raises: CUDA tensors of the right dtype, shape and layout or nothing.
    It returns the packed record (P, 21 | 27) that ``pipeline.shade_slots``
    reads (edges 9 | colour 12 | uv 6), the screen z (P, 3) and the
    corner-major index list (3 P,) whose transpose the backward takes.
  * :func:`prim_backward` launches the backward the same way: from the
    record's gradient it returns the corner-major rows (row k P + p is
    corner k of triangle p) of the pos, colour and uv gradients, which the
    caller sums into the vertex tables with ``cuda_texgrad`` over that list.
  * :func:`prim_backward_reference` repeats the backward's expressions in
    their order in plain torch, on any device, for the tests and
    chip_smoke.py: on the card the kernel equals it bit for bit; on the CPU
    it equals autograd's gradients of ``pipeline._prim_setup`` to float
    rounding, and exactly on integer-valued inputs.

The kernels read a corner index past the vertex table as its last row (a
negative one as row 0, as the plain gather's clamp does); the row
accumulation drops both corners' gradients.  Indices come from the binning,
which keeps them in range.

Each launch adds one to :data:`launch_count` and to the tracing counter
``diff.prim_kernel``.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import tracing
from .cuda_vis import _check

#: record floats a prim: 9 edge coefficients and 3 RGBA corner colours, and
#: 3 corner uvs when textured (as ``cuda_shade`` reads them)
REC_WIDTH = 21
REC_WIDTH_TEXTURED = 27

# Kernel launches of prim_forward and prim_backward since the last reset:
# a run reads it to show that its main path went through the kernels.
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def constants(width: int, height: int, near: float, far: float):
    """(hw, hh, hd, zo) as Python floats, computed as pipeline.clip_to_hdc
    and screen_z compute their scalar operands (torch rounds each to
    float32 where it meets a float32 tensor; ctypes rounds them alike)."""
    half_d = 0.5 * (far - near)
    return 0.5 * width, 0.5 * height, half_d, near + half_d


def prim_backward_reference(pos, indices, grec, width: int, height: int):
    """Plain torch :func:`prim_backward`, the kernel's expressions in its
    order, on any device: pos (V, 4), indices (P, 3), grec (P, 21 | 27) ->
    (dpos (3 P, 4), dcol (3 P, 4), duv (3 P, 2) or None), corner-major."""
    hw, hh, _, _ = constants(width, height, 0.0, 1.0)
    P, C = grec.shape
    V = pos.shape[0]
    g = grec.detach().to(torch.float32)
    v = indices.detach().long().clamp(0, max(V - 1, 0))
    q = pos.detach()[v]                              # (P, 3, 4)
    x = [q[:, k, 0] * hw + q[:, k, 3] * hw for k in range(3)]
    y = [q[:, k, 1] * hh + q[:, k, 3] * hh for k in range(3)]
    w = [q[:, k, 3] for k in range(3)]
    c = [x[(i + 1) % 3] * y[(i + 2) % 3] - x[(i + 2) % 3] * y[(i + 1) % 3]
         for i in range(3)]
    det = (c[0] * w[0] + c[1] * w[1]) + c[2] * w[2]
    s = torch.where(det < 0, -1.0, 1.0).to(torch.float32)
    ga, gb, gc = [], [], []
    for i in range(3):
        h = g[:, 3 * i + 2] * 0.5
        ga.append((g[:, 3 * i] + h) * s)
        gb.append((g[:, 3 * i + 1] + h) * s)
        gc.append(g[:, 3 * i + 2] * s)
    dpos = []
    for i in range(3):
        j, l = (i + 1) % 3, (i + 2) % 3
        gx = ((gb[j] * w[l] - gb[l] * w[j]) - gc[j] * y[l]) + gc[l] * y[j]
        gy = ((ga[l] * w[j] - ga[j] * w[l]) + gc[j] * x[l]) - gc[l] * x[j]
        gw = ((ga[j] * y[l] - ga[l] * y[j]) - gb[j] * x[l]) + gb[l] * x[j]
        gpx, gpy = gx * hw, gy * hh
        dpos.append(torch.stack([gpx, gpy, torch.zeros_like(gpx),
                                 (gpx + gpy) + gw], -1))
    dcol = torch.cat([g[:, 9 + 4 * k:13 + 4 * k] for k in range(3)])
    duv = None
    if C == REC_WIDTH_TEXTURED:
        duv = torch.cat([g[:, 21 + 2 * k:23 + 2 * k] for k in range(3)])
    return torch.cat(dpos), dcol, duv


def _tables(pos, color, uv, indices, grec=None):
    """Validate the vertex tables, the index list and (the backward's) the
    record's gradient; returns (device, V, P, C).  dtype, shape and layout
    are checked before the device, so every check can be seen to raise on
    any device."""
    if pos.dim() != 2 or indices.dim() != 2:
        raise ValueError(f"pos must be (V, 4) and indices (P, 3), got "
                         f"{tuple(pos.shape)} and {tuple(indices.shape)}")
    dev = pos.device
    V, P = pos.shape[0], indices.shape[0]
    _check("pos", pos, torch.float32, (V, 4), dev)
    if color is not None:
        _check("color", color, torch.float32, (V, 4), dev)
    if uv is not None:
        _check("uv", uv, torch.float32, (V, 2), dev)
    _check("indices", indices, torch.int32, (P, 3), dev)
    if grec is not None:
        if grec.dim() != 2 or grec.shape[1] not in (REC_WIDTH,
                                                     REC_WIDTH_TEXTURED):
            raise ValueError(f"grec must be (P, {REC_WIDTH} | "
                             f"{REC_WIDTH_TEXTURED}), got "
                             f"{tuple(grec.shape)}")
        _check("grec", grec, torch.float32, (P, grec.shape[1]), dev)
    if V == 0 and P > 0:
        raise ValueError("diff_prim: triangles over an empty vertex table")
    for name, t, align in (("pos", pos, 16), ("color", color, 16),
                           ("uv", uv, 8)):
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    if dev.type != "cuda":
        raise ValueError(f"diff_prim: the kernels take CUDA tensors, got "
                         f"{dev}; pipeline._prim_setup is their CPU version")
    if P * REC_WIDTH_TEXTURED >= 2 ** 31 or 4 * V >= 2 ** 31:
        raise ValueError(f"diff_prim: {P} triangles over {V} vertices "
                         "exceed int32 indexing")
    width = REC_WIDTH if uv is None else REC_WIDTH_TEXTURED
    return dev, V, P, width if grec is None else grec.shape[1]


def _launched():
    global launch_count
    launch_count += 1
    tracing.count("diff.prim_kernel")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def prim_forward(pos, color, uv, indices, width: int, height: int,
                 near: float, far: float):
    """The triangle set-up: pos (V, 4) and color (V, 4) float32, uv (V, 2)
    float32 or None (untextured), indices (P, 3) int32 -> (rec (P, 27 | 21)
    float32, z (P, 3) float32, corner (3 P,) int32), bit for bit the plain
    ``pipeline._prim_setup``'s edges | color | uv packed and its z."""
    dev, V, P, C = _tables(pos, color, uv, indices)
    rec = torch.empty((P, C), dtype=torch.float32, device=dev)
    z = torch.empty((P, 3), dtype=torch.float32, device=dev)
    corner = torch.empty(3 * P, dtype=torch.int32, device=dev)

    from .. import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.skybox_diff_prim_forward(
        _ptr(pos), _ptr(color), _ptr(uv), _ptr(indices), _ptr(rec), _ptr(z),
        _ptr(corner), P, V, *constants(width, height, near, far),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"diff_prim forward launch failed: CUDA error "
                           f"{rc}")
    _launched()
    return rec, z, corner


def prim_backward(pos, indices, grec, width: int, height: int):
    """The backward of :func:`prim_forward` for the record's gradient grec
    (P, 27 | 21) float32 -> (dpos (3 P, 4), dcol (3 P, 4), duv (3 P, 2) or
    None untextured), float32, corner-major; dpos's z column is 0."""
    dev, V, P, C = _tables(pos, None, None, indices, grec)
    dpos = torch.empty((3 * P, 4), dtype=torch.float32, device=dev)
    dcol = torch.empty((3 * P, 4), dtype=torch.float32, device=dev)
    duv = None
    if C == REC_WIDTH_TEXTURED:
        duv = torch.empty((3 * P, 2), dtype=torch.float32, device=dev)
    hw, hh, _, _ = constants(width, height, 0.0, 1.0)

    from .. import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.skybox_diff_prim_backward(
        _ptr(pos), _ptr(indices), _ptr(grec), _ptr(dpos), _ptr(dcol),
        _ptr(duv), P, V, hw, hh, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"diff_prim backward launch failed: CUDA error "
                           f"{rc}")
    _launched()
    return dpos, dcol, duv
