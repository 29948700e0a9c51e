"""Hard-mode slot shading of the differentiable pipeline: the CUDA kernels'
wrappers and the plain twin of their per-tile slot reduction.

The kernels, ``csrc/diff_shade.cu`` (a forward and a backward), replace no
Pallas TPU kernel: the JAX package shades the slots in plain jnp and leaves
the fusion to XLA.  ``diff/pipeline._ShadeHard`` launches them where
``shade_slots`` gets one slot in hard mode (no blend, no soft edge) on CUDA
tensors; every other case, CPU tensors included, runs the plain loop of
``shade_slots``, which is the kernels' plain version.  The source says how
they are laid out and what bounds them.

  * :func:`shade_forward` launches the forward on the current stream, or
    raises: a CUDA tensor of the right dtype, shape and layout or nothing.
    It reads each pixel's record from the packed records ``rec`` (P, C)
    through the tile lists, as ``gather_rows(rec, tile_pids)`` would give
    it, without making that (T, M, C) copy.
  * :func:`shade_backward` launches the backward the same way; it returns
    the tile-record gradient (T, M, C), summed into the tile's slots in the
    pinned order below, and, textured, each pixel's texel-quad row and its
    anchor (-1 for a background pixel), which the caller accumulates with
    ``cuda_texgrad`` (the tile-record gradient into rec's rows through the
    tile lists, the quad rows into the quad table).
  * :func:`tile_rows_reference` is the plain twin of that reduction, on any
    device: ``out[t, m] = 0 + rows[t, n]`` over the n with ``steps[t, n] ==
    m`` in ascending n, one float32 addition each.  It is what
    ``pipeline.gather_tile_rows``' one-hot product computes, with the order
    pinned: on integer-valued rows the two agree exactly.
  * :func:`shade_forward_reference` and :func:`shade_backward_reference`
    repeat the kernels' expressions in their order in plain torch, on any
    device, for the tests and chip_smoke.py: on the card the kernels equal
    them bit for bit; on the CPU the forward equals the plain loop bit for
    bit and the backward autograd's gradients of it to float rounding.

Each launch adds one to :data:`launch_count` and to the tracing counter
``diff.shade_kernel``.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import tracing
from .cuda_vis import TILE_LOGSIZES, _check, tile_coords

#: record floats a prim: 9 edge coefficients and 3 RGBA corner colours, and
#: 3 corner uvs when textured (diff/pipeline.shade_slots' ``rec``)
REC_WIDTH = 21
REC_WIDTH_TEXTURED = 27

# Kernel launches of shade_forward and shade_backward since the last reset:
# a run reads it to show that its main path went through the kernels.
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def tile_rows_reference(steps, rows, num_slots: int):
    """Plain torch ``out[t, m] = sum of rows[t, n] over steps[t, n] == m``,
    (T, num_slots, C) float32, in the pinned order: 0 + the rows in
    ascending n.  steps (T, ...) int, rows (T, ..., C) float; a step
    outside [0, num_slots) is dropped.  It ranks each kept pixel within its
    (tile, slot) group with a stable sort, then adds rank 0 of every group,
    rank 1, ... with an indexed write in which no group occurs twice."""
    T, C = rows.shape[0], rows.shape[-1]
    dev = rows.device
    steps = steps.detach().reshape(T, -1).long()
    vals = rows.detach().to(torch.float32).reshape(-1, C)
    n = steps.shape[1]
    keep = (steps >= 0) & (steps < num_slots)
    tile = torch.arange(T, device=dev)[:, None]
    key = (tile * num_slots + steps)[keep]
    src = (tile * n + torch.arange(n, device=dev)[None, :])[keep]
    order = torch.argsort(key, stable=True)          # ascending n in a group
    key, src = key[order], src[order]
    pos = torch.arange(key.numel(), device=dev)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    out = torch.zeros((T * num_slots, C), dtype=torch.float32, device=dev)
    for k in range(int(rank.max()) + 1 if key.numel() else 0):
        sel = rank == k
        rows_k = key[sel]                            # each group once
        out[rows_k] = out[rows_k] + vals[src[sel]]
    return out.reshape(T, num_slots, C)


def _pixels(rec, tex_quad, tile_pids, steps, origins, tile_logsize):
    """Every pixel's forward intermediates, the kernels' expressions in
    their order: a dict of (T, ts, ts, ...) float32 tensors."""
    T, M = tile_pids.shape
    s = steps.long()
    live = (s >= 0) & (s < M)
    pid = tile_pids.long()[torch.arange(T, device=s.device)[:, None, None],
                           s.clamp(0, max(M - 1, 0))]
    r = rec[pid.clamp(min=0)]
    xs, ys = tile_coords(1 << tile_logsize, origins)
    e = [(r[..., 3 * k] * xs + r[..., 3 * k + 1] * ys) + r[..., 3 * k + 2]
         for k in range(3)]
    den = (e[0] + e[1]) + e[2]
    big = den.abs() > 1e-20
    denom = torch.where(big, den, 1e-20)
    b0, b1 = e[0] / denom, e[1] / denom
    b = [b0[..., None], b1[..., None], ((1.0 - b0) - b1)[..., None]]

    def interp(at, width):
        return ((r[..., at:at + width] * b[0]
                 + r[..., at + width:at + 2 * width] * b[1])
                + r[..., at + 2 * width:at + 3 * width] * b[2])

    p = {"r": r, "live": live, "xs": xs, "ys": ys, "e": e, "big": big,
         "denom": denom, "b": b, "col": interp(9, 4)}
    if tex_quad is not None:
        th, tw = tex_quad.shape[:2]
        uv = interp(21, 2)
        uu = torch.remainder(uv[..., 0], 1.0) * tw - 0.5
        vv = torch.remainder(uv[..., 1], 1.0) * th - 0.5
        x0, y0 = torch.floor(uu), torch.floor(vv)
        fx, fy = (uu - x0)[..., None], (vv - y0)[..., None]
        anchor = (torch.remainder(y0.to(torch.int64), th) * tw
                  + torch.remainder(x0.to(torch.int64), tw))
        q = tex_quad.reshape(th * tw, 4, 4)[anchor]
        cx0 = q[..., 0, :] + fx * (q[..., 1, :] - q[..., 0, :])
        cx1 = q[..., 2, :] + fx * (q[..., 3, :] - q[..., 2, :])
        p.update(fx=fx, fy=fy, anchor=anchor, q=q, th=th, tw=tw,
                 texel=cx0 + fy * (cx1 - cx0))
    return p


def shade_forward_reference(rec, tex_quad, tile_pids, steps, origins,
                            tile_logsize: int, modulate: bool, background):
    """Plain torch :func:`shade_forward`, the kernel's expressions in its
    order, on any device (``pipeline.shade_loop`` gives the same bits)."""
    p = _pixels(rec, tex_quad, tile_pids, steps, origins, tile_logsize)
    col = p["col"]
    if tex_quad is not None:
        col = col * p["texel"] if modulate else p["texel"]
    bg = torch.tensor(background, dtype=torch.float32, device=col.device)
    return torch.where(p["live"][..., None], col * 1.0 + bg * (1.0 - 1.0),
                       bg)


def shade_backward_reference(rec, tex_quad, tile_pids, steps, origins, grad,
                             tile_logsize: int, modulate: bool):
    """Plain torch :func:`shade_backward`, on any device: each live pixel's
    record gradient by the kernel's expressions in its order, summed by
    :func:`tile_rows_reference`; the texel-quad rows and anchors (zeros and
    -1 for a background pixel)."""
    M, C = tile_pids.shape[1], rec.shape[1]
    p = _pixels(rec, tex_quad, tile_pids, steps, origins, tile_logsize)
    r, b, live = p["r"], p["b"], p["live"]
    g = grad * 1.0
    colour = tex_quad is None or modulate
    gcol = g
    rows = anchor = None
    if tex_quad is not None:
        gt = g * p["col"] if modulate else g
        gcol = g * p["texel"] if modulate else None
        q, fx, fy = p["q"], p["fx"], p["fy"]
        ofx, ofy = 1.0 - fx, 1.0 - fy
        tx = gt * ((q[..., 1, :] - q[..., 0, :]) * ofy
                   + (q[..., 3, :] - q[..., 2, :]) * fy)
        ty = gt * ((q[..., 2, :] - q[..., 0, :]) * ofx
                   + (q[..., 3, :] - q[..., 1, :]) * fx)
        guv = torch.stack([_sum4(tx) * float(p["tw"]),
                           _sum4(ty) * float(p["th"])], -1)
        w = (ofx * ofy, fx * ofy, ofx * fy, fx * fy)
        rows = torch.where(live[..., None],
                           torch.cat([wk * gt for wk in w], -1), 0.0)
        rows = rows.reshape(-1, 16)
        anchor = torch.where(live, p["anchor"], -1).to(torch.int32).reshape(-1)
    row = [None] * C
    gb = []
    for k in range(3):
        acc = None
        if colour:
            row[9 + 4 * k:13 + 4 * k] = (gcol * b[k]).unbind(-1)
            acc = _sum4(gcol * r[..., 9 + 4 * k:13 + 4 * k])
        else:
            row[9 + 4 * k:13 + 4 * k] = [torch.zeros_like(b[k][..., 0])] * 4
        if tex_quad is not None:
            row[21 + 2 * k:23 + 2 * k] = (guv * b[k]).unbind(-1)
            v = (guv[..., 0] * r[..., 21 + 2 * k]
                 + guv[..., 1] * r[..., 22 + 2 * k])
            acc = acc + v if colour else v
        gb.append(acc)
    e, denom = p["e"], p["denom"]
    gb0, gb1 = gb[0] - gb[2], gb[1] - gb[2]
    dd = denom * denom
    gs = torch.where(p["big"], (-gb0 * e[0]) / dd + (-gb1 * e[1]) / dd, 0.0)
    for k, ge in enumerate((gb0 / denom + gs, gb1 / denom + gs, gs)):
        row[3 * k:3 * k + 3] = [ge * p["xs"], ge * p["ys"], ge]
    grec = tile_rows_reference(steps, torch.stack(row, -1), M)
    return grec, rows, anchor


def _sum4(v):
    """((v0 + v1) + v2) + v3 over the last axis, the kernel's order."""
    return ((v[..., 0] + v[..., 1]) + v[..., 2]) + v[..., 3]


def _inputs(rec, tex_quad, tile_pids, steps, origins, tile_logsize,
            grad=None):
    """Validate the kernels' inputs (``grad``: the backward's); returns
    (device, T, M, C, TH, TW).  dtype, shape and layout are checked before
    the device, so every check can be seen to raise on any device."""
    if tile_logsize not in TILE_LOGSIZES:
        raise ValueError(f"tile_logsize {tile_logsize} not in "
                         f"{TILE_LOGSIZES}")
    if rec.dim() != 2 or tile_pids.dim() != 2:
        raise ValueError(f"rec must be (P, C) and tile_pids (T, M), got "
                         f"{tuple(rec.shape)} and {tuple(tile_pids.shape)}")
    dev = rec.device
    P, C = rec.shape
    T, M = tile_pids.shape
    ts = 1 << tile_logsize
    want = REC_WIDTH if tex_quad is None else REC_WIDTH_TEXTURED
    _check("rec", rec, torch.float32, (P, want), dev)
    _check("tile_pids", tile_pids, torch.int32, (T, M), dev)
    TH = TW = 0
    if tex_quad is not None:
        if tex_quad.dim() != 4:
            raise ValueError(f"tex_quad must be (TH, TW, 4, 4), got "
                             f"{tuple(tex_quad.shape)}")
        TH, TW = tex_quad.shape[:2]
        _check("tex_quad", tex_quad, torch.float32, (TH, TW, 4, 4), dev)
    _check("steps", steps, torch.int32, (T, ts, ts), dev)
    _check("origins", origins, torch.int32, (T, 2), dev)
    if grad is not None:
        _check("grad", grad, torch.float32, (T, ts, ts, 4), dev)
    if dev.type != "cuda":
        raise ValueError(f"diff_shade: the kernels take CUDA tensors, got "
                         f"{dev}; the plain loop of pipeline.shade_slots "
                         "is their CPU version")
    if T * M * C >= 2 ** 31 or T * ts * ts * 16 >= 2 ** 31 \
            or TH * TW >= 2 ** 31 // 16 or P * C >= 2 ** 31:
        raise ValueError(f"diff_shade: records ({P}, {C}), tiles ({T}, {M}) "
                         f"at tile_logsize {tile_logsize} exceed int32 "
                         "indexing")
    return dev, T, M, C, TH, TW


def _aligned(name, t):
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _launched():
    global launch_count
    launch_count += 1
    tracing.count("diff.shade_kernel")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def shade_forward(rec, tex_quad, tile_pids, steps, origins,
                  tile_logsize: int, modulate: bool, background):
    """The one-slot hard shade: rec (P, C) float32 (the packed records of
    ``pipeline.shade_slots``), tex_quad (TH, TW, 4, 4) float32 or None
    (untextured), tile_pids (T, M) int32 (-1 padded), steps (T, ts, ts)
    int32 winner steps (-1 background), origins (T, 2) int32 pixel origins,
    the background's four floats -> (T, ts, ts, 4) float32, bit for bit the
    plain loop's tiles."""
    dev, T, M, C, TH, TW = _inputs(rec, tex_quad, tile_pids, steps, origins,
                                   tile_logsize)
    ts = 1 << tile_logsize
    if tex_quad is not None:
        _aligned("tex_quad", tex_quad)
    out = torch.empty((T, ts, ts, 4), dtype=torch.float32, device=dev)
    bg = [float(v) for v in background]

    from .. import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.skybox_diff_shade_forward(
        _ptr(rec), _ptr(tile_pids), _ptr(tex_quad), _ptr(steps),
        _ptr(origins), _ptr(out), T, M, C, tile_logsize, TH, TW,
        int(bool(modulate)), *bg, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"diff_shade forward launch failed: CUDA error "
                           f"{rc}")
    _launched()
    return out


def shade_backward(rec, tex_quad, tile_pids, steps, origins, grad,
                   tile_logsize: int, modulate: bool):
    """The backward of :func:`shade_forward` for the upstream gradient grad
    (T, ts, ts, 4) float32 -> (grec (T, M, C) float32 in the pinned order
    of :func:`tile_rows_reference`, rows (T * ts * ts, 16) float32 and
    anchor (T * ts * ts,) int32, or None and None untextured)."""
    dev, T, M, C, TH, TW = _inputs(rec, tex_quad, tile_pids, steps, origins,
                                   tile_logsize, grad)
    ts = 1 << tile_logsize
    _aligned("grad", grad)
    grec = torch.empty((T, M, C), dtype=torch.float32, device=dev)
    rows = anchor = None
    if tex_quad is not None:
        _aligned("tex_quad", tex_quad)
        rows = torch.empty((T * ts * ts, 16), dtype=torch.float32, device=dev)
        anchor = torch.empty(T * ts * ts, dtype=torch.int32, device=dev)

    from .. import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.skybox_diff_shade_backward(
        _ptr(rec), _ptr(tile_pids), _ptr(tex_quad), _ptr(steps),
        _ptr(origins), _ptr(grad), _ptr(grec), _ptr(rows), _ptr(anchor), T,
        M, C, tile_logsize, TH, TW, int(bool(modulate)),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"diff_shade backward launch failed: CUDA error "
                           f"{rc}")
    _launched()
    return grec, rows, anchor
