"""Row accumulation (the transpose of a row gather): the CUDA kernel and its
plain torch version.

Counterpart of skybox_rt_tpu.diff.pallas_texgrad.  The kernel,
``csrc/diff_accumulate.cu``, replaces the Pallas TPU kernel
``pallas_texgrad._kernel`` (launched by ``accumulate_rows``); its source says
how it is laid out and what bounds it.  :func:`accumulate_rows` keeps the JAX
signature (minus ``interpret`` and ``split_bf16``) and drops the TPU kernel's
size limit (``pallas_texgrad.supported``): any number of rows and columns.

  * a CUDA tensor launches the kernel on the current stream, or raises;
  * a CPU tensor runs :func:`accumulate_rows_reference`.  The CPU tests and
    chip_smoke.py's comparison phase call it by name; nothing on the
    training path does when a card is present.

The sum's order is pinned, a function of (N, idx) alone:

  * n is cut into S segments of L consecutive values, :func:`segments`;
  * ``partial[s, r] = 0 + val[n]`` for the n of segment s with
    ``idx[n] == r``, one by one in ascending n;
  * ``out[r] = 0 + partial[0, r] + partial[1, r] + ...`` in ascending s.

Every addition is one float32 addition.  The kernel keeps the order by
construction (one thread owns a row of a segment, walks the segment in
ascending n and keeps the row's sum in registers; no floating-point
atomics).  The plain version is ORDER-EXACT on any device, CUDA tensors
included, so kernel and plain version compare bit for bit on the card as the
CPU tests do here: it ranks every value within its (segment, row) group with
a stable integer sort, then adds rank 0 of every group, rank 1, ... with an
indexed write in which no row occurs twice, so no atomic and no library
scatter-add decides an order.  It is slow (one pass a rank) and is never the
training path's.
"""
from __future__ import annotations

import ctypes

import torch

#: shortest segment and largest number of segments of the pinned order
SEGMENT_MIN = 1024
SEGMENTS_MAX = 256

# Calls of accumulate_rows that launched the kernel since the last reset.
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def segments(n: int) -> tuple[int, int]:
    """(S, L): n values are summed in S segments of L consecutive values
    (the last may be short).  A function of n alone: it is part of the sum's
    documented order."""
    s = max(1, min(-(-n // SEGMENT_MIN), SEGMENTS_MAX))
    return s, max(1, -(-n // s))


def accumulate_rows_reference(idx, val, num_rows: int):
    """Plain torch ``out[r] = sum of val[n] over idx[n] == r`` in the pinned
    order, (num_rows, C) float32, on any device."""
    N, C = val.shape
    dev = val.device
    R = num_rows
    S, L = segments(N)
    val = val.detach().to(torch.float32)
    idx = idx.detach().reshape(-1).long()
    n = torch.arange(N, device=dev)
    keep = (idx >= 0) & (idx < R)
    key = ((n // L) * R + idx)[keep]                # (segment, row) group
    n = n[keep]
    order = torch.argsort(key, stable=True)         # ascending n in a group
    key, n = key[order], n[order]
    pos = torch.arange(key.numel(), device=dev)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    partial = torch.zeros((S * R, C), dtype=torch.float32, device=dev)
    for k in range(int(rank.max()) + 1 if key.numel() else 0):
        sel = rank == k
        rows = key[sel]                             # each group once
        partial[rows] = partial[rows] + val[n[sel]]
    out = torch.zeros((R, C), dtype=torch.float32, device=dev)
    for table in partial.view(S, R, C):
        out = out + table
    return out


def accumulate_rows(idx, val, num_rows: int):
    """Σ over n of val[n] into row idx[n]: idx (N,) int32 or int64, val
    (N, C) float32 -> (num_rows, C) float32.  Rows outside [0, num_rows) are
    dropped.  The sum's order is the module's pinned one on either device."""
    dev = val.device
    if dev.type == "cpu":
        return accumulate_rows_reference(idx, val, num_rows)
    if dev.type != "cuda":
        raise ValueError(f"accumulate_rows: unsupported device {dev}")
    if val.dim() != 2 or val.dtype != torch.float32:
        raise TypeError(f"val must be (N, C) float32, got "
                        f"{tuple(val.shape)} {val.dtype}")
    N, C = val.shape
    if idx.device != dev or idx.numel() != N or idx.dtype not in (
            torch.int32, torch.int64):
        raise ValueError(f"idx must be {N} int32 or int64 values on {dev}, "
                         f"got {tuple(idx.shape)} {idx.dtype} on {idx.device}")
    if num_rows <= 0 or C <= 0 or num_rows * C >= 2 ** 31:
        raise ValueError(f"accumulate_rows: table ({num_rows}, {C})")
    idx = idx.detach().reshape(-1).to(torch.int32).contiguous()
    val = val.detach().contiguous()
    S, L = segments(N)
    partial = torch.empty((S, num_rows, C), dtype=torch.float32, device=dev)
    out = torch.empty((num_rows, C), dtype=torch.float32, device=dev)

    from .. import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.skybox_diff_accumulate_rows(
        ctypes.c_void_p(idx.data_ptr()), ctypes.c_void_p(val.data_ptr()),
        ctypes.c_void_p(partial.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        N, num_rows, C, S, L, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"diff_accumulate kernel launch failed: CUDA "
                           f"error {rc}")
    global launch_count
    launch_count += 1
    return out
