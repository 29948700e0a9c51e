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
construction: a stable counting sort by (row, segment) lists each row's
values in ascending n, and one warp a row walks its list, keeps the
segment's partial and the row's sum in registers and adds the partial where
the segment changes (a row longer than ``LONG_ROW`` is summed group by group
into a table of partials, then the partials in ascending s); no
floating-point atomics.  The wrapper allocates the sort's scratch,
:func:`scratch_sizes`.  The plain version is ORDER-EXACT on any device, CUDA
tensors included, so kernel and plain version compare bit for bit on the
card as the CPU tests do here: it ranks every value within its (segment,
row) group with a stable integer sort, then adds rank 0 of every group, rank
1, ... with an indexed write in which no row occurs twice, so no atomic and
no library scatter-add decides an order.  It is slow (one pass a rank) and
is never the training path's.
"""
from __future__ import annotations

import torch

#: shortest segment and largest number of segments of the pinned order
SEGMENT_MIN = 1024
SEGMENTS_MAX = 256
#: keys a block of the kernel's scan takes at most, and the length above
#: which a row is summed group by group (as csrc/diff_accumulate.cu has them)
SCAN_KEYS = 2048
LONG_ROW = 1024

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


def scratch_sizes(n: int, num_rows: int, cols: int) -> dict:
    """The kernel's scratch for n values into a (num_rows, cols) table: one
    buffer of 32-bit words, its parts in the order the kernel lays them out.
    ``status`` (the scan's look-back words, two 32-bit words for each chunk
    of ``rows`` whole rows), ``counts`` (one a (row, segment) group; the scan
    turns them into offsets), ``ticket`` and ``nlong`` (the chunks started,
    the long rows found), ``rowslot`` (a long row's slot, or -1),
    ``longrows`` (one a slot), ``perm`` (the sorted list; the kept values
    fill its first entries) and ``partials`` (float: slot, segment,
    column).  The first four parts start at 0.  A long row holds more than
    LONG_ROW kept values, so at most n // (LONG_ROW + 1) rows are long."""
    S, _ = segments(n)
    rows = max(1, SCAN_KEYS // S)
    max_long = min(num_rows, n // (LONG_ROW + 1))
    parts = {"status": 2 * -(-num_rows // rows), "counts": S * num_rows,
             "ticket": 1, "nlong": 1, "rowslot": num_rows,
             "longrows": max_long, "perm": n,
             "partials": max_long * S * cols}
    return {"parts": parts, "words": sum(parts.values()), "rows": rows,
            "max_long": max_long}


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
    S, L = segments(N)
    if num_rows <= 0 or C <= 0 or num_rows * C >= 2 ** 31 \
            or S * num_rows >= 2 ** 31 or N >= 2 ** 31 - 1024:
        raise ValueError(f"accumulate_rows: {N} values into a table "
                         f"({num_rows}, {C})")
    idx = idx.detach().reshape(-1).to(torch.int32).contiguous()
    val = val.detach().contiguous()
    plan = scratch_sizes(N, num_rows, C)
    if plan["words"] >= 2 ** 31:
        raise ValueError(f"accumulate_rows: {N} values into a table "
                         f"({num_rows}, {C}) need {plan['words']} words of "
                         "scratch, more than an int32 counts")
    scratch = torch.empty(plan["words"], dtype=torch.int32, device=dev)
    out = torch.empty((num_rows, C), dtype=torch.float32, device=dev)

    from .. import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.skybox_diff_accumulate_rows(
        idx.data_ptr(), val.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        N, num_rows, C, S, L, plan["max_long"], plan["words"], stream)
    if rc != 0:
        raise RuntimeError(f"diff_accumulate kernel launch failed: CUDA "
                           f"error {rc}")
    global launch_count
    launch_count += 1
    return out
