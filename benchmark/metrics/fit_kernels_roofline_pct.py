"""The fit step's hand-written kernels' share of their bytes bound, in %:
kernel #4 (``diff_visibility_kernel``, in an anonymous namespace) and
kernel #5 (the six kernels of the namespace ``diff_accumulate``), picked out
of the device stretch by their exact names.

The bound is the bytes that any implementation of the two functions must
move a step, over the card's memory rate (peaks.H100_PEAKS, 3.35 TB/s; the
run records the card's power limit beside it).  Visibility: each live
tile-list entry (4 bytes) and its triangle's record (edges and depths, 12
float32) read once, each pixel of the binned tiles' winner written once (4
bytes).  Row accumulation, each of a step's five calls: each value (C
float32) and its row index (4 bytes) read once, each row of the (R, C)
result written once.  The shapes are the entry's (``info``)."""
from benchmark import peaks

VIS_KERNEL = "(anonymous namespace)::diff_visibility_kernel"
ACCUMULATE_KERNELS = tuple(
    "diff_accumulate::" + k for k in (
        "zero_kernel", "count_kernel", "scan_kernel", "place_kernel",
        "long_groups_kernel", "sum_kernel"))
ENTRY_BYTES = 4
RECORD_BYTES = 12 * 4
WINNER_BYTES = 4
VALUE_BYTES = 4
INDEX_BYTES = 4


def kernel_name(op_name: str) -> str:
    """A device operation's function name: its name without the return
    type and the parameter list (the last parenthesised group) that the
    profiler prints."""
    name = op_name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip()
                break
    return name[len("void "):] if name.startswith("void ") else name


def is_fit_kernel(op_name: str) -> bool:
    return kernel_name(op_name) in (VIS_KERNEL,) + ACCUMULATE_KERNELS


def visibility_bytes(live_entries: int, pixels: int) -> int:
    return live_entries * (ENTRY_BYTES + RECORD_BYTES) + pixels * WINNER_BYTES


def accumulate_bytes(values: int, rows: int, cols: int) -> int:
    return values * (cols * VALUE_BYTES + INDEX_BYTES) + \
        rows * cols * VALUE_BYTES


def bytes_per_step(info: dict) -> int:
    return visibility_bytes(*info["visibility"]) + sum(
        accumulate_bytes(*call) for call in info["accumulate"])


def read(ctx):
    if ctx.trace is None or "visibility" not in ctx.info:
        return None
    us = sum(e - s for n, s, e in ctx.trace.device_ops if is_fit_kernel(n))
    if not us:
        return None
    bound_s = bytes_per_step(ctx.info) / peaks.H100_PEAKS["hbm_bytes_per_s"]
    return 100.0 * bound_s / (us / 1e6 / ctx.trace.iters)
