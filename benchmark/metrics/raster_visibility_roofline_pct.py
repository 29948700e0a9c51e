"""Kernel #1's share of its bytes bound, in %: the raster pass 1
(``visibility_kernel``, in an anonymous namespace), picked out of the device
stretch by its exact name.

The bound is the bytes that any implementation of pass 1 must move a
frame, over the card's memory rate (peaks.H100_PEAKS, 3.35 TB/s; the run
records the card's power limit beside it).  For each draw: each live
tile-list entry (4 bytes) read once, and its triangle's record (9 edge
and 3 depth words, 48 bytes) read once a tile; each pixel of the binned
tiles' depth-stencil word read and written once (8 bytes); each pixel's
output words written once: the winner and its two gradients for an opaque
draw, the K slots and the count for a blended one (4 bytes each).  The
entry counts the lists at set-up and K from the program's counter
``raster.blend_slots`` (``info["visibility"]``)."""
from benchmark import peaks
from benchmark.metrics.fit_kernels_roofline_pct import kernel_name

VIS_KERNEL = "(anonymous namespace)::visibility_kernel"
ENTRY_BYTES = 4
RECORD_BYTES = 12 * 4
DS_BYTES = 2 * 4
WORD_BYTES = 4


def visibility_bytes(visibility) -> int:
    """Bytes a frame from [live entries, binned pixels, output words a
    pixel] of each draw."""
    return sum(live * (ENTRY_BYTES + RECORD_BYTES)
               + px * (DS_BYTES + WORD_BYTES * words)
               for live, px, words in visibility)


def read(ctx):
    if ctx.trace is None or "visibility" not in (ctx.info or {}):
        return None
    us = sum(e - s for n, s, e in ctx.trace.device_ops
             if kernel_name(n) == VIS_KERNEL)
    if not us:
        return None
    bound_s = visibility_bytes(ctx.info["visibility"]) \
        / peaks.H100_PEAKS["hbm_bytes_per_s"]
    return 100.0 * bound_s / (us / 1e6 / ctx.trace.iters)
