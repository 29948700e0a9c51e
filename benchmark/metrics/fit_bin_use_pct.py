"""100 x the live tile-list entries over every entry of the padded lists:
the share of the (tile, list entry) pairs that kernel #4 and the shade's
per-tile gathers walk that hold a prim rather than -1 padding.  The lists
are padded to the longest list's length (a multiple of 4).  The bins are
made once at set-up, so the entry counts both on the host
(``info["tile_entries"]``, entries/fit_step.kernel_work); None where the
entry gives no such counts."""


def read(ctx):
    entries = (ctx.info or {}).get("tile_entries")
    if not entries or not entries[1]:
        return None
    live, launched = entries
    return 100.0 * live / launched
