"""The window's wall time over the iterations it completed, in ms: all work
and all time of the window, stalls included."""


def read(ctx):
    return ctx.window_s / len(ctx.lat) * 1e3
