"""Seconds from process start to the first timed iteration: imports, CUDA,
the program's set-up and the warm-up."""


def read(ctx):
    return ctx.setup_s
