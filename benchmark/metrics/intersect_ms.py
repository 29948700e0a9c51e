"""Device milliseconds an iteration in the port's ray-query kernels, picked
out of the profiled stretch by name."""

#: the __global__ functions of csrc/rt_bvh.cu, rt_clustered.cu and
#: rt_streamed.cu; a device operation whose name holds one is an intersector
INTERSECTORS = ("bvh_walk_kernel", "clustered_kernel",
                "closest_hit_flat_kernel", "closest_hit_blocks_kernel",
                "active_block_lists_kernel")


def is_intersector(name: str) -> bool:
    return any(k in name for k in INTERSECTORS)


def read(ctx):
    if ctx.trace is None:
        return None
    spans = [(s, e) for n, s, e in ctx.trace.device_ops if is_intersector(n)]
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / ctx.trace.iters
