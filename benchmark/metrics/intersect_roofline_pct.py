"""The intersectors' share of their bytes bound, in %.

The bound is the bytes every ray query of the frame must move, whatever
implements it, over the card's memory rate (peaks.H100_PEAKS, 3.35 TB/s; the
run records the card's power limit beside it): each ray the frame must
trace is read once (origin and direction, 24 bytes, and for an occlusion
query its t_max, 4 more) and its result written once (closest hit: prim, t,
u, v, 16 bytes; occlusion: 1 byte), and the scene's triangles (v0, e1, e2,
36 bytes each) are read once a query.  The rays each query must trace are
the plain reference's own count for the same frame, not the port's launch
widths."""
from benchmark import peaks
from benchmark.metrics import intersect_ms

RAY_BYTES = {"closest": 24 + 16, "any": 24 + 4 + 1}
TRI_BYTES = 36


def bytes_per_iter(queries, triangles: int) -> int:
    return sum(n * RAY_BYTES[kind] + triangles * TRI_BYTES
               for kind, n in queries)


def read(ctx):
    ms = intersect_ms.read(ctx)
    queries = ctx.info.get("queries")
    if not ms or not queries:
        return None
    bound_s = (bytes_per_iter(queries, ctx.info["triangles"])
               / peaks.H100_PEAKS["hbm_bytes_per_s"])
    return 100.0 * bound_s / (ms / 1e3)
