"""Hard-mode visibility of the differentiable pipeline: the CUDA kernel and
its plain torch version.

Counterpart of skybox_rt_tpu.diff.pallas_vis.  The kernel,
``csrc/diff_visibility.cu``, replaces the Pallas TPU kernel
``pallas_vis._make_kernel`` (launched by ``visibility_hard``); its source
says how it is laid out and what bounds it.  :func:`visibility_hard` keeps
the JAX signature (minus ``interpret``):

  * a CUDA tensor launches the kernel on the current stream, or raises;
  * a CPU tensor runs :func:`visibility_hard_reference`, the plain torch
    port of the chunk reduction ``per_tile_hard`` inside the JAX package's
    ``diff.pipeline.visibility_slots``.  ``visibility_slots(engine="xla")``,
    the CPU tests and chip_smoke.py's comparison phase call it by name;
    nothing on the training path does when a card is present.

Both return, for every pixel of every tile, the step (index into the tile's
pid list) of the fragment that wrote it last under the sequential rule of
``diff.pipeline.render_tile_set``: with the depth test the lexicographic
(z, step) minimum under strict ``<`` (the earliest step wins a z tie),
without it the last covered step; -1 is background.  Kernel and plain version
evaluate the same float32 expressions in the same order and association and
agree on every pixel.  One departure from the JAX reduction, on purpose: a
fragment whose z is ``-inf`` wins here as it does in the sequential rule
(``-inf < inf``); JAX's reduction masks with ``isfinite`` and drops it.  NaN
and ``+inf`` never win in either.
"""
from __future__ import annotations

import ctypes

import torch

TILE_LOGSIZES = (3, 4, 5, 6)

#: Steps advanced per pass of the plain chunk reduction.  Larger means fewer
#: passes and bigger (tiles, VIS_CHUNK, ts, ts) temporaries.
VIS_CHUNK = 128
# the plain version walks the tiles in groups so that one temporary holds at
# most this many elements
_GROUP_ELEMS = 1 << 25
_BIG = 2 ** 30

# Kernel launches made by visibility_hard since the last reset: a run reads
# it to show that its main path went through the kernel.
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def tile_coords(ts: int, origins: torch.Tensor):
    """(T, ts, ts) float32 pixel x / y of each tile: integers first
    (origin + local), then the cast."""
    lin = torch.arange(ts, dtype=torch.int32, device=origins.device)
    origins = origins.to(torch.int32)
    xs = (lin[None, None, :] + origins[:, 0, None, None]).to(torch.float32)
    ys = (lin[None, :, None] + origins[:, 1, None, None]).to(torch.float32)
    return xs.expand(-1, ts, ts), ys.expand(-1, ts, ts)


def barycentrics(e0, e1, e2):
    """Barycentrics from the three edge functions, the denominator clamped
    at 1e-20 (the float32 expressions the kernel repeats)."""
    s = e0 + e1 + e2
    denom = torch.where(s.abs() > 1e-20, s, 1e-20)
    b0 = e0 / denom
    b1 = e1 / denom
    b2 = 1.0 - b0 - b1
    return b0, b1, b2


def chunk_edges(edges, pc, xs, ys):
    """Edge functions of a chunk of prims at every pixel: edges (P, 3, 3),
    pc (T, CH) prim ids (-1 = padding), xs / ys (T, ts, ts) -> e0, e1, e2
    and the coverage mask, all (T, CH, ts, ts), and the clamped ids."""
    p = pc.clamp(min=0).long()
    e = edges[p]                                    # (T, CH, 3, 3)
    x, y = xs[:, None], ys[:, None]

    def ev(k):
        return (e[:, :, k, 0, None, None] * x + e[:, :, k, 1, None, None] * y
                + e[:, :, k, 2, None, None])

    e0, e1, e2 = ev(0), ev(1), ev(2)
    inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (pc >= 0)[:, :, None, None]
    return e0, e1, e2, inside, p


def chunk_z(z, p, e0, e1, e2):
    """Interpolated depth of a chunk's fragments: z (P, 3), p (T, CH)."""
    b0, b1, b2 = barycentrics(e0, e1, e2)
    zc = z[p]                                       # (T, CH, 3)
    return (zc[:, :, 0, None, None] * b0 + zc[:, :, 1, None, None] * b1
            + zc[:, :, 2, None, None] * b2)


def padded_chunks(tile_pids, ch):
    """tile_pids (T, M) padded with -1 to a multiple of ch: yields
    (pids (T, ch), steps (ch,) int32) chunk by chunk."""
    T, M = tile_pids.shape
    Mp = -(-M // ch) * ch
    pids = torch.nn.functional.pad(tile_pids, (0, Mp - M), value=-1)
    steps = torch.arange(Mp, dtype=torch.int32, device=tile_pids.device)
    for c0 in range(0, Mp, ch):
        yield pids[:, c0:c0 + ch], steps[c0:c0 + ch]


def visibility_hard_reference(edges, z, tile_pids, origins, tile_logsize,
                              depth_test):
    """Plain torch winner steps, (T, ts, ts) int32, on any device: per
    chunk of VIS_CHUNK steps the lexicographic (z, step) minimum (or the
    largest covered step), merged into a carry."""
    ts = 1 << tile_logsize
    T = tile_pids.shape[0]
    group = max(1, _GROUP_ELEMS // (VIS_CHUNK * ts * ts))
    out = []
    with torch.no_grad():
        edges, z = edges.detach(), z.detach()
        for t0 in range(0, T, group):
            out.append(_hard_group(edges, z, tile_pids[t0:t0 + group],
                                   origins[t0:t0 + group], ts, depth_test))
    return torch.cat(out)


def _hard_group(edges, z, tile_pids, origins, ts, depth_test):
    T = tile_pids.shape[0]
    dev = tile_pids.device
    xs, ys = tile_coords(ts, origins)
    inf = float("inf")
    best_z = torch.full((T, ts, ts), inf, dtype=torch.float32, device=dev)
    best_s = torch.full((T, ts, ts), _BIG if depth_test else -1,
                        dtype=torch.int32, device=dev)
    for pc, sc in padded_chunks(tile_pids, VIS_CHUNK):
        e0, e1, e2, inside, p = chunk_edges(edges, pc, xs, ys)
        sc = sc[None, :, None, None]
        if depth_test:
            zp = chunk_z(z, p, e0, e1, e2)
            # what never passes `zp < best_z` in the sequential rule (NaN,
            # +inf) carries no step
            ok = inside & (zp < inf)
            zi = torch.where(ok, zp, inf)
            si = torch.where(ok, sc, _BIG)
            czmin = zi.amin(dim=1)
            csmin = torch.where(zi == czmin[:, None], si, _BIG).amin(dim=1)
            take = czmin < best_z
            tie = czmin == best_z
            best_s = torch.where(
                take, csmin,
                torch.where(tie, torch.minimum(best_s, csmin), best_s))
            best_z = torch.where(take, czmin, best_z)
        else:
            smax = torch.where(inside, sc, -1).amax(dim=1)
            best_s = torch.maximum(best_s, smax)
    if depth_test:
        best_s = torch.where(best_s == _BIG, -1, best_s)
    return best_s


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def visibility_hard(edges, z, tile_pids, origins, tile_logsize: int,
                    depth_test: bool):
    """Hard-mode winner steps: edges (P, 3, 3) f32, z (P, 3) f32, tile_pids
    (T, M) i32 (-1 padded), origins (T, 2) i32 pixel origins -> (T, ts, ts)
    i32 step into the tile's pid list, -1 = background.  No gradient flows
    through it: the inputs are taken detached."""
    dev = tile_pids.device
    if dev.type == "cpu":
        return visibility_hard_reference(edges, z, tile_pids, origins,
                                         tile_logsize, depth_test)
    if dev.type != "cuda":
        raise ValueError(f"visibility_hard: unsupported device {dev}")
    if tile_logsize not in TILE_LOGSIZES:
        raise ValueError(f"tile_logsize {tile_logsize} not in {TILE_LOGSIZES}")
    ts = 1 << tile_logsize
    T, M = tile_pids.shape
    P = edges.shape[0]
    edges, z = edges.detach(), z.detach()
    _check("edges", edges, torch.float32, (P, 3, 3), dev)
    _check("z", z, torch.float32, (P, 3), dev)
    _check("tile_pids", tile_pids, torch.int32, (T, M), dev)
    _check("origins", origins, torch.int32, (T, 2), dev)
    out = torch.empty((T, ts, ts), dtype=torch.int32, device=dev)

    from .. import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.skybox_diff_visibility_hard(
        ctypes.c_void_p(edges.data_ptr()), ctypes.c_void_p(z.data_ptr()),
        ctypes.c_void_p(tile_pids.data_ptr()),
        ctypes.c_void_p(origins.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        T, M, tile_logsize, int(bool(depth_test)), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"diff_visibility kernel launch failed: CUDA "
                           f"error {rc}")
    global launch_count
    launch_count += 1
    return out
