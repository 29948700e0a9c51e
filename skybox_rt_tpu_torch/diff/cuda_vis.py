"""Hard-mode visibility of the differentiable pipeline: the CUDA kernel and
its plain torch version.

Counterpart of skybox_rt_tpu.diff.pallas_vis.  The kernel,
``csrc/diff_visibility.cu``, replaces the Pallas TPU kernel
``pallas_vis._make_kernel`` (launched by ``visibility_hard``); its source
says how it is laid out and what bounds it.  A warp of it culls prims for a
pixel patch: :func:`patch_culled` is that cull's plain twin and
:func:`cull_counts` the kernel's work; the tests and chip_smoke.py call
them, the training path does not.  :func:`visibility_hard` keeps
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

import numpy as np
import torch

TILE_LOGSIZES = (3, 4, 5, 6)
#: the pixels of one warp of the kernel: a patch PATCH_W wide, PATCH_H tall
#: (csrc/diff_visibility.cu kPatchW, kPatchH)
PATCH_W, PATCH_H = 8, 4

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


def patch_culled(edges, x0, y0):
    """Whether a prim provably covers no pixel of the kernel's patch
    [x0, x0 + PATCH_W) x [y0, y0 + PATCH_H): the kernel's cull, exact under
    float32 rounding.

    edges (..., 3, 3) float32 [edge][a, b, c]; x0, y0 int tensors
    broadcastable against edges[..., 0, 0].  A pixel's edge value is the
    rounded (a*x + b*y) + c of :func:`chunk_edges`.  Each rounded operation
    is monotone in each input, so that expression at the corner x = x1 if
    a >= 0 else x0 (y likewise) bounds every pixel's value from above,
    unless a NaN (inf * 0, inf - inf) arises, which reaches the end of its
    chain.  A prim is culled when the corner value of one of its edges is
    < 0 (a NaN corner never culls): each pixel's value is then NaN or
    negative, and fails ``>= 0``."""
    a, b, c = edges[..., 0], edges[..., 1], edges[..., 2]

    def corner(v0, extent, coef):
        v0 = torch.as_tensor(v0, device=edges.device)[..., None]
        return torch.where(coef >= 0, v0 + (extent - 1), v0).to(torch.float32)

    xc, yc = corner(x0, PATCH_W, a), corner(y0, PATCH_H, b)
    return (a * xc + b * yc + c < 0).any(dim=-1)


def patch_origins(origins, tile_logsize):
    """(T, patches, 2) int64 pixel (x0, y0) of each kernel patch of each
    tile, in the kernel's patch order (row-major in the tile)."""
    ts = 1 << tile_logsize
    px = torch.arange(0, ts, PATCH_W, device=origins.device)
    py = torch.arange(0, ts, PATCH_H, device=origins.device)
    local = torch.stack(torch.broadcast_tensors(px[None, :], py[:, None]),
                        dim=-1).reshape(-1, 2)
    return origins.to(torch.int64)[:, None, :] + local[None]


def cull_counts(edges, tile_pids, origins, tile_logsize):
    """The kernel's work, by :func:`patch_culled`: a dict of
    ``kept_steps`` (pixel steps its warps run), ``cull_tests`` ((patch,
    prim) tests), ``covered_steps`` (pixel steps whose three edge values
    pass) and ``all_steps`` (every pixel of a tile over each real prim: the
    earlier one-block-a-tile design's steps)."""
    ts = 1 << tile_logsize
    real = tile_pids >= 0                                   # (T, M)
    org = patch_origins(origins, tile_logsize)              # (T, Q, 2)
    e = edges[tile_pids.clamp(min=0).long()]                # (T, M, 3, 3)
    culled = patch_culled(e[:, :, None], org[:, None, :, 0],
                          org[:, None, :, 1])               # (T, M, Q)
    kept = int((~culled & real[:, :, None]).sum())
    xs, ys = tile_coords(ts, origins)
    covered = 0
    for pc, _ in padded_chunks(tile_pids, 16):
        covered += int(chunk_edges(edges, pc, xs, ys)[3].sum())
    n = int(real.sum())
    return {"kept_steps": kept * PATCH_W * PATCH_H,
            "cull_tests": n * org.shape[1], "covered_steps": covered,
            "all_steps": n * ts * ts}


def cull_case(tile_logsize, seed, device="cpu"):
    """Hard-visibility inputs (edges (P, 3, 3), z (P, 3), tile_pids (T, M),
    origins (T, 2)) for the cull's edge cases, made with numpy from
    ``seed``: 6 tiles of up to 40 of 64 prims (one row empty, one full),
    edges of random scale through random pixels, 12 edges made exactly 0 at
    a patch corner (small integer a, b), 8 prims with an infinite or NaN
    coefficient, 4 zero-area prims (two opposite edges and a zero one, or
    all three zero) and depths with infinities and NaN."""
    rng = np.random.default_rng(seed)
    P, T, Mx, ts = 64, 6, 40, 1 << tile_logsize
    origins = rng.choice(8, (T, 2)) * ts
    ab = rng.uniform(-1, 1, (P, 3, 2)) * 2.0 ** rng.integers(-6, 9, (P, 3, 1))
    at = rng.uniform(0, 8 * ts, (P, 3, 2))
    edges = np.concatenate([ab, -(ab * at).sum(-1, keepdims=True)], -1)
    pick = rng.choice(P * 3, 12, replace=False)
    a, b = rng.integers(-4, 5, (2, 12))
    x = rng.choice(8 * ts // PATCH_W, 12) * PATCH_W \
        + rng.choice([0, PATCH_W - 1], 12)
    y = rng.choice(8 * ts // PATCH_H, 12) * PATCH_H \
        + rng.choice([0, PATCH_H - 1], 12)
    edges.reshape(-1, 3)[pick] = np.stack([a, b, -(a * x + b * y)], 1)
    bad = rng.choice(P, 8, replace=False)
    edges[bad, rng.integers(0, 3, 8), rng.integers(0, 3, 8)] = rng.choice(
        [np.inf, -np.inf, np.nan], 8)
    flat = rng.choice(np.setdiff1d(np.arange(P), bad), 4, replace=False)
    edges[flat[:2], 1] = -edges[flat[:2], 0]
    edges[flat[:2], 2] = 0.0
    edges[flat[2:]] = 0.0
    z = rng.uniform(-1, 1, (P, 3))
    z[rng.choice(P, 6, replace=False), rng.integers(0, 3, 6)] = rng.choice(
        [np.inf, -np.inf, np.nan], 6)
    pids = np.full((T, Mx), -1)
    for t in range(T):
        m = 0 if t == 2 else Mx if t == 1 else int(rng.integers(1, Mx))
        pids[t, :m] = np.sort(rng.choice(P, m, replace=False))
    return tuple(torch.as_tensor(v, device=device) for v in (
        edges.astype(np.float32), z.astype(np.float32),
        pids.astype(np.int32), origins.astype(np.int32)))


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
