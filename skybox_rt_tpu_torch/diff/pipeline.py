"""Differentiable float32 render pipeline.

Counterpart of skybox_rt_tpu.diff.pipeline: the gradient twin of the
exact-int path, same architecture (host binning -> per-tile primitive walk
-> assembly), all math in float32 with gradients flowing to

  * vertex positions   (through edge functions and barycentrics)
  * vertex colors      (through interpolation)
  * texture coordinates and texels (through bilinear sampling)

Two renderers with one contract.  :func:`render` walks every tile's
primitives in submission order under autograd (the sequential oracle; a
Python loop over the M steps stands where the JAX package scans).
:func:`render_deferred` is the fast one: a visibility pass that records, per
pixel, the steps of the fragments that wrote it (:func:`visibility_slots`,
integers, no gradient), then a differentiable shade over those K fragments
(:func:`shade_slots`), O(pixels * K) work forward and backward.

Discrete-step policy: coverage is hard in the forward image; with
``soft_edge_temp > 0`` a sigmoid edge weight contributes silhouette
gradients.  The depth test picks a hard winner and gradients flow through
the winning fragment.

The hand-written kernels on this path: hard-mode visibility
(``diff/cuda_vis.py``, ``csrc/diff_visibility.cu``) and the row accumulation
behind every gather's backward (``diff/cuda_texgrad.py``,
``csrc/diff_accumulate.cu``).  :func:`gather_rows`, :func:`gather_tile_rows`
and :func:`sample_texture_bilinear_quad` are ``torch.autograd.Function``s
with the hand-written backward passes of the JAX package's ``custom_vjp``s:
no scatter-add with atomics runs in a backward pass, so the gradients of
``render_deferred`` are the same bits from run to run.

Parameters are a dict of float32 tensors (``pos`` (V, 4) clip space,
``color`` (V, 4), ``uv`` (V, 2), ``tex`` (TH, TW, 4)), ``static`` a dict of
int32 tensors from ``diff.binning.bin_static`` (``indices`` (P, 3),
``tile_pids`` (T, M) -1 padded, ``tile_xy`` (T, 2)); everything runs on the
device the parameters lie on.
"""
from __future__ import annotations

import dataclasses

import torch

from . import cuda_texgrad, cuda_vis
from .cuda_vis import barycentrics as _barycentrics
from .cuda_vis import tile_coords as _tile_coords

#: Prims advanced per sequential step of the K-slot visibility pass.
SLOT_CHUNK = 32
#: Tiles a pass of gather_tile_rows' backward: its one-hot holds
#: tiles * pixels * M floats.
ONEHOT_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class DiffRenderConfig:
    width: int
    height: int
    tile_logsize: int = 5
    near: float = 0.0
    far: float = 1.0
    depth_test: bool = True
    alpha_blend: bool = False      # src*a + dst*(1-a) over-compositing
    textured: bool = False
    modulate: bool = False         # multiply texture by vertex color
    soft_edge_temp: float = 0.0    # 0 = hard coverage
    background: tuple = (0.0, 0.0, 0.0, 1.0)


def clip_to_hdc(pos, cfg: DiffRenderConfig):
    """Differentiable clip -> homogeneous device coords."""
    half_w = 0.5 * cfg.width
    half_h = 0.5 * cfg.height
    x = pos[..., 0] * half_w + pos[..., 3] * half_w
    y = pos[..., 1] * half_h + pos[..., 3] * half_h
    w = pos[..., 3]
    return x, y, w


def screen_z(pos, cfg: DiffRenderConfig):
    half_d = 0.5 * (cfg.far - cfg.near)
    return pos[..., 2] / pos[..., 3] * half_d + (cfg.near + half_d)


def edge_matrix(p0, p1, p2):
    """Edge equations from HDC positions.  p*: tuples (x, y, w) of (P,)
    tensors.  Returns (P, 3, 3), sampled at pixel centers."""
    x0, y0, w0 = p0
    x1, y1, w1 = p1
    x2, y2, w2 = p2
    a0 = y1 * w2 - y2 * w1
    a1 = y2 * w0 - y0 * w2
    a2 = y0 * w1 - y1 * w0
    b0 = x2 * w1 - x1 * w2
    b1 = x0 * w2 - x2 * w0
    b2 = x1 * w0 - x0 * w1
    c0 = x1 * y2 - x2 * y1
    c1 = x2 * y0 - x0 * y2
    c2 = x0 * y1 - x1 * y0
    det = c0 * w0 + c1 * w1 + c2 * w2
    sign = torch.where(det < 0, -1.0, 1.0).to(det.dtype)
    edges = torch.stack([
        torch.stack([a0, b0, c0], -1),
        torch.stack([a1, b1, c1], -1),
        torch.stack([a2, b2, c2], -1),
    ], dim=1) * sign[:, None, None]
    # half-pixel offset: sample at pixel centers
    c_off = edges[:, :, 2] + 0.5 * (edges[:, :, 0] + edges[:, :, 1])
    return torch.cat([edges[:, :, :2], c_off[:, :, None]], dim=-1)


def sample_texture_bilinear(tex, u, v):
    """Differentiable bilinear sample.  tex: (TH, TW, 4) float; u, v in
    [0, 1] with repeat wrapping (``%`` with the sign of the divisor, as in
    Python and jnp).  Gradients flow to texels and to u / v."""
    th, tw = tex.shape[0], tex.shape[1]
    uu = torch.remainder(u, 1.0) * tw - 0.5
    vv = torch.remainder(v, 1.0) * th - 0.5
    x0 = torch.floor(uu)
    y0 = torch.floor(vv)
    fx = uu - x0
    fy = vv - y0
    x0i = torch.remainder(x0.to(torch.int64), tw)
    x1i = torch.remainder(x0i + 1, tw)
    y0i = torch.remainder(y0.to(torch.int64), th)
    y1i = torch.remainder(y0i + 1, th)
    t00 = tex[y0i, x0i]
    t01 = tex[y0i, x1i]
    t10 = tex[y1i, x0i]
    t11 = tex[y1i, x1i]
    fx = fx[..., None]
    fy = fy[..., None]
    # fma-form lerps (a + f*(b-a)), the order of the JAX sampler; the quad
    # sampler (_quad_lerp) uses the identical form
    cx0 = t00 + fx * (t01 - t00)
    cx1 = t10 + fx * (t11 - t10)
    return cx0 + fy * (cx1 - cx0)


def prim_setup(params, indices, cfg: DiffRenderConfig):
    """Differentiable geometry processing: vertices -> per-prim raster data
    (gradients flow through the edge coefficients back to the positions).
    Returns a dict of (P, ...) tensors."""
    pos = params["pos"]
    color = params["color"]
    P = indices.shape[0]
    # gather vertex ROWS once per corner (gather_rows routes the transpose
    # through the accumulation kernel instead of autograd's scatter), then
    # run the elementwise clip math on the gathered copies
    iall = torch.cat([indices[:, 0], indices[:, 1], indices[:, 2]])
    pos3 = gather_rows(pos, iall).reshape(3, P, 4)
    hdc0 = clip_to_hdc(pos3[0], cfg)
    hdc1 = clip_to_hdc(pos3[1], cfg)
    hdc2 = clip_to_hdc(pos3[2], cfg)
    edges = edge_matrix(hdc0, hdc1, hdc2)           # (P, 3, 3)
    color3 = gather_rows(color, iall).reshape(3, P, 4)
    setup = {
        "edges": edges,
        "z": torch.stack([screen_z(pos3[0], cfg), screen_z(pos3[1], cfg),
                          screen_z(pos3[2], cfg)], 1),          # (P, 3)
        "color": torch.stack([color3[0], color3[1], color3[2]], 1),
    }
    if cfg.textured:
        uv3 = gather_rows(params["uv"], iall).reshape(3, P, 2)
        setup["uv"] = torch.stack([uv3[0], uv3[1], uv3[2]], 1)  # (P, 3, 2)
        setup["tex"] = params["tex"]
    return setup


def _background(cfg: DiffRenderConfig, shape, device):
    bg = torch.tensor(cfg.background, dtype=torch.float32, device=device)
    return bg.expand(*shape, 4)


def render_tile_set(setup, tile_pids, origins, cfg: DiffRenderConfig):
    """Render a set of tiles: (T, M) pid lists + (T, 2) pixel origins ->
    (T, ts, ts, 4) RGBA tiles, every tile walking its M steps in order."""
    ts = 1 << cfg.tile_logsize
    edges = setup["edges"]
    z = setup["z"]
    color = setup["color"]
    T, M = tile_pids.shape
    dev = edges.device
    xs, ys = _tile_coords(ts, origins)
    fb_rgba = _background(cfg, (T, ts, ts), dev)
    fb_z = torch.full((T, ts, ts), float("inf"), dtype=torch.float32,
                      device=dev)

    for i in range(M):
        pid = tile_pids[:, i]
        valid = (pid >= 0)[:, None, None]
        p = pid.clamp(min=0).long()
        e = edges[p][:, None, None]                 # (T, 1, 1, 3, 3)
        e0 = e[..., 0, 0] * xs + e[..., 0, 1] * ys + e[..., 0, 2]
        e1 = e[..., 1, 0] * xs + e[..., 1, 1] * ys + e[..., 1, 2]
        e2 = e[..., 2, 0] * xs + e[..., 2, 1] * ys + e[..., 2, 2]
        inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & valid
        b0, b1, b2 = _barycentrics(e0, e1, e2)
        b0e, b1e, b2e = b0[..., None], b1[..., None], b2[..., None]

        zt = z[p][:, None, None]                    # (T, 1, 1, 3)
        zp = zt[..., 0] * b0 + zt[..., 1] * b1 + zt[..., 2] * b2
        c = color[p][:, None, None]                 # (T, 1, 1, 3, 4)
        col = c[..., 0, :] * b0e + c[..., 1, :] * b1e + c[..., 2, :] * b2e

        if cfg.textured:
            t = setup["uv"][p][:, None, None]       # (T, 1, 1, 3, 2)
            uvp = t[..., 0, :] * b0e + t[..., 1, :] * b1e + t[..., 2, :] * b2e
            texel = sample_texture_bilinear(setup["tex"], uvp[..., 0],
                                            uvp[..., 1])
            col = col * texel if cfg.modulate else texel

        if cfg.soft_edge_temp > 0:
            # differentiable silhouette weight; == hard coverage in the
            # limit temp -> 0.  Weight multiplies the src contribution.
            d = torch.minimum(torch.minimum(e0, e1), e2)
            w_soft = torch.sigmoid(d / cfg.soft_edge_temp)
            cov_w = torch.where(valid, w_soft, 0.0)
        else:
            cov_w = inside.to(torch.float32)

        if cfg.depth_test:
            write = inside & (zp < fb_z)
            fb_z = torch.where(write, zp.detach(), fb_z)
        else:
            write = inside

        if cfg.alpha_blend:
            a = col[..., 3:4] * cov_w[..., None]
            new_rgba = col * a + fb_rgba * (1.0 - a)
        else:
            new_rgba = (col * cov_w[..., None]
                        + fb_rgba * (1.0 - cov_w[..., None]))
        fb_rgba = torch.where(write[..., None], new_rgba, fb_rgba)
    return fb_rgba


def _is_hard(cfg: DiffRenderConfig) -> bool:
    return (not cfg.alpha_blend) and cfg.soft_edge_temp == 0


VIS_ENGINES = ("auto", "pallas", "xla")


def visibility_slots(setup, tile_pids, origins, cfg: DiffRenderConfig,
                     slots: int = 8, engine: str = "auto"):
    """K-slot visibility pass, not differentiable.

    For each pixel, records the step indices (into the tile's pid list) of
    the fragments that WROTE the pixel under render_tile_set's exact rules
    (hard coverage + depth test), in submission order.  Everything runs
    under ``torch.no_grad()`` on detached inputs and all outputs are
    integers, so the backward pass runs over shade_slots' O(pixels * K)
    work instead of the M sequential steps.

    Hard mode (no blend, no edge softening) needs only ONE slot: the final
    write is the depth winner and fully determines the pixel.  ``engine``
    picks who finds it: ``"auto"`` and ``"pallas"`` (the JAX package's name
    for its kernel, kept so a reader finds the counterpart) mean
    ``cuda_vis.visibility_hard``, which launches the CUDA kernel for CUDA
    tensors, or raises, and runs the plain chunk reduction for CPU tensors;
    ``"xla"`` always runs the plain chunk reduction
    (``cuda_vis.visibility_hard_reference``).  The other modes have no
    kernel: a prefix scan over chunks of SLOT_CHUNK prims in plain torch.

    Returns (slot_steps (T, ts, ts, K) int32 with -1 = empty,
             max_writes () int32: the observed per-pixel write count;
             exact iff max_writes <= K in non-hard modes).
    """
    if engine not in VIS_ENGINES:
        raise ValueError(f"engine {engine!r} not in {VIS_ENGINES}")
    with torch.no_grad():
        edges = setup["edges"].detach()
        z = setup["z"].detach()
        tile_pids = tile_pids.to(torch.int32).contiguous()
        origins = origins.to(torch.int32).contiguous()
        if _is_hard(cfg):
            find = (cuda_vis.visibility_hard_reference if engine == "xla"
                    else cuda_vis.visibility_hard)
            best_s = find(edges.contiguous(), z.contiguous(), tile_pids,
                          origins, cfg.tile_logsize, cfg.depth_test)
            return best_s[..., None], (best_s >= 0).to(torch.int32).max()
        return _visibility_k_slots(edges, z, tile_pids, origins, cfg, slots)


def _visibility_k_slots(edges, z, tile_pids, origins, cfg, K):
    """The sequential per-pixel rules as prefix scans along a chunk's prim
    axis: the running depth minimum is the exclusive cummin of the chunk's
    inside-z (a rejected fragment's z can never lower the running minimum,
    so the inside-prefix minimum equals the written-prefix minimum), the
    slot index the carried count plus the exclusive cumsum of the writes."""
    ts = 1 << cfg.tile_logsize
    T = tile_pids.shape[0]
    dev = tile_pids.device
    inf = float("inf")
    xs, ys = _tile_coords(ts, origins)
    fb_z = torch.full((T, ts, ts), inf, dtype=torch.float32, device=dev)
    slot_steps = torch.full((T, ts, ts, K), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((T, ts, ts), dtype=torch.int32, device=dev)
    for pc, sc in cuda_vis.padded_chunks(tile_pids, SLOT_CHUNK):
        e0, e1, e2, inside, p = cuda_vis.chunk_edges(edges, pc, xs, ys)
        sc = sc[None, :, None, None]
        if cfg.depth_test:
            zp = cuda_vis.chunk_z(z, p, e0, e1, e2)
            # NaN z never writes and never moves the running min
            zi = torch.where(inside & ~torch.isnan(zp), zp, inf)
            cm = torch.cummin(zi, dim=1).values
            runmin = torch.minimum(
                fb_z[:, None],
                torch.cat([torch.full_like(zi[:, :1], inf), cm[:, :-1]], 1))
            write = inside & (zp < runmin)
            fb_z = torch.minimum(fb_z, cm[:, -1])
        else:
            write = inside
        wi = write.to(torch.int32)
        slot = count[:, None] + torch.cumsum(wi, dim=1, dtype=torch.int32) - wi
        for k in range(K):
            cand = torch.where(write & (slot == k), sc, -1).amax(dim=1)
            slot_steps[..., k] = torch.where(cand >= 0, cand,
                                             slot_steps[..., k])
        count = count + wi.sum(dim=1, dtype=torch.int32)
    return slot_steps, count.max()


def _quad_texture(tex):
    """(TH, TW, 4) -> (TH, TW, 4, 4): the 2x2 bilinear footprint anchored
    at each texel, built from rolls (repeat wrap), so sampling needs ONE
    row gather instead of four and its backward ONE accumulation instead of
    four (rolls transpose to rolls)."""
    tx = torch.roll(tex, -1, dims=1)
    ty = torch.roll(tex, -1, dims=0)
    txy = torch.roll(tx, -1, dims=0)
    return torch.stack([tex, tx, ty, txy], dim=2)


def _quad_sample_prep(tex_quad, u, v):
    th, tw = tex_quad.shape[0], tex_quad.shape[1]
    uu = torch.remainder(u, 1.0) * tw - 0.5
    vv = torch.remainder(v, 1.0) * th - 0.5
    x0 = torch.floor(uu)
    y0 = torch.floor(vv)
    fx = uu - x0
    fy = vv - y0
    x0i = torch.remainder(x0.to(torch.int64), tw)
    y0i = torch.remainder(y0.to(torch.int64), th)
    idx = y0i * tw + x0i
    q = tex_quad.reshape(th * tw, 4, 4)[idx]
    return q, idx, fx, fy


def _quad_lerp(q, fx, fy):
    fxe = fx[..., None]
    fye = fy[..., None]
    # same fma-form as sample_texture_bilinear
    cx0 = q[..., 0, :] + fxe * (q[..., 1, :] - q[..., 0, :])
    cx1 = q[..., 2, :] + fxe * (q[..., 3, :] - q[..., 2, :])
    return cx0 + fye * (cx1 - cx0)


def _accumulate_rows(idx, val, num_rows: int):
    """The transpose of a row gather, Σ val[n] -> row idx[n], in the pinned
    order of ``cuda_texgrad``: the CUDA kernel for CUDA tensors, whatever
    the table's size, its plain version for CPU tensors."""
    return cuda_texgrad.accumulate_rows(idx, val, num_rows)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx.clamp(min=0).long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        R, C = ctx.table_shape
        return _accumulate_rows(idx.reshape(-1), g.reshape(-1, C), R), None


def gather_rows(table, idx):
    """table[(R, C)][idx] with the gather's transpose routed through
    _accumulate_rows instead of autograd's scatter-add with atomics.  A
    negative idx (list padding) reads row 0 and its gradient is dropped: it
    never reaches row 0's sum."""
    return _GatherRows.apply(table, idx)


class _GatherTileRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        T, M, C = table.shape
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        flat = idx.reshape(T, -1, 1).long().expand(-1, -1, C)
        return torch.gather(table, 1, flat).reshape(*idx.shape, C)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        T, M, C = ctx.table_shape
        gi = g.reshape(T, -1, C)
        flat = idx.reshape(T, -1)
        steps = torch.arange(M, dtype=flat.dtype, device=flat.device)
        group = max(1, ONEHOT_ELEMS // max(1, flat.shape[1] * M))
        d = torch.empty((T, M, C), dtype=g.dtype, device=g.device)
        for t0 in range(0, T, group):
            onehot = (flat[t0:t0 + group, :, None] == steps).to(g.dtype)
            d[t0:t0 + group] = torch.einsum("tnm,tnc->tmc", onehot,
                                            gi[t0:t0 + group])
        return d, None


def gather_tile_rows(table, idx):
    """Per-tile row gather: table (T, M, C)[t, idx[t, ...]] -> (T, ..., C).

    The transpose is the batched one-hot product over the SMALL per-tile
    prim axis M, a group of tiles at a time: two-level accumulation,
    pixels -> tile slots here, tile slots -> global prim rows via
    gather_rows.  It is not left to autograd's gather backward, whose
    scatter-add with atomics changes the gradients from run to run."""
    return _GatherTileRows.apply(table, idx)


class _SampleQuad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tex_quad, u, v):
        q, idx, fx, fy = _quad_sample_prep(tex_quad, u, v)
        ctx.save_for_backward(tex_quad, idx, fx, fy)
        return _quad_lerp(q, fx, fy)

    @staticmethod
    def backward(ctx, g):
        tex_quad, idx, fx, fy = ctx.saved_tensors
        th, tw = tex_quad.shape[0], tex_quad.shape[1]
        q = tex_quad.reshape(th * tw, 4, 4)[idx]    # regather (cheap)
        fxe = fx[..., None]
        fye = fy[..., None]
        t00, t01 = q[..., 0, :], q[..., 1, :]
        t10, t11 = q[..., 2, :], q[..., 3, :]
        # d/dfx, d/dfy of the lerp; chain through fx = frac((u%1)*tw - .5)
        # (d frac / d u = tw almost everywhere, floor and mod contribute
        # identity: the rule autograd applies to the plain sampler)
        dfx = torch.sum(g * ((t01 - t00) * (1 - fye) + (t11 - t10) * fye), -1)
        dfy = torch.sum(g * ((t10 - t00) * (1 - fxe) + (t11 - t01) * fxe), -1)
        du = dfx * tw
        dv = dfy * th
        w00 = (1 - fx) * (1 - fy)
        w01 = fx * (1 - fy)
        w10 = (1 - fx) * fy
        w11 = fx * fy
        V = torch.cat([w[..., None] * g for w in (w00, w01, w10, w11)], -1)
        dtq = _accumulate_rows(idx.reshape(-1), V.reshape(-1, 16), th * tw)
        return dtq.reshape(th, tw, 4, 4), du, dv


def sample_texture_bilinear_quad(tex_quad, u, v):
    """sample_texture_bilinear on a _quad_texture table: identical values
    (the t01 / t10 / t11 rows ARE the wrapped +1 neighbors), one gather.
    The hand-written backward routes the texel table's gradient through
    _accumulate_rows."""
    return _SampleQuad.apply(tex_quad, u, v)


def shade_slots(setup, tile_pids, slot_steps, origins,
                cfg: DiffRenderConfig):
    """Differentiable slot shading and composite, pass 2 of the deferred
    pipeline.  Per pixel, folds render_tile_set's exact composite rule over
    the K recorded fragments in submission order; all interpolation,
    texture sampling and (soft) coverage weights are recomputed here from
    the *differentiable* setup, so gradients flow to pos / color / uv /
    texels with O(pixels * K) work.

    Per-prim data is packed into ONE (P, C) record array so each pixel
    does a single row gather, and texels come from the rolled quad table
    (_quad_texture): one texel gather per bilinear sample.  The slot loop
    builds ``fb_rgba`` out of place: autograd keeps every slot's input.
    """
    ts = 1 << cfg.tile_logsize
    edges = setup["edges"]
    P = edges.shape[0]
    parts = [edges.reshape(P, 9), setup["color"].reshape(P, 12)]
    if cfg.textured:
        parts.append(setup["uv"].reshape(P, 6))
        tex_quad = _quad_texture(setup["tex"])
    rec = torch.cat(parts, dim=1)                   # (P, 21 | 27)

    T = tile_pids.shape[0]
    # two-level record access: global rows -> per-tile table (its transpose
    # is one small accumulation), then slot-index gather per pixel
    # (transpose = batched one-hot product over M)
    rec_tile = gather_rows(rec, tile_pids)                  # (T, M, C)
    xs, ys = _tile_coords(ts, origins)
    fb_rgba = _background(cfg, (T, ts, ts), edges.device)
    for k in range(slot_steps.shape[-1]):
        s = slot_steps[..., k]                      # (T, ts, ts)
        live = s >= 0
        r = gather_tile_rows(rec_tile, s.clamp(min=0))      # 1 row / pixel
        e = r[..., :9].reshape(*s.shape, 3, 3)
        e0 = e[..., 0, 0] * xs + e[..., 0, 1] * ys + e[..., 0, 2]
        e1 = e[..., 1, 0] * xs + e[..., 1, 1] * ys + e[..., 1, 2]
        e2 = e[..., 2, 0] * xs + e[..., 2, 1] * ys + e[..., 2, 2]
        b0, b1, b2 = _barycentrics(e0, e1, e2)
        b0e, b1e, b2e = b0[..., None], b1[..., None], b2[..., None]
        c = r[..., 9:21].reshape(*s.shape, 3, 4)
        col = c[..., 0, :] * b0e + c[..., 1, :] * b1e + c[..., 2, :] * b2e
        if cfg.textured:
            t = r[..., 21:27].reshape(*s.shape, 3, 2)
            uvp = t[..., 0, :] * b0e + t[..., 1, :] * b1e + t[..., 2, :] * b2e
            texel = sample_texture_bilinear_quad(tex_quad, uvp[..., 0],
                                                 uvp[..., 1])
            col = col * texel if cfg.modulate else texel
        if cfg.soft_edge_temp > 0:
            d = torch.minimum(torch.minimum(e0, e1), e2)
            cov_w = torch.where(live, torch.sigmoid(d / cfg.soft_edge_temp),
                                0.0)
        else:
            cov_w = live.to(torch.float32)
        if cfg.alpha_blend:
            a = col[..., 3:4] * cov_w[..., None]
            new_rgba = col * a + fb_rgba * (1.0 - a)
        else:
            new_rgba = (col * cov_w[..., None]
                        + fb_rgba * (1.0 - cov_w[..., None]))
        fb_rgba = torch.where(live[..., None], new_rgba, fb_rgba)
    return fb_rgba


def render_tile_set_deferred(setup, tile_pids, origins,
                             cfg: DiffRenderConfig, slots: int = 8,
                             engine: str = "auto"):
    """Deferred differentiable tile render: visibility + slot shading.

    Equal to render_tile_set when slots >= the scene's max per-pixel write
    count (hard mode: always, with one slot).  Returns
    (tiles (T, ts, ts, 4), max_writes () int32 for overflow monitoring).
    """
    slot_steps, maxw = visibility_slots(setup, tile_pids, origins, cfg,
                                        slots, engine=engine)
    return shade_slots(setup, tile_pids, slot_steps, origins, cfg), maxw


def _origins(static, cfg: DiffRenderConfig):
    return static["tile_xy"] * (1 << cfg.tile_logsize)


def render(params, static, cfg: DiffRenderConfig):
    """Differentiable forward render, the sequential oracle.

    params: dict of float32 tensors, all on one device:
        'pos'    (V, 4) clip-space positions
        'color'  (V, 4) vertex colors
        'uv'     (V, 2) texcoords
        'tex'    (TH, TW, 4) texture (when cfg.textured)
    static: dict of int32 tensors on the same device (diff.binning output):
        'indices'   (P, 3)  vertex indices
        'tile_pids' (T, M)  per-tile prim lists, -1 padded
        'tile_xy'   (T, 2)  tile coords
    Returns (Hp, Wp, 4) float32 RGBA image (padded to tile multiples).
    """
    setup = prim_setup(params, static["indices"], cfg)
    tiles = render_tile_set(setup, static["tile_pids"], _origins(static, cfg),
                            cfg)
    return _assemble(tiles, static["tile_xy"], cfg)


def _assemble(tiles, tile_xy, cfg: DiffRenderConfig):
    """Scatter (T, ts, ts, 4) tiles into the padded (Hp, Wp, 4) canvas;
    every tile position occurs once, so the indexed write has no order."""
    ts = 1 << cfg.tile_logsize
    Hp = -(-cfg.height // ts) * ts
    Wp = -(-cfg.width // ts) * ts
    gh, gw = Hp // ts, Wp // ts
    canvas = _background(cfg, (gh, gw, ts, ts), tiles.device)
    tile_xy = tile_xy.long()
    canvas = canvas.index_put((tile_xy[:, 1], tile_xy[:, 0]), tiles)
    return canvas.permute(0, 2, 1, 3, 4).reshape(Hp, Wp, 4)


def render_deferred(params, static, cfg: DiffRenderConfig, slots: int = 8,
                    engine: str = "auto"):
    """Fast differentiable render (same contract as render()).

    Two passes: the K-slot visibility (visibility_slots; ``engine`` as
    documented there) and the differentiable slot shading (shade_slots).
    Matches render() when ``slots`` covers the scene's per-pixel write
    count; hard mode (no alpha blend, no edge softening) always does with
    its single winner slot.  Returns (image, max_writes); max_writes is a
    0-d int32 tensor and is not read back here.
    """
    setup = prim_setup(params, static["indices"], cfg)
    tiles, maxw = render_tile_set_deferred(
        setup, static["tile_pids"], _origins(static, cfg), cfg, slots,
        engine=engine)
    return _assemble(tiles, static["tile_xy"], cfg), maxw


def measure_max_writes(params, static, cfg: DiffRenderConfig) -> int:
    """The scene's per-pixel write-count ceiling under cfg's exact write
    rules: ONE visibility pass (the K-slot ``count`` carry tallies every
    write whatever the slot capacity, so slots=1 suffices), read back to the
    host.

    K-slot shade work is proportional to K, so pick
    ``slots = next_pow2(measure_max_writes(...))`` instead of a static 8 and
    render_deferred stays exact at a fraction of the cost.  Re-check against
    render_deferred's max_writes output if the geometry moves far during
    optimization.
    """
    if _is_hard(cfg):
        return 1
    with torch.no_grad():
        setup = prim_setup(params, static["indices"], cfg)
        _, maxw = visibility_slots(setup, static["tile_pids"],
                                   _origins(static, cfg), cfg, slots=1)
    return max(int(maxw), 1)


def auto_slots(params, static, cfg: DiffRenderConfig,
               headroom: int = 0) -> int:
    """next-pow2 slot count for render_deferred (>= measured writes +
    headroom), minimum 2 in non-hard modes."""
    m = measure_max_writes(params, static, cfg) + headroom
    k = 2
    while k < m:
        k *= 2
    return k


def render_cropped(params, static, cfg: DiffRenderConfig):
    return render(params, static, cfg)[: cfg.height, : cfg.width]
