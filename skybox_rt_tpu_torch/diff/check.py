"""The training workload of the differentiable pipeline and the checks its
results are held to.  The CPU tests, chip_smoke.py and
scripts/torch_diff_profile.py share them, so that what is asked of the card
is what the tests ask of the CPU.

The workload is the JAX package's ``bench.py`` stage ``_fwd_bwd``: a
subdiv-4 icosphere (2,562 vertices, 5,120 triangles) with seeded vertex
colors and texture coordinates under a 64-texel checkerboard, rendered with
the depth test, textured and modulated, 32x32 tiles; the loss is the sum of
squares of the image (the target is zero).  Everything is numpy on the host
until :func:`to_device`.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.device import resolve_device
from ..geom.cgltrace import DATA_DIR
from ..models import scenes
from . import binning, cuda_vis, pipeline

GOLDEN = os.path.join(DATA_DIR, "diff_step_256.npz")
GOLDEN_SIZE = 256
MODES = ("hard", "alpha", "soft")
PARAM_NAMES = ("pos", "color", "uv", "tex")

# what a result may differ by from the JAX package's on the same inputs (XLA's
# CPU code contracts multiply-adds, the port does not)
IMAGE_ATOL = 1e-4           # every value
IMAGE_TIGHT = 2e-5          # ... and at least IMAGE_TIGHT_SHARE within this
IMAGE_TIGHT_SHARE = 0.999
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4            # max |diff| <= GRAD_RTOL * max |gradient|
WINNER_SHARE = 1e-3         # pixels whose winner may differ, all of them ties


def train_scene(size: int, mode: str = "hard", subdiv: int = 4,
                tile_logsize: int = 5, tex_size: int = 64, tex_tiles: int = 8):
    """(params, static, cfg): numpy parameter dict, numpy binning dict and
    the config of one ``mode`` of the training workload at size x size."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    verts, faces = scenes.icosphere(subdiv=subdiv, radius=0.85)
    V = verts.shape[0]
    pos = np.concatenate([verts.astype(np.float32),
                          np.ones((V, 1), np.float32)], axis=1)
    pos[:, 2] = pos[:, 2] * 0.4 + 0.5
    rng = np.random.default_rng(0)
    params = {
        "pos": pos,
        "color": rng.uniform(0.2, 1.0, (V, 4)).astype(np.float32),
        "uv": rng.uniform(0.0, 1.0, (V, 2)).astype(np.float32),
        "tex": scenes.checkerboard_texture(tex_size, tex_tiles),
    }
    cfg = pipeline.DiffRenderConfig(
        width=size, height=size, tile_logsize=tile_logsize, depth_test=True,
        textured=True, modulate=True, alpha_blend=(mode == "alpha"),
        soft_edge_temp=0.7 if mode == "soft" else 0.0)
    static = binning.bin_static(pos, faces.astype(np.int32), size, size,
                                tile_logsize=tile_logsize)
    return params, static, cfg


def random_triangles(n=40, seed=3, size=64, tile_logsize=4, depth_test=True,
                     duplicates=0, degenerate=False):
    """(params, static, cfg) of ``n`` random triangles, each at its own
    constant depth (untextured).  ``duplicates`` appends copies of the first
    triangles, coplanar with them, so that every pixel they cover is a depth
    tie between two steps; ``degenerate`` appends a triangle with a vertex at
    w = 1e-30 (its screen depth overflows), one with w = 0 (its depth is NaN)
    and one whose three corners coincide (zero area: its edge functions are
    zero everywhere)."""
    rng = np.random.default_rng(seed)
    V = n * 3
    pos = np.zeros((V, 4), np.float32)
    pos[:, :2] = rng.uniform(-1.0, 1.0, (V, 2)).astype(np.float32)
    pos[:, 2] = np.repeat(rng.uniform(-0.5, 0.5, n), 3).astype(np.float32)
    pos[:, 3] = 1.0
    color = rng.uniform(0.0, 1.0, (V, 4)).astype(np.float32)
    uv = rng.uniform(0.0, 1.0, (V, 2)).astype(np.float32)
    extra = [pos[:3 * duplicates]]
    if degenerate:
        tiny, zero, point = pos[:3].copy(), pos[3:6].copy(), pos[6:9].copy()
        tiny[0, 3] = 1e-30
        zero[1, 2:] = 0.0
        point[:] = point[0]
        extra += [tiny, zero, point]
    pos = np.concatenate([pos] + extra)
    more = pos.shape[0] - V
    color = np.concatenate([color, color[:more]])
    uv = np.concatenate([uv, uv[:more]])
    indices = np.arange(pos.shape[0], dtype=np.int32).reshape(-1, 3)
    cfg = pipeline.DiffRenderConfig(width=size, height=size,
                                    tile_logsize=tile_logsize,
                                    depth_test=depth_test)
    with np.errstate(divide="ignore", invalid="ignore"):
        static = binning.bin_static(pos, indices, size, size,
                                    tile_logsize=tile_logsize)
    return {"pos": pos, "color": color, "uv": uv}, static, cfg


def to_device(params, static, device=None, requires_grad=True):
    """The numpy dicts of :func:`train_scene` as tensors on ``device`` (None:
    the CUDA card); the parameters are leaves that require grad."""
    dev = resolve_device(device)
    params = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
              .to(dev).requires_grad_(requires_grad)
              for k, v in params.items()}
    static = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)
              for k, v in static.items()}
    return params, static


def loss_of(img, cfg):
    """The workload's loss: sum of squares of the cropped image."""
    return torch.sum(img[:cfg.height, :cfg.width] ** 2)


def step(params, static, cfg, slots: int = 8, engine: str = "auto"):
    """One forward and backward of ``render_deferred``: (loss, image,
    max_writes) as tensors; the gradients land in ``params[k].grad``."""
    for p in params.values():
        p.grad = None
    img, maxw = pipeline.render_deferred(params, static, cfg, slots=slots,
                                         engine=engine)
    loss = loss_of(img, cfg)
    loss.backward()
    return loss.detach(), img.detach(), maxw


def winner_differences(edges, z, tile_pids, origins, tile_logsize, got, want,
                       z_rtol=1e-5, edge_atol=1e-4):
    """Hard-mode winner steps ``got`` against ``want`` (both (T, ts, ts)
    int32): (pixels that differ, those of them that are no tie).  A
    difference is a tie where the two candidates' depths agree to ``z_rtol``
    or where an edge function of either candidate is within ``edge_atol`` of
    zero at the pixel, so that last-bit rounding decides coverage."""
    got, want = got.to(torch.int64), want.to(torch.int64)
    t, y, x = torch.nonzero(got != want, as_tuple=True)
    if t.numel() == 0:
        return 0, 0
    xs, ys = cuda_vis.tile_coords(1 << tile_logsize, origins)
    px, py = xs[t, y, x], ys[t, y, x]
    near_edge = torch.zeros_like(t, dtype=torch.bool)
    depth = []
    for steps in (got[t, y, x], want[t, y, x]):
        live = steps >= 0
        pid = tile_pids.long()[t, steps.clamp(min=0)].clamp(min=0)
        e = edges.detach()[pid]
        ev = [e[:, k, 0] * px + e[:, k, 1] * py + e[:, k, 2] for k in range(3)]
        near_edge |= live & (torch.stack(ev).abs().amin(0) <= edge_atol)
        b0, b1, b2 = cuda_vis.barycentrics(*ev)
        zc = z.detach()[pid]
        zp = zc[:, 0] * b0 + zc[:, 1] * b1 + zc[:, 2] * b2
        depth.append(torch.where(live, zp, float("nan")))
    za, zb = depth
    z_tie = (za - zb).abs() <= z_rtol * torch.maximum(za.abs(), zb.abs())
    return int(t.numel()), int((~(near_edge | z_tie)).sum())


def compare_to_golden(what, got, golden, prefix=""):
    """Raises unless image, loss and the four gradients of ``got`` (a dict of
    numpy arrays: ``image``, ``loss``, ``grad_<name>``) are within the
    module's tolerances of ``golden[prefix + key]``; returns the figures."""
    want = golden[prefix + "image"]
    diff = np.abs(got["image"] - want)
    within = float((diff <= IMAGE_TIGHT).mean())
    if not (diff.max() <= IMAGE_ATOL and within >= IMAGE_TIGHT_SHARE):
        raise AssertionError(f"{what} image: max |diff| {diff.max()}, within "
                             f"{IMAGE_TIGHT}: {within}")
    out = {"image_max_abs_diff": float(diff.max()),
           "image_values_beyond_tight": int((diff > IMAGE_TIGHT).sum())}
    want_loss = float(golden[prefix + "loss"])
    rel = abs(float(got["loss"]) - want_loss) / abs(want_loss)
    if rel > LOSS_RTOL:
        raise AssertionError(f"{what} loss {got['loss']} != {want_loss}")
    out["loss"], out["loss_rel_diff"] = float(got["loss"]), rel
    for name in PARAM_NAMES:
        g, w = got["grad_" + name], golden[prefix + "grad_" + name]
        if not np.isfinite(g).all():
            raise AssertionError(f"{what} grad {name}: not finite")
        rel = float(np.abs(g - w).max() / np.abs(w).max())
        if rel > GRAD_RTOL:
            raise AssertionError(f"{what} grad {name}: max |diff| / max |g| "
                                 f"= {rel}")
        out[f"grad_{name}_rel_diff"] = rel
    return out
