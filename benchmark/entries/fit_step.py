"""Iteration entry of the training configurations: one step of the port's
fitting loop, ``skybox_rt_tpu_torch.diff.optim.FitLoop.step``, the object
that ``optim.fit`` runs each step through.

The configuration file gives the mesh, the texture, the render settings,
the bins' margin, the start's noise and the optimizer; the traffic file the
image size, the mode and the steps of one fit (``fit_steps``): every
``fit_steps`` steps the loop resets to the start, as a new asset's fit
would.  Set-up bins the tiles once from the start's positions, renders the
target from the true parameters with the plain reference in float64 (the
program and the check get the same target, and a fault of the program's
forward pass cannot move it), and builds the loop over the start's
parameters.

A step's output holds one flat copy of the parameters it started from and
of Adam's moments before it (``state``; ``adam_steps`` the optimizer's step
counts), the parameters after it (``after``), its image, loss and four
gradients, and whether the loop's finite check took it.  The check runs the
plain reference (benchmark/reference/diff_reference.py) from each kept
output's starting parameters and the same target, and holds the update to
one float64 Adam step (:func:`adam_step`) of the gradients it used.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import compare, scenes
from ..reference import diff_reference

PARAMS = ("pos", "color", "uv", "tex")
#: a gradient row is off where its largest entry differs from the
#: reference's by more than this share of the reference gradient's largest
#: magnitude (one step of an 8-bit channel, as compare.PX_TOL for a pixel),
#: plus PROBE_SLACK times what the rounding probe moves the reference's row
GRAD_TOL = 1.0 / 256
#: pixels by which the rounding probe moves every sample point, along each
#: diagonal both ways.  Float32 rounding moves a triangle's edge in a
#: 1024x1024 frame by about 0.005 pixels and a texel coordinate by the
#: like; a pixel that close to an edge or to a texel boundary may go to the
#: other triangle or texel cell, where the hard coverage and the bilinear
#: lookup are not differentiable.  At the silhouette, where the sphere's
#: triangles stand edge-on, one such pixel moves a vertex's gradient by up
#: to ten times the gradient's largest value
PROBE_PX = 1.0 / 64
PROBE_SLACK = 2.0


def make_inputs(config, seed):
    """The fit's data, numpy float32 on the host: ``faces`` (F, 3) int32 and
    the ``true`` and ``start`` parameter dicts.  The seed draws the true
    colours, the checkerboard's two colours and the start; the mesh and the
    texture coordinates (the vertices' x and y, halved and shifted into
    [0, 1]) are the configuration's."""
    ico = config["icosphere"]
    verts, faces = scenes.icosphere(subdiv=ico["subdiv"], radius=ico["radius"])
    V = verts.shape[0]
    pos = np.concatenate([verts, np.ones((V, 1), np.float32)], 1)
    pos[:, 2] = pos[:, 2] * np.float32(ico["z_scale"]) \
        + np.float32(ico["z_offset"])
    # the texture projected along z onto the mesh, as a decal
    uv = (pos[:, :2] * np.float32(0.5) + np.float32(0.5)).astype(np.float32)
    lo, hi = config["colour_range"]
    tex = config["texture"]
    rng = np.random.default_rng([seed, 2])
    true = {"pos": pos.astype(np.float32),
            "color": rng.uniform(lo, hi, (V, 4)).astype(np.float32),
            "uv": uv,
            "tex": scenes.checkerboard_texture(
                tex["size"], tex["tiles"], rng.uniform(0.15, 1.0, (2, 3)))}
    noise = config["start_noise"]
    start_pos = true["pos"].copy()
    start_pos[:, :2] += rng.normal(0.0, noise["pos_xy_sigma"], (V, 2))
    start = {"pos": start_pos.astype(np.float32),
             "color": rng.uniform(lo, hi, (V, 4)).astype(np.float32),
             "uv": (uv + rng.normal(0.0, noise["uv_sigma"], (V, 2))).astype(
                 np.float32),
             "tex": np.full_like(true["tex"], tex["start_value"])}
    return {"faces": faces.astype(np.int32), "true": true, "start": start}


def optimizer_groups(config):
    """The callable FitLoop builds its optimizer with: Adam over the list of
    parameters in PARAMS order, ``pos`` at its own rate."""
    opt = config["optimizer"]

    def make(ps):
        return torch.optim.Adam([{"params": ps[:1], "lr": opt["pos_lr"]},
                                 {"params": ps[1:], "lr": opt["lr"]}],
                                betas=tuple(opt["betas"]), eps=opt["eps"])
    return make


def learning_rate(config, name: str) -> float:
    opt = config["optimizer"]
    return opt["pos_lr"] if name == "pos" else opt["lr"]


def adam_step(p, g, m, v, t: int, lr: float, betas, eps: float):
    """``p`` after one step of Adam (torch.optim.Adam's update: no weight
    decay, no amsgrad) from moments ``m``, ``v`` after ``t`` steps (None and
    0 for a fresh optimizer), in the dtype of ``p``."""
    b1, b2 = betas
    if m is None:
        m, v = torch.zeros_like(p), torch.zeros_like(p)
    t += 1
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    denom = v.sqrt() / math.sqrt(1 - b2 ** t) + eps
    return p - (lr / (1 - b1 ** t)) * m / denom


def unpack(out, shapes: dict) -> tuple:
    """(start, moments, after) of a step's output: the parameters it started
    from, Adam's (m, v) before it by name (None where the optimizer held no
    state) and the parameters after it, as views of the output's flat
    copies.  ``shapes``: the parameters' shapes by name, in PARAMS order."""
    sizes = [math.prod(shapes[k]) for k in PARAMS]
    have = [k for k, t in zip(PARAMS, out["adam_steps"]) if t is not None]
    parts = out["state"].split(
        sizes + [math.prod(shapes[k]) for k in have for _ in (0, 1)])
    start = {k: t.view(shapes[k]) for k, t in zip(PARAMS, parts)}
    moments = dict.fromkeys(PARAMS)
    for i, k in enumerate(have):
        moments[k] = tuple(parts[len(PARAMS) + 2 * i + j].view(shapes[k])
                           for j in (0, 1))
    after = {k: t.view(shapes[k])
             for k, t in zip(PARAMS, out["after"].split(sizes))}
    return start, moments, after


def update_error(start, moments, steps, grads, after, config) -> float:
    """How far the step's update lies from one float64 Adam step
    (:func:`adam_step`, the configuration's rates, betas and eps) of the
    gradients it used from the moments it started from: the largest over
    the parameters of the norm of the change's error beyond half a float32
    step of the parameter (the rounding of the stored result) over the
    norm of the float64 change.  0 for a sound update; 1 where the state was
    left unchanged; inf where a value is not finite.

    The gradients are the program's, which fit_numbers holds to the
    reference's row by row: Adam divides each entry by its own running
    size, so an entry that rounding decides, or a tiny entry whose sign
    rounding flips, would move by a whole step, and the reference's
    gradients would read that rounding rather than the update."""
    opt = config["optimizer"]
    worst = 0.0
    for k, t in zip(PARAMS, steps):
        p0 = start[k].to(torch.float64)
        m, v = moments[k] if moments[k] is not None else (None, None)
        want = adam_step(
            p0, grads[k].to(device=p0.device, dtype=torch.float64),
            None if m is None else m.to(torch.float64),
            None if v is None else v.to(torch.float64), int(t or 0),
            learning_rate(config, k), tuple(opt["betas"]), opt["eps"])
        a = after[k].to(device=p0.device, dtype=torch.float32)
        half_ulp = (torch.nextafter(a.abs(), torch.full_like(a, math.inf))
                    - a.abs()).to(torch.float64) / 2
        change = want - p0
        excess = ((a.to(torch.float64) - p0 - change).abs()
                  - half_ulp).clamp(min=0)
        excess = torch.nan_to_num(excess, nan=math.inf)
        num, den = float(excess.norm()), float(change.norm())
        if not math.isfinite(den):
            return math.inf
        worst = max(worst, 0.0 if num == 0 else
                    (num / den if den > 0 else math.inf))
    return worst


def screen_px(pos, width, height):
    """(V, 2) float64 screen pixels of clip positions."""
    p = torch.as_tensor(pos).detach().to(torch.float64).cpu()
    w = p[:, 3:4]
    return (p[:, :2] / w * 0.5 + 0.5) * torch.tensor([width, height],
                                                     dtype=torch.float64)


class Cell:
    def __init__(self, config, traffic, seed, device):
        # first, so that a program without the loop object fails at once
        from skybox_rt_tpu_torch.diff.optim import FitLoop

        from skybox_rt_tpu_torch.diff import binning, pipeline

        if traffic["mode"] != "hard":
            raise ValueError(f"mode {traffic['mode']!r}: the entry runs the "
                             "hard mode alone")
        self.config, self.traffic, self.device = config, traffic, device
        self.inputs = make_inputs(config, seed)
        W, H = traffic["width"], traffic["height"]
        r = config["render"]
        t0 = time.perf_counter()
        static = binning.bin_static(
            self.inputs["start"]["pos"], self.inputs["faces"], W, H,
            tile_logsize=r["tile_logsize"],
            inflate_px=config["bins"]["inflate_px"])
        self.static = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32))
                       .to(device) for k, v in static.items()}
        cfg = pipeline.DiffRenderConfig(
            width=W, height=H, tile_logsize=r["tile_logsize"],
            near=r["near"], far=r["far"], depth_test=r["depth_test"],
            textured=r["textured"], modulate=r["modulate"],
            background=tuple(r["background"]))

        with torch.no_grad():
            self.target = diff_reference.render(
                {k: torch.from_numpy(v).to(device, diff_reference.F64)
                 for k, v in self.inputs["true"].items()},
                torch.from_numpy(self.inputs["faces"]).to(device, torch.int64),
                W, H, near=r["near"], far=r["far"],
                background=tuple(r["background"])).to(torch.float32)
        self.start = {k: torch.from_numpy(self.inputs["start"][k]).to(device)
                      for k in PARAMS}
        self.shapes = {k: tuple(v.shape) for k, v in self.start.items()}
        params = {k: v.clone().requires_grad_(True)
                  for k, v in self.start.items()}
        slots = pipeline.auto_slots(params, self.static, cfg)
        self.image = None

        def loss_fn(p, static, target):
            img = pipeline.render_deferred(p, static, cfg, slots=slots)[0]
            img = img[:H, :W]
            self.image = img.detach()
            return torch.mean((img - target) ** 2)

        self.loop = FitLoop(loss_fn, params, optimizer_groups(config))
        self.steps = 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        #: host seconds of binning, the reference's render of the target and
        #: the loop's construction, ending in a synchronize
        self.prepare_s = time.perf_counter() - t0
        #: what the per-layer readers may use besides the trace
        self.info = kernel_work(static, self.inputs, cfg)

    def step(self):
        if self.steps and self.steps % self.traffic["fit_steps"] == 0:
            self.loop.reset(self.start)
        self.steps += 1
        params = [p.detach() for p in self.loop.params.values()]
        states = [self.loop.optimizer.state.get(p) for p in
                  self.loop.params.values()]
        # one copy of the parameters and the moments: two launches a step
        state = torch.cat([t.reshape(-1) for t in params] + [
            s[k].reshape(-1) for s in states if s for k in
            ("exp_avg", "exp_avg_sq")])
        # Adam keeps its step count on the host
        steps = tuple(float(s["step"]) if s else None for s in states)
        loss, grads = self.loop.step(self.static, self.target)
        return {"state": state, "adam_steps": steps,
                "after": torch.cat([t.reshape(-1) for t in params]),
                "image": self.image, "loss": loss, "grads": grads,
                "ok": self.loop.loss is not None}

    def release(self):
        self.loop = self.static = self.image = None

    def check(self, outputs):
        """The worst of fit_numbers over ``outputs``, each against the
        reference from its own starting parameters."""
        return compare.worst([self.numbers(o) for o in outputs])

    def numbers(self, out):
        W, H = self.traffic["width"], self.traffic["height"]
        start = unpack(out, self.shapes)[0]
        moved = (screen_px(start["pos"], W, H)
                 - screen_px(self.inputs["start"]["pos"], W, H)).abs().max()
        if not out["ok"] or not float(moved) <= \
                self.config["bins"]["inflate_px"]:
            return {"bad_px_pct": 100.0, "mean_abs_err": math.inf}
        args = (self.config, self.traffic, self.inputs["faces"], start,
                self.target)
        want = reference(*args)
        return fit_numbers(out, want, probe_moves(*args, want), self.target,
                           self.config, self.shapes)


def reference(config, traffic, faces, params, target,
              dtype=diff_reference.F64, **kw):
    """The plain reference's step from ``params`` in ``dtype``
    (diff_reference.fit_step; ``kw``: ``offset``)."""
    r = config["render"]
    return diff_reference.fit_step(
        params, faces, target, traffic["width"], traffic["height"], dtype,
        near=r["near"], far=r["far"], background=tuple(r["background"]),
        **kw)


def probe_moves(config, traffic, faces, params, target, want) -> dict:
    """For each gradient, how far the rounding probe moves each row of the
    float64 reference (``want``): the change of the row's largest entry,
    the largest over four probes that move every pixel's sample point by
    PROBE_PX along a diagonal."""
    moves = {}
    for dx, dy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        probe = reference(config, traffic, faces, params, target,
                          offset=(dx * PROBE_PX, dy * PROBE_PX))
        for k in PARAMS:
            w = want["grad_" + k]
            moved = (probe["grad_" + k] - w).abs().reshape(
                -1, w.shape[-1]).amax(1)
            moves[k] = torch.maximum(moves[k], moved) if k in moves \
                else moved
    return moves


def fit_numbers(out, want, moves, target, config, shapes) -> dict:
    """``bad_px_pct``: the largest of the image's share of pixels off by more
    than compare.PX_TOL and each gradient's share of rows off by more than
    GRAD_TOL of the reference gradient's largest magnitude plus PROBE_SLACK
    times the row's probe move (``moves``, probe_moves), in %.
    ``mean_abs_err``: the largest of the image's mean absolute error, the
    loss's relative difference from the mean square error of the step's own
    image against ``target``, in float64, and the update's error
    (update_error; ``shapes`` unpack the output).  A value that is not
    finite is off.

    The gradients are judged by their rows alone: a row that rounding
    decides (a pixel given to a triangle a twentieth of a pixel thick) is
    off by up to ten times the largest magnitude, which would move a mean
    over the rows by 1e-3.  The loss is held to the image it was computed
    from, and the image to the reference: the reference's loss differs from
    the program's by what the few pixels that rounding gives to another
    triangle add, a relative 4e-4 late in a fit, where the loss is small."""
    img = compare.image_numbers(out["image"], want["image"])
    bad = [img["bad_px_pct"]]
    for k in PARAMS:
        w = want["grad_" + k].to(torch.float64)
        g = out["grads"].get(k)
        if g is None or g.shape != w.shape:
            return {"bad_px_pct": 100.0, "mean_abs_err": math.inf}
        g = g.to(device=w.device, dtype=torch.float64)
        allowed = GRAD_TOL * float(w.abs().max()) \
            + PROBE_SLACK * moves[k].to(w)
        diff = torch.nan_to_num((g - w).abs(), nan=math.inf).reshape(
            -1, w.shape[-1]).amax(1)
        bad.append(float((diff > allowed).double().mean()) * 100.0)
    img64 = out["image"].to(torch.float64)
    own = float(((img64 - target.to(img64)) ** 2).mean())
    loss = float(out["loss"])
    loss_err = abs(loss - own) / own if math.isfinite(loss) and own > 0 \
        else math.inf
    start, moments, after = unpack(out, shapes)
    update_err = update_error(start, moments, out["adam_steps"],
                              out["grads"], after, config)
    return {"bad_px_pct": max(bad),
            "mean_abs_err": max(img["mean_abs_err"], loss_err, update_err)}


def kernel_work(static, inputs, cfg) -> dict:
    """The shapes a step's hand-written kernels work on, from the host's
    bins (metrics/fit_kernels_roofline_pct.py turns them into bytes):
    ``visibility`` (live tile-list entries, pixels of the binned tiles),
    ``accumulate``, one (values, rows, columns) a call of the hard-mode
    step: texels, per-prim records, then vertex pos, color and uv, and
    ``tile_entries`` (live tile-list entries, every entry of the padded
    lists, which kernel #4 walks; metrics/fit_bin_use_pct.py)."""
    pids = static["tile_pids"]
    T, M = pids.shape
    px = T << (2 * cfg.tile_logsize)
    P = inputs["faces"].shape[0]
    V = inputs["start"]["pos"].shape[0]
    th, tw = inputs["start"]["tex"].shape[:2]
    return {"visibility": [int((pids >= 0).sum()), px],
            "accumulate": [[px, th * tw, 16], [T * M, P, 27 if cfg.textured
                                                   else 21],
                           [3 * P, V, 4], [3 * P, V, 4], [3 * P, V, 2]],
            "tile_entries": [int((pids >= 0).sum()), T * M]}


def setup(config, traffic, seed, device):
    return Cell(config, traffic, seed, device)
