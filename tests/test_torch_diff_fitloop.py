"""``diff.optim.FitLoop``, the body of ``fit``'s loop, and the spans of a
fit step (CPU).

``fit`` runs through the loop object and gives, bit for bit, the losses,
parameters and rejected steps of the loop it replaced (kept here as
``fit_before``), on the one-triangle scene of tests/test_torch_diff_optim.py
and the training workload's small icosphere, roll-back included.  A traced
step nests its stages as the span readers expect: ``optim_step`` (a frame)
over ``diff.prim_setup``, ``diff.visibility``, ``diff.shade``,
``diff.backward`` (which holds the row accumulations' ``diff.accumulate``)
and ``diff.optim``, which holds ``diff.sync`` and, on a rejected step,
``diff.reset``.  Without a rejection, a step of the loop is a step of
``make_step``.
"""
import math

import pytest
import torch

from skybox_rt_tpu_torch.diff import binning, check, optim, pipeline
from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.utils import tracing

torch.set_num_threads(1)


def fit_before(loss_fn, params, *args, steps=100, lr=1e-2, optimizer=None):
    """``fit``'s loop as it stood before FitLoop, without checkpoints."""
    make_optimizer = optimizer or (lambda ps: torch.optim.Adam(ps, lr=lr))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}

    def scaled_optimizer(scale):
        opt = make_optimizer(list(params.values()))
        for group in opt.param_groups:
            group["lr"] *= scale
        return opt

    step = optim.make_step(loss_fn, params, scaled_optimizer(1.0))
    losses, bad_steps, lr_scale = [], 0, 1.0
    good = {k: p.detach().clone() for k, p in params.items()}
    for _ in range(steps):
        loss, grads = step(*args)
        loss_val = float(loss)
        if not math.isfinite(loss_val) or not optim._all_finite(
                grads.values()):
            bad_steps += 1
            lr_scale *= 0.5
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(good[k])
            step = optim.make_step(loss_fn, params,
                                   scaled_optimizer(lr_scale))
            continue
        with torch.no_grad():
            for k, p in params.items():
                good[k].copy_(p)
        losses.append(loss_val)
    return params, losses, bad_steps


def triangle():
    full, indices = scenes.triangle()
    cfg = pipeline.DiffRenderConfig(width=16, height=16, tile_logsize=3)
    static = {k: torch.from_numpy(v) for k, v in binning.bin_static(
        full["pos"], indices, 16, 16, tile_logsize=3).items()}
    full = {k: torch.from_numpy(v) for k, v in full.items()}
    with torch.no_grad():
        target = pipeline.render_cropped(
            {**full, "color": full["color"] * 0.5}, static, cfg)

    def loss_fn(p, static, target):
        img = pipeline.render_cropped({**full, **p}, static, cfg)
        return torch.mean((img - target) ** 2)

    return {"color": full["color"]}, (static, target), loss_fn, cfg


def icosphere():
    params, static, cfg = check.train_scene(32, subdiv=2, tile_logsize=3)
    params, static = check.to_device(params, static, "cpu",
                                     requires_grad=False)
    with torch.no_grad():
        target = pipeline.render_deferred(
            {**params, "color": params["color"] * 0.7}, static, cfg)[0]

    def loss_fn(p, static, target):
        img = pipeline.render_deferred(p, static, cfg)[0]
        return torch.mean((img - target) ** 2)

    return params, (static, target), loss_fn, cfg


def flaky(loss_fn, bad_calls):
    """loss_fn whose calls number ``bad_calls`` (from 1) give inf."""
    calls = {"n": 0}

    def f(p, *args):
        calls["n"] += 1
        loss = loss_fn(p, *args)
        return loss * float("inf") if calls["n"] in bad_calls else loss
    return f


def sgd(ps):
    return torch.optim.SGD(ps, lr=0.5)


def adam_groups(ps):
    return torch.optim.Adam([{"params": ps[:1], "lr": 1e-4},
                             {"params": ps[1:], "lr": 1e-2}])


@pytest.mark.parametrize("case", [
    ("triangle", "adam", ()), ("triangle", "sgd", (3,)),
    ("triangle", "adam", (1, 2, 5)), ("icosphere", "groups", ()),
    ("icosphere", "groups", (2,))])
def test_fit_is_the_loop_before_bit_for_bit(case):
    scene, opt, bad = case
    params, args, loss_fn, _ = (triangle if scene == "triangle"
                             else icosphere)()
    optimizer = {"adam": None, "sgd": sgd, "groups": adam_groups}[opt]
    steps = 6 if scene == "triangle" else 3

    def fresh():
        return flaky(loss_fn, bad) if bad else loss_fn

    want_params, want_losses, want_bad = fit_before(
        fresh(), params, *args, steps=steps, optimizer=optimizer)
    got = optim.fit(fresh(), params, *args, steps=steps, optimizer=optimizer)
    assert got.bad_steps == want_bad == len(bad)
    assert got.losses == want_losses
    for k in params:
        assert torch.equal(got.params[k].detach(), want_params[k].detach())


def traced_steps(loop, args, n):
    tracing.reset_stages()
    with tracing.enable():
        for _ in range(n):
            loop.step(*args)
    return tracing.spans()


def children(spans, parent):
    return [s["name"] for s in spans if s["parent"] == parent["id"]]


def test_a_step_nests_its_stages():
    params, args, loss_fn, cfg = icosphere()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    spans = traced_steps(optim.FitLoop(loss_fn, leaves), args, 2)
    steps = [s for s in spans if s["name"] == "optim_step"]
    assert [s["frame"] for s in steps] == [0, 1]
    for step in steps:
        assert step["parent"] is None
        assert children(spans, step) == [
            "diff.prim_setup", "diff.visibility", "diff.shade",
            "diff.backward", "diff.optim"]
        opt = next(s for s in spans if s["name"] == "diff.optim"
                   and s["parent"] == step["id"])
        assert children(spans, opt) == ["diff.sync"]
        # the backward's five row accumulations: texels, records, and the
        # pos, color and uv rows
        back = next(s for s in spans if s["name"] == "diff.backward"
                    and s["parent"] == step["id"])
        assert children(spans, back) == ["diff.accumulate"] * 5
        assert all(s["frame"] == step["frame"] for s in spans
                   if s["start_ns"] >= step["start_ns"]
                   and s["end_ns"] <= step["end_ns"])
    assert len(spans) == 2 * 12


def test_a_rejected_step_resets_inside_the_optimizer_stage():
    params, args, loss_fn, cfg = icosphere()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loop = optim.FitLoop(flaky(loss_fn, (1,)), leaves)
    spans = traced_steps(loop, args, 2)
    opts = [s for s in spans if s["name"] == "diff.optim"]
    assert children(spans, opts[0]) == ["diff.sync", "diff.reset"]
    assert children(spans, opts[1]) == ["diff.sync"]
    assert loop.bad_steps == 1 and loop.lr_scale == 0.5
    assert loop.optimizer.param_groups[0]["lr"] == 0.5e-2
    assert loop.loss is not None


def test_a_step_is_make_steps_update():
    params, args, loss_fn, cfg = icosphere()
    mine = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    theirs = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loop = optim.FitLoop(loss_fn, mine, adam_groups)
    step = optim.make_step(loss_fn, theirs,
                           adam_groups(list(theirs.values())))
    for _ in range(3):
        got, got_grads = loop.step(*args)
        want, want_grads = step(*args)
        assert torch.equal(got, want)
        assert set(got_grads) == set(want_grads) == set(params)
        for k in params:
            assert torch.equal(got_grads[k], want_grads[k])
            assert torch.equal(mine[k].detach(), theirs[k].detach())


def test_reset_restores_the_start_and_a_fresh_optimizer():
    params, args, loss_fn, cfg = icosphere()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loop = optim.FitLoop(loss_fn, leaves, adam_groups)
    first, _ = loop.step(*args)
    loop.step(*args)
    old = loop.optimizer
    loop.reset(params)
    assert loop.optimizer is not old and not loop.optimizer.state
    for k in params:
        assert torch.equal(leaves[k].detach(), params[k])
        assert torch.equal(loop.good[k], params[k])
    again, grads = loop.step(*args)
    assert torch.equal(again, first)
    assert set(grads) == set(params) and loop.bad_steps == 0
