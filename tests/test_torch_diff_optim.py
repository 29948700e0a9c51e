"""The inverse-rendering loop: the port's ``diff.optim.fit`` against the JAX
package's.

The behaviours of tests/test_optim.py on the same one-triangle scene
(convergence, the NaN guard's roll-back, checkpoint and resume), the halved
learning rate after a rejected step, and the first 20 Adam losses against the
JAX package's (optax.adam) at rtol 1e-4: ``torch.optim.Adam``'s defaults are
optax's, so the two curves are one curve.
"""
import logging
import os

import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch.diff import binning, optim, pipeline
from skybox_rt_tpu_torch.models import scenes

torch.set_num_threads(1)


def _setup():
    full, indices = scenes.triangle()
    cfg = pipeline.DiffRenderConfig(width=16, height=16, tile_logsize=3)
    static = binning.bin_static(full["pos"], indices, 16, 16, tile_logsize=3)
    full = {k: torch.from_numpy(v) for k, v in full.items()}
    static = {k: torch.from_numpy(v) for k, v in static.items()}
    with torch.no_grad():
        target = pipeline.render_cropped(
            {**full, "color": full["color"] * 0.5}, static, cfg)

    # optimize vertex colors (geometry fixed): the loop-machinery test
    params = {"color": full["color"]}

    def loss_fn(p, static, target):
        img = pipeline.render_cropped({**full, **p}, static, cfg)
        return torch.mean((img - target) ** 2)

    return params, static, target, loss_fn


def test_scenes_match_jax():
    from skybox_rt_tpu.models import scenes as jscenes
    for name in ("triangle", "quad"):
        got, gi = getattr(scenes, name)()
        want, wi = getattr(jscenes, name)()
        np.testing.assert_array_equal(gi, wi)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


def test_fit_converges():
    params, static, target, loss_fn = _setup()
    start = params["color"].clone()
    res = optim.fit(loss_fn, params, static, target, steps=60, lr=2e-2)
    assert res.losses[-1] < res.losses[0] * 0.25
    assert res.bad_steps == 0 and res.resumed_from == 0
    assert len(res.losses) == 60
    # the caller's tensors stay as they were; the result holds new leaves
    assert torch.equal(params["color"], start)
    assert res.params["color"].requires_grad and res.params["color"].grad is None


def test_first_adam_losses_match_jax():
    import jax.numpy as jnp

    from skybox_rt_tpu.diff import binning as jbin
    from skybox_rt_tpu.diff import optim as joptim
    from skybox_rt_tpu.diff import pipeline as jpipe
    from skybox_rt_tpu.models import scenes as jscenes

    full, indices = jscenes.triangle()
    full = {k: jnp.asarray(v) for k, v in full.items()}
    jcfg = jpipe.DiffRenderConfig(width=16, height=16, tile_logsize=3)
    jstatic = {k: jnp.asarray(v) for k, v in jbin.bin_static(
        np.asarray(full["pos"]), indices, 16, 16, tile_logsize=3).items()}
    jtarget = jpipe.render_cropped({**full, "color": full["color"] * 0.5},
                                   jstatic, jcfg)

    def jloss(p, static, target):
        img = jpipe.render_cropped({**full, **p}, static, jcfg)
        return jnp.mean((img - target) ** 2)

    want = joptim.fit(jloss, {"color": full["color"]}, jstatic, jtarget,
                      steps=20, lr=2e-2)
    params, static, target, loss_fn = _setup()
    np.testing.assert_allclose(target.numpy(), np.asarray(jtarget), atol=1e-6)
    got = optim.fit(loss_fn, params, static, target, steps=20, lr=2e-2)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    np.testing.assert_allclose(got.params["color"].detach().numpy(),
                               np.asarray(want.params["color"]), rtol=1e-4,
                               atol=1e-5)


def test_nan_guard_rolls_back():
    params, static, target, loss_fn = _setup()

    # clean run: no rollbacks
    res = optim.fit(loss_fn, params, static, target, steps=5, lr=1e-2)
    assert res.bad_steps == 0

    # fault injection: NaN loss every step -> every step rejected, params
    # stay finite and untouched
    def always_nan(p, static, target):
        return torch.sum(p["color"]) * float("nan")

    res2 = optim.fit(always_nan, params, static, target, steps=3, lr=1e-2)
    assert res2.bad_steps == 3 and res2.losses == []
    got = res2.params["color"].detach()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, params["color"])


def test_rejected_step_halves_the_learning_rate(caplog):
    """One bad step in the middle: the run goes on from the last good
    parameters with a fresh optimizer at half the learning rate (SGD, so the
    step sizes can be read off the parameters)."""
    params, static, target, loss_fn = _setup()
    calls = {"n": 0}

    def flaky(p, static, target):
        calls["n"] += 1
        loss = loss_fn(p, static, target)
        return loss * float("inf") if calls["n"] == 3 else loss

    seen = []

    def sgd(ps):
        seen.append(torch.optim.SGD(ps, lr=0.5))
        return seen[-1]

    with caplog.at_level(logging.INFO, logger=optim.__name__):
        res = optim.fit(flaky, params, static, target, steps=6, optimizer=sgd)
    assert res.bad_steps == 1 and len(res.losses) == 5
    assert [o.param_groups[0]["lr"] for o in seen] == [0.5, 0.25]
    assert all(b < a for a, b in zip(res.losses, res.losses[1:]))
    assert any("rolled back" in r.getMessage() for r in caplog.records)

    clean = optim.fit(loss_fn, params, static, target, steps=2,
                      optimizer=lambda ps: torch.optim.SGD(ps, lr=0.5))
    # the first two good steps are the clean run's: the bad one left no trace
    assert res.losses[:2] == clean.losses


def test_checkpoint_resume(tmp_path):
    params, static, target, loss_fn = _setup()
    ckdir = str(tmp_path / "ck")
    res1 = optim.fit(loss_fn, params, static, target, steps=20, lr=1e-2,
                     checkpoint_dir=ckdir, checkpoint_every=10)
    assert sorted(os.listdir(ckdir)) == ["10", "20"]
    assert os.path.exists(os.path.join(ckdir, "20", optim.STATE_FILE))
    # resume: a new fit with the same dir picks up at step 20 and does
    # nothing more (steps=20 already done)
    res2 = optim.fit(loss_fn, params, static, target, steps=20, lr=1e-2,
                     checkpoint_dir=ckdir, checkpoint_every=10)
    assert res2.resumed_from == 20 and res2.losses == []
    assert torch.equal(res2.params["color"].detach(),
                       res1.params["color"].detach())
    # and a longer fit continues from there
    res3 = optim.fit(loss_fn, params, static, target, steps=25, lr=1e-2,
                     checkpoint_dir=ckdir, checkpoint_every=10)
    assert res3.resumed_from == 20
    assert len(res3.losses) == 5
    assert res3.losses[0] < res1.losses[-1] * 1.01


def test_newest_three_checkpoints_are_kept(tmp_path):
    params, static, target, loss_fn = _setup()
    ckdir = str(tmp_path / "ck")
    optim.fit(loss_fn, params, static, target, steps=9, lr=1e-2,
              checkpoint_dir=ckdir, checkpoint_every=2)
    assert sorted(os.listdir(ckdir), key=int) == ["6", "8", "9"]
    state = torch.load(os.path.join(ckdir, "9", optim.STATE_FILE),
                       weights_only=True)
    assert state["step"] == 9 and set(state["params"]) == {"color"}


def test_make_step_updates_in_place():
    params, static, target, loss_fn = _setup()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    step = optim.make_step(loss_fn, leaves, torch.optim.SGD(
        list(leaves.values()), lr=1.0))
    before = leaves["color"].detach().clone()
    loss, grads = step(static, target)
    assert loss.dim() == 0 and not loss.requires_grad
    assert torch.equal(leaves["color"].detach(), before - grads["color"])
