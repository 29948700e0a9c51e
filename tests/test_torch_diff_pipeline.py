"""The differentiable pipeline as a whole: the port against the JAX package.

The same numpy-seeded parameters and binning go through the JAX package's
``diff.pipeline`` and the port's at 64x64: ``prim_setup``, the sequential
``render``, and ``render_deferred`` with its loss and all four gradients, in
the ``hard``, ``alpha`` and ``soft`` modes, on a few dozen random triangles
and on the subdiv-2 icosphere under a checkerboard.  XLA's CPU code contracts
multiply-adds and the port does not, so agreement is to a tolerance: set-up
rtol 1e-5 (atol 1e-4 of the largest edge coefficient), images atol 2e-5, loss
rtol 1e-5, each gradient max |diff| <= 1e-4 * max |gradient| (the positions'
gradients, through two divisions a pixel, come to 2e-6 of their maximum
here).  Inside the port the deferred renderer equals the sequential one bit
for bit, and the gradients stay finite with degenerate triangles in the
scene.
"""
import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch import interop
from skybox_rt_tpu_torch.diff import check, pipeline

torch.set_num_threads(1)

SIZE = 64


def _scene(kind, mode):
    if kind == "icosphere":
        return check.train_scene(SIZE, mode, subdiv=2, tile_logsize=4,
                                 tex_size=16, tex_tiles=4)
    params, static, cfg = check.random_triangles(
        n=30, seed=11, size=SIZE, degenerate=kind == "degenerate")
    import dataclasses
    cfg = dataclasses.replace(cfg, alpha_blend=mode == "alpha",
                              soft_edge_temp=0.7 if mode == "soft" else 0.0)
    return params, static, cfg


def _jax_side(params, static, cfg):
    import jax.numpy as jnp

    from skybox_rt_tpu.diff import pipeline as jpipe
    jcfg = jpipe.DiffRenderConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    assert interop.diff_config_from_reference(jcfg) == cfg
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = {k: jnp.asarray(v) for k, v in static.items()}
    return jpipe, jcfg, jp, js


def _port_side(jp, js, requires_grad=True):
    """The JAX dicts carried across with interop, on the CPU."""
    params = interop.diff_params_from_reference(jp, device="cpu")
    static = interop.diff_static_from_reference(js, device="cpu")
    for p in params.values():
        assert p.dtype == torch.float32 and p.device.type == "cpu"
        p.requires_grad_(requires_grad)
    for s in static.values():
        assert s.dtype == torch.int32
    return params, static


@pytest.mark.parametrize("kind", ["triangles", "icosphere"])
def test_prim_setup_matches_jax(kind):
    params, static, cfg = _scene(kind, "hard")
    jpipe, jcfg, jp, js = _jax_side(params, static, cfg)
    want = jpipe.prim_setup(jp, js["indices"], jcfg)
    tp, ts = _port_side(jp, js, requires_grad=False)
    got = pipeline.prim_setup(tp, ts["indices"], cfg)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("mode", check.MODES)
@pytest.mark.parametrize("kind", ["triangles", "icosphere"])
def test_render_matches_jax(kind, mode):
    params, static, cfg = _scene(kind, mode)
    jpipe, jcfg, jp, js = _jax_side(params, static, cfg)
    want = np.asarray(jpipe.render(jp, js, jcfg))
    tp, ts = _port_side(jp, js, requires_grad=False)
    got = pipeline.render(tp, ts, cfg)
    assert tuple(got.shape) == want.shape == (SIZE, SIZE, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    assert torch.equal(pipeline.render_cropped(tp, ts, cfg), got)


@pytest.mark.parametrize("mode", check.MODES)
@pytest.mark.parametrize("kind", ["triangles", "icosphere"])
def test_render_deferred_and_gradients_match_jax(kind, mode):
    import jax
    import jax.numpy as jnp

    params, static, cfg = _scene(kind, mode)
    jpipe, jcfg, jp, js = _jax_side(params, static, cfg)
    slots = 8 if mode == "hard" else jpipe.auto_slots(jp, js, jcfg)

    def jloss(p):
        img, maxw = jpipe.render_deferred(p, js, jcfg, slots=slots)
        return jnp.sum(img[:SIZE, :SIZE] ** 2), (img, maxw)

    (jl, (jimg, jmaxw)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)

    tp, ts = _port_side(jp, js)
    if mode != "hard":
        assert pipeline.auto_slots(tp, ts, cfg) == slots
        assert pipeline.measure_max_writes(tp, ts, cfg) == int(jmaxw)
    loss, img, maxw = check.step(tp, ts, cfg, slots=slots)
    assert maxw.dim() == 0 and int(maxw) == int(jmaxw) <= slots
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k, want in jgrads.items():
        want = np.asarray(want)
        if tp[k].grad is None:      # an unused leaf: JAX's gradient is zero
            assert not want.any(), k
            continue
        got = tp[k].grad.numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), k
    # inside the port: the deferred renderer is the sequential one
    with torch.no_grad():
        assert torch.equal(pipeline.render(tp, ts, cfg), img)


@pytest.mark.parametrize("mode", check.MODES)
def test_deferred_gradients_match_scan_inside_the_port(mode):
    """The two renderers of the port take different routes backward (slot
    shade with the hand-written backward passes against autograd through
    every step): the same gradients to 1e-5 of their maximum."""
    params, static, cfg = _scene("icosphere", mode)
    grads = []
    for deferred in (True, False):
        tp, ts = check.to_device(params, static, "cpu")
        if deferred:
            slots = pipeline.auto_slots(tp, ts, cfg) if mode != "hard" else 8
            img, _ = pipeline.render_deferred(tp, ts, cfg, slots=slots)
        else:
            img = pipeline.render(tp, ts, cfg)
        check.loss_of(img, cfg).backward()
        grads.append({k: p.grad.numpy() for k, p in tp.items()})
    for k in check.PARAM_NAMES:
        a, b = grads[0][k], grads[1][k]
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), k


@pytest.mark.parametrize("mode", check.MODES)
def test_gradients_finite_with_degenerate_triangles(mode):
    """A vertex at w = 1e-30, one at w = 0 and a zero-area triangle: image
    and gradients stay finite, as the JAX package's do.  The zero-area
    triangle's own vertices get gradients of the order of 1e22 (its
    barycentrics divide by the clamp, 1e-20), which no two float32 programs
    agree on; the 90 vertices of the ordinary triangles agree with JAX to
    1e-2 of their largest gradient (the w = 1e-30 triangle's huge edge
    coefficients make a few pixels ties that round either way, see
    tests/test_torch_diff_vis.py, and a pixel that changes winner changes
    its vertices' gradients)."""
    import jax
    import jax.numpy as jnp

    params, static, cfg = _scene("degenerate", mode)
    jpipe, jcfg, jp, js = _jax_side(params, static, cfg)
    slots = 8 if mode == "hard" else jpipe.auto_slots(jp, js, jcfg)
    jgrads = jax.grad(lambda p: jnp.sum(jpipe.render_deferred(
        p, js, jcfg, slots=slots)[0] ** 2))(jp)
    tp, ts = _port_side(jp, js)
    loss, img, _ = check.step(tp, ts, cfg, slots=slots)
    assert bool(torch.isfinite(img).all()) and np.isfinite(float(loss))
    for k in ("pos", "color"):
        got, want = tp[k].grad.numpy(), np.asarray(jgrads[k])
        assert np.isfinite(got).all() and np.isfinite(want).all(), k
        got, want = got[:90], want[:90]
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max(), k


def test_slot_overflow_is_reported():
    """Fewer slots than the scene writes: max_writes says so."""
    params, static, cfg = _scene("icosphere", "alpha")
    tp, ts = check.to_device(params, static, "cpu", requires_grad=False)
    _, maxw = pipeline.render_deferred(tp, ts, cfg, slots=1)
    assert int(maxw) == 2 > 1
    assert pipeline.auto_slots(tp, ts, cfg, headroom=1) == 4
    hard = _scene("icosphere", "hard")[2]
    assert pipeline.measure_max_writes(tp, ts, hard) == 1


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    params, static, _ = _scene("triangles", "hard")
    with pytest.raises(RuntimeError):
        interop.diff_params_from_reference(params)
    with pytest.raises(RuntimeError):
        interop.diff_static_from_reference(static)
    with pytest.raises(RuntimeError):
        check.to_device(params, static)
