"""The committed golden of the training step, chip_smoke.py's reference on
the card.

``skybox_rt_tpu_torch/data/diff_step_256.npz`` holds one forward and backward
of the JAX package's ``diff.pipeline.render_deferred`` (``engine="xla"``) on
the training workload of ``skybox_rt_tpu_torch.diff.check.train_scene`` at
256x256 in the ``hard``, ``alpha`` and ``soft`` modes: image, loss, the four
gradients, max_writes and the slot count, and for ``hard`` the winner steps.

Here the file is regenerated with the JAX package and must be current
(winner steps equal, image and gradients to rtol 1e-6 / atol 1e-7 of their
largest value), and the port runs the same steps on the CPU against it with
the tolerances chip_smoke.py asks of the card (``diff.check``): winner steps
differing only at ties on under 0.1 % of the pixels, image atol 1e-4 with at
least 99.9 % within 2e-5, loss rtol 1e-5, each gradient
max |diff| <= 1e-4 * max |gradient|.

Regenerate with ``PYTHONPATH=. python tests/test_torch_diff_golden.py --write``.
"""
import sys

import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch.diff import check, pipeline

torch.set_num_threads(1)

SIZE = check.GOLDEN_SIZE


def jax_step(mode):
    """One step of the JAX package on the workload: dict of numpy arrays
    under the golden's key names for ``mode``."""
    import jax
    import jax.numpy as jnp

    from skybox_rt_tpu.diff import pipeline as jpipe

    params, static, cfg = check.train_scene(SIZE, mode)
    jcfg = jpipe.DiffRenderConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = {k: jnp.asarray(v) for k, v in static.items()}
    slots = 8 if mode == "hard" else jpipe.auto_slots(jp, js, jcfg)

    def loss_fn(p):
        img, maxw = jpipe.render_deferred(p, js, jcfg, slots=slots,
                                          engine="xla")
        return jnp.sum(img[:SIZE, :SIZE] ** 2), (img, maxw)

    (loss, (img, maxw)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(jp)
    out = {"image": np.asarray(img, np.float32),
           "loss": np.float32(loss), "max_writes": np.int32(maxw),
           "slots": np.int32(slots)}
    for k in check.PARAM_NAMES:
        out["grad_" + k] = np.asarray(grads[k], np.float32)
    if mode == "hard":
        setup = jpipe.prim_setup(jp, js["indices"], jcfg)
        steps, _ = jpipe.visibility_slots(
            setup, js["tile_pids"], js["tile_xy"] * (1 << cfg.tile_logsize),
            jcfg, engine="xla")
        out["steps"] = np.asarray(steps[..., 0], np.int32)
    return {f"{mode}_{k}": v for k, v in out.items()}


@pytest.fixture(scope="module")
def golden():
    with np.load(check.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("mode", check.MODES)
def test_golden_is_current(mode, golden):
    fresh = jax_step(mode)
    assert set(fresh) == {k for k in golden if k.startswith(mode + "_")}
    for k, v in fresh.items():
        if v.dtype.kind == "i":
            np.testing.assert_array_equal(golden[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(golden[k], v, rtol=1e-6,
                                       atol=1e-7 * np.abs(v).max(), err_msg=k)


@pytest.mark.parametrize("mode", check.MODES)
def test_port_step_matches_golden_on_cpu(mode, golden):
    params, static, cfg = check.train_scene(SIZE, mode)
    params, static = check.to_device(params, static, "cpu")
    slots = int(golden[f"{mode}_slots"])
    if mode != "hard":
        assert pipeline.auto_slots(params, static, cfg) == slots
    loss, img, maxw = check.step(params, static, cfg, slots=slots)
    assert int(maxw) == int(golden[f"{mode}_max_writes"])
    got = {"image": img.numpy(), "loss": float(loss)}
    for k in check.PARAM_NAMES:
        got["grad_" + k] = params[k].grad.numpy()
    check.compare_to_golden(mode, got, golden, prefix=mode + "_")
    if mode == "hard":
        with torch.no_grad():
            setup = pipeline.prim_setup(params, static["indices"], cfg)
            origins = static["tile_xy"] * (1 << cfg.tile_logsize)
            steps, _ = pipeline.visibility_slots(setup, static["tile_pids"],
                                                 origins, cfg)
        differ, not_ties = check.winner_differences(
            setup["edges"], setup["z"], static["tile_pids"], origins,
            cfg.tile_logsize, steps[..., 0],
            torch.from_numpy(golden["hard_steps"]))
        assert not_ties == 0
        assert differ <= check.WINNER_SHARE * steps.numel()


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        raise SystemExit("usage: python tests/test_torch_diff_golden.py "
                         "--write")
    arrays = {}
    for m in check.MODES:
        arrays.update(jax_step(m))
    np.savez_compressed(check.GOLDEN, **arrays)
    print(check.GOLDEN, {k: (v.shape, str(v.dtype)) for k, v in arrays.items()})
