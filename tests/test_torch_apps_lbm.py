"""The D3Q19 lattice-Boltzmann app of the port against the JAX package, on
the CPU.

The host tables (indices, initial grid, constants) are the JAX package's bit
for bit.  The step's distributions agree with the JAX ``make_step`` within
rtol 2e-5, atol 1e-7 after each of three steps (the JAX test's tolerance
against its per-cell oracle: XLA's CPU code contracts multiply-adds, eager
torch does not); FLAGS words and margins pass through bit-equal;
after 30 steps the grid agrees within rtol 1e-4, atol 1e-7 and
``velocity_field`` within atol 1e-6: a velocity is a difference of
distributions of about 0.05 over rho, so it keeps their absolute error, not
a relative one (the largest velocity is about 1.6e-2).
"""
import numpy as np
import pytest
import torch

from skybox_rt_tpu.apps import lbm as jlbm
from skybox_rt_tpu_torch import interop
from skybox_rt_tpu_torch.apps import lbm

torch.set_num_threads(1)

JCFG = jlbm.LBMConfig(size_x=16, size_y=8, size_z=8)
CFG = interop.lbm_config_from_reference(JCFG)


def test_host_tables_are_the_jax_ones():
    assert CFG == lbm.LBMConfig(16, 8, 8)
    assert (CFG.margin, CFG.total_floats) == (JCFG.margin, JCFG.total_floats)
    for name in ("DIRS", "OPPOSITE", "WEIGHTS", "NAMES"):
        np.testing.assert_array_equal(getattr(lbm, name),
                                      getattr(jlbm, name))
    assert (lbm.OMEGA, lbm.FLAGS, lbm.N_CELL_ENTRIES) == (
        jlbm.OMEGA, jlbm.FLAGS, jlbm.N_CELL_ENTRIES)
    for got, want in zip(lbm.make_indices(CFG), jlbm.make_indices(JCFG)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lbm.init_ldc(CFG).view(np.uint32),
                                  jlbm.init_ldc(JCFG).view(np.uint32))


def test_step_matches_jax():
    grid = lbm.init_ldc(CFG)
    step = lbm.make_step(CFG, device="cpu")
    jstep = jlbm.make_step(JCFG)
    got = torch.from_numpy(grid.copy())
    want = grid.copy()
    _, _, flags_idx = lbm.make_indices(CFG)
    for _ in range(3):
        got = step(got)
        want = np.asarray(jstep(want))
        g = got.numpy()
        np.testing.assert_allclose(g, want, rtol=2e-5, atol=1e-7)
        np.testing.assert_array_equal(g.view(np.uint32)[flags_idx],
                                      want.view(np.uint32)[flags_idx])


def test_flags_and_margins_untouched():
    grid = lbm.init_ldc(CFG)
    out = lbm.run(CFG, steps=5, grid=grid, device="cpu")
    _, _, flags_idx = lbm.make_indices(CFG)
    bits, gbits = out.view(np.uint32), grid.view(np.uint32)
    np.testing.assert_array_equal(bits[flags_idx], gbits[flags_idx])
    np.testing.assert_array_equal(bits[:CFG.margin], gbits[:CFG.margin])
    np.testing.assert_array_equal(bits[-CFG.margin:], gbits[-CFG.margin:])


def test_run_and_velocity_field_match_jax():
    out = lbm.run(CFG, steps=30, device="cpu")
    jout = jlbm.run(JCFG, steps=30)
    np.testing.assert_allclose(out, jout, rtol=1e-4, atol=1e-7)
    vel = lbm.velocity_field(CFG, out)
    np.testing.assert_allclose(vel, jlbm.velocity_field(JCFG, jout),
                               rtol=0, atol=1e-6)
    # the ACCEL plates drive a cavity flow along +x
    assert np.isfinite(vel).all()
    assert np.abs(vel).max() > 1e-4
    assert np.abs(vel[:, 0]).sum() > np.abs(vel[:, 2]).sum()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid")
    with pytest.raises(RuntimeError):
        lbm.make_step(CFG)
