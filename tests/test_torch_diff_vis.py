"""Visibility of the differentiable pipeline: the port against the JAX package.

Hard mode: ``diff.cuda_vis.visibility_hard_reference`` (the plain version of
the CUDA kernel ``csrc/diff_visibility.cu``, which ``visibility_slots`` runs
for CPU tensors) is held to the JAX package's ``visibility_slots`` with
``engine="pallas"`` (its Pallas kernel in interpret mode, as its own tests run
it on the CPU) and ``engine="xla"``, on the same numpy-seeded scenes.  Winner
steps are compared tie-aware (``diff.check.winner_differences``): XLA's CPU
code contracts multiply-adds, the port does not, so a pixel may differ only
where the two candidates' depths agree to rtol 1e-5 or an edge function is
within 1e-4 of zero, on under 0.1 % of the pixels; on the scenes without
degenerate triangles every pixel is equal.

K-slot modes: slot steps and max_writes equal to JAX's.

The CUDA kernel against the plain version runs only on a card (marker
``cuda``):  python -m pytest --noconftest -m cuda tests/test_torch_diff_vis.py
"""
import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch.diff import check, cuda_vis, pipeline

torch.set_num_threads(1)

CASES = {
    "random_0": dict(seed=0),
    "random_3": dict(seed=3),
    "random_0_noz": dict(seed=0, depth_test=False),
    "random_3_noz": dict(seed=3, depth_test=False),
    "tile_3": dict(n=30, seed=5, tile_logsize=3),
    "tile_5": dict(n=30, seed=6, tile_logsize=5),
    "tile_6": dict(n=30, seed=7, tile_logsize=6),
    "coplanar_duplicates": dict(duplicates=12),
    "degenerate": dict(degenerate=True),
    "degenerate_noz": dict(degenerate=True, depth_test=False),
}
EXACT = {k for k in CASES if not k.startswith("degenerate")}


def _jax_inputs(params, static, cfg):
    import jax.numpy as jnp

    from skybox_rt_tpu.diff import pipeline as jpipe
    jcfg = jpipe.DiffRenderConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = {k: jnp.asarray(v) for k, v in static.items()}
    setup = jpipe.prim_setup(jp, js["indices"], jcfg)
    return jpipe, jcfg, setup, js


def _port_inputs(params, static, cfg, device="cpu"):
    params, static = check.to_device(params, static, device,
                                     requires_grad=False)
    setup = pipeline.prim_setup(params, static["indices"], cfg)
    return setup, static["tile_pids"], static["tile_xy"] * (
        1 << cfg.tile_logsize)


@pytest.mark.parametrize("name", sorted(CASES))
def test_hard_winners_match_jax(name):
    params, static, cfg = check.random_triangles(**CASES[name])
    jpipe, jcfg, jsetup, js = _jax_inputs(params, static, cfg)
    setup, pids, origins = _port_inputs(params, static, cfg)
    got, got_w = pipeline.visibility_slots(setup, pids, origins, cfg)
    assert got.dtype == torch.int32 and got.shape[-1] == 1
    assert bool((got >= 0).any())
    plain = cuda_vis.visibility_hard_reference(
        setup["edges"], setup["z"], pids, origins, cfg.tile_logsize,
        cfg.depth_test)
    assert torch.equal(got[..., 0], plain)      # CPU tensors: the plain version
    engines = ["xla"]
    from skybox_rt_tpu.diff import pallas_vis
    if pallas_vis.supported(cfg.tile_logsize):
        engines.append("pallas")
    for engine in engines:
        want, want_w = jpipe.visibility_slots(
            jsetup, js["tile_pids"], js["tile_xy"] * (1 << cfg.tile_logsize),
            jcfg, engine=engine)
        want = torch.from_numpy(np.array(want[..., 0]))
        differ, not_ties = check.winner_differences(
            setup["edges"], setup["z"], pids, origins, cfg.tile_logsize,
            got[..., 0], want)
        assert not_ties == 0, engine
        assert differ <= check.WINNER_SHARE * want.numel(), engine
        if name in EXACT:
            assert differ == 0, engine
        assert int(got_w) == int(want_w) == 1


def test_duplicates_go_to_the_earliest_step():
    """Coplanar duplicates tie in z on every pixel they cover: the earlier
    step wins, as in the sequential rule."""
    params, static, cfg = check.random_triangles(duplicates=12)
    setup, pids, origins = _port_inputs(params, static, cfg)
    steps, _ = pipeline.visibility_slots(setup, pids, origins, cfg)
    won = torch.gather(pids.long(), 1, steps[..., 0].clamp(min=0).long()
                       .reshape(pids.shape[0], -1))
    won = won[steps[..., 0].reshape(pids.shape[0], -1) >= 0]
    assert int((won < 12).sum()) > 100      # the originals are visible
    assert int((won >= 40).sum()) == 0      # their copies never win


def test_degenerate_depths_never_win():
    """NaN and +inf depths fail the sequential rule's strict `<`."""
    params, static, cfg = check.random_triangles(degenerate=True)
    setup, pids, origins = _port_inputs(params, static, cfg)
    assert not bool(torch.isfinite(setup["z"]).all())
    steps, _ = pipeline.visibility_slots(setup, pids, origins, cfg)
    live = steps[..., 0] >= 0
    won = torch.gather(pids.long(), 1, steps[..., 0].clamp(min=0).long()
                       .reshape(pids.shape[0], -1)).reshape(live.shape)[live]
    zw = setup["z"][won]
    assert not bool(torch.isnan(zw).any())
    assert not bool((zw == float("inf")).any())
    # the sequential oracle agrees on every pixel
    p, s = check.to_device(params, static, "cpu", requires_grad=False)
    assert torch.equal(pipeline.render(p, s, cfg),
                       pipeline.render_deferred(p, s, cfg)[0])


@pytest.mark.parametrize("mode", ["alpha", "soft"])
@pytest.mark.parametrize("slots", [2, 4])
def test_k_slot_steps_match_jax(mode, slots):
    params, static, cfg = check.train_scene(64, mode, subdiv=2,
                                            tile_logsize=4, tex_size=16,
                                            tex_tiles=4)
    jpipe, jcfg, jsetup, js = _jax_inputs(params, static, cfg)
    setup, pids, origins = _port_inputs(params, static, cfg)
    got, got_w = pipeline.visibility_slots(setup, pids, origins, cfg,
                                           slots=slots)
    want, want_w = jpipe.visibility_slots(
        jsetup, js["tile_pids"], js["tile_xy"] * (1 << cfg.tile_logsize),
        jcfg, slots=slots)
    assert got.shape == tuple(want.shape) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_w) == int(want_w) == 2


def test_k_slot_deep_overlap_crosses_chunks():
    """Forty stacked layers, front to back and back to front: more prims
    than one scan chunk, so the carried count and running depth cross chunk
    borders; slot steps equal to JAX's."""
    n = pipeline.SLOT_CHUNK + 8
    for order in (1, -1):
        pos = np.zeros((n * 3, 4), np.float32)
        pos[:, 3] = 1.0
        tri = np.array([[-0.8, -0.8], [0.8, -0.8], [0.0, 0.8]], np.float32)
        depth = np.linspace(0.1, 0.9, n, dtype=np.float32)[::order]
        for i in range(n):
            pos[3 * i:3 * i + 3, :2] = tri
            pos[3 * i:3 * i + 3, 2] = depth[i]
        rng = np.random.default_rng(2)
        params = {"pos": pos,
                  "color": rng.uniform(0, 1, (n * 3, 4)).astype(np.float32),
                  "uv": rng.uniform(0, 1, (n * 3, 2)).astype(np.float32)}
        indices = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
        from skybox_rt_tpu_torch.diff import binning
        static = binning.bin_static(pos, indices, 32, 32, tile_logsize=4)
        cfg = pipeline.DiffRenderConfig(width=32, height=32, tile_logsize=4,
                                        alpha_blend=True)
        jpipe, jcfg, jsetup, js = _jax_inputs(params, static, cfg)
        setup, pids, origins = _port_inputs(params, static, cfg)
        got, got_w = pipeline.visibility_slots(setup, pids, origins, cfg,
                                               slots=4)
        want, want_w = jpipe.visibility_slots(
            jsetup, js["tile_pids"], js["tile_xy"] * 16, jcfg, slots=4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got_w) == int(want_w) == (n if order == -1 else 1)


def test_engine_names():
    params, static, cfg = check.random_triangles(n=10)
    setup, pids, origins = _port_inputs(params, static, cfg)
    a, _ = pipeline.visibility_slots(setup, pids, origins, cfg, engine="xla")
    b, _ = pipeline.visibility_slots(setup, pids, origins, cfg,
                                     engine="pallas")
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        pipeline.visibility_slots(setup, pids, origins, cfg, engine="mosaic")


def test_wrapper_rejects_other_devices():
    params, static, cfg = check.random_triangles(n=10)
    setup, pids, origins = _port_inputs(params, static, cfg)
    with pytest.raises(ValueError):
        cuda_vis.visibility_hard(setup["edges"].to("meta"),
                                 setup["z"].to("meta"), pids.to("meta"),
                                 origins.to("meta"), 4, True)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    for name, kw in sorted(CASES.items()):
        params, static, cfg = check.random_triangles(**kw)
        setup, pids, origins = _port_inputs(params, static, cfg, "cuda")
        cuda_vis.reset_launch_count()
        got, _ = pipeline.visibility_slots(setup, pids, origins, cfg)
        assert cuda_vis.launch_count == 1
        want, _ = pipeline.visibility_slots(setup, pids, origins, cfg,
                                            engine="xla")
        assert cuda_vis.launch_count == 1
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
