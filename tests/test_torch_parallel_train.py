"""The sharded differentiable render and training step (parallel.tile_shard)
and the gradient collectives (parallel.overlap), in worlds of 1, 2 and 3
ranks and on a 2x2 (hosts, tiles) mesh of 4 (gloo, spawned processes that
load no JAX), against the JAX package on its virtual mesh of as many
devices and against the port's unsharded step.

The scene is the JAX tests': scenes.triangle() at 64x64 with 16x16 tiles
(4 binned tiles, so 3 ranks pad the tile list to 6 and a padding tile lands
on tile (0, 0)), the target its image, the step starting from colors 0.25.
Tolerances, the JAX tests' own: loss rtol 1e-6; params rtol 1e-5, atol
1e-7; images atol 1e-6 (the port's unsharded) and 2e-5 (the JAX package's,
whose CPU code contracts multiply-adds); bucketed against per-leaf sums
rtol 1e-6 (gloo's ring sums a chunk in an order of its own); integer-valued
data through two_level_psum exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from skybox_rt_tpu.diff import binning as jax_binning
from skybox_rt_tpu.diff import pipeline as jax_pipeline
from skybox_rt_tpu.models import scenes as jax_scenes
from skybox_rt_tpu.parallel import mesh as jax_mesh
from skybox_rt_tpu.parallel import overlap as jax_overlap
from skybox_rt_tpu.parallel import tile_shard as jax_tile_shard
from skybox_rt_tpu_torch import interop
from skybox_rt_tpu_torch.diff import binning, pipeline
from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.parallel import mesh as mesh_mod
from skybox_rt_tpu_torch.parallel import tile_shard

import test_torch_parallel_ranks as ranks

torch.set_num_threads(1)

SIZE, TLS = 64, 4
#: the make_train_step keywords of each world's steps (the default lr 0.1)
STEPS = {"buckets3": {"grad_buckets": 3}, "buckets2": {"grad_buckets": 2},
         "per_leaf": {"grad_buckets": 0},
         "two_level": {"grad_collective": "two_level"}}
#: world -> (ranks, 2-D mesh shape or None, the STEPS it takes)
WORLDS = {"1": (1, None, ("buckets3",)),
          "2": (2, None, ("buckets3",)),
          "3": (3, None, ("buckets3", "per_leaf")),
          "2x2": (4, (2, 2), ("buckets3", "buckets2", "per_leaf",
                              "two_level"))}


@pytest.fixture(scope="module")
def scene():
    """Numpy params, bad params (colors 0.25), binning, both configs and
    the target image (the JAX render of the true params)."""
    params, indices = scenes.triangle()
    jparams, jindices = jax_scenes.triangle()
    for k in params:
        np.testing.assert_array_equal(params[k], jparams[k])
    np.testing.assert_array_equal(indices, jindices)
    static = binning.bin_static(params["pos"], indices, SIZE, SIZE,
                                tile_logsize=TLS)
    jcfg = jax_pipeline.DiffRenderConfig(width=SIZE, height=SIZE,
                                         tile_logsize=TLS)
    cfg = interop.diff_config_from_reference(jcfg)
    jstatic = {k: jnp.asarray(v) for k, v in jax_binning.bin_static(
        params["pos"], indices, SIZE, SIZE, tile_logsize=TLS).items()}
    target = np.asarray(jax_pipeline.render(
        {k: jnp.asarray(v) for k, v in params.items()}, jstatic, jcfg))
    bad = dict(params, color=np.full_like(params["color"], 0.25))
    return params, bad, static, cfg, jcfg, target[:SIZE, :SIZE]


#: (world, step) pairs of test_train_step_matches
PAIRS = [(w, s) for w, (_, _, steps) in WORLDS.items() for s in steps]


def _corner_scene():
    """A triangle over the whole of an 80x16 frame of 16x16 tiles, its 5
    tiles listed in reverse, so that tile (0, 0) comes last: 3 ranks hold
    blocks of 2 and the last holds tile (0, 0) and a padding tile, which an
    assignment in place of the JAX package's .at[].add would let overwrite
    the real tile with zeros."""
    params, indices = scenes.triangle()
    params["pos"] = np.array([[-1, -1, 0.2, 1], [1, -1, 0.2, 1],
                              [0, 1, 0.2, 1]], np.float32)
    static = binning.bin_static(params["pos"], indices, 80, 16,
                                tile_logsize=TLS)
    assert static["tile_pids"].shape[0] == 5
    assert (static["tile_xy"][0] == 0).all()
    rev = dict(static, tile_pids=static["tile_pids"][::-1].copy(),
               tile_xy=static["tile_xy"][::-1].copy())
    return params, static, rev, jax_pipeline.DiffRenderConfig(
        width=80, height=16, tile_logsize=TLS)


@pytest.fixture(scope="module")
def worlds(scene):
    """name -> the world's results; each world is spawned once (the world
    of 3 renders the corner scene too)."""
    params, bad, static, cfg, _, target = scene
    c_params, _, c_rev, c_jcfg = _corner_scene()
    done = {}

    def get(name):
        if name not in done:
            n, shape, steps = WORLDS[name]
            extra = None
            if name == "3":
                extra = (c_params, c_rev,
                         interop.diff_config_from_reference(c_jcfg))
            done[name] = mesh_mod.spawn(
                ranks.train_world, n, n, shape, params, bad, static, cfg,
                target, {s: STEPS[s] for s in steps}, extra)
        return done[name]

    return get


def _jax_mesh(name):
    n, shape, _ = WORLDS[name]
    return jax_mesh.make_mesh(n) if shape is None else \
        jax_mesh.make_mesh_2d(*shape)


@pytest.mark.parametrize("name", list(WORLDS))
def test_sharded_render_matches(worlds, name, scene):
    got = worlds(name)
    params, _, static, cfg, jcfg, _ = scene
    n = WORLDS[name][0]
    plain = pipeline.render({k: torch.as_tensor(v) for k, v in params.items()},
                            {k: torch.as_tensor(v) for k, v in static.items()},
                            cfg).numpy()
    sharded = jax_tile_shard.shard_tiles(static, n)
    want = np.asarray(jax.jit(jax_tile_shard.make_sharded_render(
        _jax_mesh(name), jcfg))({k: jnp.asarray(v) for k, v in
                                 params.items()}, sharded))
    assert got["tiles"] == -(-static["tile_pids"].shape[0] // n) * n
    assert got["image"].shape == (SIZE, SIZE, 4)
    np.testing.assert_allclose(got["image"], plain, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["image"], want, atol=2e-5, rtol=0)
    assert got["jax_loaded"] is False


def test_sharded_render_padding_beside_tile_00(worlds):
    """The last of 3 ranks holds tile (0, 0) and a padding tile (at tile
    (0, 0) too): the frame equals the unsharded one and the JAX package's
    sharded one on the same reversed tile list."""
    got = worlds("3")["extra_image"]
    params, static, rev, jcfg = _corner_scene()
    cfg = interop.diff_config_from_reference(jcfg)
    plain = pipeline.render({k: torch.as_tensor(v) for k, v in params.items()},
                            {k: torch.as_tensor(v) for k, v in static.items()},
                            cfg).numpy()
    want = np.asarray(jax.jit(jax_tile_shard.make_sharded_render(
        jax_mesh.make_mesh(3), jcfg))(
        {k: jnp.asarray(v) for k, v in params.items()},
        jax_tile_shard.shard_tiles(rev, 3)))
    assert got.shape == (16, 80, 4)
    # tile (0, 0) is drawn: overwritten by the padding tile it would keep
    # the clear color (0, 0, 0, 1)
    assert (got[:16, :16, 3] == 1).all() and got[:16, :16, :3].sum() > 0
    np.testing.assert_allclose(got, plain, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _close_params(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name,step", PAIRS)
def test_train_step_matches(worlds, name, step, scene):
    got = worlds(name)
    params, bad, static, cfg, jcfg, target = scene
    n = WORLDS[name][0]
    res = got[step]
    sharded = jax_tile_shard.shard_tiles(static, n)
    tt = jax_tile_shard.gather_target_tiles(target, sharded["tile_xy"], TLS)
    jp, jloss, jmaxw = jax_tile_shard.make_train_step(
        _jax_mesh(name), jcfg, **STEPS[step])(
        {k: jnp.asarray(v) for k, v in bad.items()},
        {k: jnp.asarray(v) for k, v in sharded.items()}, jnp.asarray(tt))
    np.testing.assert_allclose(res["loss"], float(jloss), rtol=1e-6)
    _close_params(res["params"], jp)
    assert res["max_writes"] == int(jmaxw) == 1

    loss, new = ranks.unsharded_step(bad, static, cfg, target)
    np.testing.assert_allclose(res["loss"], loss, rtol=1e-6)
    _close_params(res["params"], new)
    assert res["loss"] > 0 and not np.allclose(new["color"], bad["color"])

    # the gradient collectives, one all-reduce of the loss and one of
    # max_writes (the JAX test's count of all-reduces in the step's HLO)
    leaves = len(bad)
    expect = {"buckets3": {"all_reduce": min(3, leaves) + 2},
              "buckets2": {"all_reduce": 2 + 2},
              "per_leaf": {"all_reduce": leaves + 2},
              "two_level": {"reduce_scatter": min(3, leaves),
                            "all_reduce": min(3, leaves) + 2,
                            "all_gather": min(3, leaves)}}[step]
    assert res["counts"] == expect


def test_two_level_needs_a_2d_mesh():
    """Raised when the step is made, before any collective."""
    mesh = type("M", (), {"ndim": 1})()
    with pytest.raises(ValueError, match="two_level needs"):
        tile_shard.make_train_step(mesh, None, grad_collective="two_level")


def test_gather_target_tiles_and_shard_tiles_match_jax(scene):
    _, _, static, _, _, target = scene
    for n in (1, 2, 3, 4):
        got = tile_shard.shard_tiles(static, n)
        want = jax_tile_shard.shard_tiles(static, n)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
            assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(
            tile_shard.gather_target_tiles(target, got["tile_xy"], TLS),
            jax_tile_shard.gather_target_tiles(target, want["tile_xy"], TLS))


def _trees():
    rng = np.random.default_rng(0)
    f32 = {"a": rng.normal(size=(33, 4)), "b": rng.normal(size=(7,)),
           "c": rng.normal(size=(16, 16, 4)), "d": rng.normal(size=(1,))}
    rng = np.random.default_rng(5)
    mixed = {"f": rng.normal(size=(17,)).astype(np.float32),
             "h": rng.normal(size=(9, 3)).astype(np.float32),
             "i": rng.integers(0, 100, size=(5,)).astype(np.int32)}
    rng = np.random.default_rng(9)
    ints = {"a": rng.integers(-50, 50, size=(33, 4)),
            "b": rng.integers(-50, 50, size=(7,)),
            "c": rng.integers(-50, 50, size=(16, 16, 4))}
    return {"f32": {k: v.astype(np.float32) for k, v in f32.items()},
            "mixed": mixed, "int": {k: v.astype(np.float32)
                                    for k, v in ints.items()}}


@pytest.fixture(scope="module")
def collectives():
    trees = _trees()
    return trees, mesh_mod.spawn(ranks.collectives_world, 4, trees)


def _jax_sum(tree, fn, mesh, spec):
    """fn over the JAX mesh, device i holding every leaf times i + 1."""
    n = int(np.prod(mesh.devices.shape))
    stacked = {k: jnp.stack([jnp.asarray(v) * (i + 1) for i in range(n)])
               .reshape(mesh.devices.shape + np.shape(v))
               for k, v in tree.items()}
    lead = (0,) * mesh.devices.ndim

    @functools.partial(shard_map, mesh=mesh, in_specs=(spec,),
                       out_specs=P(), check_vma=False)
    def run(t):
        return fn({k: v[lead] for k, v in t.items()})

    return {k: np.asarray(v) for k, v in run(stacked).items()}


@pytest.mark.parametrize("n_buckets", [1, 2, 3, 10])
def test_bucketed_psum_matches_per_leaf_and_jax(collectives, n_buckets):
    trees, got = collectives
    res, counts = got["bucketed"][n_buckets]
    want = _jax_sum(trees["f32"], lambda t: jax_overlap.bucketed_psum(
        t, "tiles", n_buckets), jax_mesh.make_mesh(4), P("tiles"))
    for k in trees["f32"]:
        assert res[k].dtype == np.float32 and res[k].shape == want[k].shape
        np.testing.assert_allclose(res[k], got["bucketed_per_leaf"][k],
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(res[k], want[k], rtol=1e-6, err_msg=k)
    assert counts == {"all_reduce": min(n_buckets, len(trees["f32"]))}
    assert got["jax_loaded"] is False


def test_bucketed_psum_mixed_dtypes_native(collectives):
    """A bucket a dtype: bf16 and int32 leaves sum in their own dtype, equal
    to a per-leaf all-reduce bit for bit; against the JAX package's sums
    float32 rtol 1e-6, int32 exactly, bfloat16 within an ulp."""
    trees, got = collectives
    res, counts = got["mixed"]
    assert counts == {"all_reduce": 3}
    assert got["mixed_dtypes"] == {"f": "torch.float32",
                                   "h": "torch.bfloat16", "i": "torch.int32"}
    for k in ("f", "h", "i"):
        np.testing.assert_array_equal(res[k], got["mixed_per_leaf"][k],
                                      err_msg=k)
    tree = dict(trees["mixed"], h=jnp.asarray(trees["mixed"]["h"]).astype(
        jnp.bfloat16))
    want = _jax_sum(tree, lambda t: jax_overlap.bucketed_psum(t, "tiles", 2),
                    jax_mesh.make_mesh(4), P("tiles"))
    np.testing.assert_allclose(res["f"], want["f"], rtol=1e-6)
    np.testing.assert_array_equal(res["i"], want["i"])
    # bfloat16 within one unit of its last place (2^-7 of the value): gloo
    # rounds every add to bfloat16, XLA's CPU sum rounds once at the end
    h = torch.from_numpy(res["h"]).view(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(h, want["h"].astype(np.float32),
                               rtol=2.0 ** -7)


@pytest.mark.parametrize("n_buckets", [1, 3])
def test_two_level_psum_matches_flat_and_jax(collectives, n_buckets):
    trees, got = collectives
    res, counts = got["two_level"][n_buckets]
    mesh2 = jax_mesh.make_mesh_2d(2, 2)
    want = _jax_sum(trees["int"], lambda t: jax_overlap.two_level_psum(
        t, dcn_axis="hosts", ici_axis="tiles", n_buckets=n_buckets),
        mesh2, P("hosts", "tiles"))
    for k in trees["int"]:
        np.testing.assert_array_equal(res[k], got["two_level_flat"][k])
        np.testing.assert_array_equal(res[k], want[k])
    nb = min(n_buckets, len(trees["int"]))
    assert counts == {"reduce_scatter": nb, "all_reduce": nb,
                      "all_gather": nb}
    # rank h * 2 + c sits at (h, c) of the (hosts, tiles) mesh
    np.testing.assert_array_equal(got["coordinate"],
                                  [[0, 0], [0, 1], [1, 0], [1, 1]])


def test_barrier_psum(collectives):
    """BAR/GBAR analog (test_compute_apps.py::test_barrier_psum) on 4
    ranks: every rank deposits its value, then reads the others' sum."""
    _, got = collectives
    mesh = jax_mesh.make_mesh(4)

    def body(x):
        return jax.lax.psum(x, "tiles") - x

    want = shard_map(body, mesh=mesh, in_specs=P("tiles"),
                     out_specs=P("tiles"))(jnp.arange(4, dtype=jnp.float32))
    np.testing.assert_array_equal(got["barrier"], np.asarray(want))
    np.testing.assert_array_equal(got["barrier"], [6.0, 5.0, 4.0, 3.0])
