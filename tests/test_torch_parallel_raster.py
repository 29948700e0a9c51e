"""The tile-striped exact-int raster (parallel.draw_shard) in worlds of 1, 2
and 4 ranks (gloo, spawned processes that load no JAX) against the JAX
package's draw_shard on its virtual mesh of as many devices and against the
port's unsharded frame, bit for bit, on the committed synth_draw3d trace:
64x64 with 8x8 tiles, and 128x128 with 32x32 tiles, where draws d0 and d1
bin 9 tiles, so that 2 and 4 ranks hold padding tiles.  The blended draw d2
runs the slotted pass, overflows K 4 and retries under the MAX-reduced
count.  Beside them: the striping rule, the mesh helpers and the refused
visibility mode, in this process (which forms no process group)."""
import numpy as np
import pytest
import torch

from skybox_rt_tpu.geom import cgltrace as jax_cgltrace
from skybox_rt_tpu.parallel import draw_shard as jax_draw_shard
from skybox_rt_tpu.parallel import mesh as jax_mesh
from skybox_rt_tpu_torch.geom import cgltrace
from skybox_rt_tpu_torch.ops import deferred
from skybox_rt_tpu_torch.parallel import draw_shard
from skybox_rt_tpu_torch.parallel import mesh as mesh_mod
from skybox_rt_tpu_torch.ref import driver

import test_torch_parallel_ranks as ranks

torch.set_num_threads(1)

#: (size, tile_logsize) of the frames
CASES = ((64, 3), (128, 5))


def _trace():
    return cgltrace.load_trace(cgltrace.trace_path("synth_draw3d"))


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded deferred frame and its blend K a draw."""
    out = {}
    for size, tls in CASES:
        trace = _trace()
        fb = driver.render_trace(trace, size, size, tls, mode="deferred",
                                 device="cpu")
        out[(size, tls)] = fb, trace._blend_k_cache[(size, size, tls)]
    return out


@pytest.fixture(scope="module", params=(1, 2, 4))
def world(request):
    n = request.param
    return n, mesh_mod.spawn(ranks.raster_world, n, n, CASES)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}px_k{c[1]}")
def test_sharded_frame_is_bit_exact(world, case, unsharded):
    n, got = world
    size, tls = case
    res = got[case]
    with np.load(cgltrace.trace_path("synth_draw3d")) as z:
        jax_trace = jax_cgltrace._from_npz(z)
    want = np.asarray(jax_draw_shard.render_trace_sharded(
        jax_trace, size, size, jax_mesh.make_mesh(n), tls))
    plain, plain_ks = unsharded[case]
    assert res["first"].dtype == np.uint32
    assert res["first"].shape == (size, size)
    np.testing.assert_array_equal(res["first"], want)
    np.testing.assert_array_equal(res["first"], plain)
    if case == CASES[0]:
        np.testing.assert_array_equal(res["cached"], plain)
    for fb in res["every_rank"]:
        np.testing.assert_array_equal(fb, plain)
    # the blended draw's K: measured as the unsharded frame measures it,
    # after an overflow of the default slots
    assert res["blend_k"] == plain_ks
    retries = sum(1 for k in plain_ks.values()
                  if k > deferred.DEFAULT_BLEND_SLOTS)
    assert retries >= 1
    # color, ds and count SUM and the fragment count MAX, a render of a draw
    assert res["counts"] == {"all_reduce": 4 * (len(plain_ks) + retries)}
    assert got["jax_loaded"] is False


@pytest.mark.parametrize("T,M,n", [(11, 3, 4), (9, 5, 2), (9, 2, 4),
                                   (4, 3, 4), (1, 2, 3), (16, 1, 1)])
def test_stripe_tiles_matches_jax(T, M, n):
    """Rank i's block holds tiles i, i+N, i+2N, ... (raster_unit.cpp:
    221-227), as the JAX package's stripes them."""
    binned = type("B", (), {})()
    binned.tile_pids = np.arange(T * M).reshape(T, M).astype(np.int32)
    binned.tile_xy = np.stack([np.arange(T), np.arange(T)[::-1]],
                              -1).astype(np.int32)
    got = draw_shard.stripe_tiles(binned, n)
    want = jax_draw_shard.stripe_tiles(binned, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.dtype == np.int32
    Tl = -(-T // n)
    pids, valid = got[0].reshape(n, Tl, M), got[2].reshape(n, Tl)
    for i in range(n):
        expect = np.arange(i, T, n)
        assert valid[i].sum() == len(expect)
        np.testing.assert_array_equal(pids[i, :len(expect), 0],
                                      binned.tile_pids[expect, 0])


def test_pad_to_multiple_matches_jax():
    arr = np.arange(10).reshape(5, 2)
    for multiple, axis, fill in ((4, 0, -1), (3, 1, 7), (5, 0, 0)):
        got = mesh_mod.pad_to_multiple(arr, multiple, axis=axis, fill=fill)
        np.testing.assert_array_equal(
            got, jax_mesh.pad_to_multiple(arr, multiple, axis=axis,
                                          fill=fill))


def test_refused_visibility_and_missing_world():
    """"pallas_interpret" gets ref.driver's message; a mesh of more ranks
    than one needs a world formed beforehand, and the default device is the
    card (no process group is formed by any of these)."""
    with pytest.raises(ValueError, match='device="cpu"'):
        draw_shard.render_trace_sharded(_trace(), 8, 8, None,
                                        visibility="pallas_interpret")
    with pytest.raises(ValueError, match="not in"):
        draw_shard.render_trace_sharded(_trace(), 8, 8, None,
                                        visibility="immediate")
    with pytest.raises(ValueError, match="spawn or initialize_distributed"):
        mesh_mod.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="spawn or initialize_distributed"):
        mesh_mod.make_mesh_2d(2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.make_mesh()
    assert not torch.distributed.is_initialized()
