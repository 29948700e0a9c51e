"""rt.bvh and rt.wavefront of the port against the JAX package, on the CPU.

The build functions are host numpy in both packages: every array must be equal.
The stackless traversals go through the same rays: prims and occlusion
equal, t rtol 1e-5, u/v atol 1e-4 (XLA's CPU code contracts multiply-adds,
eager torch does not; see tests/test_torch_rt_intersect.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skybox_rt_tpu.rt import bvh as jax_bvh
from skybox_rt_tpu.rt import intersect as jax_intersect
from skybox_rt_tpu.rt import wavefront as jax_wavefront
from skybox_rt_tpu_torch import interop
from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.rt import bvh as bvh_mod
from skybox_rt_tpu_torch.rt import intersect, wavefront

torch.set_num_threads(1)

NODE_FIELDS = ("node_min", "node_max", "node_left", "node_right",
               "node_first", "node_count", "prim_order")
PRE_FIELDS = ("pre_min", "pre_max", "pre_first", "pre_count", "pre_escape")


def _scene(name):
    if name == "icosphere":
        return scenes.icosphere(subdiv=2)
    if name == "multi_sphere":
        return scenes.multi_sphere(n=3, subdiv=2, seed=13)
    verts, faces, _ = scenes.sphere_field(copies=4, subdiv=1)
    return verts, faces


@pytest.mark.parametrize("scene", ["icosphere", "multi_sphere", "field"])
@pytest.mark.parametrize("method", ["sah", "median", "lbvh"])
def test_build_functions_equal_jax(method, scene):
    verts, faces = _scene(scene)
    want = jax_bvh.build(verts, faces, method=method)
    got = bvh_mod.build(verts, faces, method=method)
    for f in NODE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.leaf_size == want.leaf_size
    want.build_preorder()
    got.build_preorder()
    for f in PRE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    carried = interop.bvh_from_reference(want)
    for f in NODE_FIELDS + PRE_FIELDS:
        np.testing.assert_array_equal(getattr(carried, f), getattr(want, f))

    cw, cg = jax_bvh.build_clusters(want, 16), bvh_mod.build_clusters(got, 16)
    assert sorted(cw) == sorted(cg)
    for k in cw:
        np.testing.assert_array_equal(cg[k], cw[k], err_msg=k)
    for tri_block in (16, 256):
        sw = jax_bvh.build_block_set(want, tri_block=tri_block, top_size=4)
        sg = bvh_mod.build_block_set(got, tri_block=tri_block, top_size=4)
        assert (sg["tri_block"], sg["num_blocks"]) == \
            (sw["tri_block"], sw["num_blocks"])
        assert len(sg["aabb_levels"]) == len(sw["aabb_levels"])
        for a, b in zip(sg["aabb_levels"], sw["aabb_levels"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sg["bcnt"], sw["bcnt"])
        np.testing.assert_array_equal(sg["slot_to_prim"], sw["slot_to_prim"])


def test_unknown_build_method():
    verts, faces = scenes.icosphere(subdiv=0)
    with pytest.raises(ValueError):
        bvh_mod.build(verts, faces, method="nope")


def _rays(R, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32) * 3.0
    d = -o + rng.normal(size=(R, 3)).astype(np.float32) * 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("method", ["median", "sah"])
def test_stackless_matches_jax(method):
    verts, faces = scenes.icosphere(subdiv=2)
    o, d = _rays(1024, seed=7)
    jb = jax_bvh.build(verts, faces, method=method)
    jtri = jax_intersect.triangle_arrays(jnp.asarray(verts),
                                         jnp.asarray(faces))
    want = [np.asarray(x) for x in jax_bvh.closest_hit_stackless(
        jb.as_stackless_arrays(), jtri, jnp.asarray(o), jnp.asarray(d))]
    pb = bvh_mod.build(verts, faces, method=method)
    ptri = intersect.triangle_arrays(torch.as_tensor(verts),
                                     torch.as_tensor(faces))
    arrays = pb.as_stackless_arrays("cpu")
    got = [x.numpy() for x in bvh_mod.closest_hit_stackless(
        arrays, ptri, torch.as_tensor(o), torch.as_tensor(d))]
    assert got[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    hits = want[0] >= 0
    assert hits.mean() > 0.5
    assert np.isinf(got[1][~hits]).all()
    np.testing.assert_allclose(got[1][hits], want[1][hits], rtol=1e-5)
    np.testing.assert_allclose(got[2][hits], want[2][hits], atol=1e-4)
    np.testing.assert_allclose(got[3][hits], want[3][hits], atol=1e-4)
    # the port's own oracle: same arithmetic, so exactly equal
    brute = intersect.closest_hit_bruteforce(torch.as_tensor(o),
                                             torch.as_tensor(d), *ptri)
    for g, b in zip(got, brute):
        np.testing.assert_array_equal(g, b.numpy())

    for t_max in (2.5, (np.arange(1024) % 3 + 1.5).astype(np.float32)):
        jt = t_max if np.ndim(t_max) == 0 else jnp.asarray(t_max)
        pt = t_max if np.ndim(t_max) == 0 else torch.as_tensor(t_max)
        occ_w = np.asarray(jax_bvh.any_hit_stackless(
            jb.as_stackless_arrays(), jtri, jnp.asarray(o), jnp.asarray(d),
            t_max=jt))
        occ = bvh_mod.any_hit_stackless(arrays, ptri, torch.as_tensor(o),
                                        torch.as_tensor(d), t_max=pt).numpy()
        np.testing.assert_array_equal(occ, occ_w)
        assert 0 < occ.mean() < 1


def test_tile_order_perm_equals_jax():
    for w, h, tile in ((8, 8, 4), (48, 48, 32), (100, 75, 32)):
        for a, b in zip(wavefront.tile_order_perm(w, h, tile),
                        jax_wavefront.tile_order_perm(w, h, tile)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_ray_sort_keys_and_traverse_sorted():
    verts, faces = scenes.icosphere(subdiv=2)
    o, d = _rays(777, seed=11)
    lo, hi = verts.min(0) - 3.0, verts.max(0) + 3.0
    want = np.asarray(jax_wavefront.ray_sort_keys(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo), jnp.asarray(hi)))
    got = wavefront.ray_sort_keys(torch.as_tensor(o), torch.as_tensor(d),
                                  torch.as_tensor(lo), torch.as_tensor(hi))
    # (o - lo) / ext * 1023 truncates to an integer: a last-ulp difference
    # moves a quantized coordinate by one on a handful of rays at most
    assert (got.numpy() == want.astype(np.int64)).mean() > 0.99
    xyz = torch.tensor([[0, 0, 0], [1023, 0, 0], [0, 1023, 0], [5, 6, 7]])
    np.testing.assert_array_equal(
        wavefront.morton3d(xyz[:, 0], xyz[:, 1], xyz[:, 2]).numpy(),
        np.asarray(jax_wavefront.morton3d(*(jnp.asarray(xyz.numpy()[:, k])
                                            for k in range(3)))))

    ptri = intersect.triangle_arrays(torch.as_tensor(verts),
                                     torch.as_tensor(faces))

    def closest(o_, d_):
        return intersect.closest_hit_bruteforce(o_, d_, *ptri)

    ref = closest(torch.as_tensor(o), torch.as_tensor(d))
    out = wavefront.traverse_sorted(closest, torch.as_tensor(o),
                                    torch.as_tensor(d), lo, hi)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
