"""rt.diff, the differentiable ray tracer: values and gradients against the
JAX package on the same seeded inputs, and the per-ray-stack BVH traversal
its hit selection runs on.

Tolerances.  Values: 2e-5 (XLA's CPU code contracts multiply-adds, eager
torch does not).  Gradients with respect to verts, colors and normals:
max |diff| <= 1e-4 of the largest |gradient| of that table, against
``jax.grad`` of the same weighted sum.  Two backward passes give the same
bits: every gather's transpose is the pinned-order row accumulation
(diff.pipeline.gather_rows), not a scatter-add.  ``topk_plane_hits``: equal
to JAX's, the order among equal keys included (lower prim id first).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skybox_rt_tpu.rt import bvh as jax_bvh
from skybox_rt_tpu.rt import diff as jax_diff
from skybox_rt_tpu.rt import intersect as jax_intersect
from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.rt import bvh as bvh_mod
from skybox_rt_tpu_torch.rt import diff, intersect, tracer

torch.set_num_threads(1)

LIGHT = (0.4, 0.8, 0.45)
R = 600


def _scene():
    verts, faces = scenes.multi_sphere(n=3, subdiv=1, seed=5)
    rng = np.random.default_rng(2)
    colors = rng.uniform(0.2, 1.0, size=(verts.shape[0], 4)).astype(np.float32)
    normals = tracer.vertex_normals(verts, faces)
    o, d = scenes.aimed_rays(R, seed=9)
    weights = rng.uniform(0.5, 1.5, size=(R, 3)).astype(np.float32)
    return verts, np.asarray(faces, np.int64), colors, normals, o, d, weights


def _bvh_arrays(verts, faces):
    bvh = bvh_mod.build(verts, faces)
    jb = jax_bvh.build(verts, faces)
    np.testing.assert_array_equal(bvh.prim_order, jb.prim_order)
    return bvh.as_device_arrays("cpu"), jb.as_device_arrays()


def _leaves(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


def _grad_close(got, want, what):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got.numpy() - want).max()
    print(f"{what}: max |grad| {scale:.3e}, max |diff| {err:.3e}")
    assert err <= 1e-4 * scale, what


def test_solve_hit():
    rng = np.random.default_rng(0)
    a = [rng.normal(size=(800, 3)).astype(np.float32) for _ in range(5)]
    # well-conditioned pairs only: 1/det amplifies the last bit without bound
    det = np.einsum("nk,nk->n", a[3].astype(np.float64),
                    np.cross(a[1].astype(np.float64), a[4]))
    a = [x[np.abs(det) > 0.2] for x in a]
    assert a[0].shape[0] > 300
    got = diff.solve_hit(*(torch.as_tensor(x) for x in a))
    want = jax_diff.solve_hit(*(jnp.asarray(x) for x in a))
    for g, w, name in zip(got, want, "tuv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("use_bvh", [False, True], ids=["brute", "bvh"])
def test_closest_hit_diff(use_bvh):
    verts, faces, _, _, o, d, _ = _scene()
    arrays, jarrays = _bvh_arrays(verts, faces) if use_bvh else (None, None)
    prim, t, u, v = diff.closest_hit_diff(verts, faces, o, d, arrays,
                                          device="cpu")
    jp, jt, ju, jv = jax_diff.closest_hit_diff(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(o),
        jnp.asarray(d), jarrays)
    jp = np.asarray(jp)
    assert prim.dtype == torch.int32 and not prim.requires_grad
    np.testing.assert_array_equal(prim.numpy() < 0, jp < 0)
    hit = jp >= 0
    assert 0.3 < hit.mean() < 1.0
    assert (prim.numpy() == jp).mean() >= 0.99          # ties only
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(jt)[hit], rtol=1e-5)
    same = hit & (prim.numpy() == jp)
    np.testing.assert_allclose(u.numpy()[same], np.asarray(ju)[same],
                               atol=1e-4)
    np.testing.assert_allclose(v.numpy()[same], np.asarray(jv)[same],
                               atol=1e-4)
    assert np.isinf(t.numpy()[~hit]).all() and not u.numpy()[~hit].any()


def test_per_ray_stack_traversal_matches_jax_and_bruteforce():
    """rt.bvh.closest_hit / any_hit against the JAX vmapped while-loop and
    the all-pairs oracle, with a bound and with a non-default leaf size."""
    verts, faces, _, _, o, d, _ = _scene()
    tri = intersect.triangle_arrays(torch.as_tensor(verts),
                                    torch.as_tensor(faces))
    jtri = jax_intersect.triangle_arrays(jnp.asarray(verts),
                                         jnp.asarray(faces))
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    for leaf_size, t_max in ((4, np.inf), (2, 3.0)):
        bvh = bvh_mod.build(verts, faces, leaf_size=leaf_size)
        jb = jax_bvh.build(verts, faces, leaf_size=leaf_size)
        got = bvh_mod.closest_hit(bvh.as_device_arrays("cpu"), tri, ot, dt,
                                  t_max=t_max, leaf_size=leaf_size)
        want = jax_bvh.closest_hit(jb.as_device_arrays(), jtri,
                                   jnp.asarray(o), jnp.asarray(d),
                                   t_max=t_max, leaf_size=leaf_size)
        brute = intersect.closest_hit_bruteforce(ot, dt, *tri, t_max=t_max)
        p, jp = got[0].numpy(), np.asarray(want[0])
        np.testing.assert_array_equal(p < 0, jp < 0)
        np.testing.assert_array_equal(p < 0, brute[0].numpy() < 0)
        hit = p >= 0
        assert hit.any() and (p == jp).mean() >= 0.99
        # atol: a hit just above t_min has few significant bits left
        np.testing.assert_allclose(got[1].numpy()[hit],
                                   np.asarray(want[1])[hit], rtol=1e-5,
                                   atol=1e-7)
        # the same arithmetic as the oracle: t equal bit for bit
        np.testing.assert_array_equal(got[1].numpy(), brute[1].numpy())
        occ = bvh_mod.any_hit(bvh.as_device_arrays("cpu"), tri, ot, dt,
                              t_max=2.5, leaf_size=leaf_size)
        np.testing.assert_array_equal(
            occ.numpy(), intersect.any_hit_bruteforce(ot, dt, *tri,
                                                      t_max=2.5).numpy())
    with pytest.raises(RuntimeError, match="stack"):
        bvh_mod.closest_hit(bvh.as_device_arrays("cpu"), tri, ot, dt,
                            leaf_size=2, stack_depth=2)


def _render_pair(name, use_bvh):
    """(port loss fn over leaves, jax loss fn, leaf arrays, names)."""
    verts, faces, colors, normals, o, d, weights = _scene()
    arrays, jarrays = _bvh_arrays(verts, faces) if use_bvh else (None, None)
    jf, jo, jd, jw = (jnp.asarray(a) for a in (faces, o, d, weights))
    w = torch.as_tensor(weights)
    if name == "depth":
        names, leaves = ["verts"], [verts]

        def port(v):
            img = diff.render_depth(v, faces, o, d, arrays, device="cpu")
            return img, (img * w[:, 0]).sum()

        def ref(v):
            img = jax_diff.render_depth(v, jf, jo, jd, jarrays)
            return (img * jw[:, 0]).sum(), img
    elif name == "lambert":
        names, leaves = ["verts", "colors"], [verts, colors]

        def port(v, c):
            img = diff.render_lambert(v, faces, c, o, d, LIGHT, arrays,
                                      device="cpu")
            return img, (img * w).sum()

        def ref(v, c):
            img = jax_diff.render_lambert(v, jf, c, jo, jd, LIGHT, jarrays)
            return (img * jw).sum(), img
    elif name == "lambert_smooth":
        names = ["verts", "normals", "colors"]
        leaves = [verts, normals, colors]

        def port(v, n, c):
            img = diff.render_lambert_smooth(v, faces, n, c, o, d, LIGHT,
                                             arrays, device="cpu")
            return img, (img * w).sum()

        def ref(v, n, c):
            img = jax_diff.render_lambert_smooth(v, jf, n, c, jo, jd, LIGHT,
                                                 jarrays)
            return (img * jw).sum(), img
    else:
        names, leaves = ["verts", "colors"], [verts, colors]

        def port(v, c):
            img = diff.render_lambert_soft(v, faces, c, o, d, LIGHT, K=4,
                                           device="cpu")
            return img, (img * w).sum()

        def ref(v, c):
            img = jax_diff.render_lambert_soft(v, jf, c, jo, jd, LIGHT, K=4)
            return (img * jw).sum(), img
    return port, ref, leaves, names


@pytest.mark.parametrize("name,use_bvh", [
    ("depth", True), ("lambert", False), ("lambert", True),
    ("lambert_smooth", True), ("lambert_soft", False)])
def test_render_values_and_gradients(name, use_bvh):
    port, ref, arrays, names = _render_pair(name, use_bvh)
    leaves = _leaves(*arrays)
    img, loss = port(*leaves)
    grads = torch.autograd.grad(loss, leaves)
    (_, jimg), jgrads = jax.value_and_grad(
        ref, argnums=tuple(range(len(arrays))), has_aux=True)(
            *(jnp.asarray(a) for a in arrays))
    diff_img = np.abs(img.detach().numpy() - np.asarray(jimg))
    print(f"{name}: max |image diff| {diff_img.max():.3e}")
    assert img.detach().abs().max() > 0.2
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg),
                               atol=2e-5, rtol=1e-5)
    for g, jg, what in zip(grads, jgrads, names):
        _grad_close(g, jg, f"{name} d/d{what}")
    # a second graph, a second backward: the same bits
    img2, loss2 = port(*leaves)
    for g, g2 in zip(grads, torch.autograd.grad(loss2, leaves)):
        assert torch.equal(g, g2)


def test_topk_plane_hits_orders_equal_keys_as_jax():
    """Duplicate triangles give equal keys: the lower prim id comes first,
    as jax.lax.top_k orders them; K above P pads with -1."""
    verts, faces, _, _, o, d, _ = _scene()
    faces = np.concatenate([faces[:20], faces[:20][::-1], faces[20:40]])
    for K in (4, 70):
        got = diff.topk_plane_hits(torch.as_tensor(verts),
                                   torch.as_tensor(faces), torch.as_tensor(o),
                                   torch.as_tensor(d), K)
        want = jax_diff.topk_plane_hits(jnp.asarray(verts),
                                        jnp.asarray(faces), jnp.asarray(o),
                                        jnp.asarray(d), K)
        assert got.dtype == torch.int32 and tuple(got.shape) == (R, K)
        g, w = got.numpy(), np.asarray(want)
        # keys that differ by rounding between the packages may swap; equal
        # keys (the duplicates) may not: rows must agree on >= 99 % of rays
        assert (g == w).all(axis=1).mean() >= 0.99
        dup = (g[:, :-1] >= 0) & (g[:, 1:] >= 0) & (
            np.minimum(g[:, :-1], g[:, 1:]) < 20) & (
            g[:, :-1] + g[:, 1:] == 39)
        assert dup.any()
        assert (g[:, :-1][dup] < g[:, 1:][dup]).all()
        if K == 70:
            assert (g[:, 60:] == -1).all()


def test_renders_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    verts, faces, colors, _, o, d, _ = _scene()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diff.render_lambert(verts, faces, colors, o, d, LIGHT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diff.render_lambert_soft(verts, faces, colors, o, d, LIGHT)
