"""rt.intersect of the port against the JAX package, on the CPU.

Same numpy inputs through both.  Hit masks and prims: equal.  t: rtol 1e-5;
u, v: atol 1e-4.  XLA's CPU code contracts multiply-adds, eager torch does
not, so the two differ by a few ulps in t (measured 8) and by up to 5e-5 in
the barycentrics of glancing rays, each being as far from float64; bit
equality, or 1e-6, is not reachable across that divide.  Rays within 1e-4 of
an edge of the hit test are left out of the mask comparison, and the test
checks that they are few.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skybox_rt_tpu.rt import intersect as jax_intersect
from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.rt import intersect

torch.set_num_threads(1)


def _tri(verts, faces):
    jt = jax_intersect.triangle_arrays(jnp.asarray(verts), jnp.asarray(faces))
    pt = intersect.triangle_arrays(torch.as_tensor(verts),
                                   torch.as_tensor(faces))
    for a, b in zip(jt, pt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return jt, pt


def test_moller_trumbore_analytic():
    v0 = torch.tensor([[0.0, 0.0, 0.0]])
    e1 = torch.tensor([[1.0, 0.0, 0.0]])
    e2 = torch.tensor([[0.0, 1.0, 0.0]])
    o = torch.tensor([[0.25, 0.25, -1.0], [0.9, 0.9, -1.0], [0.25, 0.25, 1.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    hit, t, u, v = intersect.moller_trumbore(o, d, v0, e1, e2)
    assert hit.tolist() == [True, False, True]     # two-sided
    assert t[0].item() == 1.0 and (u[0].item(), v[0].item()) == (0.25, 0.25)


def test_moller_trumbore_matches_jax():
    verts, faces = scenes.icosphere(subdiv=2)
    jt, pt = _tri(verts, faces)
    o, d = scenes.aimed_rays(256, seed=7)
    want = [np.asarray(x) for x in jax_intersect.moller_trumbore(
        jnp.asarray(o)[:, None], jnp.asarray(d)[:, None],
        *[a[None] for a in jt])]
    got = [x.numpy() for x in intersect.moller_trumbore(
        torch.as_tensor(o)[:, None], torch.as_tensor(d)[:, None],
        *[a[None] for a in pt])]
    _, t, u, v = want
    edge = ((np.abs(u) < 1e-4) | (np.abs(v) < 1e-4)
            | (np.abs(u + v - 1) < 1e-4) | (np.abs(t - 1e-4) < 1e-4))
    assert edge.mean() < 0.01
    np.testing.assert_array_equal(got[0][~edge], want[0][~edge])
    h = want[0] & got[0]
    assert h.sum() > 200
    np.testing.assert_allclose(got[1][h], want[1][h], rtol=1e-5)
    np.testing.assert_allclose(got[2][h], want[2][h], atol=1e-4)
    np.testing.assert_allclose(got[3][h], want[3][h], atol=1e-4)


@pytest.mark.parametrize("R,t_max", [(128, np.inf), (1000, np.inf),
                                     (512, 2.5)])
def test_closest_hit_bruteforce_matches_jax(R, t_max, monkeypatch):
    # a small pair budget, so that the call walks several ray chunks
    monkeypatch.setattr(intersect, "PAIR_BUDGET", 320 * 100)
    verts, faces = scenes.icosphere(subdiv=2)
    jt, pt = _tri(verts, faces)
    o, d = scenes.aimed_rays(R)
    want = [np.asarray(x) for x in jax_intersect.closest_hit_bruteforce(
        jnp.asarray(o), jnp.asarray(d), *jt, t_max=t_max)]
    got = [x.numpy() for x in intersect.closest_hit_bruteforce(
        torch.as_tensor(o), torch.as_tensor(d), *pt, t_max=t_max)]
    assert got[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    hits = want[0] >= 0
    assert hits.mean() > (0.9 if np.isinf(t_max) else 0.01)
    assert np.isinf(got[1][~hits]).all() and not got[2][~hits].any()
    np.testing.assert_allclose(got[1][hits], want[1][hits], rtol=1e-5)
    np.testing.assert_allclose(got[2][hits], want[2][hits], atol=1e-4)
    np.testing.assert_allclose(got[3][hits], want[3][hits], atol=1e-4)


def test_closest_hit_ties_take_lowest_prim():
    """Two identical triangles: argmin keeps the first, as jnp.argmin."""
    v0 = torch.tensor([[0.0, 0.0, 0.0]] * 2)
    e1 = torch.tensor([[1.0, 0.0, 0.0]] * 2)
    e2 = torch.tensor([[0.0, 1.0, 0.0]] * 2)
    o = torch.tensor([[0.25, 0.25, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    prim, t, _, _ = intersect.closest_hit_bruteforce(o, d, v0, e1, e2)
    assert prim.tolist() == [0] and t.item() == 1.0


@pytest.mark.parametrize("per_ray", [False, True])
def test_any_hit_bruteforce_matches_jax(per_ray):
    verts, faces = scenes.icosphere(subdiv=1)
    jt, pt = _tri(verts, faces)
    o, d = scenes.aimed_rays(512)
    tm = (np.arange(512) % 3 + 1.5).astype(np.float32) if per_ray else 2.0
    want = np.asarray(jax_intersect.any_hit_bruteforce(
        jnp.asarray(o), jnp.asarray(d), *jt,
        t_max=jnp.asarray(tm)[:, None] if per_ray else tm))
    got = intersect.any_hit_bruteforce(
        torch.as_tensor(o), torch.as_tensor(d), *pt,
        t_max=torch.as_tensor(tm) if per_ray else tm).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_empty_batch():
    verts, faces = scenes.icosphere(subdiv=0)
    tri = intersect.triangle_arrays(torch.as_tensor(verts),
                                    torch.as_tensor(faces))
    o = torch.zeros((0, 3))
    prim, t, u, v = intersect.closest_hit_bruteforce(o, o, *tri)
    assert prim.shape == (0,) and prim.dtype == torch.int32
    assert intersect.any_hit_bruteforce(o, o, *tri).shape == (0,)
