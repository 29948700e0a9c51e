"""The next-hit-after query: the port's plain version against the JAX
package's Pallas kernel, the brute-force oracle and the closest-hit query.

``ops.cuda_rt.closest_hit_bvh_after`` on CPU tensors (its plain version,
``closest_hit_bvh_after_reference``) is held to
``pallas_rt.closest_hit_bvh_after(..., interpret=True)`` on the check soups
of models.scenes (a soup with an exact duplicate triangle, a coplanar grid
whose rays meet up to eight triangles at exactly t = 1, parked rays, a per-ray
t_max) and on a K-slot draw of the synthetic config-3 trace.  The blocks
carried over with ``interop.bvh_blocks_from_reference`` are held equal to the
port's own, which add the leaf table of rt.bvh.build_block_leaves (the JAX
package has none); the port walks its own, at every leaf size swept on the
card.

Tolerances.  K walks enumerate the same (t, prim) sequence: the same number
of hits a ray, t to rtol 1e-5 (XLA's CPU code contracts multiply-adds, eager
torch does not), the same set of prims; both of a tied pair present.  Both
packages enumerate in (t, slot) order, so with the same blocks even tied
hits come in the same order wherever the two t of a walk are equal bits.

The CUDA kernel against the plain version runs only on a card (marker
``cuda``):  python -m pytest --noconftest -m cuda tests/test_torch_rt_after.py
"""
import math

import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch import interop
from skybox_rt_tpu_torch.geom import cgltrace
from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.ops import cuda_rt
from skybox_rt_tpu_torch.rt import bvh as bvh_mod
from skybox_rt_tpu_torch.rt import raster_bridge, tracer

torch.set_num_threads(1)

T_MIN = 1e-6
#: the leaf sizes swept on the card (scripts/torch_rt_profile.py
#: --leaf-tris), and 4, which splits the coplanar grid's 8-slot blocks
LEAF_SIZES = (4, 8, 16, 32)


def _t(a, device="cpu"):
    return None if a is None else torch.as_tensor(np.array(a), device=device)


def _port_blocks(v0, e1, e2, tri_block, device="cpu",
                 leaf_tris=tracer.BVH_LEAF_TRIS):
    verts, faces = scenes.soup_mesh(v0, e1, e2)
    bvh = bvh_mod.build_sah(verts, faces)
    bs = bvh_mod.build_block_set(bvh, tri_block=tri_block)
    return cuda_rt.prepare_bvh_blocks(
        _t(v0, device), _t(e1, device), _t(e2, device), bs,
        bvh_mod.build_block_leaves(bvh, bs, leaf_tris))


def _enumerate(after, R, walks):
    """[(slot, prim, t, u, v) numpy] of `walks` walks fed back into each
    other, from (-inf, -1)."""
    tlo = torch.full((R,), -math.inf, dtype=torch.float32)
    slo = torch.full((R,), -1, dtype=torch.int32)
    out = []
    for _ in range(walks):
        res = after(tlo, slo)
        out.append(tuple(np.asarray(x) for x in res))
        tlo, slo = _t(out[-1][2]), _t(out[-1][0])
    return out


def _port_walks(blocks, o, d, tm, walks, device="cpu"):
    o, d, tm = _t(o, device), _t(d, device), _t(tm, device)
    return _enumerate(
        lambda tlo, slo: tuple(x.cpu() for x in cuda_rt.closest_hit_bvh_after(
            o, d, blocks, tlo.to(device), slo.to(device), t_max=tm,
            t_min=T_MIN)), o.shape[0], walks)


def _mt_all_t(o, d, v0, e1, e2):
    """(R, P) hit t (inf = miss): the brute-force enumeration oracle with
    the kernel's Möller–Trumbore bounds, in float64 from float32 inputs."""
    o, d, v0, e1, e2 = (np.asarray(a, np.float64) for a in (o, d, v0, e1, e2))
    pv = np.cross(d[:, None], e2[None])
    det = np.einsum("pk,rpk->rp", e1, pv)
    valid = np.abs(det) > 1e-9
    inv = np.where(valid, 1.0 / np.where(valid, det, 1), 0)
    tv = o[:, None] - v0[None]
    u = np.einsum("rpk,rpk->rp", tv, pv) * inv
    qv = np.cross(tv, e1[None])
    vv = np.einsum("rk,rpk->rp", d, qv) * inv
    t = np.einsum("pk,rpk->rp", e2, qv) * inv
    hit = valid & (u >= 0) & (vv >= 0) & (u + vv <= 1) & (t > T_MIN)
    return np.where(hit, t, np.inf)


def _per_ray(walks):
    """[[(t, prim), ...] a ray] of the hits of a list of walks."""
    R = walks[0][0].shape[0]
    got = [[] for _ in range(R)]
    for _, prim, t, _, _ in walks:
        for r in np.nonzero(prim >= 0)[0]:
            got[r].append((t[r], prim[r]))
    return got


@pytest.mark.parametrize("name", scenes.AFTER_CHECK_SOUPS)
def test_plain_matches_jax_pallas(name):
    import jax.numpy as jnp

    from skybox_rt_tpu.ops import pallas_rt
    from skybox_rt_tpu.rt import bvh as jax_bvh

    v0, e1, e2, tri_block, o, d, tm, walks = scenes.after_check_queries(name)
    verts, faces = scenes.soup_mesh(v0, e1, e2)
    jbs = jax_bvh.build_block_set(jax_bvh.build_sah(verts, faces),
                                  tri_block=tri_block)
    jblocks = pallas_rt.prepare_bvh_blocks(
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2), jbs)
    blocks = interop.bvh_blocks_from_reference(jblocks, "cpu")
    own = {lt: _port_blocks(v0, e1, e2, tri_block, leaf_tris=lt)
           for lt in LEAF_SIZES}
    for k in ("tri", "bcnt", "s2p", "aabb"):
        assert torch.equal(own[tracer.BVH_LEAF_TRIS][k], blocks[k]), k

    wk = pallas_rt.bvh_worklists(
        jnp.asarray(o), jnp.asarray(d), jblocks,
        t_max=None if tm is None else jnp.asarray(tm), sub=2)
    want = _enumerate(lambda tlo, slo: pallas_rt.closest_hit_bvh_after(
        jblocks, wk, jnp.asarray(tlo.numpy()), jnp.asarray(slo.numpy()),
        t_min=T_MIN, interpret=True), o.shape[0], walks)
    for lt, leafy in own.items():
        got = _port_walks(leafy, o, d, tm, walks)
        assert int((got[0][1] >= 0).sum()) > 0.2 * o.shape[0]
        assert not (got[-1][1] >= 0).any()        # the enumeration has ended
        for k, (g, w) in enumerate(zip(got, want)):
            # same hits a walk, t to rtol 1e-5, misses exactly as stated
            np.testing.assert_array_equal(g[1] < 0, w[1] < 0,
                                          err_msg=f"leaves {lt}, walk {k}")
            hit = g[1] >= 0
            np.testing.assert_allclose(g[2][hit], w[2][hit], rtol=1e-5)
            assert np.isinf(g[2][~hit]).all() and (g[0][~hit] == -1).all()
            assert not g[3][~hit].any() and not g[4][~hit].any()
            np.testing.assert_array_equal(g[0] < 0, g[1] < 0)
        for r, (gr, wr) in enumerate(zip(_per_ray(got), _per_ray(want))):
            assert {p for _, p in gr} == {p for _, p in wr}, f"ray {r}"


@pytest.mark.parametrize("leaf_tris", LEAF_SIZES)
@pytest.mark.parametrize("name", scenes.AFTER_CHECK_SOUPS)
def test_plain_enumerates_every_hit_of_the_oracle(name, leaf_tris):
    """Against the float64 all-pairs oracle: every hit once, in ascending t
    (rtol 1e-5), the same prims, tied pairs both present; parked rays and
    rays bounded before the plane miss at once."""
    v0, e1, e2, tri_block, o, d, tm, walks = scenes.after_check_queries(name)
    blocks = _port_blocks(v0, e1, e2, tri_block, leaf_tris=leaf_tris)
    got = _per_ray(_port_walks(blocks, o, d, tm, walks))
    T = _mt_all_t(o, d, v0, e1, e2)
    if tm is not None:
        T = np.where(T < tm[:, None], T, np.inf)
    P = v0.shape[0]
    ties = 0
    for r in range(o.shape[0]):
        ref = sorted((T[r, p], p) for p in range(P) if np.isfinite(T[r, p]))
        assert len(got[r]) == len(ref), f"ray {r}"
        np.testing.assert_allclose([t for t, _ in got[r]],
                                   [t for t, _ in ref], rtol=1e-5, atol=1e-6)
        assert {p for _, p in got[r]} == {p for _, p in ref}
        ts = [t for t, _ in got[r]]
        assert ts == sorted(ts)
        ties += len(ts) - len(set(ts))
    assert ties > 0
    if name == "duplicate_soup":
        both = [r for r in range(o.shape[0]) if np.isfinite(T[r, 5])]
        assert both and all({5, 20} <= {p for _, p in got[r]} for r in both)
        assert not any(got[r] for r in range(0, o.shape[0], 5))   # parked
    else:
        assert max(len(g) for g in got) >= 8     # a vertex of both layers


@pytest.mark.parametrize("name", scenes.AFTER_CHECK_SOUPS)
def test_first_walk_is_the_closest_hit_and_a_miss_feeds_back(name):
    v0, e1, e2, tri_block, o, d, tm, _ = scenes.after_check_queries(name)
    blocks = _port_blocks(v0, e1, e2, tri_block)
    R = o.shape[0]
    first = _port_walks(blocks, o, d, tm, 1)[0]
    want = cuda_rt.closest_hit_bvh_reference(_t(o), _t(d), blocks, _t(tm),
                                             T_MIN)
    for g, w in zip(first[1:], want):
        np.testing.assert_array_equal(g, w.numpy())
    # any order of the blocks gives the same bits
    rev = cuda_rt.closest_hit_bvh_after_reference(
        _t(o), _t(d), blocks, torch.full((R,), -math.inf),
        torch.full((R,), -1, dtype=torch.int32), _t(tm), T_MIN,
        block_order=range(blocks["num_blocks"] - 1, -1, -1))
    for g, w in zip(first, rev):
        np.testing.assert_array_equal(g, w.numpy())
    # a miss fed back is a miss, and so is the carry (+inf, anything); such
    # a ray is not walked at all (the kernel's early exit)
    for s_lo in (-1, 7):
        stats = {}
        miss = cuda_rt.closest_hit_bvh_after_reference(
            _t(o), _t(d), blocks, torch.full((R,), math.inf),
            torch.full((R,), s_lo, dtype=torch.int32), _t(tm), T_MIN,
            stats=stats)
        assert (miss[0] == -1).all() and (miss[1] == -1).all()
        assert torch.isinf(miss[2]).all()
        assert not miss[3].any() and not miss[4].any()
        assert not any(stats.values()), stats
    # a carry of +inf on some rays: the others' next hits are unchanged
    ended = torch.arange(R) % 2 == 0
    tlo = torch.where(ended, math.inf, -math.inf)
    part = cuda_rt.closest_hit_bvh_after(
        _t(o), _t(d), blocks, tlo, torch.full((R,), -1, dtype=torch.int32),
        t_max=_t(tm), t_min=T_MIN)
    for g, w in zip(part, first):
        np.testing.assert_array_equal(g[~ended].numpy(), w[~ended.numpy()])
    slot, prim, t, u, v = (x[ended] for x in part)
    assert (slot == -1).all() and (prim == -1).all() and torch.isinf(t).all()
    assert not u.any() and not v.any()
    with pytest.raises(ValueError, match="carry"):
        cuda_rt.closest_hit_bvh_after(
            _t(o), _t(d), blocks, torch.zeros(R), torch.zeros(R))


def test_plain_matches_jax_on_a_trace_draw():
    """The translucent shell of the config-3 trace (draw 2, 5,080 triangles
    in blocks of 64) at 24x24: three walks (two fragments a ray and the
    probe) against the JAX kernel, as above."""
    import jax.numpy as jnp

    from skybox_rt_tpu.ops import pallas_rt

    trace = cgltrace.load_trace(cgltrace.trace_path("synth_config3"))
    size = 24
    geo = raster_bridge._screen_triangles(trace.drawcalls[2], size, size)
    tri = raster_bridge._persp_tris(geo)
    blocks = raster_bridge._engine_prep(tri, "pallas_bvh", "cpu")["blocks"]
    _, _, nx, ny = raster_bridge.pixel_rays(size, size, "cpu")
    d = torch.stack([nx, ny, torch.ones_like(nx)], -1)
    o = torch.zeros_like(d)
    got = _port_walks(blocks, o.numpy(), d.numpy(), None, 3)

    from skybox_rt_tpu.rt import raster_bridge as jax_rb
    jblocks = jax_rb._engine_prep(tri, "pallas_bvh")["blocks"]
    carried = interop.bvh_blocks_from_reference(jblocks, "cpu")
    for k in ("tri", "bcnt", "s2p", "aabb"):
        assert torch.equal(carried[k], blocks[k]), k
    wk = pallas_rt.bvh_worklists(jnp.asarray(o.numpy()),
                                 jnp.asarray(d.numpy()), jblocks, sub=2)
    want = _enumerate(lambda tlo, slo: pallas_rt.closest_hit_bvh_after(
        jblocks, wk, jnp.asarray(tlo.numpy()), jnp.asarray(slo.numpy()),
        t_min=T_MIN, interpret=True), o.shape[0], 3)
    hits = [int((g[1] >= 0).sum()) for g in got]
    assert hits[0] > 100 and hits[1] > 100 and hits[2] == 0, hits
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1] < 0, w[1] < 0)
        hit = g[1] >= 0
        np.testing.assert_allclose(g[2][hit], w[2][hit], rtol=1e-5)
        same = hit & (g[1] == w[1])
        assert same.sum() >= 0.99 * hit.sum()
        np.testing.assert_allclose(g[3][same], w[3][same], atol=1e-4)
        np.testing.assert_allclose(g[4][same], w[4][same], atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_tris", LEAF_SIZES)
@pytest.mark.parametrize("name", scenes.AFTER_CHECK_SOUPS)
def test_cuda_kernel_matches_plain(name, leaf_tris):
    """Every walk, past the end of every ray's list, bit-equal to the plain
    version at every leaf size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no interpret mode")
    v0, e1, e2, tri_block, o, d, tm, walks = scenes.after_check_queries(name)
    blocks = _port_blocks(v0, e1, e2, tri_block, "cuda", leaf_tris)
    got = _port_walks(blocks, o, d, tm, walks, "cuda")
    want = _port_walks(_port_blocks(v0, e1, e2, tri_block,
                                    leaf_tris=leaf_tris), o, d, tm, walks)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
