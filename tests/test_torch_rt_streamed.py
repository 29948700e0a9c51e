"""The streamed and worklist closest-hit queries (the comparison engines
``pallas_streamed`` / ``pallas_worklist``): the port's plain versions against
the JAX package's Pallas kernels, the worklist's prepass against the JAX
prepass, and both engines' frames against the clustered frame.

``ops.cuda_rt.closest_hit_streamed`` / ``closest_hit_worklist`` on CPU tensors
(their plain versions) are held to ``pallas_rt.closest_hit_streamed`` /
``closest_hit_worklist`` run as the JAX package's own tests run them on the
CPU (``interpret=True``), on the scenes of tests/test_pallas_rt.py, with and
without ``order`` and ``t_max``.

Tolerances.  Miss masks: equal.  t: rtol 1e-5 (XLA's CPU code contracts
multiply-adds, eager torch does not).  Prims: the JAX kernels keep the first
of equal-t hits in their block order, the port the lowest slot, so prims may
differ on ties only: where they differ the two t agree to rtol 1e-5, on under
1 % of the hits.  u, v: atol 1e-4 where the prims agree.  Within the port the
two queries, their either list order and the clustered query run the same
arithmetic under the same tie rule: equal bit for bit.  Against the flat query
(lowest prim id) the check is models.scenes.check_clustered_equals_flat.

The kernels' lanes: a warp of 32 consecutive rays tests an entered block's
triangles a ray a lane, or across its lanes one ray at a time when fewer than
``STREAM_LANE_SWITCH`` of its rays enter.  The plain versions count that work
by warps (``cuda_rt._count_lanes``); the counts are held to the per-ray ones.

The CUDA kernels against the plain versions run only on a card (marker
``cuda``):  python -m pytest --noconftest -m cuda tests/test_torch_rt_streamed.py
"""
import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.ops import cuda_rt
from skybox_rt_tpu_torch.rt import bvh as bvh_mod
from skybox_rt_tpu_torch.rt import intersect, tracer, wavefront

torch.set_num_threads(1)

# name -> (mesh maker, its arguments, use the treelet order, tri_block,
#          rays, ray seed, t_max)
CASES = {
    "ico3_order": (scenes.icosphere, dict(subdiv=3), True, 64, 1500, 21, None),
    "ico1_no_order_tmax": (scenes.icosphere, dict(subdiv=1), False, 64, 300,
                           23, 2.0),
    "multi4_order_tmax": (scenes.multi_sphere, dict(n=4, subdiv=2), True, 24,
                          900, 29, 3.0),
}


def _case(name, device="cpu"):
    maker, kw, ordered, tri_block, R, seed, tm = CASES[name]
    verts, faces = maker(**kw)
    faces = np.asarray(faces, np.int64)
    o, d = scenes.aimed_rays(R, seed=seed)
    if name == "multi4_order_tmax":
        o, d, _ = scenes.parked(o, d, 6)
    bvh = bvh_mod.build(verts, faces)
    clusters = bvh_mod.build_clusters(bvh, max_tris=64)
    tri = intersect.triangle_arrays(torch.as_tensor(verts, device=device),
                                    torch.as_tensor(faces, device=device))
    stream = cuda_rt.prepare_stream_blocks(
        *tri, order=clusters["order"] if ordered else None,
        tri_block=tri_block)
    tmax = None if tm is None else torch.full((R,), tm, device=device)
    return (verts, faces, clusters, tri, stream,
            torch.as_tensor(o, device=device),
            torch.as_tensor(d, device=device), tmax)


def _np(res):
    return [x.cpu().numpy() for x in res]


def _tie_aware(got, want):
    """got against a JAX (prim, t, u, v): see the module docstring."""
    p, t, u, v = got
    p_w, t_w, u_w, v_w = want
    np.testing.assert_array_equal(p < 0, p_w < 0)
    hits = p >= 0
    assert hits.any()
    assert np.isinf(t[~hits]).all() and not u[~hits].any()
    np.testing.assert_allclose(t[hits], t_w[hits], rtol=1e-5)
    same = hits & (p == p_w)
    np.testing.assert_allclose(u[same], u_w[same], atol=1e-4)
    np.testing.assert_allclose(v[same], v_w[same], atol=1e-4)
    ties = hits & (p != p_w)
    assert ties.sum() < 0.01 * hits.sum()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("query", ["streamed", "worklist"])
def test_plain_matches_jax_pallas(name, query):
    import jax.numpy as jnp

    from skybox_rt_tpu.ops import pallas_rt
    from skybox_rt_tpu.rt import intersect as jax_intersect

    verts, faces, clusters, _, stream, o, d, tmax = _case(name)
    ordered = CASES[name][2]
    jtri = jax_intersect.triangle_arrays(jnp.asarray(verts),
                                         jnp.asarray(faces))
    jax_query = (pallas_rt.closest_hit_streamed if query == "streamed"
                 else pallas_rt.closest_hit_worklist)
    want = [np.asarray(x) for x in jax_query(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), *jtri,
        order=clusters["order"] if ordered else None,
        t_max=None if tmax is None else jnp.asarray(tmax.numpy()),
        interpret=True)]
    port_query = (cuda_rt.closest_hit_streamed if query == "streamed"
                  else cuda_rt.closest_hit_worklist)
    got = _np(port_query(o, d, stream, t_max=tmax))
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    _tie_aware(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_queries_agree_bit_for_bit_within_the_port(name):
    """Streamed == worklist (near to far and ascending) == clustered, every
    output; against the flat query tie-aware; against brute force on t."""
    _, _, clusters, tri, stream, o, d, tmax = _case(name)
    streamed = _np(cuda_rt.closest_hit_streamed(o, d, stream, t_max=tmax))
    for f2b in (True, False):
        work = _np(cuda_rt.closest_hit_worklist(o, d, stream, t_max=tmax,
                                                front_to_back=f2b))
        for a, b in zip(streamed, work):
            np.testing.assert_array_equal(a, b)
    flat = _np(cuda_rt.closest_hit_pallas(o, d, cuda_rt.pack_records(*tri),
                                          t_max=tmax))
    scenes.check_clustered_equals_flat(streamed, flat)
    if CASES[name][2]:
        # the clustered query over the same order: the same slots, so the
        # same winner among equal t
        clustered = _np(cuda_rt.closest_hit_clustered(
            o, d, cuda_rt.prepare_clusters(*tri, clusters), t_max=tmax))
        for a, b in zip(streamed, clustered):
            np.testing.assert_array_equal(a, b)
    else:
        # without an order a slot is a prim id: the flat query's own rule
        for a, b in zip(streamed, flat):
            np.testing.assert_array_equal(a, b)
    stats = {}
    cuda_rt.closest_hit_streamed_reference(o, d, stream, tmax, stats=stats)
    wstats = {}
    lists = cuda_rt.active_block_lists(o, d, stream, tmax)
    cuda_rt.closest_hit_worklist_reference(o, d, stream, *lists, tmax,
                                           stats=wstats)
    # the lists spare slab tests, never triangle tests that matter
    assert wstats["slab_tests"] <= stats["slab_tests"]
    assert stats["slab_tests"] == o.shape[0] * stream["num_blocks"]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("front_to_back", [True, False])
def test_prepass_lists_match_jax(name, front_to_back):
    """active_block_lists against pallas_rt._active_block_lists on the same
    ray tiles (128 rays, as one (1, 128) tile row) and the same block boxes:
    the same counts and, as sets, the same active blocks a tile; in ascending
    mode the same order too."""
    import jax.numpy as jnp

    from skybox_rt_tpu.ops import pallas_rt

    _, _, _, _, stream, o, d, tmax = _case(name)
    R, T = o.shape[0], cuda_rt.STREAM_RAY_TILE
    G = -(-R // T)
    lists, counts = cuda_rt.active_block_lists(o, d, stream, tmax,
                                               front_to_back)
    assert lists.shape == (G, stream["num_blocks"]) and counts.shape == (G,)

    def tiles(a, fill):
        a = np.concatenate([a, np.full((G * T - R,), fill, np.float32)])
        return jnp.asarray(a.reshape(G, 1, T))

    park_o, park_d = 3e7, 0.57735       # what the JAX wrapper pads with
    rays = ([tiles(o[:, k].numpy(), park_o) for k in range(3)]
            + [tiles(d[:, k].numpy(), park_d) for k in range(3)])
    far = tiles(np.full((R,), np.inf, np.float32) if tmax is None
                else tmax.numpy(), np.inf)
    aabb8 = np.zeros((stream["num_blocks"], 8), np.float32)
    aabb8[:, :6] = stream["aabb"].numpy()
    jl, jc = pallas_rt._active_block_lists(rays, jnp.asarray(aabb8), far,
                                           front_to_back=front_to_back)
    jl, jc = np.asarray(jl), np.asarray(jc)
    np.testing.assert_array_equal(counts.numpy(), jc)
    assert jc.sum() > 0
    if name == "multi4_order_tmax":     # parked rays and many small blocks
        assert jc.sum() < 0.8 * G * stream["num_blocks"]
    for g in range(G):
        mine, theirs = lists[g, :jc[g]].numpy(), jl[g, :jc[g]]
        assert set(mine) == set(theirs), f"tile {g}"
        if not front_to_back:
            np.testing.assert_array_equal(mine, theirs)


def test_short_last_block_and_empty_lists():
    """P not a multiple of tri_block; a batch of parked rays only: every
    list is empty and every ray misses."""
    _, _, _, tri, _, o, d, _ = _case("ico1_no_order_tmax")
    stream = cuda_rt.prepare_stream_blocks(*tri, tri_block=48)
    assert stream["num_blocks"] == 2 and stream["num_prims"] == 80
    a = _np(cuda_rt.closest_hit_streamed(o, d, stream))
    b = _np(cuda_rt.closest_hit_worklist(o, d, stream))
    flat = _np(cuda_rt.closest_hit_pallas(o, d, cuda_rt.pack_records(*tri)))
    for x, y, z in zip(a, b, flat):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert (a[0] >= 0).mean() > 0.3
    po = torch.full_like(o, 3e7)
    pd = torch.full_like(d, 0.57735)
    lists, counts = cuda_rt.active_block_lists(po, pd, stream)
    assert int(counts.sum()) == 0
    assert (cuda_rt.closest_hit_worklist(po, pd, stream)[0] == -1).all()
    assert (cuda_rt.closest_hit_streamed(po, pd, stream)[0] == -1).all()
    with pytest.raises(ValueError, match="tri_block"):
        cuda_rt.prepare_stream_blocks(*tri, tri_block=1024)


def _lane_stats(name, query, switch, monkeypatch):
    *_, stream, o, d, tmax = _case(name)
    monkeypatch.setattr(cuda_rt, "STREAM_LANE_SWITCH", switch)
    stats = {}
    if query == "streamed":
        cuda_rt.closest_hit_streamed_reference(o, d, stream, tmax,
                                               stats=stats)
    else:
        cuda_rt.closest_hit_worklist_reference(
            o, d, stream, *cuda_rt.active_block_lists(o, d, stream, tmax),
            tmax, stats=stats)
    return stats


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("query", ["streamed", "worklist"])
def test_lane_counts_equal_the_per_ray_counts(name, query, monkeypatch):
    """Counted by warps, the useful lane-steps are the per-ray triangle
    tests; a ray a lane on every visit (switch 0) runs the earlier design's
    lane-steps, and the switch only ever spares lanes."""
    by_switch = {sw: _lane_stats(name, query, sw, monkeypatch)
                 for sw in (0, cuda_rt.STREAM_LANE_SWITCH, 33)}
    for sw, st in by_switch.items():
        assert st["warp_tri_tests"] == st["tri_tests"] > 0, sw
        assert st["tri_tests"] <= st["lane_steps"] <= st["lane_steps_ray"]
        for k in ("slab_tests", "slab_pass", "tri_tests", "warp_visits",
                  "lane_steps_ray"):
            assert st[k] == by_switch[0][k], (sw, k)
    assert by_switch[0]["lane_steps"] == by_switch[0]["lane_steps_ray"]
    assert by_switch[33]["lane_steps"] < by_switch[0]["lane_steps"]


def test_lane_counts_by_hand():
    """Two warps: rays 0-2 and 40 enter a block of 40 triangles, rays 3 and
    41-63 a block of 10."""
    stats = {}
    cuda_rt._count_lanes(stats, torch.tensor([0, 1, 2, 40]),
                         torch.tensor([40, 40, 40, 40]))
    cuda_rt._count_lanes(stats, torch.tensor([3] + list(range(41, 64))), 10)
    S = cuda_rt.STREAM_LANE_SWITCH
    assert 1 < S <= 23
    # warp 0: 3 rays of 40 (2 passes each), then 1 of 10; warp 1: 1 of 40,
    # then 23 of 10 (a ray a lane)
    assert stats == {"warp_visits": 4,
                     "warp_tri_tests": 3 * 40 + 10 + 40 + 23 * 10,
                     "lane_steps_ray": 32 * (40 + 10 + 40 + 10),
                     "lane_steps": 32 * (3 * 2 + 1 + 2) + 32 * 10}


@pytest.mark.parametrize("engine", ["pallas_streamed", "pallas_worklist"])
def test_engine_frame_equals_the_clustered_frame(engine):
    """make_frame_fn at 64x64, 2 bounces, shadows: the comparison engines
    render the default engine's image.  Equal hits give equal bits; the
    occlusion query is the closest hit inside the bound, so a shadow ray can
    only differ where a hit lies exactly at a bound: atol 0 is asserted."""
    verts, faces, colors = scenes.sphere_field(copies=4, subdiv=2)
    scene = tracer.RTScene(verts=verts, faces=faces, colors=colors,
                           reflectivity=0.35)
    cam = tracer.Camera(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0),
                        fov_y_deg=55.0)
    kw = dict(width=64, height=64, bounces=2, shadows=True)
    base_fn, (o, d) = tracer.make_frame_fn(scene, cam, tracer.RTConfig(**kw),
                                           device="cpu")
    base = base_fn(o, d).numpy()
    frame, (o2, d2) = tracer.make_frame_fn(
        scene, cam, tracer.RTConfig(engine=engine, **kw), device="cpu")
    # tile order, as for every engine whose name starts with "pallas"
    perm, _ = wavefront.tile_order_perm(64, 64, 32)
    assert torch.equal(o2, tracer.camera_rays(cam, 64, 64, "cpu")[0][perm])
    assert torch.equal(o2, o) and torch.equal(d2, d)
    img = frame(o2, d2).numpy()
    assert (img[..., :3].sum(-1) > 0).mean() > 0.2
    np.testing.assert_array_equal(img, base)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernels_match_plain(name, monkeypatch):
    """Both kernels against their plain versions, every output bit for bit:
    at the case's tri_block and at 1, 63, 64 and 48 (a short last block),
    with the lane switch at 0 (a ray a lane), the shipped value and 33
    (triangles across lanes for every block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    *_, tri, stream0, o, d, tmax = _case(name, "cuda")
    order = stream0["order"]
    for tri_block in (stream0["tri_block"], 1, 63, 64, 48):
        stream = cuda_rt.prepare_stream_blocks(
            *tri, order=None if order is None else order.cpu().numpy(),
            tri_block=tri_block)
        want = cuda_rt.closest_hit_streamed_reference(o, d, stream, tmax)
        lists = cuda_rt.active_block_lists(o, d, stream, tmax)
        want_w = cuda_rt.closest_hit_worklist_reference(o, d, stream,
                                                        *lists, tmax)
        for switch in (0, cuda_rt.STREAM_LANE_SWITCH, 33):
            monkeypatch.setattr(cuda_rt, "STREAM_LANE_SWITCH", switch)
            got = cuda_rt.closest_hit_streamed(o, d, stream, t_max=tmax)
            got_w = cuda_rt.closest_hit_worklist(o, d, stream, t_max=tmax,
                                                 lists=lists)
            torch.cuda.synchronize()
            for a, b, c, e in zip(got, want, got_w, want_w):
                assert torch.equal(a, b) and torch.equal(c, e) \
                    and torch.equal(a, c), (tri_block, switch)
