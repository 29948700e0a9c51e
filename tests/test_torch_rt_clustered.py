"""The small-scene ray queries: the port's clusters and plain versions against
the JAX package, and the CUDA kernels against the plain versions.

``rt.bvh.build_clusters`` is held to the JAX package's by array equality on a
JAX-built BVH carried over with ``interop``.  ``ops.cuda_rt``'s
``closest_hit_clustered`` / ``any_hit_clustered`` / ``closest_hit_pallas`` /
``any_hit_pallas`` (on the CPU: their ``*_reference`` plain versions) are held
to ``pallas_rt``'s kernels of the same names, run as the JAX package's own
tests run them on the CPU (``interpret=True``), on the cases of
tests/test_pallas_rt.py and on ``models.scenes.CLUSTER_CHECK_SCENES``; the
clusters are carried over with ``interop.clusters_from_reference``.  The
clustered closest hit meets groups of clusters, then their clusters, in a
two-level order (``ops.cuda_rt.cluster_groups``); it is held to JAX at every
group size of ``GROUP_SIZES``.

Tolerances.  Miss masks and occlusion: equal (the JAX kernel gates a cluster
for a whole 1,024-ray tile, the port for each ray; no ray of these cases
differs, and none may).  t: rtol 1e-5.  u, v: atol 1e-4 where the prims agree
(XLA's CPU code contracts multiply-adds and eager torch does not; see
tests/test_torch_rt_kernels.py).  Prims: the clustered Pallas kernel keeps the
first of equal-t hits in its tile's visit order, the port the lowest slot, so
prims may differ on ties only: where they differ the two t agree to rtol 1e-5
and such rays are under 1 % of the hits.  The flat query's rule (lowest prim
id) is the same in both packages, but a hit across a shared edge may still
flip where the two packages' t differ in the last bits, so it gets the same
check.  Against the port's own all-pairs oracle the flat plain version is
exactly equal, and the clustered one equal in t wherever the prims agree.

The CUDA kernels against the plain versions run only on a card (marker
``cuda``):  python -m pytest --noconftest -m cuda tests/test_torch_rt_clustered.py
"""
import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch import interop
from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.ops import cuda_rt
from skybox_rt_tpu_torch.rt import bvh as bvh_mod
from skybox_rt_tpu_torch.rt import intersect

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

MESHES = {
    "ico2": lambda: scenes.icosphere(subdiv=2),
    "ico3": lambda: scenes.icosphere(subdiv=3),
    "multi4": lambda: scenes.multi_sphere(n=4, subdiv=2),
}
QUERIES = [(name, q) for name in sorted(scenes.CLUSTER_CHECK_SCENES)
           for q in range(len(scenes.cluster_check_queries(name)[3]))]
#: clusters a group: the sizes swept on the card (scripts/torch_rt_profile.py
#: --cluster-group), 1 (a group a cluster: the one-level order) and 3 (a
#: short last group)
GROUP_SIZES = (1, 3, 4, 8, 16)


def _t(a, device="cpu"):
    if a is None or np.ndim(a) == 0:
        return a
    return torch.as_tensor(a, device=device)


def _port_scene(verts, faces, max_tris, device="cpu", group=None):
    """(tri arrays, clusters dict, flat records) built by the port alone."""
    tri = intersect.triangle_arrays(
        torch.as_tensor(verts, device=device),
        torch.as_tensor(np.asarray(faces, np.int64), device=device))
    clusters = cuda_rt.prepare_clusters(
        *tri, bvh_mod.build_clusters(bvh_mod.build(verts, faces), max_tris),
        group=group)
    return tri, clusters, cuda_rt.pack_records(*tri)


def _jax_scene(verts, faces, max_tris):
    """(JAX tri arrays, JAX clusters, the port's clusters carried over, the
    port's flat records)."""
    import jax.numpy as jnp

    from skybox_rt_tpu.rt import bvh as jax_bvh
    from skybox_rt_tpu.rt import intersect as jax_intersect

    jtri = jax_intersect.triangle_arrays(jnp.asarray(verts),
                                         jnp.asarray(faces))
    jcl = jax_bvh.build_clusters(jax_bvh.build(verts, faces),
                                 max_tris=max_tris)
    ntri = [np.asarray(a) for a in jtri]
    clusters = interop.clusters_from_reference(jcl, *ntri, "cpu")
    flat = cuda_rt.pack_records(*(torch.from_numpy(a.copy()) for a in ntri))
    return jtri, jcl, clusters, flat


def _check_closest(got, want, min_hits):
    """The tolerances of the module docstring; returns the hit mask."""
    p, t, u, v = (x.numpy() for x in got)
    p_w, t_w, u_w, v_w = (np.asarray(x) for x in want)
    assert p.dtype == np.int32 and t.dtype == np.float32
    np.testing.assert_array_equal(p < 0, p_w < 0)
    hits = p >= 0
    assert hits.mean() >= min_hits
    assert np.isinf(t[~hits]).all()
    assert not u[~hits].any() and not v[~hits].any()
    np.testing.assert_allclose(t[hits], t_w[hits], rtol=1e-5)
    same = hits & (p == p_w)
    np.testing.assert_allclose(u[same], u_w[same], atol=1e-4)
    np.testing.assert_allclose(v[same], v_w[same], atol=1e-4)
    ties = hits & (p != p_w)
    assert ties.sum() <= 0.01 * hits.sum()
    np.testing.assert_allclose(t[ties], t_w[ties], rtol=1e-5)
    return hits


@pytest.mark.parametrize("max_tris", [32, 64])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_build_clusters_equal_jax(mesh, max_tris):
    from skybox_rt_tpu.rt import bvh as jax_bvh

    verts, faces = MESHES[mesh]()
    jbvh = jax_bvh.build(verts, faces)
    want = jax_bvh.build_clusters(jbvh, max_tris=max_tris)
    got = bvh_mod.build_clusters(interop.bvh_from_reference(jbvh), max_tris)
    assert sorted(got) == sorted(want) == ["aabb", "count", "first", "order"]
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["count"].max() <= max_tris and len(got["first"]) > 1
    # the ranges tile [0, P) and the port's own BVH gives the same clusters
    spans = sorted(zip(got["first"].tolist(), got["count"].tolist()))
    assert [f for f, _ in spans] == \
        np.cumsum([0] + [c for _, c in spans])[:-1].tolist()
    own = bvh_mod.build_clusters(bvh_mod.build(verts, faces), max_tris)
    for k in want:
        np.testing.assert_array_equal(own[k], want[k], err_msg=k)


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("aimed", [True, False])
@pytest.mark.parametrize("R", [128, 1000])   # aligned + ragged batch
def test_flat_closest_matches_jax(R, aimed, bounded):
    import jax.numpy as jnp

    from skybox_rt_tpu.ops import pallas_rt

    verts, faces = scenes.icosphere(subdiv=2)
    jtri, _, _, flat = _jax_scene(verts, faces, 64)
    o, d = scenes.aimed_rays(R, seed=3, aimed=aimed)
    tm = (np.random.default_rng(7).uniform(1.0, 4.0, size=R)
          .astype(np.float32) if bounded else None)
    want = pallas_rt.closest_hit_pallas(
        jnp.asarray(o), jnp.asarray(d), *jtri,
        t_max=None if tm is None else jnp.asarray(tm), interpret=True)
    got = cuda_rt.closest_hit_pallas(_t(o), _t(d), flat, t_max=_t(tm))
    hits = _check_closest(got, want, 0.0)
    if aimed and not bounded:
        assert hits.mean() > 0.9
    if not aimed:
        assert (~hits).any()
    if bounded:
        assert (got[1].numpy()[hits] < tm[hits]).all()
    # the port's all-pairs oracle: exactly equal
    tri = intersect.triangle_arrays(torch.as_tensor(verts),
                                    torch.as_tensor(faces).long())
    oracle = intersect.closest_hit_bruteforce(
        _t(o), _t(d), *tri, t_max=np.inf if tm is None else _t(tm))
    for g, w in zip(got, oracle):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _regrouped(clusters, jcl, group):
    """The carried-over clusters cut into groups of ``group`` (None: as
    they are)."""
    if group is None:
        return clusters
    return cuda_rt.pack_clusters(
        clusters["tri"], np.asarray(jcl["aabb"]), np.asarray(jcl["first"]),
        np.asarray(jcl["count"]), np.asarray(jcl["order"]), "cpu",
        group=group)


@pytest.mark.parametrize("name,q", QUERIES)
def test_queries_match_jax(name, q):
    """Every query of the check scenes through the clustered and the flat
    query of both packages."""
    import jax.numpy as jnp

    from skybox_rt_tpu.ops import pallas_rt

    verts, faces, max_tris, queries = scenes.cluster_check_queries(name)
    label, kind, oq, dq, tm = queries[q]
    jtri, jcl, clusters, flat = _jax_scene(verts, faces, max_tris)
    # what was carried over equals what the port builds itself
    tri, own, own_flat = _port_scene(verts, faces, max_tris)
    for k in ("tri", "table", "visit", "group_table", "group_visit", "order"):
        assert torch.equal(own[k], clusters[k]), k
    assert torch.equal(own_flat, flat)
    jo, jd = jnp.asarray(oq), jnp.asarray(dq)
    jtm = tm if tm is None or np.ndim(tm) == 0 else jnp.asarray(tm)

    if kind == "any":
        want = np.asarray(pallas_rt.any_hit_clustered(
            jo, jd, *jtri, jcl, t_max=jtm, interpret=True))
        want_flat = np.asarray(pallas_rt.any_hit_pallas(
            jo, jd, *jtri, t_max=jtm, interpret=True))
        got_flat = cuda_rt.any_hit_pallas(_t(oq), _t(dq), flat, t_max=_t(tm))
        oracle = intersect.any_hit_bruteforce(
            _t(oq), _t(dq), *tri,
            t_max=tm if np.ndim(tm) == 0 else _t(tm)[:, None])
        assert got_flat.dtype == torch.bool
        np.testing.assert_array_equal(got_flat.numpy(), want_flat)
        assert torch.equal(got_flat, oracle)
        # the clustered query at every group size (the default one carried
        # over from JAX): it gates groups, then their clusters
        for group in (None,) + GROUP_SIZES:
            got = cuda_rt.any_hit_clustered(
                _t(oq), _t(dq), _regrouped(clusters, jcl, group),
                t_max=_t(tm))
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(got.numpy(), want)
            assert torch.equal(got, oracle)
            assert 0 < got.float().mean() < 1
        return

    want = pallas_rt.closest_hit_clustered(jo, jd, *jtri, jcl, t_max=jtm,
                                           interpret=True)
    want_flat = pallas_rt.closest_hit_pallas(jo, jd, *jtri, t_max=jtm,
                                             interpret=True)
    got_flat = cuda_rt.closest_hit_pallas(_t(oq), _t(dq), flat, t_max=_t(tm))
    min_hits = {("ico3_c64", "unbounded"): 0.9, ("ico3_c64", "parked"): 0.6,
                ("multi4_c32", "unbounded"): 0.2}.get((name, label), 0.05)
    _check_closest(got_flat, want_flat, min_hits)
    # the clustered query at every group size (the default one carried over
    # from JAX): the groups change the order in which clusters are met
    for group in (None,) + GROUP_SIZES:
        got = cuda_rt.closest_hit_clustered(
            _t(oq), _t(dq), _regrouped(clusters, jcl, group), t_max=_t(tm))
        hits = _check_closest(got, want, min_hits)
        if label == "parked":
            park = np.arange(oq.shape[0]) % 3 == 0
            assert not hits[park].any()
        if label == "axis_parallel":
            assert (dq == 0).any(axis=1).mean() > 0.6 and hits.any()
            assert not torch.isnan(torch.stack(got[1:])).any()
        # the clustered query against the port's flat one: the same
        # arithmetic, so wherever the prims agree every output is exactly
        # equal; where they differ the hit is a tie across clusters
        ties = scenes.check_clustered_equals_flat(
            [x.numpy() for x in got], [x.numpy() for x in got_flat])
        assert ties <= 0.01 * hits.sum()


def _two_clusters():
    """The same triangle at slots 1 and 2, in two clusters, and a farther
    one at slot 0; slot -> prim is (7, 5, 3)."""
    tri_a = [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    tri_far = [0.0, 0.0, -1.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    rows = torch.zeros((3, cuda_rt.RECORD_WIDTH))
    rows[:, :9] = torch.tensor([tri_far, tri_a, tri_a])
    box = np.array([[0, 0, -1, 1, 1, 0, 0, 0], [0, 0, 0, 1, 1, 0, 0, 0]],
                   np.float32)
    return cuda_rt.pack_clusters(rows, box, [0, 2], [2, 1], [7, 5, 3], "cpu")


def test_tie_rules():
    """Clustered: of two coplanar duplicates the lower slot wins for rays of
    either octant (they meet the clusters in opposite orders).  Flat: the
    lower prim id wins."""
    clusters = _two_clusters()
    assert clusters["visit"].shape == (8, 2)
    assert clusters["visit"][0].tolist() != clusters["visit"][7].tolist()
    o = torch.tensor([[0.25, 0.25, 1.0], [0.25, 0.25, -2.0],
                      [0.25, 0.25, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    p, t, u, v = cuda_rt.closest_hit_clustered(o, d, clusters)
    assert p.tolist() == [5, 7, -1]
    assert t.tolist()[:2] == [1.0, 1.0] and np.isinf(t[2].item())
    assert (u[0].item(), v[0].item()) == (0.25, 0.25)
    assert (u[2].item(), v[2].item()) == (0.0, 0.0)
    assert cuda_rt.any_hit_clustered(o, d, clusters, t_max=1.5).tolist() == \
        [True, True, False]
    assert cuda_rt.any_hit_clustered(o, d, clusters, t_max=1.0).tolist() == \
        [False, False, False]
    p, t, _, _ = cuda_rt.closest_hit_pallas(o, d, clusters["tri"])
    assert p.tolist() == [1, 0, -1] and t.tolist()[:2] == [1.0, 1.0]
    assert cuda_rt.any_hit_pallas(o, d, clusters["tri"],
                                  t_max=1.5).tolist() == [True, True, False]


def test_visit_table_is_near_to_far():
    verts, faces = scenes.multi_sphere(n=4, subdiv=2)
    cl = bvh_mod.build_clusters(bvh_mod.build(verts, faces), 32)
    visit = cuda_rt.octant_visit_table(cl["aabb"])
    C = len(cl["first"])
    assert visit.shape == (8, C) and visit.dtype == np.int32
    cen = (cl["aabb"][:, 0:3] + cl["aabb"][:, 3:6]) * 0.5
    for octant in range(8):
        assert sorted(visit[octant].tolist()) == list(range(C))
        sign = np.array([1.0 if octant & (1 << k) else -1.0
                         for k in range(3)])
        assert (np.diff(cen[visit[octant]] @ sign) >= -1e-6).all()
    # opposite octants start at opposite ends of the scene
    assert visit[0][0] == visit[7][-1] and visit[0][-1] == visit[7][0]


def _mesh_clusters(mesh, group):
    verts, faces = MESHES[mesh]()
    cl = bvh_mod.build_clusters(bvh_mod.build(verts, faces), 32)
    rows = torch.zeros((len(cl["order"]), cuda_rt.RECORD_WIDTH))
    return cl, cuda_rt.pack_clusters(rows, cl["aabb"], cl["first"],
                                     cl["count"], cl["order"], "cpu",
                                     group=group)


def _centre_keys(box):
    """(8, n) float32: each box's centre on each octant's sign vector, as
    octant_visit_table computes it."""
    box = np.asarray(box, np.float32)
    cen = (box[:, 0:3] + box[:, 3:6]) * np.float32(0.5)
    signs = np.array([[1.0 if q & (1 << k) else -1.0 for k in range(3)]
                      for q in range(8)], np.float32)
    return np.stack([s[0] * cen[:, 0] + s[1] * cen[:, 1] + s[2] * cen[:, 2]
                     for s in signs])


@pytest.mark.parametrize("group", GROUP_SIZES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_group_boxes_hold_their_clusters(mesh, group):
    """A group is ``group`` consecutive clusters (the last may be shorter);
    its box is exactly the float32 min / max of their boxes, so it contains
    each of them with no rounding."""
    cl, packed = _mesh_clusters(mesh, group)
    C = len(cl["first"])
    G = -(-C // group)
    gt = packed["group_table"].numpy()
    assert gt.shape == (G, 8) and packed["num_groups"] == G
    assert packed["group_visit"].shape == (8, G)
    first, count = gt[:, 6:8].view(np.int32).T
    np.testing.assert_array_equal(first, np.arange(G) * group)
    assert count.sum() == C and (count >= 1).all()
    box = cl["aabb"][:, :6]
    for g in range(G):
        members = box[first[g]:first[g] + count[g]]
        assert (gt[g, 0:3] <= members[:, 0:3]).all()
        assert (gt[g, 3:6] >= members[:, 3:6]).all()
        np.testing.assert_array_equal(gt[g, 0:3], members[:, 0:3].min(0))
        np.testing.assert_array_equal(gt[g, 3:6], members[:, 3:6].max(0))


@pytest.mark.parametrize("group", GROUP_SIZES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_visit_order_is_two_level(mesh, group):
    """Each octant's row of ``visit`` lists every cluster once: the groups
    in the row of ``group_visit`` (near to far by their boxes' centres), and
    inside each group its clusters near to far by their own centres, equal
    keys in ascending id."""
    cl, packed = _mesh_clusters(mesh, group)
    C = len(cl["first"])
    visit = packed["visit"].numpy()
    gvisit = packed["group_visit"].numpy()
    gt = packed["group_table"].numpy()
    count = gt[:, 7].view(np.int32)
    np.testing.assert_array_equal(
        gvisit, cuda_rt.octant_visit_table(gt[:, :6]))
    ckey, gkey = _centre_keys(cl["aabb"]), _centre_keys(gt)
    for q in range(8):
        assert sorted(visit[q].tolist()) == list(range(C))
        assert sorted(gvisit[q].tolist()) == list(range(len(count)))
        assert (np.diff(gkey[q][gvisit[q]]) >= 0).all()
        # the row, cut at the group sizes in visit order: the groups' members
        runs = np.split(visit[q], np.cumsum(count[gvisit[q]])[:-1])
        for g, run in zip(gvisit[q], runs):
            assert (run // group == g).all()
            k = ckey[q][run]
            assert ((np.diff(k) > 0) | ((np.diff(k) == 0)
                                        & (np.diff(run) > 0))).all()
    if group == 1:      # a group a cluster: the one-level order
        np.testing.assert_array_equal(
            visit, cuda_rt.octant_visit_table(cl["aabb"]))


@pytest.mark.parametrize("group", GROUP_SIZES)
def test_group_gate_changes_no_result(group):
    """The clustered closest hit with its group gate and with every group
    box opened to all of space (the clusters gated alone, in the same
    order): the same bits, and fewer cluster slab tests with the gate."""
    verts, faces, max_tris, queries = scenes.cluster_check_queries(
        "ico3_c64")
    _, clusters, _ = _port_scene(verts, faces, max_tris, group=group)
    gt = clusters["group_table"].clone()
    gt[:, 0:3], gt[:, 3:6] = -np.inf, np.inf
    open_groups = {**clusters, "group_table": gt}
    for label, kind, oq, dq, tm in queries:
        gated, opened = {}, {}
        got = cuda_rt.closest_hit_clustered_reference(
            _t(oq), _t(dq), clusters, _t(tm), stats=gated)
        want = cuda_rt.closest_hit_clustered_reference(
            _t(oq), _t(dq), open_groups, _t(tm), stats=opened)
        for g, w in zip(got, want):
            assert torch.equal(g, w), label
        assert opened["groups_entered"] == opened["group_slab_tests"]
        assert gated["slab_tests"] <= opened["slab_tests"]
        assert gated["tri_tests"] == opened["tri_tests"]


@pytest.mark.parametrize("group", GROUP_SIZES)
def test_any_group_gate_changes_no_result(group):
    """The clustered any hit with its group gate, with every group box
    opened to all of space, and over the flattened row with no group level
    (the walk before the gate): the same answer, equal to the brute-force
    oracle; the gate takes cluster slab tests away and no triangle test."""
    verts, faces, max_tris, queries = scenes.cluster_check_queries(
        "ico3_c64")
    tri, clusters, _ = _port_scene(verts, faces, max_tris, group=group)
    gt = clusters["group_table"].clone()
    gt[:, 0:3], gt[:, 3:6] = -np.inf, np.inf
    open_groups = {**clusters, "group_table": gt}
    # one group of all the clusters, its box all of space: the flattened row
    one = cuda_rt.pack_clusters(
        clusters["tri"], clusters["table"].numpy(),
        *clusters["table"][:, 6:8].contiguous().view(torch.int32).T.numpy(),
        clusters["order"].numpy(), "cpu", group=clusters["num_clusters"])
    one["group_table"][:, 0:3], one["group_table"][:, 3:6] = -np.inf, np.inf
    anys = 0
    for label, kind, oq, dq, tm in queries:
        tm = 2.5 if tm is None else tm
        gated, opened = {}, {}
        got = cuda_rt.any_hit_clustered_reference(
            _t(oq), _t(dq), clusters, _t(tm), stats=gated)
        want = cuda_rt.any_hit_clustered_reference(
            _t(oq), _t(dq), open_groups, _t(tm), stats=opened)
        flat = cuda_rt.any_hit_clustered_reference(_t(oq), _t(dq), one,
                                                   _t(tm))
        oracle = intersect.any_hit_bruteforce(
            _t(oq), _t(dq), *tri,
            t_max=tm if np.ndim(tm) == 0 else _t(tm)[:, None])
        assert torch.equal(got, want) and torch.equal(got, flat), label
        assert torch.equal(got, oracle), label
        assert opened["groups_entered"] == opened["group_slab_tests"]
        assert gated["groups_entered"] <= gated["group_slab_tests"]
        assert gated["slab_tests"] <= opened["slab_tests"]
        assert gated["tri_tests"] == opened["tri_tests"]
        assert gated["slab_pass"] == opened["slab_pass"]
        anys += int(got.any())
    assert anys > 0


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_group_level_cuts_slab_tests_on_small_scene(kind):
    """The 12,032-triangle sphere field of the small-scene frame (302
    clusters of <= 64): on a sample of its 256x256 primary rays the group
    and cluster slab tests a ray fall far under C, and the hits hold to
    the one-level order's (group 1) with ties only.  The any hit, on the
    shadow rays that the frame's shading makes from those hits (most of
    them parked): under 40 group and cluster slab tests a ray (the walk
    without the group level: about 298), and the same answer as at group
    1."""
    from skybox_rt_tpu_torch.geom import cgltrace
    from skybox_rt_tpu_torch.rt import tracer

    verts, faces, colors = scenes.sphere_field(copies=9, subdiv=3)
    tri = intersect.triangle_arrays(
        torch.as_tensor(verts), torch.as_tensor(np.asarray(faces, np.int64)))
    cl = bvh_mod.build_clusters(bvh_mod.build(verts, faces, method="sah"), 64)
    with np.load(f"{cgltrace.DATA_DIR}/rt_small_256.npz") as z:
        o, d = _t(z["o"][::16].copy()), _t(z["d"][::16].copy())
    R = o.shape[0]
    one = cuda_rt.closest_hit_clustered(o, d, cuda_rt.prepare_clusters(
        *tri, cl, group=1))
    clusters = cuda_rt.prepare_clusters(*tri, cl)
    C = clusters["num_clusters"]
    assert C == 302
    assert clusters["num_groups"] == -(-C // cuda_rt.CLUSTER_GROUP)
    stats = {}
    got = cuda_rt.closest_hit_clustered_reference(o, d, clusters,
                                                  stats=stats)
    slabs = (stats["group_slab_tests"] + stats["slab_tests"]) / R
    assert slabs < C / 4, stats
    assert stats["group_slab_tests"] == clusters["num_groups"] * R
    hits = (got[0] >= 0).numpy()
    assert hits.mean() > 0.3
    if kind == "closest":
        ties = scenes.check_clustered_equals_flat(
            [x.numpy() for x in got], [x.numpy() for x in one])
        assert ties <= 0.01 * hits.sum()
        return
    scene = tracer.RTScene(verts=verts, faces=faces, colors=colors,
                           normals=tracer.vertex_normals(verts, faces),
                           reflectivity=0.35)
    cfg = tracer.RTConfig(width=256, height=256, bounces=2, shadows=True)
    shadow = []

    def occluded(so, sd, t_max):
        shadow.append((so, sd, t_max))
        return torch.zeros((so.shape[0],), dtype=torch.bool)

    tracer.shade_hits(tracer.scene_shade_arrays(scene, cfg, "cpu"), cfg,
                      occluded, o, d, *got)
    so, sd, tm = shadow[0]
    parked = (so[:, 0] > 1e7).float().mean()
    assert 0.3 < parked < 0.9
    stats = {}
    occ = cuda_rt.any_hit_clustered_reference(so, sd, clusters, tm,
                                              stats=stats)
    slabs = (stats["group_slab_tests"] + stats["slab_tests"]) / R
    assert slabs < 40, stats
    assert 0 < occ.float().mean() < 0.5
    assert torch.equal(occ, cuda_rt.any_hit_clustered_reference(
        so, sd, cuda_rt.prepare_clusters(*tri, cl, group=1), tm))


def test_wrappers_reject_bad_inputs():
    verts, faces, max_tris, queries = scenes.cluster_check_queries(
        "multi4_c32")
    _, clusters, flat = _port_scene(verts, faces, max_tris)
    o, d = _t(queries[0][2]), _t(queries[0][3])
    for fn, arg in ((cuda_rt.closest_hit_clustered, clusters),
                    (cuda_rt.any_hit_clustered, clusters),
                    (cuda_rt.closest_hit_pallas, flat),
                    (cuda_rt.any_hit_pallas, flat)):
        with pytest.raises(TypeError):
            fn(o.double(), d.double(), arg)
        with pytest.raises(ValueError):
            fn(o[:, :2], d[:, :2], arg)
        with pytest.raises(ValueError):      # neither the CPU nor a card
            fn(o.to("meta"), d.to("meta"), arg)
    with pytest.raises(ValueError):          # a range past the records
        cuda_rt.pack_clusters(flat[:10], np.zeros((1, 8), np.float32), [4],
                              [7], np.arange(10), "cpu")
    with pytest.raises(ValueError):          # order of another scene
        cuda_rt.pack_clusters(flat[:10], np.zeros((1, 8), np.float32), [0],
                              [10], np.arange(9), "cpu")
    # an empty batch and an empty scene
    e = torch.zeros((0, 3))
    assert cuda_rt.closest_hit_clustered(e, e, clusters)[0].shape == (0,)
    assert cuda_rt.closest_hit_pallas(o[:4], d[:4], flat[:0])[0].tolist() == \
        [-1] * 4


@pytest.mark.cuda
@pytest.mark.parametrize("group", GROUP_SIZES)
def test_kernels_match_plain_on_card(group):
    """Each of the three kernels against its plain version on the card:
    every output equal bit for bit (same operations in the same per-ray
    order, no fused multiply-add), and their launches counted, at every
    group size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    dev = torch.device("cuda")
    cuda_rt.reset_launch_counts()
    launched = [0, 0, 0]
    for name in sorted(scenes.CLUSTER_CHECK_SCENES):
        verts, faces, max_tris, queries = scenes.cluster_check_queries(name)
        _, clusters, flat = _port_scene(verts, faces, max_tris, device=dev,
                                        group=group)
        for label, kind, oq, dq, tm in queries:
            oq, dq, tm = _t(oq, dev), _t(dq, dev), _t(tm, dev)
            if kind == "any":
                pairs = [
                    (cuda_rt.any_hit_clustered(oq, dq, clusters, t_max=tm),
                     cuda_rt.any_hit_clustered_reference(oq, dq, clusters,
                                                         tm)),
                    (cuda_rt.any_hit_pallas(oq, dq, flat, t_max=tm),
                     cuda_rt.closest_hit_pallas_reference(
                         oq, dq, flat, cuda_rt._per_ray_tmax(
                             tm, oq.shape[0], dev))[0] >= 0)]
                launched[1] += 1
            else:
                pairs = list(zip(
                    cuda_rt.closest_hit_clustered(oq, dq, clusters, t_max=tm),
                    cuda_rt.closest_hit_clustered_reference(oq, dq, clusters,
                                                            tm)))
                pairs += list(zip(
                    cuda_rt.closest_hit_pallas(oq, dq, flat, t_max=tm),
                    cuda_rt.closest_hit_pallas_reference(oq, dq, flat, tm)))
                launched[0] += 1
            launched[2] += 1
            torch.cuda.synchronize()
            for g, w in pairs:
                assert g.dtype == w.dtype and torch.equal(g, w), (name, label)
    assert [cuda_rt.launch_counts[k] for k in (
        "closest_hit_clustered", "any_hit_clustered",
        "closest_hit_flat")] == launched
    # more clusters than the shared-memory stage holds: the tables are read
    # from global memory
    verts, faces = scenes.icosphere(subdiv=4)
    _, clusters, _ = _port_scene(verts, faces, 4, device=dev, group=group)
    assert clusters["num_clusters"] > 768
    o, d = scenes.aimed_rays(3000, seed=9)
    # all of one octant, so that the plain version walks one row of the table
    o, d = _t(np.abs(o), dev), _t(-np.abs(d), dev)
    for g, w in zip(cuda_rt.closest_hit_clustered(o, d, clusters),
                    cuda_rt.closest_hit_clustered_reference(o, d, clusters)):
        assert torch.equal(g, w)
    assert torch.equal(
        cuda_rt.any_hit_clustered(o, d, clusters, t_max=3.0),
        cuda_rt.any_hit_clustered_reference(o, d, clusters, 3.0))
