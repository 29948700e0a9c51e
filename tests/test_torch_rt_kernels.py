"""The BVH-block ray queries: the port's plain versions against the JAX
package's Pallas kernels, and the CUDA kernels against the plain versions.

``ops.cuda_rt.closest_hit_bvh_reference`` / ``any_hit_bvh_reference`` are
held to ``pallas_rt.closest_hit_bvh`` / ``any_hit_bvh`` run as the JAX
package's own tests run them on the CPU (``interpret=True``), on the scenes
of tests/test_pallas_rt.py (multi-sphere, tri_block 32 and 16, per-ray t_max,
parked rays, scalar and per-ray any-hit t_max), the blocks carried over with
``interop.bvh_blocks_from_reference``.  The JAX package has no leaf table, so
the queries run on the port's own blocks, held equal to the carried ones,
with the leaves of rt.bvh.build_block_leaves at every leaf size from 1 to 32
(the JAX any hit gates whole blocks, the port's the leaves: a leaf box's
rounded slab test could cull a graze that the block's let in; no ray of
these cases differs, and none may).

Tolerances.  Miss masks: equal.  t: rtol 1e-5.  u, v: atol 1e-4 where the
prims agree: XLA's CPU code contracts multiply-adds and eager torch does not,
and the cross products of glancing rays cancel, so each package is up to
3.5e-5 from the float64 barycentrics on these scenes and up to 5e-5 from the
other (measured); 1e-5, the JAX suite's bound between two JAX paths, does not
hold across that divide.  Prims: the Pallas kernel keeps the first of equal-t
hits in its worklist order, the port the lowest slot, so prims may differ on
ties only: where they differ the two t agree to rtol 1e-5 and such rays are
under 1 % of the hits (the JAX suite's own bound).  Occlusion: equal; a ray
that differs must be a boundary case.

The CUDA kernels against the plain versions run only on a card (marker
``cuda``):  python -m pytest --noconftest -m cuda tests/test_torch_rt_kernels.py
"""
import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch import interop
from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.ops import cuda_rt
from skybox_rt_tpu_torch.rt import bvh as bvh_mod
from skybox_rt_tpu_torch.rt import intersect, tracer

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

SCENES = scenes.BVH_CHECK_SCENES
#: the leaf sizes swept on the card (scripts/torch_rt_profile.py
#: --leaf-tris), and 1, 2 and 4, which split the 16-slot blocks finer
LEAF_SIZES = (1, 2, 4, 8, 16, 32)


def _port_blocks(name, device="cpu", leaf_tris=tracer.BVH_LEAF_TRIS):
    """(tri arrays, blocks, queries) of a scene, built by the port alone."""
    verts, faces, tri_block, queries = scenes.bvh_check_queries(name)
    tri = intersect.triangle_arrays(torch.as_tensor(verts, device=device),
                                    torch.as_tensor(faces, device=device))
    bvh = bvh_mod.build(verts, faces)
    bs = bvh_mod.build_block_set(bvh, tri_block=tri_block)
    return tri, cuda_rt.prepare_bvh_blocks(
        *tri, bs, bvh_mod.build_block_leaves(bvh, bs, leaf_tris)), queries


def _t(a, device="cpu"):
    return None if a is None else torch.as_tensor(a, device=device)


def _reverse_leaves(blocks):
    """A copy of the blocks dict whose leaf table lists every block's leaves
    in descending order (pack_blocks refuses that order; the any-hit query
    reads each leaf's own first slot and count, so it takes it)."""
    rng = blocks["leaf_range"].tolist()
    rows = torch.cat([torch.arange(k1 - 1, k0 - 1, -1)
                      for k0, k1 in zip(rng[:-1], rng[1:])])
    table = blocks["leaf_table"]
    return {**blocks, "leaf_table": table[rows.to(table.device)].contiguous()}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_matches_jax_pallas(name):
    import jax.numpy as jnp

    from skybox_rt_tpu.ops import pallas_rt
    from skybox_rt_tpu.rt import bvh as jax_bvh
    from skybox_rt_tpu.rt import intersect as jax_intersect

    verts, faces, tri_block, queries = scenes.bvh_check_queries(name)
    jtri = jax_intersect.triangle_arrays(jnp.asarray(verts),
                                         jnp.asarray(faces))
    jbs = jax_bvh.build_block_set(jax_bvh.build(verts, faces),
                                  tri_block=tri_block)
    jblocks = pallas_rt.prepare_bvh_blocks(*jtri, jbs)
    blocks = interop.bvh_blocks_from_reference(jblocks, "cpu")
    if name == "multi6_tb16":
        assert len(blocks["levels"]) >= 2 and blocks["num_blocks"] > 64
    # the blocks carried over equal the ones the port builds itself, which
    # add the leaf table; carried without leaves, a block is one leaf with
    # its own box
    own = {lt: _port_blocks(name, leaf_tris=lt)[1] for lt in LEAF_SIZES}
    for k in ("tri", "bcnt", "s2p", "aabb"):
        assert torch.equal(own[tracer.BVH_LEAF_TRIS][k], blocks[k]), k
    assert own[tracer.BVH_LEAF_TRIS]["level_counts"] == blocks["level_counts"]
    C = blocks["num_blocks"]
    assert torch.equal(blocks["leaf_range"],
                       torch.arange(C + 1, dtype=torch.int32))
    assert torch.equal(blocks["leaf_table"][:, :6], blocks["levels"][0])

    for kind, oq, dq, tm in queries:
        if kind == "any":
            want = np.asarray(pallas_rt.any_hit_bvh(
                jnp.asarray(oq), jnp.asarray(dq), jblocks,
                t_max=tm if np.ndim(tm) == 0 else jnp.asarray(tm),
                interpret=True))
            assert 0 < want.mean() < 1
            for lt, leafy in own.items():
                got = cuda_rt.any_hit_bvh(_t(oq), _t(dq), leafy,
                                          t_max=_t(tm)).numpy()
                assert got.dtype == np.bool_
                # equal; no count of differing rays is allowed (a ray that
                # ever differs has to be shown to be a boundary case here)
                np.testing.assert_array_equal(got, want, err_msg=f"{lt}")
            continue
        p_w, t_w, u_w, v_w = (np.asarray(x) for x in pallas_rt.closest_hit_bvh(
            jnp.asarray(oq), jnp.asarray(dq), jblocks,
            t_max=None if tm is None else jnp.asarray(tm), interpret=True))
        for lt, leafy in own.items():
            p, t, u, v = (x.numpy() for x in cuda_rt.closest_hit_bvh(
                _t(oq), _t(dq), leafy, t_max=_t(tm)))
            assert p.dtype == np.int32 and t.dtype == np.float32
            np.testing.assert_array_equal(p < 0, p_w < 0, err_msg=f"{lt}")
            hits = p >= 0
            # a bounded query (t_max 2.5 from |o| ~ 3) hits rarely
            assert hits.mean() > (0.2 if tm is None else 0.01)
            assert np.isinf(t[~hits]).all() and not u[~hits].any()
            np.testing.assert_allclose(t[hits], t_w[hits], rtol=1e-5)
            same = hits & (p == p_w)
            np.testing.assert_allclose(u[same], u_w[same], atol=1e-4)
            np.testing.assert_allclose(v[same], v_w[same], atol=1e-4)
            ties = hits & (p != p_w)
            assert ties.sum() < 0.01 * hits.sum()
            np.testing.assert_allclose(t[ties], t_w[ties], rtol=1e-5)


def _answers(blocks, queries):
    """Every query's plain answer over ``blocks``: the any hits'
    occlusion, the closest hits' (prim, t, u, v) and the first two hits of
    a next-hit walk (slot, prim, t, u, v each)."""
    out = []
    for kind, oq, dq, tm in queries:
        oq, dq, tm = _t(oq), _t(dq), _t(tm)
        if kind == "any":
            out.append(cuda_rt.any_hit_bvh_reference(oq, dq, blocks, tm))
            continue
        out += cuda_rt.closest_hit_bvh_reference(oq, dq, blocks, tm)
        R = oq.shape[0]
        carry = (torch.zeros(R), torch.full((R,), -1, dtype=torch.int32))
        for _ in range(2):
            got = cuda_rt.closest_hit_bvh_after_reference(oq, dq, blocks,
                                                          *carry, tm)
            out += got
            carry = (got[2], got[0])
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_carried_blocks_with_leaves_answer_as_the_ports_own(name):
    """interop.bvh_blocks_from_reference(leaves=) on a JAX block set, with
    the leaves cut from the JAX BVH carried over: the port's own packing,
    leaf table and every plain answer bit for bit."""
    import jax.numpy as jnp

    from skybox_rt_tpu.ops import pallas_rt
    from skybox_rt_tpu.rt import bvh as jax_bvh
    from skybox_rt_tpu.rt import intersect as jax_intersect

    verts, faces, tri_block, queries = scenes.bvh_check_queries(name)
    jbvh = jax_bvh.build(verts, faces)
    jbs = jax_bvh.build_block_set(jbvh, tri_block=tri_block)
    jblocks = pallas_rt.prepare_bvh_blocks(*jax_intersect.triangle_arrays(
        jnp.asarray(verts), jnp.asarray(faces)), jbs)
    bvh = interop.bvh_from_reference(jbvh)
    lv = bvh_mod.build_block_leaves(bvh, bvh_mod.build_block_set(
        bvh, tri_block=tri_block), tracer.BVH_LEAF_TRIS)
    carried = interop.bvh_blocks_from_reference(jblocks, "cpu", leaves=lv)
    own = _port_blocks(name)[1]
    for k in ("tri", "bcnt", "s2p", "aabb", "leaf_range", "leaf_table"):
        assert torch.equal(carried[k], own[k]), k
    for a, b in zip(_answers(carried, queries), _answers(own, queries),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_prepare_bvh_blocks_takes_the_jax_call(name):
    """prepare_bvh_blocks(v0, e1, e2, block_set), the JAX entry's call, cuts
    no leaves: a block is one leaf with its own box, and every plain answer
    equals the one over the BVH's leaves bit for bit."""
    tri, leafy, queries = _port_blocks(name)
    verts, faces, tri_block, _ = scenes.bvh_check_queries(name)
    bs = bvh_mod.build_block_set(bvh_mod.build(verts, faces),
                                 tri_block=tri_block)
    whole = cuda_rt.prepare_bvh_blocks(*tri, bs)
    assert whole["leaf_table"].shape[0] == whole["num_blocks"]
    assert leafy["leaf_table"].shape[0] > whole["num_blocks"]
    for a, b in zip(_answers(whole, queries), _answers(leafy, queries),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("leaf_tris", LEAF_SIZES)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_matches_bruteforce_and_any_block_order(name, leaf_tris):
    """The plain versions against the port's all-pairs oracle (same
    arithmetic, so exactly equal), over the blocks in reverse, and for the
    any hit with every block's leaves met in reverse."""
    tri, blocks, queries = _port_blocks(name, leaf_tris=leaf_tris)
    rev = range(blocks["num_blocks"] - 1, -1, -1)
    for kind, oq, dq, tm in queries:
        oq, dq = _t(oq), _t(dq)
        if kind == "any":
            want = intersect.any_hit_bruteforce(oq, dq, *tri, t_max=_t(tm))
            for leafy in (blocks, _reverse_leaves(blocks)):
                for order in (None, rev):
                    got = cuda_rt.any_hit_bvh_reference(
                        oq, dq, leafy, _t(tm), block_order=order)
                    assert torch.equal(got, want)
            continue
        want = intersect.closest_hit_bruteforce(
            oq, dq, *tri, t_max=np.inf if tm is None else _t(tm))
        for order in (None, rev):
            got = cuda_rt.closest_hit_bvh_reference(oq, dq, blocks, _t(tm),
                                                    block_order=order)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        if "parked" in name:
            park = np.arange(oq.shape[0]) % 3 == 0
            assert bool((got[0][park] < 0).all())


def _duplicate_leaves():
    """A leaf a triangle of :func:`_duplicate_blocks`."""
    box_far, box_a = [0, 0, -1, 1, 1, -1], [0, 0, 0, 1, 1, 0]
    return {"range": np.array([0, 2, 3]),
            "aabb": np.array([box_far, box_a, box_a], np.float32),
            "first": np.array([0, 1, 2]), "count": np.array([1, 1, 1])}


def _duplicate_blocks(leaves=None):
    """Two blocks of two slots; the same triangle sits at slot 1 (block 0)
    and slot 2 (block 1), a farther one at slot 0."""
    tri_a = [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    tri_far = [0.0, 0.0, -1.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    rows = np.array([tri_far, tri_a, tri_a, [0.0] * 9], np.float32)
    box = np.array([[0, 0, -1, 1, 1, 0], [0, 0, 0, 1, 1, 0]], np.float32)
    return cuda_rt.pack_blocks(rows, np.array([2, 1], np.int32),
                               np.array([7, 5, 3, -1], np.int32), [box],
                               2, 8, "cpu", leaves=leaves)


def test_tie_rule_lowest_slot_wins():
    """Two coplanar duplicate triangles: the lower slot wins, whichever way
    the blocks are walked; the prim is the slot's through slot_to_prim."""
    blocks = _duplicate_blocks(_duplicate_leaves())
    o = torch.tensor([[0.25, 0.25, 1.0], [0.25, 0.25, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    for order in (None, (1, 0)):
        p, t, u, v = cuda_rt.closest_hit_bvh_reference(o, d, blocks,
                                                       block_order=order)
        assert p.tolist() == [5, -1]
        assert t[0].item() == 1.0 and np.isinf(t[1].item())
        assert (u[0].item(), v[0].item()) == (0.25, 0.25)
        assert (u[1].item(), v[1].item()) == (0.0, 0.0)


def test_any_hit_stops_at_first_hit_and_counts():
    """The any hit over leaves: a ray stops at its first hit in the order
    the walk meets leaves, and the counts say what it tested.  Block 0
    holds a far triangle (slot 0, z = -1, its own leaf) and a near one
    (slot 1, z = 0); block 1 the near one again (slot 2)."""
    blocks = _duplicate_blocks(_duplicate_leaves())
    o = torch.tensor([[0.25, 0.25, 1.0]] * 3)
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    tmax = torch.tensor([2.5, 1.5, 0.5])
    stats = {}
    occ = cuda_rt.any_hit_bvh_reference(o, d, blocks, tmax, stats=stats)
    assert occ.tolist() == [True, True, False]
    # ray 0 stops at slot 0 (leaf 0 passes at t = 2 < 2.5); ray 1's gate
    # culls leaf 0 (t = 2 > 1.5) and it stops at slot 1, where a whole-block
    # test would have tested slot 0 too; ray 2 enters no block
    assert stats == {"blocks_entered": 2, "slab_tests": 3, "slab_pass": 2,
                     "tri_tests": 2, "block_tri_tests": 3}
    # leaves met in reverse: both rays stop at slot 1, at the first leaf
    stats = {}
    occ = cuda_rt.any_hit_bvh_reference(o, d, _reverse_leaves(blocks), tmax,
                                        stats=stats)
    assert occ.tolist() == [True, True, False]
    assert stats == {"blocks_entered": 2, "slab_tests": 2, "slab_pass": 2,
                     "tri_tests": 2, "block_tri_tests": 3}


def test_zero_direction_and_parked_rays_miss_without_nan():
    _, blocks, queries = _port_blocks("multi4_tb32")
    o = torch.as_tensor(queries[0][1][:8].copy())
    d = torch.zeros((8, 3))
    o[4:] = 3e7
    d[4:] = 0.57735
    p, t, u, v = cuda_rt.closest_hit_bvh(o, d, blocks)
    assert (p == -1).all() and torch.isinf(t).all()
    assert not torch.isnan(u).any() and not torch.isnan(v).any()
    assert not cuda_rt.any_hit_bvh(o, d, blocks, t_max=1e8).any()


def test_wrappers_reject_bad_inputs():
    _, blocks, queries = _port_blocks("multi3_tb32_parked")
    o, d = _t(queries[0][1]), _t(queries[0][2])
    with pytest.raises(TypeError):
        cuda_rt.closest_hit_bvh(o.double(), d.double(), blocks)
    with pytest.raises(ValueError):
        cuda_rt.closest_hit_bvh(o[:, :2], d[:, :2], blocks)
    with pytest.raises(ValueError):
        cuda_rt.any_hit_bvh(o.to("meta"), d.to("meta"), blocks)
    with pytest.raises(ValueError):        # deeper than the kernels take
        cuda_rt.pack_blocks(
            np.zeros((1, 9), np.float32), np.ones(1, np.int32),
            np.zeros(1, np.int32),
            [np.zeros((1, 6), np.float32)] * (cuda_rt.MAX_LEVELS + 1),
            1, 1, "cpu")
    # no leaf cut: a block is one leaf with its own box, and every query
    # answers as over the leaves
    bare = _duplicate_blocks()
    assert bare["leaf_range"].tolist() == [0, 1, 2]
    o2 = torch.tensor([[0.25, 0.25, 1.0]])
    d2 = torch.tensor([[0.0, 0.0, -1.0]])
    leafy = _duplicate_blocks(_duplicate_leaves())
    for a, b in zip(cuda_rt.closest_hit_bvh(o2, d2, bare),
                    cuda_rt.closest_hit_bvh(o2, d2, leafy), strict=True):
        assert torch.equal(a, b)
    carry = (torch.zeros(1), torch.zeros(1, dtype=torch.int32))
    for a, b in zip(cuda_rt.closest_hit_bvh_after(o2, d2, bare, *carry),
                    cuda_rt.closest_hit_bvh_after(o2, d2, leafy, *carry),
                    strict=True):
        assert torch.equal(a, b)
    assert cuda_rt.any_hit_bvh(o2, d2, bare, t_max=2.0).tolist() == [True]
    assert cuda_rt.any_hit_bvh(o2, d2, leafy, t_max=2.0).tolist() == [True]
    # leaves that do not tile their blocks' slots in ascending order
    for bad in ({"first": np.array([1, 0, 2])},          # descending
                {"count": np.array([1, 2, 1])},          # past the block
                {"range": np.array([0, 1, 3])},          # slot 1 left out
                {"aabb": np.zeros((2, 6), np.float32)}):
        with pytest.raises(ValueError):
            _duplicate_blocks({**_duplicate_leaves(), **bad})


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_tris", LEAF_SIZES)
def test_kernels_match_plain_on_card(leaf_tris):
    """Kernel against plain version on the card: every output equal bit for
    bit (same operations in the same order, no fused multiply-add), at every
    leaf size; the any hit also with its leaves met in reverse."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    dev = torch.device("cuda")
    from skybox_rt_tpu_torch import _build
    with open(_build.build() + ".log") as f:
        print(f.read())
    for name in sorted(SCENES):
        _, blocks, queries = _port_blocks(name, device=dev,
                                          leaf_tris=leaf_tris)
        for kind, oq, dq, tm in queries:
            oq, dq, tm = _t(oq, dev), _t(dq, dev), _t(tm, dev)
            if kind == "any":
                want = cuda_rt.any_hit_bvh_reference(oq, dq, blocks, tm)
                # and with every block's leaves met in reverse
                for leafy in (blocks, _reverse_leaves(blocks)):
                    got = cuda_rt.any_hit_bvh(oq, dq, leafy, t_max=tm)
                    torch.cuda.synchronize()
                    assert got.dtype == torch.bool
                    assert torch.equal(got, want), name
                continue
            got = cuda_rt.closest_hit_bvh(oq, dq, blocks, t_max=tm)
            want = cuda_rt.closest_hit_bvh_reference(oq, dq, blocks, tm)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w), name
    # zero-direction and parked rays: all miss, no NaN
    _, blocks, queries = _port_blocks("multi4_tb32", device=dev)
    o = torch.as_tensor(queries[0][1][:64].copy(), device=dev)
    d = torch.zeros((64, 3), device=dev)
    o[32:] = 3e7
    d[32:] = 0.57735
    p, t, u, v = cuda_rt.closest_hit_bvh(o, d, blocks)
    assert bool((p == -1).all()) and bool(torch.isinf(t).all())
    assert not bool(cuda_rt.any_hit_bvh(o, d, blocks, t_max=1e8).any())
