"""The leaf table of the BVH-block closest-hit queries (rt.bvh.build_block_leaves)
and its packing into the blocks dict (ops.cuda_rt.prepare_bvh_blocks).

Every check is exact: a leaf box is the min / max over a subset of the same
vertex floats as its block's box, so containment holds with ``<=`` on the
float32 values, with no tolerance.
"""
import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.ops import cuda_rt
from skybox_rt_tpu_torch.rt import bvh as bvh_mod
from skybox_rt_tpu_torch.rt import intersect

torch.set_num_threads(1)


def _mesh(name):
    if name == "multi_sphere":
        return scenes.multi_sphere(n=4, subdiv=2)
    verts, faces, _ = scenes.sphere_field(copies=4, subdiv=1)
    return verts, faces


@pytest.mark.parametrize("leaf_tris", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("tri_block", [16, 64, 256])
@pytest.mark.parametrize("method", ["sah", "median", "lbvh"])
@pytest.mark.parametrize("mesh", ["multi_sphere", "field"])
def test_leaves_tile_their_blocks(mesh, method, tri_block, leaf_tris):
    verts, faces = _mesh(mesh)
    verts = np.asarray(verts, np.float32)
    bvh = bvh_mod.build(verts, faces, method=method)
    bs = bvh_mod.build_block_set(bvh, tri_block=tri_block)
    lv = bvh_mod.build_block_leaves(bvh, bs, leaf_tris)
    rng, box, first, count = lv["range"], lv["aabb"], lv["first"], lv["count"]
    C = bs["num_blocks"]
    assert rng.shape == (C + 1,) and rng[0] == 0 and rng[-1] == first.size
    assert box.dtype == np.float32 and box.shape == (first.size, 6)
    # a leaf of at most leaf_tris triangles, or one BVH leaf that is larger
    assert (count >= 1).all()
    assert (count <= max(leaf_tris, bvh.leaf_size)).all()
    tri = verts[np.asarray(faces)]                              # (P, 3, 3)
    s2p = bs["slot_to_prim"]
    block_box = bs["aabb_levels"][0]
    for b in range(C):
        k0, k1 = rng[b], rng[b + 1]
        assert k1 > k0
        # ascending and contiguous: every slot of the block in exactly one
        ends = first[k0:k1] + count[k0:k1]
        np.testing.assert_array_equal(first[k0:k1],
                                      np.r_[b * tri_block, ends[:-1]])
        assert ends[-1] == b * tri_block + bs["bcnt"][b]
        for k in range(k0, k1):
            pts = tri[s2p[first[k]:first[k] + count[k]]].reshape(-1, 3)
            # the leaf box holds its triangles' vertices ...
            assert (box[k, 0:3] <= pts.min(0)).all()
            assert (box[k, 3:6] >= pts.max(0)).all()
            # ... and lies inside its block's box
            assert (box[k, 0:3] >= block_box[b, 0:3]).all()
            assert (box[k, 3:6] <= block_box[b, 3:6]).all()
        # leaves of a tree cut: the block's box is their union
        np.testing.assert_array_equal(box[k0:k1, 0:3].min(0),
                                      block_box[b, 0:3])
        np.testing.assert_array_equal(box[k0:k1, 3:6].max(0),
                                      block_box[b, 3:6])


def test_leaf_table_packs_into_the_blocks():
    """prepare_bvh_blocks keeps the leaves bit for bit: range as is, each
    row the box and (first, count) as int32 bit patterns."""
    verts, faces, tri_block, _ = scenes.bvh_check_queries("multi4_tb32")
    bvh = bvh_mod.build(verts, faces)
    bs = bvh_mod.build_block_set(bvh, tri_block=tri_block)
    lv = bvh_mod.build_block_leaves(bvh, bs, 8)
    tri = intersect.triangle_arrays(torch.as_tensor(verts),
                                    torch.as_tensor(faces))
    blocks = cuda_rt.prepare_bvh_blocks(*tri, bs, lv)
    table, rng = blocks["leaf_table"], blocks["leaf_range"]
    assert table.dtype == torch.float32 and rng.dtype == torch.int32
    np.testing.assert_array_equal(rng.numpy(), lv["range"])
    np.testing.assert_array_equal(table[:, :6].numpy(), lv["aabb"])
    ints = table[:, 6:8].contiguous().view(torch.int32).numpy()
    np.testing.assert_array_equal(ints[:, 0], lv["first"])
    np.testing.assert_array_equal(ints[:, 1], lv["count"])


def test_leaves_refuse_another_block_set():
    verts, faces = _mesh("multi_sphere")
    bvh = bvh_mod.build(verts, faces, method="sah")
    other = bvh_mod.build(verts, faces, method="median")
    bs = bvh_mod.build_block_set(bvh, tri_block=64)
    with pytest.raises(ValueError, match="not cut from this BVH"):
        bvh_mod.build_block_leaves(other, bs, 16)
    with pytest.raises(ValueError, match="not cut from this BVH"):
        bvh_mod.build_block_leaves(
            bvh, bvh_mod.build_block_set(bvh, tri_block=32) | {
                "tri_block": 64}, 16)
    with pytest.raises(ValueError):
        bvh_mod.build_block_leaves(bvh, bs, 0)
