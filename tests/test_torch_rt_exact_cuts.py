"""The exactness premises of two kernels of the port, pinned on the CPU with
the plain arithmetic, and the kernels against their plain versions on a card.

The worklist's prepass (``ops.cuda_rt.active_block_lists``,
csrc/rt_streamed.cu) orders a tile's blocks by the bits of their least slab
entry distance tn, sign bit cleared, and sorts the (key, block id) pairs with
no regard to stability: the blocks of finite key by (key, id), then every
other block in ascending id.  That is the plain version's stable argsort
(``active_block_lists_reference``) because every passing tn is >= 0 and not
NaN; both are held here on the check scenes (parked and axis-parallel rays
included) and on a block that a ray enters at tn = +inf.

The flat closest hit (``ops.cuda_rt.closest_hit_pallas``,
csrc/rt_clustered.cu) stops a test when |det| <= MT_EPS, or when t_num = e2 .
qv is 0, NaN or of the sign opposite to det's (t <= 0 then, so t > t_min fails
for t_min >= 0), and a block whose rays share their origin bit for bit stages
tv, qv and t_num once a record.  Held here: the cut never rejects a test that
the plain arithmetic (``_range_tests``, ``intersect.mt_components``) makes a
hit, on seeded random records and on adversarial ones (t_num exactly 0,
triangles behind the origin, |det| just above MT_EPS, subnormal products);
the terms computed the staged way give t, u, v bit-equal to ``_range_tests``.

The kernels against their plain versions run only on a card (marker
``cuda``):  python -m pytest --noconftest -m cuda tests/test_torch_rt_exact_cuts.py
"""
import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.ops import cuda_rt
from skybox_rt_tpu_torch.rt import bvh as bvh_mod
from skybox_rt_tpu_torch.rt import intersect, tracer

torch.set_num_threads(1)

F32 = np.float32
NO_KEY = 0xFFFFFFFF
INF_KEY = 0x7F800000
#: the flat query's t_min values: the default, 0 (where t's sign alone
#: decides) and below 0 (the kernel's cut is off)
T_MINS = (cuda_rt.T_MIN, 0.0, -1.0)
EYE = (0.0, 2.5, 9.5)


def _stream_queries(name, tri_block, device="cpu"):
    """(stream, [(label, o, d, t_max (R,) or None)]) of a check scene."""
    verts, faces, _, queries = scenes.cluster_check_queries(name)
    tri = intersect.triangle_arrays(torch.as_tensor(verts, device=device),
                                    torch.as_tensor(faces, device=device))
    order = bvh_mod.build_clusters(bvh_mod.build(verts, faces), 64)["order"]
    stream = cuda_rt.prepare_stream_blocks(*tri, order=order,
                                           tri_block=tri_block)
    out = []
    for label, _, o, d, tm in queries:
        o = torch.as_tensor(o, device=device)
        tm = None if tm is None else cuda_rt._per_ray_tmax(
            torch.as_tensor(tm, device=device) if np.ndim(tm) else tm,
            o.shape[0], o.device)
        out.append((label, o, torch.as_tensor(d, device=device), tm))
    return stream, out


def _slab_all(o, d, stream, tm):
    """(tn, passes) of every ray against every block, (R, NB): the plain
    prepass's slab test."""
    oc, _, inv = cuda_rt._components(o, d)
    far = cuda_rt._per_ray_tmax(float("inf") if tm is None else tm,
                                o.shape[0], o.device)
    box = stream["aabb"]
    tn, tf = cuda_rt._slab([box[None, :, k] for k in range(6)],
                           [c[:, None] for c in oc], [c[:, None] for c in inv],
                           far[:, None])
    return tn, tn <= tf


def _kernel_order(o, d, stream, tm, front_to_back):
    """The prepass kernel's lists, emulated: keys as tn's bits with the sign
    bit cleared, a tile's key the least over its passing rays (0xffffffff
    where none passes), then the head (finite keys, or the active blocks)
    sorted by (key, id) through a sort that keeps no order of equal keys
    (the composite keys are distinct), then the rest in ascending id."""
    tn, passes = _slab_all(o, d, stream, tm)
    R, NB = tn.shape
    T = cuda_rt.STREAM_RAY_TILE
    G = -(-R // T)
    bits = tn.contiguous().view(torch.int32).long() & 0x7FFFFFFF
    bits = torch.where(passes, bits, torch.full_like(bits, NO_KEY))
    pad = torch.full((G * T - R, NB), NO_KEY, dtype=torch.int64)
    key = torch.cat([bits, pad]).view(G, T, NB).amin(dim=1)
    active = key != NO_KEY
    head = key < INF_KEY if front_to_back else active
    ids = torch.arange(NB).expand(G, NB)
    comp = torch.where(head, (key if front_to_back else 0) * NB + ids,
                       (1 << 50) + ids)
    lists = torch.sort(comp, dim=1, stable=False).indices.to(torch.int32)
    return lists, active.sum(dim=1).to(torch.int32)


def _inf_key_rays():
    """Rays of which one (ray 20) enters every block at tn = +inf: a zero
    direction (1/d replaced by 1e30) from an origin beyond every box by more
    than 3.4e8 in each axis, so each axis' entry and exit overflow to +inf
    and tn = tf = +inf.  The rest of its tile is parked but for ray 10,
    aimed at the sphere as the rays of the other tiles are.  (o, d, 20)."""
    o, d = scenes.aimed_rays(300, seed=43)
    o, d, _ = scenes.parked(o, d, 1)
    o[10:], d[10:] = scenes.aimed_rays(290, seed=44)
    o[11:128], d[11:128] = 3e7, 0.57735
    o[20], d[20] = -1e9, 0.0
    return torch.as_tensor(o), torch.as_tensor(d), 20


@pytest.mark.parametrize("name", sorted(scenes.CLUSTER_CHECK_SCENES))
@pytest.mark.parametrize("tri_block", [24, 64])
def test_passing_tn_is_never_nan_or_negative(name, tri_block):
    """The prepass kernel's premise: tn of a passing (ray, block) pair is
    >= 0 and not NaN, so its bits (sign cleared) order as the float."""
    stream, queries = _stream_queries(name, tri_block)
    for label, o, d, tm in queries:
        tn, passes = _slab_all(o, d, stream, tm)
        assert passes.any(), label
        ok = tn[passes]
        assert not torch.isnan(ok).any() and (ok >= 0).all(), label


@pytest.mark.parametrize("name", sorted(scenes.CLUSTER_CHECK_SCENES))
@pytest.mark.parametrize("front_to_back", [True, False])
def test_bit_keys_and_an_unstable_sort_give_the_plain_lists(name,
                                                           front_to_back):
    """Ordering by the uint32 bits of the keys, and sorting the (key, id)
    pairs with no regard to stability, gives the plain version's lists and
    counts element for element."""
    stream, queries = _stream_queries(name, 24)
    for label, o, d, tm in queries:
        want = cuda_rt.active_block_lists_reference(o, d, stream, tm,
                                                    front_to_back)
        got = _kernel_order(o, d, stream, tm, front_to_back)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(want[1].sum()) > 0, label


@pytest.mark.parametrize("front_to_back", [True, False])
def test_a_block_entered_at_infinity_is_active_and_in_the_tail(front_to_back):
    """An active block whose key is +inf: counted, and (near to far) placed
    with the inactive blocks in ascending id, as the stable argsort ties
    +inf with them; the emulated kernel order agrees."""
    stream, _ = _stream_queries("ico3_c64", 64)
    o, d, k = _inf_key_rays()
    tn, passes = _slab_all(o, d, stream, None)
    assert passes[k].all() and torch.isinf(tn[k]).all()
    want = cuda_rt.active_block_lists_reference(o, d, stream, None,
                                                front_to_back)
    got = _kernel_order(o, d, stream, None, front_to_back)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    g = k // cuda_rt.STREAM_RAY_TILE
    assert int(want[1][g]) == stream["num_blocks"]
    if front_to_back:   # the blocks of finite key first, then ascending id
        tile = torch.where(passes, tn, torch.full_like(tn, float("inf")))[
            g * cuda_rt.STREAM_RAY_TILE:(g + 1) * cuda_rt.STREAM_RAY_TILE]
        head = int(torch.isfinite(tile.amin(dim=0)).sum())
        assert 0 < head < stream["num_blocks"]
        tail = want[0][g, head:]
        assert torch.equal(tail, tail.sort().values)


def _flat_adversarial(seed):
    """(records (P, 12), o (R, 3), d (R, 3)) that put the flat kernel's cuts
    on their edges.  Rays: blocks 0-2 of 128 from the eye (block 0 with one
    origin x of -0.0 for 0.0, block 1 with one origin one ulp off: both take
    the general path; block 2 shared), looking down -z; a short block of 100
    from the origin (0, 0, 0) in random directions.  Records: v0 at the eye
    (t_num = 0), v0 on the eye's line along e1 (t_num = 0), triangles behind
    the eye (t < 0), edges of length ~3.2e-5 (|det| just above 1e-9), v0 and
    edges so small that t_num and the products are subnormal, and random
    triangles ahead."""
    rng = np.random.default_rng(seed)
    eye = np.array(EYE, F32)
    dirs = np.stack([rng.uniform(-0.5, 0.5, 384), rng.uniform(-0.5, 0.5, 384),
                     -np.ones(384)], axis=1)
    d_eye = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    o_eye = np.broadcast_to(eye, (384, 3)).copy()
    o_eye[5, 0] = -0.0
    o_eye[130, 1] = np.nextafter(eye[1], F32(np.inf))
    d0 = rng.normal(size=(100, 3))
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    o = np.concatenate([o_eye, np.zeros((100, 3))]).astype(F32)
    d = np.concatenate([d_eye, d0]).astype(F32)
    rows = []

    def add(v0, e1, e2):
        rows.append(np.concatenate([v0, e1, e2, np.zeros(3)]))

    for _ in range(8):
        add(eye, rng.normal(size=3), rng.normal(size=3))
        add(eye - 3.0 * np.array([1.0, 0, 0]), np.array([1.0, 0, 0]),
            rng.normal(size=3))
        add(eye + np.array([0, 0, 2.0]) + rng.normal(size=3) * 0.3,
            rng.normal(size=3), rng.normal(size=3))
    for s in np.geomspace(3.15e-5, 3.35e-5, 24):
        add(eye + np.array([-s / 3, -s / 3, -1.0]), np.array([s, 0, 0]),
            np.array([0, s, 0]))
        add(np.zeros(3) + rng.normal(size=3) * s * s,
            np.array([s, 0, 0]), np.array([0, 0, s]))
    for scale in (1e-30, 1e-33, 1e-36):
        for _ in range(6):
            add(rng.normal(size=3) * scale, rng.normal(size=3) * 1e-3,
                rng.normal(size=3) * 1e-3)
    for _ in range(40):
        add(eye + np.array([0, 0, -4.0]) + rng.normal(size=3),
            rng.normal(size=3) * 0.8, rng.normal(size=3) * 0.8)
    rec = torch.as_tensor(np.asarray(rows, F32))
    return rec, torch.as_tensor(o), torch.as_tensor(d)


def _flat_random(seed):
    """Seeded random triangles in a box and rays aimed at it from spread
    origins (every block takes the general path); R not a multiple of 128."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-2, 2, size=(300, 3))
    e = rng.normal(size=(300, 6)) * 0.6
    rec = np.concatenate([v0, e, np.zeros((300, 3))], axis=1)
    o, d = scenes.aimed_rays(500, seed=seed)
    return torch.as_tensor(rec.astype(F32)), torch.as_tensor(o), \
        torch.as_tensor(d)


FLAT_CASES = {"adversarial_7": lambda: _flat_adversarial(7),
              "adversarial_8": lambda: _flat_adversarial(8),
              "random_3": lambda: _flat_random(3)}


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
@pytest.mark.parametrize("t_min", T_MINS)
def test_flat_t_sign_cut_rejects_no_hit(case, t_min):
    """No (ray, record) pair that the kernel stops early (|det| <= MT_EPS,
    or the t-sign cut) is a hit of the plain arithmetic; and the
    adversarial cases reach the cut's edges."""
    rec, o, d = FLAT_CASES[case]()
    oc, dc, _ = cuda_rt._components(o, d)
    ok, t, _, _ = cuda_rt._range_tests(rec, 0, rec.shape[0], oc, dc,
                                       torch.arange(o.shape[0]), t_min)
    terms = cuda_rt.flat_test_terms(rec, o, d)
    det, t_num = terms["det"], terms["t_num"]
    go_on = (det.abs() > intersect.EPS) & cuda_rt.flat_t_may_pass(
        det, t_num, t_min)
    assert not (ok & ~go_on).any()
    assert ok.any()
    if t_min < 0:
        assert ((det.abs() > intersect.EPS) == go_on).all()
    else:
        assert (~go_on).any()
    if case.startswith("adversarial"):
        live = det.abs() > intersect.EPS
        assert (live & (t_num == 0)).any()
        assert (live & (det.abs() < 1.1e-9)).any()
        tiny = (t_num != 0) & (t_num.abs() < np.finfo(F32).tiny)
        assert (live & tiny).any()
        assert (live & (t < 0)).any()


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_staged_terms_equal_range_tests(case):
    """tv, qv and t_num computed once a record for a shared origin, as a
    block of such rays stages them, give t, u, v bit-equal to
    ``_range_tests`` on every pair, and so do the per-pair terms."""
    rec, o, d = FLAT_CASES[case]()
    staged = 0
    for rays in (slice(256, 384), slice(0, o.shape[0])):
        oo, dd = o[rays].contiguous(), d[rays].contiguous()
        oc, dc, _ = cuda_rt._components(oo, dd)
        _, t, u, v = cuda_rt._range_tests(rec, 0, rec.shape[0], oc, dc,
                                          torch.arange(oo.shape[0]),
                                          cuda_rt.T_MIN)
        forms = [cuda_rt.flat_test_terms(rec, oo, dd)]
        if bool((oo == oo[0]).all()):
            forms.append(cuda_rt.flat_test_terms(rec, oo[0], dd))
            staged += 1
        for terms in forms:
            for k, want in (("t", t), ("u", u), ("v", v)):
                assert torch.equal(terms[k].view(torch.int32),
                                   want.view(torch.int32)), k
    assert staged == 1 or case.startswith("random")


def test_flat_shared_origin_blocks():
    """Blocks of 128 rays whose origins agree bit for bit: -0.0 against
    0.0 and one ulp both break a block's share; camera rays share."""
    _, o, _ = _flat_adversarial(7)
    assert cuda_rt.flat_shared_origin_blocks(o) == (4, 2)
    cam = tracer.Camera(eye=EYE, look_at=(0.0, -0.4, 0.0), fov_y_deg=55.0)
    oc, _ = tracer.camera_rays(cam, 24, 16, device="cpu")
    assert cuda_rt.flat_shared_origin_blocks(oc) == (3, 3)


def test_flat_work_counts_by_hand():
    """flat_work_counts against the masks counted directly."""
    rec, o, d = _flat_adversarial(8)
    counts = cuda_rt.flat_work_counts(o, d, rec)
    terms = cuda_rt.flat_test_terms(rec, o, d)
    det_pass = terms["det"].abs() > intersect.EPS
    t_pass = det_pass & cuda_rt.flat_t_may_pass(terms["det"], terms["t_num"])
    general = torch.ones(o.shape[0], dtype=torch.bool)
    general[256:] = False       # blocks 2 and 3 share their origins
    assert counts == {"pairs": o.shape[0] * rec.shape[0],
                      "det_pass": int(det_pass.sum()),
                      "det_pass_general": int(det_pass[general].sum()),
                      "t_pass": int(t_pass.sum()),
                      "u_pass": int((t_pass & (terms["u"] >= 0)).sum()),
                      "blocks": 4, "shared_blocks": 2}
    assert 0 < counts["u_pass"] < counts["t_pass"] < counts["det_pass"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(scenes.CLUSTER_CHECK_SCENES))
def test_cuda_prepass_matches_plain(name):
    """The prepass kernel against its plain version element for element, in
    both orders: the check scenes' queries (R not a multiple of 128, parked
    rays, per-ray t_max) at tri_block 24, 64 and 1 (NB not a multiple of
    32; 1,280 blocks at 1 on ico3), a tile of parked rays only (an empty
    list), and a block entered at tn = +inf."""
    dev = _card()
    for tri_block in (24, 64, 1):
        stream, queries = _stream_queries(name, tri_block, dev)
        o, d, _ = _inf_key_rays()
        park = torch.full((128, 3), 3e7)
        queries += [("inf_key", o.to(dev), d.to(dev), None),
                    ("empty_tile", torch.cat([park, o]).to(dev),
                     torch.cat([torch.full((128, 3), 0.57735), d]).to(dev),
                     None)]
        for label, o, d, tm in queries:
            for f2b in (True, False):
                want = cuda_rt.active_block_lists_reference(o, d, stream, tm,
                                                            f2b)
                got = cuda_rt.active_block_lists(o, d, stream, tm, f2b)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]) and torch.equal(
                    got[1], want[1]), (tri_block, label, f2b)
            if label == "empty_tile":
                assert int(want[1][0]) == 0


@pytest.mark.cuda
def test_cuda_prepass_refuses_too_many_blocks():
    """Above PREPASS_MAX_BLOCKS the kernel's tile does not fit in shared
    memory: the wrapper raises, and at many blocks under it the lists still
    equal the plain version's."""
    dev = _card()
    verts, faces = scenes.icosphere(subdiv=6)
    tri = intersect.triangle_arrays(torch.as_tensor(verts, device=dev),
                                    torch.as_tensor(np.asarray(faces,
                                                               np.int64),
                                                    device=dev))
    o, d = (torch.as_tensor(a, device=dev)
            for a in scenes.aimed_rays(200, seed=5))
    big = cuda_rt.prepare_stream_blocks(*tri, tri_block=1)
    assert big["num_blocks"] > cuda_rt.PREPASS_MAX_BLOCKS
    with pytest.raises(ValueError, match="at most"):
        cuda_rt.active_block_lists(o, d, big)
    fits = cuda_rt.prepare_stream_blocks(*tri, tri_block=4)
    assert 2048 < fits["num_blocks"] <= cuda_rt.PREPASS_MAX_BLOCKS
    got = cuda_rt.active_block_lists(o, d, fits)
    want = cuda_rt.active_block_lists_reference(o, d, fits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLAT_CASES) + ["camera"])
def test_cuda_flat_matches_plain(case):
    """The flat kernel against its plain version bit for bit at each t_min
    of T_MINS, with and without a per-ray t_max: blocks of shared origin,
    one off by -0.0, one off by an ulp, mixed origins, the adversarial
    records, and the camera's primary rays on a sphere field."""
    dev = _card()
    if case == "camera":
        verts, faces, _ = scenes.sphere_field(copies=4, subdiv=2)
        rec = cuda_rt.pack_records(*intersect.triangle_arrays(
            torch.as_tensor(verts), torch.as_tensor(np.asarray(faces,
                                                               np.int64))))
        cam = tracer.Camera(eye=EYE, look_at=(0.0, -0.4, 0.0),
                            fov_y_deg=55.0)
        o, d = tracer.camera_rays(cam, 40, 30, device="cpu")
    else:
        rec, o, d = FLAT_CASES[case]()
    rec, o, d = rec.to(dev), o.to(dev), d.to(dev)
    tm = torch.as_tensor(np.random.default_rng(1).uniform(
        1.0, 12.0, o.shape[0]).astype(F32), device=dev)
    cuda_rt.reset_launch_counts()
    for t_min in T_MINS:
        for t_max in (None, tm):
            got = cuda_rt.closest_hit_pallas(o, d, rec, t_max=t_max,
                                             t_min=t_min)
            want = cuda_rt.closest_hit_pallas_reference(o, d, rec, t_max,
                                                        t_min)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (t_min, t_max is None)
            assert (got[0] >= 0).any()
    assert cuda_rt.launch_counts["closest_hit_flat"] == 2 * len(T_MINS)
