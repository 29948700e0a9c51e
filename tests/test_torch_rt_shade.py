"""Hit shading: ``ops.cuda_rt.shade_hits`` (csrc/rt_shade.cu on the card, its
plain twin ``shade_hits_reference`` on the CPU) against the plain torch shade
that ``rt.tracer.shade_hits`` ran before the kernel.

On the CPU: the wrapper's route equals that shade (``_shade_before``, frozen
here as it stood) bit for bit, textured and untextured, shadows on and off,
on hit batches captured from ``trace_rays`` and on seeded edge inputs (misses,
u + v = 1, uvs that wrap, a zero-length normal, ndotl exactly 0 and below
0); whole frames are unchanged; the CPU route counts no launch; the wrapper
rejects a wrong dtype, shape, width or device mix.

On the card (marker ``cuda``; no JAX in this file): the kernel against the
twin, bit for bit, on the edge inputs and on the inputs that ``trace_rays``
hands it at 256x256 on the benchmark's two scenes, with the frame itself
equal to the frame shaded by the twin:
  python -m pytest --noconftest -m cuda tests/test_torch_rt_shade.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch.diff.pipeline import sample_texture_bilinear
from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.ops import cuda_rt
from skybox_rt_tpu_torch.rt import tracer
from skybox_rt_tpu_torch.utils.tracing import stage

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

CAM = tracer.Camera(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0),
                    fov_y_deg=55.0)
FORMS = [(False, False), (False, True), (True, False), (True, True)]
FORM_IDS = ["plain", "plain_shadows", "textured", "textured_shadows"]


def _shade_before(scene_arrays, cfg, occluded, o, d, prim, t, u, v,
                  bounce=0):
    """rt.tracer.shade_hits as it stood before the kernel, unchanged."""
    dev = o.device
    hit = prim >= 0
    pt = o + d * torch.where(hit, t, torch.zeros_like(t))[..., None]
    r = scene_arrays["rec"][prim.clamp(min=0).long()]
    R = r.shape[0]
    n = tracer._interp3(r[:, 0:9].reshape(R, 3, 3), u, v)
    n = n / tracer._norm3(n).clamp(min=1e-20)
    n = torch.where(tracer._dot3(n, d) > 0, -n, n)

    albedo = tracer._interp3(r[:, 9:21].reshape(R, 3, 4), u, v)[..., :3]
    if cfg.textured:
        uv = tracer._interp3(r[:, 21:27].reshape(R, 3, 2), u, v)
        texel = sample_texture_bilinear(scene_arrays["texture"],
                                        uv[..., 0], uv[..., 1])
        albedo = albedo * texel[..., :3]

    ldir = tracer._vec(cfg.light_dir, dev)
    ldir = ldir / tracer._norm3(ldir)
    ndotl = tracer._dot3(n, ldir)[..., 0].clamp(min=0.0)

    if cfg.shadows:
        need = hit & (ndotl > 0.0)
        sh_o = torch.where(need[..., None], pt + n * 1e-3,
                           tracer._vec(tracer.PARK_O, dev))
        sh_d = torch.broadcast_to(ldir, sh_o.shape).contiguous()
        with stage("rt.occlusion", stream=True, bounce=bounce,
                   width=sh_o.shape[0]):
            blocked = occluded(sh_o, sh_d, 1e8)
        ndotl = torch.where(blocked, torch.zeros_like(ndotl), ndotl)

    lc = tracer._vec(cfg.light_color, dev)
    rgb = albedo * (cfg.ambient + ndotl[..., None] * lc)
    return rgb, hit, pt, n


def _same_bits(got, want):
    """Equal dtype, shape and bits (-0.0 and +0.0 differ; NaN equals
    itself)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return torch.equal(got.cpu(), want.cpu())


class _Occluder:
    """A deterministic stand-in for the shadow query that keeps what it was
    asked: blocked where the origin's coordinates sum to an odd floor."""

    def __init__(self, query=None):
        self.query, self.asked = query, []

    def __call__(self, o, d, t_max):
        self.asked.append((o.clone(), d.clone(), t_max))
        if self.query is not None:
            return self.query(o, d, t_max)
        return torch.remainder(torch.floor(o.sum(1) * 7.0), 2.0) == 1.0


def _compare(scene_arrays, cfg, query, args, shade, want_shade):
    """Shade ``args`` = (o, d, prim, t, u, v, bounce) with ``shade`` and
    ``want_shade``; asserts the four outputs and the shadow rays asked of
    the query equal bit for bit."""
    occ_got, occ_want = _Occluder(query), _Occluder(query)
    got = shade(scene_arrays, cfg, occ_got, *args)
    want = want_shade(scene_arrays, cfg, occ_want, *args)
    for name, g, w in zip(("rgb", "hit", "pt", "n"), got, want):
        assert _same_bits(g, w), name
    assert len(occ_got.asked) == len(occ_want.asked) == int(cfg.shadows)
    for (go, gd, gt), (wo, wd, wt) in zip(occ_got.asked, occ_want.asked):
        assert _same_bits(go, wo) and _same_bits(gd, wd) and gt == wt


def _small_scene(textured):
    verts, faces, colors = scenes.sphere_field(copies=4, subdiv=1)
    extra = {}
    if textured:
        extra = dict(uvs=scenes.planar_uvs(verts),
                     texture=scenes.checkerboard_texture(**scenes.RT_CHECKER))
    return tracer.RTScene(verts=verts, faces=faces, colors=colors,
                          reflectivity=0.35, **extra)


def _capture(monkeypatch, scene, cfg, device):
    """The (o, d, prim, t, u, v, bounce) of every shade call of one frame,
    the frame's image and its (closest, occluded) pair."""
    calls = []
    real = tracer.shade_hits

    def recorder(scene_arrays, cfg, occluded, o, d, prim, t, u, v,
                 bounce=0):
        calls.append((o, d, prim, t, u, v, bounce))
        return real(scene_arrays, cfg, occluded, o, d, prim, t, u, v, bounce)

    scene = scene.finalize()
    scene_arrays = tracer.scene_shade_arrays(scene, cfg, device)
    closest, occluded = tracer.make_intersectors(scene, cfg, device)
    o, d = tracer.camera_rays(CAM, cfg.width, cfg.height, device)
    monkeypatch.setattr(tracer, "shade_hits", recorder)
    img = tracer.trace_rays(scene_arrays, cfg, closest, occluded,
                            scene.reflectivity, o, d)
    monkeypatch.setattr(tracer, "shade_hits", real)
    return scene_arrays, occluded, calls, img


# uvs that torch.remainder(., 1.0) and the texel indices wrap: negative,
# exactly 1.0, -0.0, just below 1, tiny, large, far beyond the float's ulp
UV_EDGES = [(-0.3, 1.0), (-1e-9, 2.5e6), (-0.0, 1.0 - 2.0 ** -24),
            (1.0, -1.0), (-2.5e6, 0.5), (1e-30, -1e-30), (3e7, -3e7),
            (0.999999, -0.999999)]


def _edge_batch(textured, device, seed=5):
    """(scene_arrays, cfg, args): a hand-made record table and hit batch
    whose rays meet the edge cases, then seeded random ones.  The light
    points along +y so that ndotl can be exactly 0."""
    rng = np.random.default_rng(seed)
    width = 27 if textured else 21
    P = 4 + len(UV_EDGES)
    rec = rng.uniform(-1.0, 1.0, (P, width)).astype(np.float32)
    rec[:, 9:21] = rng.uniform(0.0, 1.0, (P, 12))
    rec[1, 0:9] = 0.0                          # zero-length normal
    rec[2, 0:9] = np.tile([1.0, 0.0, 0.0], 3)  # n . l exactly 0
    rec[3, 0:9] = np.tile([0.0, -1.0, 0.0], 3)  # n . l = -1 (faces the ray)
    if textured:
        # corner 0's uv, read alone where u = v = 0
        rec[4:, 21:23] = UV_EDGES
    edge_prim = [-1, -1, 0, 1, 2, 3, 0] + list(range(4, P))
    edge_u = [0.0, 0.3, 0.25, 0.2, 0.1, 0.1, 0.3] + [0.0] * len(UV_EDGES)
    edge_v = [0.0, 0.7, 0.75, 0.3, 0.2, 0.2, 0.7] + [0.0] * len(UV_EDGES)
    n_rand = 500
    prim = np.concatenate([edge_prim, rng.integers(-1, P, n_rand)])
    u = rng.uniform(0.0, 1.0, n_rand)
    v = rng.uniform(0.0, 1.0, n_rand) * (1.0 - u)
    u = np.concatenate([edge_u, u]).astype(np.float32)
    v = np.concatenate([edge_v, v]).astype(np.float32)
    R = prim.shape[0]
    o = rng.uniform(-3.0, 3.0, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d[5] = [0.0, 1.0, 0.0]                     # against rec[3]'s normal
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0.1, 20.0, R).astype(np.float32)
    t[prim < 0] = np.inf
    scene_arrays = {"rec": torch.as_tensor(rec, device=device)}
    if textured:
        scene_arrays["texture"] = torch.as_tensor(
            rng.uniform(0.0, 1.0, (8, 16, 4)).astype(np.float32),
            device=device)
    cfg = tracer.RTConfig(width=R, height=1, textured=textured,
                          light_dir=(0.0, 1.0, 0.0),
                          light_color=(1.0, 0.9, 0.8), ambient=0.15)
    args = tuple(torch.as_tensor(x, device=device) for x in (
        o, d, prim.astype(np.int32), t, u, v)) + (0,)
    return scene_arrays, cfg, args


# ---------------------------------------------------------------- CPU ----

@pytest.mark.parametrize("textured,shadows", FORMS, ids=FORM_IDS)
def test_cpu_route_equals_pre_change_shade(monkeypatch, textured, shadows):
    """Every shade call of a 2-bounce frame: the wrapper's CPU route against
    the shade as it stood, bit for bit."""
    cfg = tracer.RTConfig(width=24, height=20, bounces=2, shadows=shadows,
                          textured=textured, engine="bvh")
    scene_arrays, occluded, calls, _ = _capture(
        monkeypatch, _small_scene(textured), cfg, "cpu")
    assert [c[-1] for c in calls] == [0, 1, 2]
    for args in calls:
        _compare(scene_arrays, cfg, occluded, args, cuda_rt.shade_hits,
                 _shade_before)


@pytest.mark.parametrize("textured,shadows", FORMS, ids=FORM_IDS)
def test_cpu_route_equals_pre_change_on_edges(textured, shadows):
    scene_arrays, cfg, args = _edge_batch(textured, "cpu")
    cfg = dataclasses.replace(cfg, shadows=shadows)
    _compare(scene_arrays, cfg, None, args, cuda_rt.shade_hits,
             _shade_before)


def test_edge_values():
    """What the edge rays read: a miss keeps its origin and gets no shadow
    ray; a zero-length normal stays 0; ndotl 0 or below parks the shadow
    ray; every output is finite."""
    scene_arrays, cfg, args = _edge_batch(True, "cpu")
    cfg = dataclasses.replace(cfg, shadows=True)
    occ = _Occluder()
    rgb, hit, pt, n = cuda_rt.shade_hits(scene_arrays, cfg, occ, *args)
    o = args[0]
    sh_o = occ.asked[0][0]
    park = torch.tensor(tracer.PARK_O)
    assert torch.equal(hit, args[2] >= 0)
    assert torch.equal(pt[:2], o[:2])
    assert torch.equal(sh_o[:2], park.expand(2, 3))
    assert torch.equal(n[3], torch.zeros(3))            # rec[1]: zero normal
    assert torch.equal(sh_o[3], park)
    for ray in (4, 5):                                  # ndotl 0, -1: parked
        assert torch.equal(sh_o[ray], park)
    assert bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(n).all())
    assert torch.equal(occ.asked[0][1], torch.tensor([[0.0, 1.0, 0.0]])
                       .expand(o.shape[0], 3))


@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_frame_unchanged(monkeypatch, textured):
    """A whole 2-bounce shadowed frame through the wrapper equals the frame
    shaded by the pre-change body."""
    cfg = tracer.RTConfig(width=24, height=20, bounces=2, shadows=True,
                          textured=textured, engine="bvh")
    scene = _small_scene(textured)
    frame, (o, d) = tracer.make_frame_fn(scene, CAM, cfg, device="cpu")
    img = frame(o, d)
    monkeypatch.setattr(tracer, "shade_hits", _shade_before)
    assert _same_bits(frame(o, d), img)


def test_cpu_route_counts_no_launch():
    scene_arrays, cfg, args = _edge_batch(False, "cpu")
    cuda_rt.reset_launch_counts()
    cuda_rt.shade_hits(scene_arrays, cfg, _Occluder(), *args)
    assert cuda_rt.launch_counts["shade_hits"] == 0
    assert not cuda_rt.launch_counts


def _bad(case):
    scene_arrays, cfg, args = _edge_batch(True, "cpu")
    o, d, prim, t, u, v, bounce = args
    if case == "prim_int64":
        prim = prim.long()
    elif case == "t_float64":
        t = t.double()
    elif case == "u_short":
        u = u[:-1]
    elif case == "rays_float64":
        o, d = o.double(), d.double()
    elif case == "rec_width":
        scene_arrays["rec"] = scene_arrays["rec"][:, :21]
    elif case == "rec_empty":
        scene_arrays["rec"] = scene_arrays["rec"][:0]
    elif case == "texture_channels":
        scene_arrays["texture"] = scene_arrays["texture"][..., :3]
    elif case == "texture_without_cfg":
        cfg = dataclasses.replace(cfg, textured=False)
    elif case == "device_mix":
        v = torch.empty(v.shape, dtype=v.dtype, device="meta")
    return scene_arrays, cfg, (o, d, prim, t, u, v, bounce)


@pytest.mark.parametrize("case", [
    "prim_int64", "t_float64", "u_short", "rays_float64", "rec_width",
    "rec_empty", "texture_channels", "texture_without_cfg", "device_mix"])
def test_wrapper_rejects(case):
    scene_arrays, cfg, args = _bad(case)
    with pytest.raises((TypeError, ValueError)):
        cuda_rt.shade_hits(scene_arrays, cfg, _Occluder(), *args)


# --------------------------------------------------------------- card ----

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("textured,shadows", FORMS, ids=FORM_IDS)
def test_kernel_matches_twin_on_edges_on_card(textured, shadows):
    dev = _need_card()
    scene_arrays, cfg, args = _edge_batch(textured, dev)
    cfg = dataclasses.replace(cfg, shadows=shadows)
    cuda_rt.reset_launch_counts()
    _compare(scene_arrays, cfg, None, args, cuda_rt.shade_hits,
             cuda_rt.shade_hits_reference)
    torch.cuda.synchronize()
    assert cuda_rt.launch_counts["shade_hits"] == 1


def _cell_scene(name):
    """The benchmark's two scenes (benchmark/configs): 184,832 triangles
    untextured, 12,032 textured."""
    verts, faces, colors = scenes.sphere_field(
        copies=9, subdiv=5 if name == "spheres184k" else 3)
    extra = {}
    if name == "spheres12k_tex":
        extra = dict(uvs=scenes.planar_uvs(verts),
                     texture=scenes.checkerboard_texture(**scenes.RT_CHECKER))
    return tracer.RTScene(verts=verts, faces=faces, colors=colors,
                          reflectivity=0.35, **extra)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["spheres184k", "spheres12k_tex"])
def test_kernel_matches_twin_on_frames_on_card(monkeypatch, name):
    """The three shade calls of a 256x256 2-bounce shadowed frame: kernel
    against twin bit for bit, three launches, and the frame equal to the
    twin-shaded frame."""
    dev = _need_card()
    textured = name == "spheres12k_tex"
    cfg = tracer.RTConfig(width=256, height=256, bounces=2, shadows=True,
                          textured=textured)
    scene = _cell_scene(name)
    cuda_rt.reset_launch_counts()
    scene_arrays, occluded, calls, img = _capture(monkeypatch, scene, cfg,
                                                  dev)
    torch.cuda.synchronize()
    assert cuda_rt.launch_counts["shade_hits"] == 3
    for args in calls:
        _compare(scene_arrays, cfg, occluded, args, cuda_rt.shade_hits,
                 cuda_rt.shade_hits_reference)
    frame, (o, d) = tracer.make_frame_fn(scene, CAM, cfg, device=dev)
    img = frame(o, d)
    monkeypatch.setattr(tracer, "shade_hits", cuda_rt.shade_hits_reference)
    assert _same_bits(frame(o, d), img)
