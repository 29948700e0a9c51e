"""The small-scene ray-traced frame as a whole: ``rt.tracer`` with the default
engine ``"pallas"`` on a scene of at most 15,000 triangles, which both
packages answer with their clustered closest-hit / any-hit pair.

At a small size: ``sphere_field(copies=4, subdiv=2)`` (1,792 triangles) at
64x64, the port on the CPU (the kernels' plain versions) against the JAX
frame of the same config (its Pallas kernels in interpret mode, as its own
tests run them).  Scene, BVH, camera and config are carried across with
``interop``; both frames get the same numpy rays in 32x32 pixel-tile order.
Tolerances: image atol 2e-5 without bounces, 1e-4 with two bounces.

At full size: ``skybox_rt_tpu_torch/data/rt_small_256.npz`` holds the 256x256
frames (plain and textured; 2 bounces, shadows) of ``sphere_field(copies=9,
subdiv=3)`` (12,032 triangles, reflectivity 0.35) rendered by the JAX package
with ``engine="pallas"``, and the scanline-order camera rays they were
rendered from.  chip_smoke.py holds the card's frames to it.  Here the file is
regenerated with the JAX package and must be current (rays rtol 1e-6, images
atol 1e-5), and the port renders a window of its rays on the CPU: atol 1e-4
and at least 99.9 % of the values within 2e-5 (what chip_smoke.py asks of the
card).

Regenerate the golden with
``PYTHONPATH=. python tests/test_torch_rt_small_frame.py --write``.
"""
import os
import sys

import numpy as np
import pytest
import torch

from skybox_rt_tpu.models import scenes as jax_scenes
from skybox_rt_tpu.rt import tracer as jax_tracer
from skybox_rt_tpu_torch import interop
from skybox_rt_tpu_torch.geom import cgltrace
from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.ops import cuda_rt
from skybox_rt_tpu_torch.rt import tracer, wavefront

torch.set_num_threads(1)

GOLDEN = os.path.join(cgltrace.DATA_DIR, "rt_small_256.npz")
GOLDEN_SIZE = 256
SIZE = 64
CAM = dict(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0), fov_y_deg=55.0)
BOUNCES = dict(bounces=2, shadows=True)
FRAMES = {
    "primary": dict(),
    "bounces": BOUNCES,
    "textured": dict(textured=True, shadows=True),
}


def jax_small_scene(copies, subdiv, textured=False):
    """The sphere field as a JAX-package scene, with planar texture
    coordinates and the checkerboard when textured."""
    verts, faces, colors = jax_scenes.sphere_field(copies=copies,
                                                   subdiv=subdiv)
    extra = {}
    if textured:
        extra = dict(uvs=scenes.planar_uvs(verts),
                     texture=jax_scenes.checkerboard_texture(
                         **scenes.RT_CHECKER))
    scene = jax_tracer.RTScene(verts=verts, faces=faces, colors=colors,
                               reflectivity=0.35, **extra)
    return scene, jax_tracer.Camera(**CAM)


def jax_frame(jscene, jcam, cfg):
    """(image, scanline rays o, d) of the JAX frame; the rays go in in
    32x32 pixel-tile order, as make_frame_fn hands them out."""
    import jax.numpy as jnp

    o, d = (np.asarray(a, np.float32)
            for a in jax_tracer.camera_rays(jcam, cfg.width, cfg.height))
    perm, _ = wavefront.tile_order_perm(cfg.width, cfg.height, 32)
    frame, _ = jax_tracer.make_frame_fn(jscene, jcam, cfg)
    image = np.asarray(frame(jnp.asarray(o[perm]), jnp.asarray(d[perm])),
                       np.float32)
    return image, o, d


_cache = {}


def _reference(name):
    """(port scene, port camera, port config, scanline rays o, d, JAX image)
    of a small frame, rendered once per process."""
    if name not in _cache:
        jscene, jcam = jax_small_scene(4, 2, textured=name == "textured")
        assert jscene.faces.shape[0] == 1792
        jcfg = jax_tracer.RTConfig(width=SIZE, height=SIZE, **FRAMES[name])
        assert jcfg.engine == "pallas"
        image, o, d = jax_frame(jscene, jcam, jcfg)
        _cache[name] = (interop.rt_scene_from_reference(jscene),
                        interop.camera_from_reference(jcam),
                        interop.rt_config_from_reference(jcfg), o, d, image)
    return _cache[name]


def _render(scene, cam, cfg, o, d):
    """The port's frame on the CPU from scanline rays o, d."""
    frame, (po, _) = tracer.make_frame_fn(scene, cam, cfg, device="cpu")
    assert po.shape == (SIZE * SIZE, 3) and po.device.type == "cpu"
    perm, _ = wavefront.tile_order_perm(SIZE, SIZE, 32)
    img = frame(o[perm], d[perm])
    assert img.shape == (SIZE, SIZE, 4) and img.dtype == torch.float32
    return img.numpy()


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of the clustered pair's plain versions."""
    counts = {"closest": 0, "any": 0}

    def counted(kind, fn):
        def wrapper(*args, **kw):
            counts[kind] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(cuda_rt, "closest_hit_clustered_reference", counted(
        "closest", cuda_rt.closest_hit_clustered_reference))
    monkeypatch.setattr(cuda_rt, "any_hit_clustered_reference", counted(
        "any", cuda_rt.any_hit_clustered_reference))
    return counts


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_small_frame_matches_jax(name, calls):
    scene, cam, cfg, o, d, want = _reference(name)
    assert cfg.engine == "pallas" and scene.bvh is not None
    assert tracer.resolve_engine(cfg, scene.faces.shape[0]) == "pallas"
    cuda_rt.reset_launch_counts()
    got = _render(scene, cam, cfg, o, d)
    # 1 + bounces closest calls, each with its shadow call; on the CPU they
    # are the plain versions and no kernel launch is counted
    n = 1 + cfg.bounces
    assert calls == {"closest": n, "any": n if cfg.shadows else 0}
    assert not cuda_rt.launch_counts
    assert np.isfinite(got).all() and (got[..., 3] == 1.0).all()
    hit = want[..., :3].sum(-1) > 0
    assert 0.2 < hit.mean() < 0.9
    diff = np.abs(got - want)
    print(f"{name}: max |diff| {diff.max():.3e}, beyond 2e-5: "
          f"{int((diff > 2e-5).sum())} of {diff.size}")
    np.testing.assert_allclose(got, want,
                               atol=1e-4 if cfg.bounces else 2e-5)
    if name == "bounces":
        primary = _reference("primary")[5]
        assert np.abs(want - primary).max() > 0.02      # the bounces show
    if name == "textured":      # the checker shows on the ground plane
        plain = _render(scene, cam, tracer.RTConfig(
            width=SIZE, height=SIZE, shadows=True), o, d)
        assert np.abs(got - plain).max() > 0.2
    # the port's own oracle engines
    for engine in ("brute", "pallas_bvh"):
        other = tracer.make_frame_fn(scene, cam, tracer.RTConfig(
            width=SIZE, height=SIZE, engine=engine, **FRAMES[name]),
            device="cpu")[0]
        if engine == "brute":
            img = other(o, d)
        else:
            perm, _ = wavefront.tile_order_perm(SIZE, SIZE, 32)
            img = other(o[perm], d[perm])
        np.testing.assert_allclose(got, img.numpy(), atol=2e-5,
                                   err_msg=engine)


@pytest.mark.parametrize("variant", [dict(bounce_width_ladder=0),
                                     dict(compact_stay=False),
                                     dict(compact_bounces=False)],
                         ids=["ladder_off", "no_stay", "no_compact"])
def test_scheduling_variants_bit_identical(variant, calls):
    """Launch width and ray order are scheduling: every ray's result is its
    own, so the image is equal bit for bit."""
    scene, cam, cfg, o, d, _ = _reference("bounces")
    base = _render(scene, cam, cfg, o, d)
    other = _render(scene, cam, tracer.RTConfig(
        width=SIZE, height=SIZE, **BOUNCES, **variant), o, d)
    assert calls == {"closest": 6, "any": 6}
    np.testing.assert_array_equal(base, other)


def test_default_config_renders_through_the_clustered_pair(calls):
    """RTConfig(width, height) and nothing else, on an icosphere."""
    verts, faces = scenes.icosphere(subdiv=2)
    scene = tracer.RTScene(verts=verts, faces=faces,
                           colors=np.ones((verts.shape[0], 4), np.float32))
    cam = tracer.Camera(eye=(0, 0, 3), look_at=(0, 0, 0))
    cfg = tracer.RTConfig(width=16, height=16)
    assert cfg.engine == "pallas"
    img = tracer.render(scene, cam, cfg, device="cpu").numpy()
    assert calls == {"closest": 1, "any": 0}
    ref = tracer.render(scene, cam, tracer.RTConfig(
        width=16, height=16, engine="brute"), device="cpu").numpy()
    assert (img[..., :3].sum(-1) > 0).mean() > 0.2
    np.testing.assert_allclose(img, ref, atol=2e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tracer.make_frame_fn(scene, cam, cfg)


@pytest.mark.parametrize("num_tris,engine,resolved", [
    (15000, "pallas", "pallas"), (15001, "pallas", "pallas_bvh"),
    (1, "pallas", "pallas"), (15000, "pallas_bvh", "pallas_bvh"),
    (15001, "bvh", "bvh"), (100, "brute", "brute"),
    (100, "pallas_streamed", "pallas_streamed"),
    (15001, "pallas_worklist", "pallas_worklist")])
def test_resolve_engine(num_tris, engine, resolved):
    assert tracer.PALLAS_MAX_TRIS == jax_tracer.PALLAS_MAX_TRIS == 15000
    cfg = tracer.RTConfig(width=8, height=8, engine=engine)
    assert tracer.resolve_engine(cfg, num_tris) == resolved
    assert tracer.resolve_engine(tracer.RTConfig(
        width=8, height=8, engine=engine, use_bvh=False), num_tris) == "brute"
    # the comparison engines resolve to themselves at any size
    for kept in ("pallas_streamed", "pallas_worklist"):
        assert tracer.resolve_engine(tracer.RTConfig(
            width=8, height=8, engine=kept), num_tris) == kept
    with pytest.raises(ValueError, match="unknown engine"):
        tracer.resolve_engine(tracer.RTConfig(
            width=8, height=8, engine="pallas_nope"), num_tris)


# ---- the committed golden of the full-width scene -------------------------

def jax_small_golden():
    """(scene, cam, {image, image_textured, o, d}) from the JAX package."""
    out = {}
    for key, textured in (("image", False), ("image_textured", True)):
        scene, cam = jax_small_scene(9, 3, textured=textured)
        cfg = jax_tracer.RTConfig(width=GOLDEN_SIZE, height=GOLDEN_SIZE,
                                  textured=textured, **BOUNCES)
        assert cfg.engine == "pallas"
        out[key], out["o"], out["d"] = jax_frame(scene, cam, cfg)
    return scene, cam, out


@pytest.fixture(scope="module")
def regenerated():
    return jax_small_golden()


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_golden_is_current(regenerated, golden):
    scene, _, new = regenerated
    assert int(golden["num_triangles"]) == scene.faces.shape[0] == 12032
    assert scene.faces.shape[0] <= jax_tracer.PALLAS_MAX_TRIS
    np.testing.assert_allclose(golden["o"], new["o"], rtol=1e-6)
    np.testing.assert_allclose(golden["d"], new["d"], rtol=1e-6, atol=1e-7)
    for key in ("image", "image_textured"):
        assert golden[key].shape == (GOLDEN_SIZE, GOLDEN_SIZE, 4)
        np.testing.assert_allclose(golden[key], new[key], atol=1e-5)
        hit = new[key][..., :3].sum(-1) > 0
        assert 0.3 < hit.mean() < 0.6 and (new[key][..., 3] == 1.0).all()
    assert np.abs(new["image"] - new["image_textured"]).max() > 0.2


@pytest.mark.parametrize("key,window", [("image", (104, 40, 32)),
                                        ("image_textured", (60, 150, 32))])
def test_port_renders_window_of_golden(regenerated, golden, key, window):
    """A window of the golden's rays through the port's clustered pair on
    the CPU, on the JAX-built BVH carried over with interop."""
    jscene, _, _ = regenerated
    scene = interop.rt_scene_from_reference(jscene)
    textured = key == "image_textured"
    assert (scene.texture is not None) and scene.bvh is not None
    y0, x0, n = window
    cfg = tracer.RTConfig(width=n, height=n, textured=textured, **BOUNCES)
    assert tracer.resolve_engine(cfg, scene.faces.shape[0]) == "pallas"
    closest, occluded = tracer.make_intersectors(scene, cfg, "cpu")
    arrays = tracer.scene_shade_arrays(scene, cfg, "cpu")
    ys, xs = np.mgrid[y0:y0 + n, x0:x0 + n]
    idx = (ys * GOLDEN_SIZE + xs).ravel()
    want = golden[key][y0:y0 + n, x0:x0 + n].reshape(-1, 4)
    got = tracer.trace_rays(arrays, cfg, closest, occluded,
                            scene.reflectivity,
                            torch.as_tensor(golden["o"][idx]),
                            torch.as_tensor(golden["d"][idx])).numpy()
    hit = want[:, :3].sum(-1) > 0
    assert 0.3 < hit.mean() <= 1.0
    diff = np.abs(got - want)
    print(f"{key}: max |diff| {diff.max():.3e}, beyond 2e-5: "
          f"{int((diff > 2e-5).sum())} of {diff.size}")
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (diff <= 2e-5).mean() >= 0.999


def _write_golden():
    scene, _, out = jax_small_golden()
    np.savez_compressed(GOLDEN, num_triangles=np.int64(scene.faces.shape[0]),
                        **out)
    print(GOLDEN, os.path.getsize(GOLDEN), "bytes")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=. python "
                 "tests/test_torch_rt_small_frame.py --write")
    import jax
    jax.config.update("jax_platforms", "cpu")
    _write_golden()
