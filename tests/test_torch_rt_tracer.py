"""The ray-traced frame as a whole: the port's rt.tracer against the JAX
package, on the CPU.

Scene: ``sphere_field(copies=4, subdiv=2)`` (1,792 triangles) at 48x48,
engine ``pallas_bvh`` with ``BVH_TRI_BLOCK`` set to 32 in both packages so
that the AABB pyramid has two levels.  Both ``frame`` functions get the same
numpy rays: JAX's scanline-order ``camera_rays``, permuted into 32x32 pixel
tiles by the port's ``tile_order_perm`` (the order a ``pallas*`` engine's
``frame`` expects).  The JAX side runs its Pallas kernels in interpret mode,
as its own tests do on the CPU.

Tolerances: image atol 2e-5 (the JAX suite's cross-engine tolerance) for the
primary, shadowed and textured frames; atol 1e-4 with bounces, the count of
values beyond 2e-5 printed.  The one bounce loop runs under every engine of
the port, each held to the one JAX bounce frame, and at other depths, with
and without shadows, against the JAX all-pairs frame of the same config.
The width ladder is pure scheduling: ladder 0 and 2 give the same bits.
The port's ``pallas_bvh`` against its own ``brute`` and ``bvh`` engines:
atol 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skybox_rt_tpu.models import scenes as jax_scenes
from skybox_rt_tpu.rt import tracer as jax_tracer
from skybox_rt_tpu_torch import interop
from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.ops import cuda_rt
from skybox_rt_tpu_torch.rt import tracer, wavefront

torch.set_num_threads(1)

SIZE = 48
TRI_BLOCK = 32
CAM = dict(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0), fov_y_deg=55.0)
FRAMES = {
    "primary": dict(),
    "shadows": dict(shadows=True),
    "bounces": dict(bounces=2, shadows=True),
    "textured": dict(textured=True, shadows=True),
}
# bounce depths and shadows of the depth sweep, beside FRAMES["bounces"]
DEPTHS = {
    "b1": dict(bounces=1),
    "b1_shadows": dict(bounces=1, shadows=True),
    "b2": dict(bounces=2),
    "b3": dict(bounces=3),
    "b3_shadows": dict(bounces=3, shadows=True),
}


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(jax_tracer, "BVH_TRI_BLOCK", TRI_BLOCK)
    monkeypatch.setattr(tracer, "BVH_TRI_BLOCK", TRI_BLOCK)


def _jax_scene(name):
    if name == "textured":
        verts, faces = jax_scenes.icosphere(subdiv=2)
        colors = np.ones((verts.shape[0], 4), np.float32)
        uvs = np.stack([
            0.5 + np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi),
            0.5 + np.arcsin(np.clip(verts[:, 1], -1, 1)) / np.pi,
        ], -1).astype(np.float32)
        tex = jax_scenes.checkerboard_texture(size=32, tiles=4)
        scene = jax_tracer.RTScene(verts=verts, faces=faces, colors=colors,
                                   uvs=uvs, texture=tex)
        return scene, jax_tracer.Camera(eye=(0, 0, 3), look_at=(0, 0, 0))
    verts, faces, colors = jax_scenes.sphere_field(copies=4, subdiv=2)
    assert faces.shape[0] == 1792
    scene = jax_tracer.RTScene(verts=verts, faces=faces, colors=colors,
                               reflectivity=0.35)
    return scene, jax_tracer.Camera(**CAM)


_cache = {}
_renders = {}


def _reference(name):
    """(port scene, port camera, scanline rays o, d, JAX image) of a frame,
    the JAX frame rendered once per process."""
    if name not in _cache:
        jscene, jcam = _jax_scene(name)
        cfg = jax_tracer.RTConfig(width=SIZE, height=SIZE,
                                  engine="pallas_bvh", **FRAMES[name])
        o, d = (np.asarray(a) for a in jax_tracer.camera_rays(jcam, SIZE,
                                                              SIZE))
        perm, _ = wavefront.tile_order_perm(SIZE, SIZE, 32)
        frame, _ = jax_tracer.make_frame_fn(jscene, jcam, cfg)
        image = np.asarray(frame(jnp.asarray(o[perm]), jnp.asarray(d[perm])))
        _cache[name] = (interop.rt_scene_from_reference(jscene),
                        interop.camera_from_reference(jcam), o, d, image,
                        interop.rt_config_from_reference(cfg))
    return _cache[name]


def _render(scene, cam, cfg, o, d):
    """The port's frame on the CPU from scanline rays o, d."""
    frame, (po, pd) = tracer.make_frame_fn(scene, cam, cfg, device="cpu")
    assert po.shape == (SIZE * SIZE, 3) and po.device.type == "cpu"
    if cfg.engine.startswith("pallas"):
        perm, _ = wavefront.tile_order_perm(SIZE, SIZE, 32)
        o, d = o[perm], d[perm]
    img = frame(o, d)
    assert img.shape == (SIZE, SIZE, 4) and img.dtype == torch.float32
    return img.numpy()


@pytest.mark.parametrize("name", ["primary", "shadows", "textured"])
def test_frame_matches_jax(name):
    scene, cam, o, d, want, cfg = _reference(name)
    assert cfg.engine == "pallas_bvh" and cfg.width == SIZE
    got = _render(scene, cam, cfg, o, d)
    assert np.isfinite(got).all() and (got[..., 3] == 1.0).all()
    hit = want[..., :3].sum(-1) > 0
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_allclose(got, want, atol=2e-5)
    if name == "textured":      # the checker shows: bright and dark hits
        vals = got[..., :3].sum(-1)[hit]
        assert vals.max() > vals.min() * 2.0
    for engine in ("brute", "bvh"):
        other = _render(scene, cam, tracer.RTConfig(
            width=SIZE, height=SIZE, engine=engine, **FRAMES[name]), o, d)
        np.testing.assert_allclose(got, other, atol=2e-5, err_msg=engine)


def _bounce_render(engine):
    """The port's bounce frame under ``engine``, rendered once per process."""
    if engine not in _renders:
        scene, cam, o, d, _, _ = _reference("bounces")
        cuda_rt.reset_launch_counts()
        _renders[engine] = _render(scene, cam, tracer.RTConfig(
            width=SIZE, height=SIZE, engine=engine, **FRAMES["bounces"]),
            o, d)
        # the CPU runs the plain versions: no kernel launch is counted
        assert not cuda_rt.launch_counts
    return _renders[engine]


@pytest.mark.parametrize("engine", [
    pytest.param("pallas_bvh", id="default"), "pallas", "pallas_streamed",
    "pallas_worklist", "bvh", "brute"])
def test_bounce_frame_matches_jax(engine):
    """The one bounce loop under each of the port's engines against the JAX
    pallas_bvh bounce frame."""
    assert engine in tracer.ENGINES
    want = _reference("bounces")[4]
    got = _bounce_render(engine)
    diff = np.abs(got - want)
    print(f"{engine}: max |diff| {diff.max():.3e}, beyond 2e-5: "
          f"{int((diff > 2e-5).sum())} of {diff.size}")
    np.testing.assert_allclose(got, want, atol=1e-4)
    primary = _reference("shadows")[4]
    assert np.abs(want - primary).max() > 0.02      # the bounces show
    if engine == "pallas_bvh":
        for other in ("brute", "bvh"):
            np.testing.assert_allclose(got, _bounce_render(other), atol=2e-5,
                                       err_msg=other)


@pytest.mark.parametrize("depth", sorted(DEPTHS))
def test_bounce_depths_match_jax(depth, monkeypatch):
    """Bounce depths 1 to 3, with and without shadows, on pallas_bvh
    against the JAX all-pairs frame of the same config (scanline rays, no
    Pallas interpret).  Few rays survive a bounce here, so every bounce
    launches at R/4 and, past the first, sorts only that prefix."""
    scene, cam, o, d, _, _ = _reference("bounces")
    jscene, jcam = _jax_scene("bounces")
    jcfg = jax_tracer.RTConfig(width=SIZE, height=SIZE, engine="brute",
                               **DEPTHS[depth])
    frame, _ = jax_tracer.make_frame_fn(jscene, jcam, jcfg)
    want = np.asarray(frame(jnp.asarray(o), jnp.asarray(d)))
    widths = []
    ladder = tracer._ladder_width

    def recorded(*args):
        widths.append(ladder(*args))
        return widths[-1]

    monkeypatch.setattr(tracer, "_ladder_width", recorded)
    got = _render(scene, cam, tracer.RTConfig(
        width=SIZE, height=SIZE, engine="pallas_bvh", **DEPTHS[depth]), o, d)
    bounces = DEPTHS[depth]["bounces"]
    # one launch width a bounce, one prefix width a bounce past the first
    assert len(widths) == 2 * bounces - 1
    assert max(widths) < SIZE * SIZE    # the ladder narrows every launch
    diff = np.abs(got - want)
    print(f"{depth}: max |diff| {diff.max():.3e}, beyond 2e-5: "
          f"{int((diff > 2e-5).sum())} of {diff.size}, widths {widths}")
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(want - _reference("primary")[4]).max() > 0.02


def test_ladder_variants_bit_identical(monkeypatch):
    """Ladder 0 against ladder 2: the same per-ray arithmetic at another
    launch width, so the images are equal bit for bit."""
    scene, cam, o, d, _, _ = _reference("bounces")
    imgs = []
    for k in (0, 2):
        monkeypatch.setattr(tracer, "BOUNCE_WIDTH_LADDER", k)
        imgs.append(_render(scene, cam, tracer.RTConfig(
            width=SIZE, height=SIZE, engine="pallas_bvh",
            **FRAMES["bounces"]), o, d))
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert tracer.BOUNCE_WIDTH_LADDER == 2
    assert tracer._ladder_width(4096, 1000, 2) == 1024
    assert tracer._ladder_width(4096, 1025, 2) == 2048
    assert tracer._ladder_width(4096, 3000, 2) == 4096
    assert tracer._ladder_width(1024, 10, 2) == 512     # the w < 512 floor
    assert tracer._ladder_width(4096, 10, 0) == 4096


def test_camera_rays_match_jax():
    """rtol 1e-6: tan, deg2rad and the norms may differ by an ulp."""
    for w, h in ((48, 48), (40, 24)):
        cam = tracer.Camera(**CAM)
        o, d = tracer.camera_rays(cam, w, h, device="cpu")
        jo, jd = jax_tracer.camera_rays(jax_tracer.Camera(**CAM), w, h)
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                                   atol=1e-7)


def test_compaction_helpers_match_jax():
    rng = np.random.default_rng(0)
    R = 1000
    o = rng.normal(size=(R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    active = rng.random(R) < 0.6
    want = np.asarray(jax_tracer._compact_key(
        jnp.asarray(active), jnp.asarray(o), jnp.asarray(d)))
    got = tracer._compact_key(torch.as_tensor(active), torch.as_tensor(o),
                              torch.as_tensor(d))
    assert got.dtype == torch.int32
    # the quantized origin truncates a float: a last-ulp difference may
    # move a handful of keys by one cell
    assert (got.numpy() == want).mean() > 0.99
    assert (got.numpy()[~active] == 1 << 30).all()
    # the bounce loop's permutation: a stable argsort of the key, live
    # rays first, as the JAX package's default ("argsort") compaction
    gp = torch.argsort(got, stable=True).numpy()
    wp = np.asarray(jnp.argsort(jnp.asarray(want), stable=True))
    assert active[gp][:active.sum()].all()
    np.testing.assert_array_equal(np.sort(gp), np.arange(R))
    np.testing.assert_array_equal(gp, np.argsort(got.numpy(), kind="stable"))
    np.testing.assert_array_equal(np.sort(gp[:active.sum()]),
                                  np.sort(wp[:active.sum()]))


def test_vertex_normals_and_shade_arrays_match_jax():
    jscene, _ = _jax_scene("textured")
    jscene.finalize()
    scene = interop.rt_scene_from_reference(
        jax_tracer.RTScene(verts=jscene.verts, faces=jscene.faces,
                           colors=jscene.colors, uvs=jscene.uvs,
                           texture=jscene.texture, bvh=jscene.bvh))
    assert scene.normals is None and scene.bvh is not None
    scene.finalize()
    np.testing.assert_array_equal(scene.normals, jscene.normals)
    cfg = tracer.RTConfig(width=8, height=8, textured=True)
    want = jax_tracer.scene_shade_arrays(
        jscene, jax_tracer.RTConfig(width=8, height=8, textured=True))
    got = tracer.scene_shade_arrays(scene, cfg, device="cpu")
    for k in ("rec", "texture"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("engine", ["pallas", "pallas_streamed",
                                    "pallas_worklist"])
def test_unported_engines_raise(engine):
    """Every engine of the JAX package has its kernels now: none raises
    NotImplementedError, each resolves to itself on a scene of at most
    PALLAS_MAX_TRIS triangles and renders the all-pairs oracle's frame
    (atol 2e-5); only an unknown name raises."""
    scene, cam, o, d, _, _ = _reference("primary")
    cfg = tracer.RTConfig(width=16, height=16, engine=engine)
    assert engine in tracer.ENGINES
    assert tracer.resolve_engine(cfg, scene.faces.shape[0]) == engine
    frame, (po, pd) = tracer.make_frame_fn(scene, cam, cfg, device="cpu")
    brute = tracer.render(scene, cam, tracer.RTConfig(
        width=16, height=16, engine="brute"), device="cpu")
    perm, _ = wavefront.tile_order_perm(16, 16, 32)
    # po, pd are in tile order; brute renders scanline order
    assert torch.equal(po[np.argsort(perm)],
                       tracer.camera_rays(cam, 16, 16, "cpu")[0])
    np.testing.assert_allclose(frame(po, pd).numpy(), brute.numpy(),
                               atol=2e-5)
    with pytest.raises(ValueError):
        tracer.make_frame_fn(scene, cam, tracer.RTConfig(
            width=16, height=16, engine="nope"), device="cpu")
    # a JAX config's use_bvh=False converts to the all-pairs oracle
    jcfg = jax_tracer.RTConfig(width=16, height=16, engine=engine,
                               use_bvh=False)
    cfg = interop.rt_config_from_reference(jcfg)
    assert cfg.engine == "brute" and cfg.width == 16
    assert tracer.resolve_engine(cfg, scene.faces.shape[0]) == "brute"
    tracer.make_intersectors(scene, cfg, "cpu")


def test_large_scene_takes_bvh_blocks_engine(monkeypatch):
    """Engine "pallas" above PALLAS_MAX_TRIS triangles takes pallas_bvh, as
    in the JAX package, and matches the stackless engine."""
    monkeypatch.setattr(tracer, "BVH_TRI_BLOCK", 256)
    verts, faces = scenes.icosphere(subdiv=5)
    assert faces.shape[0] == 20480 > tracer.PALLAS_MAX_TRIS
    colors = np.ones((verts.shape[0], 4), np.float32)
    scene = tracer.RTScene(verts=verts, faces=faces, colors=colors,
                           bvh_method="median")
    cam = tracer.Camera(eye=(0, 0, 3), look_at=(0, 0, 0))
    cfg = tracer.RTConfig(width=16, height=16, engine="pallas")
    assert tracer.resolve_engine(cfg, faces.shape[0]) == "pallas_bvh"
    img = tracer.render(scene, cam, cfg, device="cpu").numpy()
    assert np.isfinite(img).all() and (img[..., :3].sum(-1) > 0).any()
    ref = tracer.render(scene, cam, tracer.RTConfig(
        width=16, height=16, engine="bvh"), device="cpu").numpy()
    np.testing.assert_allclose(img, ref, atol=1e-5)


def test_entry_points_default_to_the_card():
    """Without device= the entry points use the CUDA card, and without a
    card they raise: none carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    from skybox_rt_tpu_torch.geom import cgltrace
    from skybox_rt_tpu_torch.ref import driver

    scene, cam, _, _, _, _ = _reference("primary")
    cfg = tracer.RTConfig(width=8, height=8, engine="brute")
    trace = cgltrace.load_trace(cgltrace.trace_path("synth_draw3d"))
    calls = [
        lambda: tracer.make_frame_fn(scene, cam, cfg),
        lambda: tracer.render(scene, cam, cfg),
        lambda: tracer.camera_rays(cam, 8, 8),
        lambda: tracer.make_intersectors(scene, cfg),
        lambda: tracer.scene_shade_arrays(scene, cfg),
        lambda: driver.render_trace(trace, 32, 32),
        lambda: driver.prepare_drawcalls(trace, 32, 32),
        lambda: driver.compile_frame(trace, 32, 32),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
