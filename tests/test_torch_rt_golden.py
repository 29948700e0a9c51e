"""The committed JAX golden of the full-size ray-traced scene.

``skybox_rt_tpu_torch/data/rt_northstar_256.npz`` holds the 256x256 frame of
``sphere_field(copies=9, subdiv=5)`` (184,832 triangles, reflectivity 0.35,
2 mirror bounces, shadows) rendered on the CPU by the JAX package's
stackless XLA engine (``engine="bvh"``), and the scanline-order camera rays
``o``, ``d`` it was rendered from.  chip_smoke.py holds the card's frame to
it.  Here, at full size (about 15 s for the SAH build and 15 s for the JAX
render on one CPU core; nothing is reduced):

  * the file is regenerated with the JAX package and must be current:
    rays rtol 1e-6, image atol 1e-5 (XLA's CPU code may differ in the last
    ulps from one CPU model to another);
  * the port's ``"bvh"`` engine, on the JAX-built BVH carried over with
    interop, renders a 64x64 window of those rays on the CPU: atol 1e-4 and
    at least 99.9 % of the values within 2e-5 (the tolerances chip_smoke.py
    holds the card to);
  * the port's ``"pallas_bvh"`` engine (the plain versions of the kernels, on
    the port's own treelet blocks at tri_block 256) renders a 32x32 window.

Regenerate the golden with
``PYTHONPATH=. python tests/test_torch_rt_golden.py --write``.
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
from skybox_rt_tpu_torch.rt import tracer

torch.set_num_threads(1)

GOLDEN = os.path.join(cgltrace.DATA_DIR, "rt_northstar_256.npz")
SIZE = 256
KW = dict(bounces=2, shadows=True)


def jax_northstar():
    """(scene, cam, image (256,256,4), o, d) from the JAX package."""
    verts, faces, colors = jax_scenes.sphere_field(copies=9, subdiv=5)
    scene = jax_tracer.RTScene(verts=verts, faces=faces, colors=colors,
                               reflectivity=0.35)
    cam = jax_tracer.Camera(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0),
                            fov_y_deg=55.0)
    cfg = jax_tracer.RTConfig(width=SIZE, height=SIZE, engine="bvh", **KW)
    frame, (o, d) = jax_tracer.make_frame_fn(scene, cam, cfg)
    image = np.asarray(frame(o, d), np.float32)
    return scene, cam, image, np.asarray(o, np.float32), \
        np.asarray(d, np.float32)


@pytest.fixture(scope="module")
def northstar():
    return jax_northstar()


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_golden_is_current(northstar, golden):
    _, _, image, o, d = northstar
    assert golden["image"].shape == (SIZE, SIZE, 4)
    assert int(golden["num_triangles"]) == 184832
    np.testing.assert_allclose(golden["o"], o, rtol=1e-6)
    np.testing.assert_allclose(golden["d"], d, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(golden["image"], image, atol=1e-5)
    hit = image[..., :3].sum(-1) > 0
    assert 0.3 < hit.mean() < 0.6 and (image[..., 3] == 1.0).all()


def _window(golden, y0, x0, n):
    ys, xs = np.mgrid[y0:y0 + n, x0:x0 + n]
    idx = (ys * SIZE + xs).ravel()
    return golden["o"][idx], golden["d"][idx], \
        golden["image"][y0:y0 + n, x0:x0 + n].reshape(-1, 4)


def _check(got, want):
    diff = np.abs(got - want)
    print(f"max |diff| {diff.max():.3e}, beyond 2e-5: "
          f"{int((diff > 2e-5).sum())} of {diff.size}")
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (diff <= 2e-5).mean() >= 0.999


@pytest.mark.parametrize("engine,window", [("bvh", (112, 32, 64)),
                                           ("pallas_bvh", (136, 160, 32))])
def test_port_renders_window_of_golden(northstar, golden, engine, window):
    """A window of the golden's rays through the port on the CPU; the window
    holds spheres, ground, shadows and reflections."""
    jscene, _, _, _, _ = northstar
    scene = interop.rt_scene_from_reference(jscene)
    n = window[2]
    cfg = tracer.RTConfig(width=n, height=n, engine=engine, **KW)
    closest, occluded = tracer.make_intersectors(scene, cfg, "cpu")
    arrays = tracer.scene_shade_arrays(scene, cfg, "cpu")
    o, d, want = _window(golden, *window)
    got = tracer.trace_rays(arrays, cfg, closest, occluded,
                            scene.reflectivity, torch.as_tensor(o),
                            torch.as_tensor(d)).numpy()
    hit = want[:, :3].sum(-1) > 0
    assert 0.3 < hit.mean() < 1.0
    _check(got, want)


def _write_golden():
    scene, _, image, o, d = jax_northstar()
    np.savez_compressed(GOLDEN, image=image, o=o, d=d,
                        num_triangles=np.int64(scene.faces.shape[0]))
    print(GOLDEN, os.path.getsize(GOLDEN), "bytes")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_rt_golden.py "
                 "--write")
    import jax
    jax.config.update("jax_platforms", "cpu")
    _write_golden()
