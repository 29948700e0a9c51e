"""Ray-sharded rendering (parallel.ray_shard), the multi-process bring-up
(parallel.mesh.initialize_distributed over TCP), the scaling harness
(parallel.scaling) and ``cli scale``, on the CPU with gloo ranks in spawned
processes that load no JAX.

render_sharded at 48x40 (rows that do not divide among the ranks): the JAX
test_ray_shard.py configurations, engines bvh and pallas on 2 ranks, bvh
with a bounce on 4, and the north-star scene class (sphere_field(copies=4,
subdiv=2), two bounces, shadows) with pallas_bvh on 4.  Each frame against
the port's unsharded tracer.render within atol 1e-6 (the JAX test's
sharded-vs-single tolerance) and against the JAX package's unsharded render
within atol 2e-5, 1e-4 with bounces (tests/test_torch_rt_tracer.py's; XLA's
CPU code contracts multiply-adds); the north star against JAX's bvh engine,
which its pallas_bvh equals in the JAX suite (the Pallas interpreter would
take the JAX side 9 s).
"""
import json
import multiprocessing
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skybox_rt_tpu.diff import binning as jax_binning
from skybox_rt_tpu.diff import pipeline as jax_pipeline
from skybox_rt_tpu.models import scenes as jax_scenes
from skybox_rt_tpu.parallel import mesh as jax_mesh
from skybox_rt_tpu.parallel import tile_shard as jax_tile_shard
from skybox_rt_tpu.rt import tracer as jax_tracer
from skybox_rt_tpu_torch import interop
from skybox_rt_tpu_torch.diff import binning
from skybox_rt_tpu_torch.parallel import mesh as mesh_mod
from skybox_rt_tpu_torch.parallel import scaling
from skybox_rt_tpu_torch.rt import tracer

import test_torch_parallel_ranks as ranks

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 48, 40
#: frame -> (ranks, scene, RTConfig keywords, the JAX engine it is held to)
FRAMES = {
    "bvh": (2, "sphere", dict(engine="bvh"), "bvh"),
    "pallas_shadows": (2, "sphere", dict(engine="pallas", shadows=True),
                       "pallas"),
    "bvh_bounce": (4, "sphere", dict(engine="bvh", shadows=True, bounces=1),
                   "bvh"),
    "northstar": (4, "field", dict(engine="pallas_bvh", shadows=True,
                                   bounces=2), "bvh"),
}


def _jax_scene(name):
    if name == "sphere":
        verts, faces = jax_scenes.icosphere(subdiv=2)
        colors = np.tile(np.array([[0.8, 0.3, 0.25, 1.0]], np.float32),
                         (verts.shape[0], 1))
        return jax_tracer.RTScene(
            verts=verts.astype(np.float32), faces=faces.astype(np.int32),
            colors=colors, reflectivity=0.4), jax_tracer.Camera(
            eye=(0.0, 0.6, 3.2), look_at=(0.0, -0.1, 0.0))
    verts, faces, colors = jax_scenes.sphere_field(copies=4, subdiv=2)
    return jax_tracer.RTScene(verts=verts, faces=faces, colors=colors,
                              reflectivity=0.35), jax_tracer.Camera(
        eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0), fov_y_deg=55.0)


def _case(frame):
    """(port RTScene fields as numpy, Camera, RTConfig) of a frame."""
    _, scene_name, kw, _ = FRAMES[frame]
    jscene, jcam = _jax_scene(scene_name)
    scene = interop.rt_scene_from_reference(jscene)
    fields = {k: getattr(scene, k) for k in
              ("verts", "faces", "colors", "reflectivity")}
    return (fields, interop.camera_from_reference(jcam),
            tracer.RTConfig(width=W, height=H, **kw))


@pytest.fixture(scope="module")
def worlds():
    """ranks -> {frame: results}; one world of each size."""
    out = {}
    for n in sorted({v[0] for v in FRAMES.values()}):
        cases = {f: _case(f) for f, v in FRAMES.items() if v[0] == n}
        out[n] = mesh_mod.spawn(ranks.rt_world, n, n, cases)
    return out


@pytest.mark.parametrize("frame", list(FRAMES))
def test_ray_sharded_frame_matches(worlds, frame):
    n, scene_name, kw, jax_engine = FRAMES[frame]
    got = worlds[n]
    res = got[frame]
    fields, cam, cfg = _case(frame)
    plain = tracer.render(tracer.RTScene(**fields), cam, cfg,
                          device="cpu").numpy()
    jscene, jcam = _jax_scene(scene_name)
    jcfg = jax_tracer.RTConfig(width=W, height=H,
                               **dict(kw, engine=jax_engine))
    want = np.asarray(jax_tracer.render(jscene, jcam, jcfg))
    assert res["image"].shape == (H, W, 4)
    assert res["image"].dtype == np.float32
    assert float((res["image"][..., :3].sum(-1) > 0).mean()) > 0.1
    np.testing.assert_allclose(res["image"], plain, atol=1e-6, rtol=0)
    for img in res["every_rank"]:
        np.testing.assert_array_equal(img, res["image"])
    np.testing.assert_allclose(res["image"], want, rtol=0,
                               atol=1e-4 if cfg.bounces else 2e-5)
    assert res["counts"] == {"all_gather": 1}
    assert got["jax_loaded"] is False


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_tcp_world_matches_jax():
    """Two processes joined by initialize_distributed over
    tcp://127.0.0.1 (tests/test_multiprocess.py's bring-up): both see a
    world of 2 and compute the same sharded render and train step, which
    agree with the JAX package's on a 2-device mesh (rtol 1e-5, the JAX
    test's)."""
    params, indices = jax_scenes.triangle()
    jcfg = jax_pipeline.DiffRenderConfig(width=32, height=32, tile_logsize=3)
    static = binning.bin_static(params["pos"], indices, 32, 32,
                                tile_logsize=3)
    cfg = interop.diff_config_from_reference(jcfg)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=ranks.tcp_rank,
                         args=(coordinator, pid, params, static, cfg,
                               results)) for pid in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(results.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    assert all(isinstance(r, dict) for r in got.values()), got
    assert [got[i]["rank"] for i in (0, 1)] == [0, 1]
    for r in got.values():
        assert r["world"] == 2 and r["jax_loaded"] is False
    for k in ("loss", "color_sum", "img_sum", "max_writes"):
        assert got[0][k] == got[1][k], k
    np.testing.assert_array_equal(got[0]["img"], got[1]["img"])

    mesh = jax_mesh.make_mesh(2)
    sharded = jax_tile_shard.shard_tiles(
        jax_binning.bin_static(params["pos"], indices, 32, 32,
                               tile_logsize=3), 2)
    arrays = {k: jnp.asarray(v) for k, v in sharded.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    img = np.asarray(jax_tile_shard.make_sharded_render(mesh, jcfg)(
        jparams, arrays))
    target = jnp.zeros((sharded["tile_xy"].shape[0], 8, 8, 4), jnp.float32)
    new, loss, _ = jax_tile_shard.make_train_step(mesh, jcfg, lr=1e-4)(
        jparams, arrays, target)
    np.testing.assert_allclose(got[0]["img_sum"], float(img.sum()),
                               rtol=1e-5)
    np.testing.assert_allclose(got[0]["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(got[0]["color_sum"],
                               float(jnp.sum(new["color"])), rtol=1e-5)


#: the keys of a size's entry in the JAX package's scaling.measure
SCALING_KEYS = {"ms", "speedup", "efficiency"}


def test_scaling_measure():
    """The sweep across worlds of 1 and 2 ranks reports the JAX harness's
    keys (the CPU's numbers are no performance claim)."""
    results = scaling.measure(mesh_sizes=[1, 2], size=64, iters=2,
                              warmup=1, device="cpu")
    assert set(results) == {1, 2}
    assert results[1]["efficiency"] == 1.0
    for r in results.values():
        assert set(r) == SCALING_KEYS
        assert r["ms"] > 0 and np.isfinite(r["speedup"])


def test_build_workload_matches_jax():
    from skybox_rt_tpu.parallel import scaling as jax_scaling
    params, static, cfg = scaling.build_workload(64)
    jparams, jstatic, jcfg = jax_scaling.build_workload(64)
    assert sorted(params) == sorted(jparams)
    for k in params:
        np.testing.assert_array_equal(params[k], np.asarray(jparams[k]))
    for k in jstatic:
        np.testing.assert_array_equal(static[k], jstatic[k])
    assert cfg == interop.diff_config_from_reference(jcfg)


def test_cli_scale_writes_its_artifact(tmp_path):
    """``python -m skybox_rt_tpu_torch scale --device cpu``: the JAX
    command's JSON and its BENCH_r*-shaped artifact lines, one a world."""
    artifact = tmp_path / "scale.jsonl"
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "skybox_rt_tpu_torch", "scale", "--device",
         "cpu", "-w", "64", "--iters", "2", "--artifact", str(artifact)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    report = json.loads(out[:out.index("\nwrote ")])
    assert set(report) == {"1", "2"}
    assert all(set(v) == SCALING_KEYS for v in report.values())
    assert out.rstrip().endswith(f"wrote {artifact}")
    lines = [json.loads(ln) for ln in artifact.read_text().splitlines()]
    assert [ln["metric"] for ln in lines] == ["train_step_64x64_mesh1",
                                              "train_step_64x64_mesh2"]
    for ln in lines:
        assert set(ln) == {"metric", "value", "unit", "vs_baseline"}
        assert ln["unit"] == "ms/step" and ln["value"] > 0
    assert lines[0]["vs_baseline"] == 1.0
