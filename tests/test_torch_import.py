"""The port stands without JAX: importing every module of
skybox_rt_tpu_torch, rendering a raster frame (binned by the native engine)
with its statistics, asking the command line for the device's caps,
rendering a ray-traced frame (every engine) and the ray-traced CGLTrace
frame, taking training steps of the differentiable render, running the
apps and the sharded raster frame of a one-rank world on the CPU loads
neither jax, optax, orbax nor skybox_rt_tpu, and
chip_smoke.py refuses to run without a card."""
import importlib.util
import json
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest

import skybox_rt_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(skybox_rt_tpu_torch.__path__,
                                          "skybox_rt_tpu_torch."))

_PROBE = r"""
import importlib, json, sys
mods = json.loads(sys.argv[1])
for m in mods:
    importlib.import_module(m)
from skybox_rt_tpu_torch.geom import cgltrace
from skybox_rt_tpu_torch.ref import driver
trace = cgltrace.load_trace(cgltrace.trace_path("synth_draw3d"))
stats = driver.FrameStats()
fb = driver.render_trace(trace, 32, 32, start_draw=2, end_draw=3,
                         stats=stats, mode="deferred", measure_traffic=True,
                         device="cpu")
from skybox_rt_tpu_torch import cli
cli.main(["info", "--device", "cpu"])
from skybox_rt_tpu_torch.models import scenes
from skybox_rt_tpu_torch.rt import tracer
verts, faces = scenes.icosphere(subdiv=1)
scene = tracer.RTScene(verts=verts, faces=faces,
                       colors=scenes.F32(1) * (verts[:, :1] * 0 + [1, 1, 1, 1]),
                       reflectivity=0.5)
img = tracer.render(scene, tracer.Camera(eye=(0, 0.5, 3), look_at=(0, 0, 0)),
                    tracer.RTConfig(width=16, height=16, engine="brute",
                                    bounces=1, shadows=True), device="cpu")
small = tracer.render(scene, tracer.Camera(eye=(0, 0.5, 3), look_at=(0, 0, 0)),
                      tracer.RTConfig(width=16, height=16, bounces=1,
                                      shadows=True), device="cpu")
engines = {}
for engine in ("pallas_streamed", "pallas_worklist"):
    cfg = tracer.RTConfig(width=16, height=16, engine=engine, bounces=1,
                          shadows=True)
    assert tracer.resolve_engine(cfg, faces.shape[0]) == engine
    other = tracer.render(scene, tracer.Camera(eye=(0, 0.5, 3),
                                               look_at=(0, 0, 0)), cfg,
                          device="cpu")
    engines[engine] = float((other - small).abs().max())
from skybox_rt_tpu_torch.rt import diff as rt_diff, frame, raster_bridge
c3 = cgltrace.load_trace(cgltrace.trace_path("synth_config3"))
fused = frame.render_trace_rt_fused(c3, 16, 16, device="cpu")
bridged = raster_bridge.render_trace_rt(c3, 16, 16, engine="brute",
                                        camera="perspective", device="cpu")
import torch
v = torch.tensor(verts, requires_grad=True)
o, d = tracer.camera_rays(tracer.Camera(eye=(0, 0.5, 3), look_at=(0, 0, 0)),
                          8, 8, "cpu")
rt_diff.render_lambert(v, faces, scene.colors, o, d, (0.4, 0.8, 0.45),
                       device="cpu").sum().backward()
from skybox_rt_tpu_torch.diff import check, optim, pipeline
params, static, cfg = check.train_scene(32, subdiv=1, tile_logsize=3,
                                        tex_size=8, tex_tiles=2)
params, static = check.to_device(params, static, "cpu")
fit = optim.fit(lambda p: check.loss_of(
    pipeline.render_deferred(p, static, cfg)[0], cfg), params, steps=3)
from skybox_rt_tpu_torch.apps import compute, lbm, om_app
sg = compute.sgemm_pallas(torch.ones(8, 4), torch.ones(4, 8), block=(4, 4, 4))
lbm.run(lbm.LBMConfig(8, 8, 4), steps=1, device="cpu")
om_app.run(8, 8, device="cpu")
from skybox_rt_tpu_torch.parallel import draw_shard, mesh
sharded = draw_shard.render_trace_sharded(trace, 32, 32,
                                          mesh.make_mesh(device="cpu"), 3)
import torch.distributed
torch.distributed.destroy_process_group()
unsharded = driver.render_trace(trace, 32, 32, 3, mode="deferred",
                                device="cpu")
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "optax", "orbax",
                                       "skybox_rt_tpu"))
print(json.dumps({"loaded": loaded, "shape": list(fb.shape),
                  "stats_drawcalls": stats.drawcalls,
                  "stats_fragments": stats.traffic["fragments"],
                  "dtype": str(fb.dtype), "rt_shape": list(img.shape),
                  "rt_hits": int((img[..., :3].sum(-1) > 0).sum()),
                  "rt_default_engine_diff": float((small - img).abs().max()),
                  "engines": engines,
                  "config3_shape": list(fused.shape),
                  "config3_vs_scan": float(abs(fused - bridged).max()),
                  "rt_diff_grad": float(v.grad.abs().max()),
                  "fit_losses": fit.losses,
                  "sgemm": float(sg.sum()),
                  "sharded_equal": bool((sharded == unsharded).all())}))
"""


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


@pytest.fixture(scope="module")
def probe():
    res = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(MODULES)],
                         capture_output=True, text=True, cwd=REPO,
                         env=_clean_env(), timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


_DTYPE_ALIASES = "jnp dtype aliases: the port names torch dtypes"
#: the JAX package's modules whose port has another name
_RENAMED = {"ops/pallas_rt.py": "ops/cuda_rt.py",
            "ops/pallas_raster.py": "ops/cuda_raster.py",
            "diff/pallas_vis.py": "diff/cuda_vis.py",
            "diff/pallas_texgrad.py": "diff/cuda_texgrad.py"}
#: module of the JAX package -> {public name the port does not carry:
#: why}
NOT_CARRIED = {
    "parallel/mesh.py": {
        "tile_sharding": "returns a jax NamedSharding, which torch has not; "
                         "a rank takes its block with mesh.tile_block"},
    "parallel/overlap.py": {
        "count_all_reduces": "parses XLA's HLO text, which eager torch has "
                             "not; overlap.collective_counts counts the "
                             "collectives as they are issued",
        "collective_schedule_report": "parses XLA's scheduled HLO text, "
                                      "which eager torch has not"},
    "runtime/perf.py": {
        "V5E_PEAKS": "a TPU's peaks; the port's rooflines default to "
                     "H100_PEAKS",
        "cost_analysis": "reads XLA's cost model, which torch has not; the "
                         "port's kernel bounds are the work counts that "
                         "chip_smoke.py computes",
        "roofline_of_fn": "cost_analysis + roofline: XLA's cost model, "
                          "which torch has not"},
    "core/fixed.py": {
        "I32": _DTYPE_ALIASES, "U32": _DTYPE_ALIASES,
        "smul32_parts": "a TPU emulation of the 32x32 -> 64-bit product as "
                        "two int32 halves; the port multiplies in int64"},
    "geom/cgltrace.py": {
        "ASSETS_DIR": "the reference assets are absent; trace_path "
                      "searches the port's own data/"},
    "geom/native.py": {
        "available": "a failed native build raises (no silent fallback); "
                     "SKYBOX_NATIVE=0 bins with numpy"},
    "ops/pallas_raster.py": {
        "I32": _DTYPE_ALIASES, "U32": _DTYPE_ALIASES,
        "LANES": "TPU lane width",
        "pack_prim_records": "TPU layout: pre-gathered (T, M, 16) records",
        "supported": "TPU gate (ts * ts a multiple of 128 lanes)"},
    "ops/pallas_rt.py": {
        "F32": _DTYPE_ALIASES, "I32": _DTYPE_ALIASES,
        "LANES": "TPU lane width", "TRI_SUB": "TPU sublane step",
        "TRI_BLOCK": "TPU VMEM block; the port's is STREAM_TRI_BLOCK",
        "EPS": "the Moller-Trumbore epsilon lives in rt.intersect.EPS",
        "PARK_LIMIT": "TPU worklist entry encoding",
        "ENTRY_LEVEL_SHIFT": "TPU worklist entry encoding",
        "ENTRY_START_MASK": "TPU worklist entry encoding",
        "bvh_worklists": "how the TPU brings blocks to a ray tile; a ray "
                         "walks the pyramid itself in the port"},
    "diff/pallas_vis.py": {
        "F32": _DTYPE_ALIASES, "I32": _DTYPE_ALIASES,
        "LANES": "TPU lane width", "GROUP": "TPU tiles a grid step",
        "pack_prim_records": "TPU layout: pre-gathered records",
        "supported": "TPU gate (ts * ts a multiple of 128 lanes)"},
    "diff/pallas_texgrad.py": {
        "F32": _DTYPE_ALIASES, "I32": _DTYPE_ALIASES,
        "BLK": "TPU pixels a grid step", "R_CHUNK": "TPU one-hot row chunk",
        "supported": "TPU gate"},
    "diff/pipeline.py": {
        "F32": _DTYPE_ALIASES, "I32": _DTYPE_ALIASES,
        "VIS_CHUNK": "sizes the plain reduction, so it lives beside it: "
                     "diff.cuda_vis.VIS_CHUNK"},
    "rt/tracer.py": {n: "TPU kernel knob" for n in (
        "BVH_UNROLL", "BVH_EARLY_EXIT", "BVH_EARLY_EXIT_BOUNCE")},
    **{m: {n: _DTYPE_ALIASES for n in names} for m, names in (
        ("parallel/draw_shard.py", ("I32", "U32")),
        ("parallel/tile_shard.py", ("F32",)),
        ("ops/deferred.py", ("I32", "U32")), ("rt/bvh.py", ("F32", "I32")),
        ("rt/intersect.py", ("F32", "I32")), ("rt/wavefront.py",
                                              ("I32", "U32")),
        ("raster/edge.py", ("I32",)), ("raster/interp.py", ("F32", "I32")),
        ("om/blend.py", ("I32", "U32")), ("om/depth_stencil.py", ("U32",)),
        ("om/merger.py", ("U32",)), ("ref/renderer.py", ("I32", "U32")),
        ("texture/sampler.py", ("I32", "U32")))},
}


def _public_names(path, private=False):
    """The public names (with ``private``: every name) a module's source
    binds at its top level: defs, classes and assignments (the JAX package
    is read, not imported)."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    found = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            found.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            found |= {e.id for t in targets for e in ast.walk(t)
                      if isinstance(e, ast.Name)}
    return {n for n in found if private or not n.startswith("_")}


def _jax_modules():
    root = os.path.join(REPO, "skybox_rt_tpu")
    return sorted(os.path.relpath(os.path.join(d, f), root).replace(
        os.sep, "/") for d, _, files in os.walk(root) for f in files
        if f.endswith(".py"))


@pytest.mark.parametrize("module", _jax_modules())
def test_public_names_carried_or_listed(module):
    """Every public name of every JAX module is in its port, or is listed
    in NOT_CARRIED with its reason; a listed name that the port gains must
    leave the list.  A listed private name is one the JAX module binds and
    the port does not."""
    port = os.path.join(REPO, "skybox_rt_tpu_torch",
                        _RENAMED.get(module, module))
    listed = NOT_CARRIED.get(module, {})
    assert os.path.exists(port), f"{module} has no port"
    jax_path = os.path.join(REPO, "skybox_rt_tpu", module)
    missing = _public_names(jax_path) - _public_names(port)
    public = {n for n in listed if not n.startswith("_")}
    assert missing == public, (sorted(missing), sorted(public))
    hidden = set(listed) - public
    assert hidden <= _public_names(jax_path, private=True) - _public_names(
        port, private=True)
    assert all(listed.values())


def test_to_fixed_matches_jax():
    import jax.numpy as jnp
    import numpy as np
    import torch

    from skybox_rt_tpu.core import fixed as jax_fixed
    from skybox_rt_tpu_torch.core import fixed
    x = np.random.default_rng(0).uniform(-100, 100, 4096).astype(np.float32)
    x[:4] = (0.0, -0.0, 2.0 ** -24, -(2.0 ** -17))
    for frac in (fixed.EDGE_FRAC, fixed.ATTR_FRAC - 18):
        got = fixed.to_fixed(torch.from_numpy(x), frac)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_fixed.to_fixed(jnp.asarray(x), frac)))
        np.testing.assert_array_equal(got.numpy(), fixed.to_fixed_np(x, frac))


def test_every_module_listed():
    for m in ("core.fixed", "ops.cuda_raster", "ops.deferred", "ref.driver",
              "interop", "_build", "models.make_synth_trace", "core.device",
              "rt.tracer", "rt.bvh", "rt.intersect", "rt.wavefront",
              "ops.cuda_rt", "diff.pipeline", "diff.binning", "diff.cuda_vis",
              "diff.cuda_texgrad", "diff.optim", "diff.check",
              "rt.raster_bridge", "rt.frame", "rt.diff", "apps.compute",
              "apps.cuda_sgemm", "apps.opencl", "apps.lbm", "apps.om_app",
              "apps.tex_app", "apps.raster_app", "texture.convert",
              "texture.units", "geom.native", "geom.validate",
              "runtime.perf", "runtime.device", "utils.tracing",
              "utils.image", "models.obj", "cli", "__main__",
              "parallel.mesh", "parallel.overlap", "parallel.draw_shard",
              "parallel.tile_shard", "parallel.ray_shard",
              "parallel.scaling"):
        assert f"skybox_rt_tpu_torch.{m}" in MODULES


def test_no_jax_after_import_and_render(probe):
    assert probe["loaded"] == []
    assert probe["shape"] == [32, 32] and probe["dtype"] == "uint32"
    assert probe["stats_drawcalls"] == 2 and probe["stats_fragments"] > 0
    assert probe["rt_shape"] == [16, 16, 4] and probe["rt_hits"] > 20
    # the default engine (the clustered pair) against the all-pairs oracle
    assert probe["rt_default_engine_diff"] <= 2e-5
    # the comparison engines render the default engine's image
    assert probe["engines"] == {"pallas_streamed": 0.0,
                                "pallas_worklist": 0.0}
    # the ray-traced CGLTrace frame against its own scan oracle
    assert probe["config3_shape"] == [16, 16, 4]
    assert probe["config3_vs_scan"] <= 1e-3
    assert probe["rt_diff_grad"] > 0
    # three Adam steps of the differentiable render, each one downhill
    losses = probe["fit_losses"]
    assert len(losses) == 3 and losses[2] < losses[1] < losses[0]
    assert probe["sgemm"] == 8 * 8 * 4
    # a world of one rank in one process: the sharded raster frame
    assert probe["sharded_equal"]


def test_ops_and_rt_import_one_way():
    """The kernel wrappers sit below the frame: ops.cuda_rt, imported first
    in a fresh interpreter, loads rt.intersect and not rt.tracer, and
    rt/tracer.py and rt/raster_bridge.py import ops at module level only,
    with no import inside a function to get round a cycle."""
    import ast
    res = subprocess.run(
        [sys.executable, "-c",
         "import json, sys\n"
         "import skybox_rt_tpu_torch.ops.cuda_rt\n"
         "print(json.dumps(sorted(m for m in sys.modules\n"
         "                        if m.startswith('skybox_rt_tpu_torch.'))))"],
        capture_output=True, text=True, cwd=REPO, env=_clean_env(),
        timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert "skybox_rt_tpu_torch.rt.intersect" in loaded
    assert "skybox_rt_tpu_torch.rt.tracer" not in loaded
    for name in ("tracer.py", "raster_bridge.py"):
        path = os.path.join(REPO, "skybox_rt_tpu_torch", "rt", name)
        with open(path) as f:
            tree = ast.parse(f.read())
        nested = [(fn.name, node.lineno) for fn in ast.walk(tree)
                  if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                  for node in ast.walk(fn)
                  if isinstance(node, ast.ImportFrom) and node.level == 2
                  and (node.module or "").split(".")[0] == "ops"]
        assert nested == [], (name, nested)


_BAD_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|optax|orbax|skybox_rt_tpu)(\.|\s|$)",
    re.M)


@pytest.mark.parametrize("path", MODULES + ["chip_smoke"])
def test_source_imports_no_jax(path):
    if path == "chip_smoke":
        src = os.path.join(REPO, "chip_smoke.py")
    else:
        src = importlib.util.find_spec(path).origin
    with open(src) as f:
        assert _BAD_IMPORT.search(f.read()) is None, src


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card here: chip_smoke.py exits non-zero and prints no result,
    both in the repo and alone in an otherwise empty directory."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd, env in ((REPO, _clean_env()), (str(tmp_path), None)):
        if env is None:
            env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, env=env,
                             timeout=300)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout


_C_FUNCTION = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _c_interface():
    """name -> ctypes kinds of every extern "C" function in csrc/*.cu."""
    import ctypes

    from skybox_rt_tpu_torch import _build
    found = {}
    for src in _build._sources():
        with open(src) as f:
            for name, params in _C_FUNCTION.findall(f.read()):
                kinds = []
                for prm in params.split(","):
                    ctype = prm.strip().rsplit(" ", 1)[0]
                    kinds.append(ctypes.c_void_p if ctype.endswith("*") else
                                 {"int": ctypes.c_int,
                                  "float": ctypes.c_float}[ctype])
                found[name] = kinds
    return found


def test_ctypes_signatures_match_the_sources():
    """No compiler here: hold the argument lists that ctypes passes to the
    ones the sources declare, kernel by kernel."""
    from skybox_rt_tpu_torch import _build
    found = _c_interface()
    assert sorted(found) == sorted(_build._SIGNATURES)
    assert {"skybox_rt_closest_hit_clustered", "skybox_rt_any_hit_clustered",
            "skybox_rt_closest_hit_flat", "skybox_diff_visibility_hard",
            "skybox_diff_accumulate_rows", "skybox_rt_closest_hit_bvh_after",
            "skybox_rt_closest_hit_streamed",
            "skybox_rt_closest_hit_worklist", "skybox_apps_sgemm",
            "skybox_rt_shade_hits", "skybox_diff_shade_forward",
            "skybox_diff_shade_backward", "skybox_diff_prim_forward",
            "skybox_diff_prim_backward"} <= set(found)
    for name, kinds in found.items():
        assert kinds == _build._SIGNATURES[name], name
    names = {os.path.basename(s) for s in _build._sources()}
    assert names == {"raster_visibility.cu", "rt_bvh.cu", "rt_clustered.cu",
                     "rt_common.cuh", "diff_visibility.cu",
                     "diff_accumulate.cu", "rt_streamed.cu", "apps_sgemm.cu",
                     "rt_shade.cu", "diff_shade.cu", "diff_prim.cu"}


def test_package_data_ships_every_source():
    """An installed package builds its kernels and its native binning engine
    too: every file the two builds read (sources and the header they
    include) matches a package-data glob."""
    import fnmatch
    import tomllib

    from skybox_rt_tpu_torch import _build
    from skybox_rt_tpu_torch.geom import native
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "skybox_rt_tpu_torch"]
    pkg = os.path.dirname(skybox_rt_tpu_torch.__file__)
    for src in _build._sources() + [native.SRC]:
        rel = os.path.relpath(src, pkg).replace(os.sep, "/")
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel


@pytest.mark.cuda
def test_every_source_builds_on_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels build there")
    from skybox_rt_tpu_torch import _build
    lib = _build.load_library()
    for name in _build._SIGNATURES:
        assert hasattr(lib, name), name
    with open(_build.build() + ".log") as f:
        log = f.read()
    for src in _build._sources():
        if src.endswith(".cu"):
            assert os.path.basename(src) in log


@pytest.mark.parametrize("name", ["synth_draw3d", "synth_config3"])
def test_committed_trace_is_what_the_generator_writes(name, tmp_path):
    """The committed npz equals, array for array, what make_synth_trace
    writes now."""
    import numpy as np

    from skybox_rt_tpu_torch.geom import cgltrace
    from skybox_rt_tpu_torch.models import make_synth_trace
    out = str(tmp_path / f"{name}.npz")
    make_synth_trace.main([name, out])
    with np.load(out) as new, np.load(cgltrace.trace_path(name)) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in new.files:
            assert new[k].dtype == old[k].dtype, k
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)
    trace = cgltrace.load_trace(out)
    if name == "synth_config3":
        masks = [dc.states.color_writemask for dc in trace.drawcalls]
        assert masks == [0xFFFFFFFF] * 6 + [0x00FFFFFF]
        assert [dc.indices.shape[0] for dc in trace.drawcalls] == [
            2, 5120, 5120, 16, 1280, 1280, 2]
