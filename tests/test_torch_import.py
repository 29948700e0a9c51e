"""The port stands without JAX: importing every module of
skybox_rt_tpu_torch and rendering a raster and a ray-traced frame on the CPU
loads neither jax nor
skybox_rt_tpu, and chip_smoke.py refuses to run without a card."""
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
fb = driver.render_trace(trace, 32, 32, start_draw=2, end_draw=3,
                         mode="deferred", device="cpu")
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
loaded = sorted(k for k in sys.modules
                if k == "jax" or k.startswith(("jax.", "jaxlib"))
                or k == "skybox_rt_tpu" or k.startswith("skybox_rt_tpu."))
print(json.dumps({"loaded": loaded, "shape": list(fb.shape),
                  "dtype": str(fb.dtype), "rt_shape": list(img.shape),
                  "rt_hits": int((img[..., :3].sum(-1) > 0).sum()),
                  "rt_default_engine_diff": float((small - img).abs().max())}))
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


def test_every_module_listed():
    for m in ("core.fixed", "ops.cuda_raster", "ops.deferred", "ref.driver",
              "interop", "_build", "models.make_synth_trace", "core.device",
              "rt.tracer", "rt.bvh", "rt.intersect", "rt.wavefront",
              "ops.cuda_rt", "diff.pipeline"):
        assert f"skybox_rt_tpu_torch.{m}" in MODULES


def test_no_jax_after_import_and_render(probe):
    assert probe["loaded"] == []
    assert probe["shape"] == [32, 32] and probe["dtype"] == "uint32"
    assert probe["rt_shape"] == [16, 16, 4] and probe["rt_hits"] > 20
    # the default engine (the clustered pair) against the all-pairs oracle
    assert probe["rt_default_engine_diff"] <= 2e-5


_BAD_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|skybox_rt_tpu)(\.|\s|$)", re.M)


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
            "skybox_rt_closest_hit_flat"} <= set(found)
    for name, kinds in found.items():
        assert kinds == _build._SIGNATURES[name], name
    names = {os.path.basename(s) for s in _build._sources()}
    assert names == {"raster_visibility.cu", "rt_bvh.cu", "rt_clustered.cu",
                     "rt_common.cuh"}


def test_package_data_ships_every_source():
    """An installed package builds its kernels too: every file the build
    reads (sources and the header they include) matches a package-data
    glob."""
    import fnmatch
    import tomllib

    from skybox_rt_tpu_torch import _build
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "skybox_rt_tpu_torch"]
    pkg = os.path.dirname(skybox_rt_tpu_torch.__file__)
    for src in _build._sources():
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
