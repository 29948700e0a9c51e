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
loaded = sorted(k for k in sys.modules
                if k == "jax" or k.startswith(("jax.", "jaxlib"))
                or k == "skybox_rt_tpu" or k.startswith("skybox_rt_tpu."))
print(json.dumps({"loaded": loaded, "shape": list(fb.shape),
                  "dtype": str(fb.dtype), "rt_shape": list(img.shape),
                  "rt_hits": int((img[..., :3].sum(-1) > 0).sum())}))
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
