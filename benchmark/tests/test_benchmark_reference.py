"""The frozen scenes, the plain reference against the port at a tiny size,
the control, and a run with its timed path broken (CPU)."""
import argparse
import json
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import calibrate, compare, harness, scenes
from benchmark.entries import rt_frame
from benchmark.reference import rt_reference

torch.set_num_threads(1)

TINY = {"width": 48, "height": 40, "bounces": 2, "shadows": True}
SEED = 2 ** 33 + 12345


def config(name):
    with open(os.path.join(harness.BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


def limits(workload):
    return harness.resolve(workload)["limits"]


def small(name, **field):
    c = config(name)
    c["sphere_field"] = {**c["sphere_field"], **field}
    return c


def test_frozen_generators_equal_the_programs():
    from skybox_rt_tpu_torch.models import scenes as prog

    for a, b in zip(scenes.sphere_field(copies=4, subdiv=2, seed=7),
                    prog.sphere_field(copies=4, subdiv=2, seed=7)):
        np.testing.assert_array_equal(a, b)
    v, _, _ = scenes.sphere_field(copies=2, subdiv=1)
    np.testing.assert_array_equal(scenes.planar_uvs(v), prog.planar_uvs(v))
    np.testing.assert_array_equal(scenes.checkerboard_texture(32, 4),
                                  prog.checkerboard_texture(32, 4))
    for a, b in zip(scenes.icosphere(3, 0.9), prog.icosphere(3, 0.9)):
        np.testing.assert_array_equal(a, b)


def test_seed_sets_colours_only():
    c = config("spheres12k_tex")
    a, b = scenes.make_scene(c, 1), scenes.make_scene(c, SEED)
    for k in ("verts", "faces", "uvs"):
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["colors"], b["colors"])
    assert not np.array_equal(a["texture"], b["texture"])


@pytest.mark.parametrize("name,field,traffic", [
    ("spheres12k_tex", {}, TINY),
    ("spheres184k", {"copies": 4, "subdiv": 2}, TINY),
    ("spheres12k_tex", {"copies": 4, "subdiv": 2},
     {**TINY, "bounces": 0, "width": 64, "height": 64}),
])
def test_reference_agrees_with_the_port(name, field, traffic):
    c = small(name, **field)
    cell = rt_frame.setup(c, traffic, SEED, torch.device("cpu"))
    got = cell.step()
    want, queries = rt_frame.reference(c, traffic, cell.inputs, "cpu")
    n = compare.image_numbers(got, want)
    assert n["bad_px_pct"] == 0.0 and n["mean_abs_err"] < 1e-6, n
    assert queries[0] == ("closest", traffic["width"] * traffic["height"])
    assert len(queries) == 2 * (1 + traffic["bounces"])


def test_reference_culling_equals_all_pairs():
    """The box tests skip only pairs that cannot hit."""
    verts, faces, _ = scenes.sphere_field(copies=4, subdiv=2)
    geo = rt_reference.Geometry(verts, faces, torch.float64, "cpu")
    g = torch.Generator().manual_seed(3)
    o = torch.randn(500, 3, generator=g, dtype=torch.float64) * 4
    d = rt_reference._unit(-o + torch.randn(500, 3, generator=g,
                                            dtype=torch.float64))
    prim, t, _, _ = rt_reference.closest_hit(geo, o, d)
    hit, tt, _, _ = rt_reference._mt(o[:, None], d[:, None], geo.v0[None],
                                     geo.e1[None], geo.e2[None], np.inf)
    tt = torch.where(hit, tt, torch.inf)
    best = tt.min(1)
    assert torch.equal(prim >= 0, torch.isfinite(best.values))
    found = prim >= 0
    assert torch.equal(t[found], best.values[found])
    occ = rt_reference.any_hit(geo, o, d, 3.0)
    assert torch.equal(occ, (hit & (tt < 3.0)).any(1))


def test_control_is_not_correct():
    """The reference in bfloat16 in the program's place fails a limit."""
    c = config("spheres12k_tex")
    inputs = rt_frame.make_inputs(c, SEED)
    want, _ = rt_frame.reference(c, TINY, inputs, "cpu")
    low, _ = rt_frame.reference(c, TINY, inputs, "cpu",
                                calibrate.CONTROL_DTYPE[c["precision"]])
    n = compare.image_numbers(low, want)
    lim = limits("spheres12k_tex.bounce2_1024")
    assert any(n[k] > lim[k] for k in lim), n


def tiny_root(tmp_path):
    root = tmp_path / "root"
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(open(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")).read())
    spec["workloads"].append({"name": "spheres12k_tex.tiny",
                              "config": "spheres12k_tex", "traffic": "tiny",
                              "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "benchmark" / "traffic" / "tiny.json").write_text(
        json.dumps(TINY))
    (root / "benchmark" / "limits" / "spheres12k_tex.tiny.json").write_text(
        json.dumps(limits("spheres12k_tex.bounce2_1024")))
    return str(root)


def run_tiny(root):
    args = argparse.Namespace(workload="spheres12k_tex.tiny", seed=SEED,
                              seconds=0.01, trace=0)
    return harness.run(args, root=root, device="cpu")


def test_run_line_has_the_result_keys(tmp_path):
    rc, line = run_tiny(tiny_root(tmp_path))
    assert rc == 0 and line["correct"] is True
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"setup_s", "iter_ms", "iter_p95_ms"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_a_listed_metric_that_reads_nothing_fails_the_run(tmp_path):
    """A metric that the cell lists and that reads None gives no result."""
    root = tiny_root(tmp_path)
    (tmp_path / "root" / "benchmark" / "metrics" / "silent_ms.py").write_text(
        "def read(ctx):\n    return None\n")
    spec_path = tmp_path / "root" / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["end_to_end"].append({"name": "silent_ms", "unit": "ms",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["spheres12k_tex.tiny"]})
    spec_path.write_text(json.dumps(spec))
    rc, line = run_tiny(root)
    assert rc == 4 and line is None


def _half_left_out(cell):
    from skybox_rt_tpu_torch.rt import tracer

    o, d = cell.o.clone(), cell.d.clone()
    half = o.shape[0] // 2
    o[half:] = torch.tensor(tracer.PARK_O)
    d[half:] = torch.tensor(tracer.PARK_D)
    return cell.frame(o, d)


def _unchanged(cell):
    return torch.zeros((cell.traffic["height"], cell.traffic["width"], 4))


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out",
                                   "answer_altered"])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    from skybox_rt_tpu_torch.rt import tracer

    if fault == "unchanged":
        monkeypatch.setattr(rt_frame.Cell, "step", _unchanged)
    elif fault == "half_left_out":
        monkeypatch.setattr(rt_frame.Cell, "step", _half_left_out)
    else:
        make = tracer.make_intersectors

        def altered(*a, **k):
            closest, occluded = make(*a, **k)

            def wrong(o, d, t_max=float("inf")):
                prim, t, u, v = closest(o, d, t_max)
                # one 32 x 32 tile of rays reports a miss where it is found
                prim = prim.clone()
                prim[:1024] = -1
                return prim, t, u, v
            return wrong, occluded
        monkeypatch.setattr(tracer, "make_intersectors", altered)
    rc, line = run_tiny(tiny_root(tmp_path))
    assert rc == 0 and line["correct"] is False, line["checks"]
    assert line["failed"] == line["attempted"]
