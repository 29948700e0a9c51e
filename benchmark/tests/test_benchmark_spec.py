"""BENCHMARK.json against the format's rules on names and keys, and the
harness's lookups by name (CPU)."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, nojax, profiling
from benchmark.metrics import intersect_roofline_pct

ROOT = harness.ROOT
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_spec_keys_names_and_units():
    s = spec()
    assert set(s) == TOP_KEYS
    assert 1 <= s["run_seconds"] <= 51
    assert s["paths"] == ["benchmark"]
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"].startswith("benchmark/")
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(set(names)) == len(names)
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    moves = {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert m["moves"] in moves and "\n" not in m["layer"]


@pytest.mark.parametrize("workload", [w["name"] for w in spec()["workloads"]])
def test_cell_files_found_by_name(workload):
    r = harness.resolve(workload)
    assert hasattr(r["entry"], "setup")
    assert set(r["limits"]) == {"bad_px_pct", "mean_abs_err"}
    per_layer = harness.cell_metrics(r["spec"], workload, "per_layer")
    e2e = harness.cell_metrics(r["spec"], workload, "end_to_end")
    assert per_layer
    assert {"setup_s", "iter_ms", "iter_p95_ms"} <= {m["name"] for m in e2e}
    for m in per_layer + e2e:
        assert callable(harness.load_reader(r["metrics_dir"], m["name"]).read)


def copy_root(tmp_path):
    """A copy of BENCHMARK.json and the benchmark's data folders."""
    root = tmp_path / "root"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def add_cell(root, name, config, traffic, why="added in a test"):
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["workloads"].append({"name": name, "config": config,
                           "traffic": traffic, "chips": 1, "why": why})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    (root / "benchmark" / "limits" / f"{name}.json").write_text(
        json.dumps({"bad_px_pct": 0.01, "mean_abs_err": 1e-05}))


def test_new_config_mix_and_metric_are_files_and_entries(tmp_path):
    root = copy_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    bench = root / "benchmark"
    (bench / "configs" / "spheres1k.json").write_text(json.dumps(
        {**json.loads((bench / "configs" / "spheres12k_tex.json")
                      .read_text()),
         "sphere_field": {"copies": 4, "subdiv": 1, "spacing": 2.4,
                          "ground": True}}))
    (bench / "traffic" / "bounce1_64.json").write_text(json.dumps(
        {"width": 64, "height": 64, "bounces": 1, "shadows": False}))
    (bench / "metrics" / "frames_in_stretch.py").write_text(
        "def read(ctx):\n    return None if ctx.trace is None "
        "else ctx.trace.iters\n")
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "spheres1k", "source": "a test",
                         "file": "benchmark/configs/spheres1k.json",
                         "reduced": [], "why": "a test"})
    s["per_layer"].append({"name": "frames_in_stretch", "unit": "frames",
                           "better": "higher", "source": "device_trace",
                           "layer": "RT frame function", "moves": "iter_ms",
                           "workloads": ["spheres1k.bounce1_64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    add_cell(root, "spheres1k.bounce1_64", "spheres1k", "bounce1_64")

    r = harness.resolve("spheres1k.bounce1_64", str(root))
    assert r["config"]["sphere_field"]["subdiv"] == 1
    assert r["traffic"]["width"] == 64
    names = [m["name"] for m in harness.cell_metrics(
        r["spec"], "spheres1k.bounce1_64", "per_layer")]
    assert names == ["frames_in_stretch"]
    reader = harness.load_reader(r["metrics_dir"], "frames_in_stretch")
    trace = profiling.Trace([("k", 0.0, 1.0)], [], 7, 1.0)
    ctx = harness.Context([0.01], 0.01, 1.0, trace, 0.0, {}, {})
    assert reader.read(ctx) == 7
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_sources_import_nothing_of_jax():
    assert nojax.source_findings() == []


def test_source_check_compares_whole_top_level_names(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "a.py").write_text(
        "import skybox_rt_tpu_torch.rt\nimport jax.numpy\n")
    (tmp_path / "reference" / "b.py").write_text(
        "from skybox_rt_tpu_torch import rt\nimport skybox_rt_tpu\n")
    assert sorted(nojax.source_findings(str(tmp_path))) == [
        ("a.py", "jax"), (os.path.join("reference", "b.py"), "skybox_rt_tpu"),
        (os.path.join("reference", "b.py"), "skybox_rt_tpu_torch")]


def test_union_and_idle_gaps():
    dev = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 25.0),
           ("d", 40.0, 41.0)]
    host = [("aten::argsort", 11.0, 30.0), ("aten::nonzero", 14.0, 18.0)]
    trace = profiling.Trace(dev, host, 1, 1e-4)
    assert profiling.busy_us(dev) == 12.0 + 5.0 + 1.0
    gaps = profiling.idle_gaps(trace)
    # 12..20 (middle 16: inside nonzero), 25..40 (middle 32.5: nothing)
    assert gaps == {"aten::nonzero": 8.0, "host python": 15.0}
    assert profiling.top(gaps, 1) == [["host python", 15.0 / 1e6]]


def test_roofline_bytes():
    q = [("closest", 1000), ("any", 10)]
    assert intersect_roofline_pct.bytes_per_iter(q, 5) == \
        1000 * 40 + 10 * 29 + 2 * 5 * 36


def test_no_result_without_the_program(tmp_path):
    """In a folder that holds only BENCHMARK.json and benchmark/, a run
    exits non-zero and prints no result."""
    root = copy_root(tmp_path)
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "spheres12k_tex.bounce2_1024", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
