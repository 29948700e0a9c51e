"""A short run of a cell on the card, untraced and traced (skips without
one): the line's keys, correct, and a device trace that saw work."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "spheres12k_tex.bounce2_1024", "--seed", str(2 ** 32 + 99),
         "--seconds", "2", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
        assert "breakdown" in line and "intersect_ms" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"setup_s", "iter_ms", "iter_p95_ms"}
