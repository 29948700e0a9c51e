"""The training cell's plain reference against the port's fit step at a
small size, the control, planted faults, and a run with its timed path
broken (CPU)."""
import argparse
import json
import os
import shutil

import pytest
import torch

from benchmark import calibrate, calibrate_fit, harness
from benchmark.entries import fit_step
from benchmark.reference import diff_reference

torch.set_num_threads(1)

WORKLOAD = "icosphere_train.fit100_1024"
SMALL = {"width": 64, "height": 64, "mode": "hard", "fit_steps": 3}
SEED = 2 ** 33 + 12345


def config(subdiv=2):
    with open(os.path.join(harness.BENCH_DIR, "configs",
                           "icosphere_train.json")) as f:
        c = json.load(f)
    c["icosphere"] = {**c["icosphere"], "subdiv": subdiv}
    return c


def limits():
    return harness.resolve(WORKLOAD)["limits"]


@pytest.fixture(scope="module")
def stepped():
    """A small cell and the outputs of its first four steps (a reset after
    the third)."""
    cell = fit_step.setup(config(), SMALL, SEED, torch.device("cpu"))
    outs = [cell.step() for _ in range(4)]
    return cell, outs


def test_inputs_follow_the_seed():
    a, b = fit_step.make_inputs(config(), 1), fit_step.make_inputs(config(),
                                                                   SEED)
    for k in ("pos", "uv"):
        assert (a["true"][k] == b["true"][k]).all()
    assert not (a["true"]["color"] == b["true"]["color"]).all()
    assert not (a["start"]["pos"] == b["start"]["pos"]).all()
    assert (b["start"]["tex"] == 0.5).all()
    again = fit_step.make_inputs(config(), SEED)
    assert all((again["start"][k] == b["start"][k]).all()
               for k in fit_step.PARAMS)


def test_reference_agrees_with_the_port(stepped):
    cell, outs = stepped
    lim = limits()
    for out in outs:
        n = cell.numbers(out)
        assert all(n[k] <= lim[k] for k in lim), n
        assert out["ok"]


def start_of(cell, out):
    return fit_step.unpack(out, cell.shapes)[0]


def test_reset_every_fit_steps(stepped):
    cell, outs = stepped
    for k in fit_step.PARAMS:
        assert torch.equal(start_of(cell, outs[0])[k], cell.start[k])
        assert torch.equal(start_of(cell, outs[3])[k], cell.start[k])
    # the flat start texture gives uv no gradient in the first step
    for k in ("pos", "color", "tex"):
        assert not torch.equal(start_of(cell, outs[1])[k], cell.start[k])
    # a fresh optimizer holds no moments; the next step starts from the
    # first step's
    assert outs[0]["adam_steps"] == outs[3]["adam_steps"] == (None,) * 4
    assert outs[1]["adam_steps"] == (1.0,) * 4
    for k in fit_step.PARAMS:
        assert torch.equal(fit_step.unpack(outs[0], cell.shapes)[2][k],
                           start_of(cell, outs[1])[k])


def test_target_is_the_reference_render(stepped):
    cell, _ = stepped
    r = cell.config["render"]
    want = diff_reference.render(
        {k: torch.from_numpy(v).double()
         for k, v in cell.inputs["true"].items()},
        torch.from_numpy(cell.inputs["faces"]).long(), SMALL["width"],
        SMALL["height"], near=r["near"], far=r["far"],
        background=tuple(r["background"]))
    assert cell.target.dtype == torch.float32
    assert torch.equal(cell.target, want.float())


def test_adam_step_is_torch_adam():
    """adam_step in float64 is torch.optim.Adam's update, step by step."""
    g = torch.Generator().manual_seed(SEED)
    p = torch.randn(50, 3, generator=g, dtype=torch.float64)
    leaf = p.clone().requires_grad_(True)
    opt = torch.optim.Adam([leaf], lr=1e-3, betas=(0.8, 0.99), eps=1e-6)
    m = v = None
    for t in range(3):
        grad = torch.randn(50, 3, generator=g, dtype=torch.float64)
        state = opt.state.get(leaf)
        if state:
            m, v = state["exp_avg"].clone(), state["exp_avg_sq"].clone()
            assert float(state["step"]) == t
        want = fit_step.adam_step(leaf.detach().clone(), grad, m, v, t, 1e-3,
                                  (0.8, 0.99), 1e-6)
        leaf.grad = grad
        opt.step()
        torch.testing.assert_close(leaf.detach(), want, rtol=1e-14,
                                   atol=1e-16)


def test_sound_updates_read_rounding(stepped):
    cell, outs = stepped
    for out in outs:
        start, moments, after = fit_step.unpack(out, cell.shapes)
        err = fit_step.update_error(start, moments, out["adam_steps"],
                                    out["grads"], after, cell.config)
        assert err < 1e-5, err


def test_winner_search_equals_all_pairs():
    """The box cull skips only pairs that cannot cover a pixel."""
    inputs = fit_step.make_inputs(config(1), SEED)
    pos = torch.from_numpy(inputs["start"]["pos"]).double()
    faces = torch.from_numpy(inputs["faces"]).long()
    W, H = 40, 36
    hv = diff_reference.screen_vertices(pos, W, H)
    e = diff_reference.edge_functions(hv, faces)
    zv = pos[:, 2] / pos[:, 3] * 0.5 + 0.5
    got = diff_reference.winners(e, zv, faces, hv, W, H)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                            torch.arange(W, dtype=torch.float64),
                            indexing="ij")
    ev = diff_reference._eval(e[:, None], xs.reshape(-1)[None] + 0.5,
                              ys.reshape(-1)[None] + 0.5)    # (F, HW, 3)
    z = (diff_reference._barycentrics(ev) * zv[faces][:, None]).sum(-1)
    z = torch.where((ev >= 0).all(-1), z, float("inf"))
    best = z.min(0)
    want = torch.where(torch.isfinite(best.values), best.indices, -1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("which", [0, 2])
def test_control_is_not_correct(stepped, which):
    """The control from a fresh start and from a later step's parameters
    and moments."""
    cell, outs = stepped
    out = outs[which]
    args = (cell.config, SMALL, cell.inputs["faces"], start_of(cell, out),
            cell.target)
    want = fit_step.reference(*args)
    low = calibrate_fit.control(out, cell, calibrate.CONTROL_DTYPE["float32"])
    n = fit_step.fit_numbers(low, want, fit_step.probe_moves(*args, want),
                             cell.target, cell.config, cell.shapes)
    lim = limits()
    assert any(n[k] > lim[k] for k in lim), n


@pytest.mark.parametrize("fault", ["tex_grad_zeroed", "tile_altered",
                                   "state_unchanged", "rejected",
                                   "moved_past_margin"])
def test_planted_fault_is_not_correct(stepped, fault):
    cell, outs = stepped
    out = outs[1]
    if fault == "tex_grad_zeroed":
        out = calibrate_fit.grad_zeroed(out)
    elif fault == "tile_altered":
        out = calibrate_fit.tile_altered(out)
    elif fault == "state_unchanged":
        out = calibrate_fit.state_unchanged(out, cell.shapes)
    elif fault == "rejected":
        out = {**out, "ok": False}
    else:
        out = {**out, "state": out["state"].clone()}
        start_of(cell, out)["pos"][7, 0] += \
            2.2 * cell.config["bins"]["inflate_px"] / SMALL["width"]
    n = cell.numbers(out)
    lim = limits()
    assert any(n[k] > lim[k] for k in lim), n


def tiny_root(tmp_path):
    root = tmp_path / "root"
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(open(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")).read())
    spec["configs"].append({"name": "icosphere_small", "source": "a test",
                            "file": "benchmark/configs/icosphere_small.json",
                            "reduced": ["icosphere"], "why": "a test"})
    spec["workloads"].append({"name": "icosphere_small.tiny",
                              "config": "icosphere_small", "traffic": "tiny",
                              "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = root / "benchmark"
    (bench / "configs" / "icosphere_small.json").write_text(
        json.dumps(config()))
    (bench / "traffic" / "tiny.json").write_text(json.dumps(SMALL))
    (bench / "limits" / "icosphere_small.tiny.json").write_text(
        json.dumps(limits()))
    return str(root)


def run_tiny(root):
    args = argparse.Namespace(workload="icosphere_small.tiny", seed=SEED,
                              seconds=0.01, trace=0)
    return harness.run(args, root=root, device="cpu")


def test_run_is_correct(tmp_path):
    rc, line = run_tiny(tiny_root(tmp_path))
    assert rc == 0 and line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"setup_s", "iter_ms", "iter_p95_ms"}


@pytest.mark.parametrize("fault", ["no_update", "optimizer_step_skipped",
                                   "sgd_update", "texture_dropped"])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    from skybox_rt_tpu_torch.diff import optim, pipeline

    new_optimizer = optim.FitLoop._new_optimizer
    if fault == "no_update":
        # every step's gradients come out zero
        step = optim.FitLoop.step

        def zeroed(self, *args):
            loss, grads = step(self, *args)
            return loss, {k: torch.zeros_like(g) for k, g in grads.items()}
        monkeypatch.setattr(optim.FitLoop, "step", zeroed)
    elif fault == "optimizer_step_skipped":
        # the state left unchanged: the optimizer's step does nothing
        def frozen(self):
            opt = new_optimizer(self)
            opt.step = lambda closure=None: None
            return opt
        monkeypatch.setattr(optim.FitLoop, "_new_optimizer", frozen)
    elif fault == "sgd_update":
        # plain gradient steps at the same rates in place of Adam's
        def sgd(self):
            opt = new_optimizer(self)
            return torch.optim.SGD([{"params": g["params"], "lr": g["lr"]}
                                    for g in opt.param_groups])
        monkeypatch.setattr(optim.FitLoop, "_new_optimizer", sgd)
    else:
        # the image shaded without its texture
        render = pipeline.render_deferred

        def untextured(params, static, cfg, *a, **k):
            import dataclasses
            return render(params, static,
                          dataclasses.replace(cfg, textured=False), *a, **k)
        monkeypatch.setattr(pipeline, "render_deferred", untextured)
    rc, line = run_tiny(tiny_root(tmp_path))
    assert rc == 0 and line["correct"] is False, line["checks"]
    assert line["failed"] == line["attempted"]


def test_roofline_bytes_and_kernel_names():
    from benchmark.metrics import fit_kernels_roofline_pct as roof

    info = {"visibility": [10, 100], "accumulate": [[5, 3, 2], [7, 1, 4]]}
    assert roof.bytes_per_step(info) == (10 * 52 + 100 * 4 + 5 * 12 + 3 * 8
                                         + 7 * 20 + 1 * 16)
    assert roof.is_fit_kernel(
        "(anonymous namespace)::diff_visibility_kernel(float const*, "
        "float const*, int const*, int const*, int*, int, int, int)")
    assert roof.is_fit_kernel("diff_accumulate::scan_kernel(int*, unsigned "
                              "long long*, int*, int, int, int, int*, int*, "
                              "int*)")
    assert not roof.is_fit_kernel("void at::native::reduce_kernel<512, 1>("
                                  "at::native::ReduceOp<float>)")


def test_entry_counts_the_kernels_work(stepped):
    cell, _ = stepped
    pids = cell.static["tile_pids"]
    T, M = pids.shape
    P = cell.inputs["faces"].shape[0]
    assert cell.info["visibility"] == [int((pids >= 0).sum()), T * 32 * 32]
    assert cell.info["accumulate"][:2] == [[T * 32 * 32, 64 * 64, 16],
                                           [T * M, P, 27]]
    assert cell.info["tile_entries"] == [int((pids >= 0).sum()), T * M]


def test_span_readers_on_traced_steps():
    """On the CPU the stages have host times and the bin use reads the
    entry's counts; the device-stream readers have nothing to read."""
    from benchmark.metrics import (fit_backward_stream_ms, fit_bin_use_pct,
                                   fit_host_busy_ms, fit_shade_stream_ms,
                                   fit_visibility_stream_ms)
    from skybox_rt_tpu_torch.utils import tracing

    cell = fit_step.setup(config(1), {**SMALL, "width": 32, "height": 32},
                          SEED, torch.device("cpu"))
    tracing.reset_stages()
    with tracing.enable():
        for _ in range(3):
            cell.step()
    assert fit_host_busy_ms.read(None) > 0
    pids = cell.static["tile_pids"]
    ctx = argparse.Namespace(info=cell.info)
    assert fit_bin_use_pct.read(ctx) == pytest.approx(
        100.0 * int((pids >= 0).sum()) / pids.numel())
    assert fit_bin_use_pct.read(argparse.Namespace(info={})) is None
    for reader in (fit_visibility_stream_ms, fit_shade_stream_ms,
                   fit_backward_stream_ms):
        assert reader.read(None) is None
    tracing.reset_stages()
    assert fit_host_busy_ms.read(None) is None
