"""The port's runtime.perf against the JAX package's, on the CPU.

Counters, rooflines and the two traffic models take the same inputs in both
packages and must give the same outputs: the traffic dicts and the table's
text exactly, the rooflines' floats to 1e-12 when both get the same peaks.
The port's default peaks are the H100's (the JAX package's are a TPU's).
The drawcall traffic runs on every draw of synth_draw3d at 64x64, with each
package's own measured fragment counts and without them; the diff-step
traffic on one seeded training scene (diff.check.train_scene at 64x64,
handed to JAX as numpy arrays) in the hard, alpha and soft modes.
"""
import dataclasses
import inspect
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skybox_rt_tpu.diff import pipeline as jax_pipeline
from skybox_rt_tpu.geom import cgltrace as jax_cgltrace
from skybox_rt_tpu.ops import deferred as jax_deferred
from skybox_rt_tpu.ref import driver as jax_driver
from skybox_rt_tpu.ref import renderer as jax_renderer
from skybox_rt_tpu.runtime import perf as jax_perf
from skybox_rt_tpu_torch.diff import check
from skybox_rt_tpu_torch.geom import cgltrace
from skybox_rt_tpu_torch.ops import deferred
from skybox_rt_tpu_torch.ref import driver
from skybox_rt_tpu_torch.runtime import perf

torch.set_num_threads(1)

SIZE = 64


def _drive_counters(mod):
    c = mod.PerfCounters()
    other = mod.PerfCounters()
    c.count("drawcalls", 4)
    c.count("prims_binned", 10762)
    c.count("drawcalls")
    other.count("drawcalls", 2)
    other.add_time("frame_ms", 12.3456)
    c.add_time("frame_ms", 0.5)
    c.merge(other)
    out = io.StringIO()
    c.dump(file=out)
    return c.as_dict(), out.getvalue()


def test_perf_counters_as_jax():
    assert _drive_counters(perf) == _drive_counters(jax_perf)


def _seeded_programs():
    rng = np.random.default_rng(0)
    return [(float(f), float(b), float(s)) for f, b, s in zip(
        rng.uniform(0, 1e12, 6), rng.uniform(1, 1e10, 6),
        rng.uniform(1e-5, 1.0, 6))] + [(0.0, 4096.0, 1e-3)]


def _assert_roofline_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("flops,nbytes,seconds", _seeded_programs())
def test_roofline_as_jax_on_the_same_peaks(flops, nbytes, seconds):
    _assert_roofline_equal(
        perf.roofline(flops, nbytes, seconds),
        jax_perf.roofline(flops, nbytes, seconds, peaks=perf.H100_PEAKS))
    traffic = {"raster_mem_reads_bytes": int(nbytes),
               "om_mem_writes_bytes_ub": 7, "tiles": 3, "prims": 9}
    assert perf.traffic_bytes(traffic) == jax_perf.traffic_bytes(traffic)
    _assert_roofline_equal(
        perf.roofline_from_traffic(traffic, seconds),
        jax_perf.roofline_from_traffic(traffic, seconds,
                                       peaks=perf.H100_PEAKS))


def test_default_peaks_are_the_h100s():
    for fn in (perf.roofline, perf.roofline_from_traffic):
        assert inspect.signature(fn).parameters["peaks"].default \
            is perf.H100_PEAKS
    assert perf.H100_PEAKS == {"f32_flops_per_s": 67e12,
                               "i32_ops_per_s": 33.5e12,
                               "hbm_bytes_per_s": 3.35e12}


def test_format_roofline_table_as_jax():
    rows = {f"path {i}": jax_perf.roofline(f, b, s, peaks=perf.H100_PEAKS)
            for i, (f, b, s) in enumerate(_seeded_programs())}
    port_rows = {f"path {i}": perf.roofline(f, b, s)
                 for i, (f, b, s) in enumerate(_seeded_programs())}
    assert perf.format_roofline_table(port_rows) \
        == jax_perf.format_roofline_table(rows)


@pytest.fixture(scope="module")
def draws():
    """Both packages' prepared draws of synth_draw3d at 64x64 and each one's
    measured counts against cleared buffers."""
    path = cgltrace.trace_path("synth_draw3d")
    with np.load(path) as z:
        jax_trace = jax_cgltrace._from_npz(z)
    jax_draws = jax_driver.prepare_drawcalls(jax_trace, SIZE, SIZE)
    port_draws = driver.prepare_drawcalls(cgltrace.load_trace(path), SIZE,
                                          SIZE, device="cpu")
    assert len(jax_draws) == len(port_draws) == 4
    jfbd = jnp.asarray(jax_renderer.pad_framebuffer(
        np.full((SIZE, SIZE), jax_driver.CLEAR_DEPTH, np.uint32), 5))
    _, pfbd = driver.clear_framebuffers(SIZE, SIZE, 5, "cpu")
    return [(jrs, jb, jax_deferred.measure_drawcall_counts(jrs, jb, jfbd),
             prs, pb, deferred.measure_drawcall_counts(prs, pb, pfbd))
            for (jrs, _, jb), (prs, _, pb) in zip(jax_draws, port_draws)]


@pytest.mark.parametrize("d", range(4))
def test_drawcall_traffic_as_jax(draws, d):
    jrs, jb, jcounts, prs, pb, pcounts = draws[d]
    assert pcounts == jcounts
    assert pcounts["fragments"] > 0
    for jc, pc in ((None, None), (jcounts, pcounts)):
        want = jax_perf.drawcall_traffic(jb, jrs, counts=jc)
        got = perf.drawcall_traffic(pb, prs, counts=pc)
        assert got == want
        assert all(type(got[k]) is int for k in got)


@pytest.fixture(scope="module")
def train_scenes():
    return {mode: check.train_scene(SIZE, mode) for mode in check.MODES}


@pytest.mark.parametrize("mode", check.MODES)
@pytest.mark.parametrize("fwd_bwd", [True, False])
def test_diff_step_traffic_as_jax(train_scenes, mode, fwd_bwd):
    params, static, cfg = train_scenes[mode]
    jax_cfg = jax_pipeline.DiffRenderConfig(**dataclasses.asdict(cfg))
    slots = 1 if mode == "hard" else 4
    want = jax_perf.diff_step_traffic(params, static, jax_cfg, slots,
                                      fwd_bwd=fwd_bwd)
    tparams, tstatic = check.to_device(params, static, "cpu")
    for p, s in ((params, static), (tparams, tstatic)):
        got = perf.diff_step_traffic(p, s, cfg, slots, fwd_bwd=fwd_bwd)
        assert got == want
    assert perf.diff_step_traffic(params, static, cfg, slots,
                                  optimizer="adam") == \
        jax_perf.diff_step_traffic(params, static, jax_cfg, slots,
                                   optimizer="adam")
