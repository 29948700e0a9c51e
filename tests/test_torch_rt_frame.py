"""rt.frame, the whole-frame ray tracing of a CGLTrace (the config-3 path):
the port against the JAX package and against its own scan oracle, and the
committed golden of the synthetic config-3 trace.

``data/synth_config3_128.npz`` holds the JAX package's 128x128 frame of
``data/synth_config3.npz`` (color, zbuf), its plan (mode, K, P per draw, K as
the JAX overflow retry converged it from 1) and the size.  chip_smoke.py
holds the card's frame to it; here it is regenerated from JAX (with the K
hints seeded from the file, which spares the retry's four recompilations and
must leave no overflow) and compared with the file.

    PYTHONPATH=. python tests/test_torch_rt_frame.py --write    # CPU, ~4 min

Tolerance against JAX.  Kernel against plain version is exact.  Against JAX
a ray that grazes an edge can gain or lose a whole fragment (XLA's CPU code
contracts multiply-adds, eager torch does not), and in a blended draw that is
a large difference at that pixel.  So: >= 99.9 % of the values within 2e-5,
and every pixel with a value beyond 1e-4 is a graze or a tie in the port's own
enumeration (rt.frame.fragment_margins under 1e-4); their count is printed.
Against the port's own scan oracle: the JAX test's 1e-3.
"""
import os
import sys

import numpy as np
import pytest
import torch

from skybox_rt_tpu.geom import cgltrace as jax_cgltrace
from skybox_rt_tpu.rt import frame as jax_frame
from skybox_rt_tpu_torch.geom import cgltrace
from skybox_rt_tpu_torch.models import make_synth_trace
from skybox_rt_tpu_torch.rt import frame
from skybox_rt_tpu_torch.rt import raster_bridge as rb

torch.set_num_threads(1)

GOLDEN_SIZE = 128
GOLDEN = os.path.join(cgltrace.DATA_DIR, f"synth_config3_{GOLDEN_SIZE}.npz")
MODES = ["scan", "winner", "kslot", "kslot", "kslot", "winner", "scan"]


def _port_trace():
    return cgltrace.load_trace(cgltrace.trace_path("synth_config3"))


def _jax_trace(trace=None):
    """The JAX package's trace from the same npz arrays."""
    if trace is None:
        with np.load(cgltrace.trace_path("synth_config3")) as z:
            return jax_cgltrace._from_npz(z)
    return jax_cgltrace._from_npz(cgltrace._to_npz(trace))


def jax_golden(k_hints=None):
    """{color, zbuf, modes, K, P, size} of the JAX frame at GOLDEN_SIZE.
    k_hints {draw: K} seeds the retry; None lets it converge from 1."""
    jtrace = _jax_trace()
    tkey = jax_frame._trace_key(jtrace)
    for di, k in (k_hints or {}).items():
        jax_frame._K_HINTS[(tkey, di)] = int(k)
    color = jax_frame.render_trace_rt_fused(jtrace, GOLDEN_SIZE, GOLDEN_SIZE)
    fn, arrays, rays, metas = jax_frame.make_frame_fn(jtrace, GOLDEN_SIZE,
                                                      GOLDEN_SIZE)
    zbuf, color2, ovf = fn(arrays, *rays)
    assert not np.asarray(ovf).any()
    np.testing.assert_array_equal(
        np.asarray(color2).reshape(color.shape), color)
    return {"color": color,
            "zbuf": np.asarray(zbuf).reshape(GOLDEN_SIZE, GOLDEN_SIZE),
            "modes": np.array([m["mode"] for m in metas]),
            "K": np.array([m["K"] for m in metas], np.int64),
            "P": np.array([m["P"] for m in metas], np.int64),
            "size": np.int64(GOLDEN_SIZE)}


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port_frame():
    """(trace, color, zbuf, metas) of the port's frame at GOLDEN_SIZE, its K
    hints converged by its own retry from 1."""
    trace = _port_trace()
    color = frame.render_trace_rt_fused(trace, GOLDEN_SIZE, GOLDEN_SIZE,
                                        device="cpu")
    fn, arrays, rays, metas = frame.make_frame_fn(trace, GOLDEN_SIZE,
                                                  GOLDEN_SIZE, device="cpu")
    zbuf, color2, ovf = fn(arrays, *rays)
    assert ovf.numel() == len(frame.probed_draws(metas)) and not ovf.any()
    np.testing.assert_array_equal(
        color2.reshape(GOLDEN_SIZE, GOLDEN_SIZE, 4).numpy(), color)
    return trace, color, zbuf.reshape(GOLDEN_SIZE, GOLDEN_SIZE).numpy(), metas


def frame_against_jax(trace, size, got, want, device="cpu"):
    """The stated tolerance of a frame against the JAX package's (module
    docstring); returns (max |diff|, pixels beyond 1e-4)."""
    diff = np.abs(got - want)
    assert (diff <= 2e-5).mean() >= 0.999
    far = (diff > 1e-4).any(-1)
    if far.any():
        margins = frame.fragment_margins(trace, size, size, device=device)
        assert (margins[far] < 1e-4).all(), \
            f"{int((far & ~(margins < 1e-4)).sum())} pixels differ from " \
            f"JAX by more than 1e-4 without a graze or a tie"
    print(f"max |diff| {diff.max():.3e}, values beyond 2e-5: "
          f"{int((diff > 2e-5).sum())} of {diff.size}, graze or tie pixels "
          f"beyond 1e-4: {int(far.sum())}")
    return float(diff.max()), int(far.sum())


def test_plan_modes_and_k_match_jax(golden, port_frame):
    """Before any hint: the same modes, K = 1 everywhere, P equal.  After
    the port's own retry: the K the JAX retry converged to (the golden's)."""
    trace, _, _, metas = port_frame
    fresh = _port_trace()       # a new object: no hints yet
    plan = frame._build_plan(fresh, GOLDEN_SIZE, GOLDEN_SIZE, 0, 2 ** 31,
                             "raise", {}, "cpu")
    jplan = jax_frame._build_plan(_jax_trace(), GOLDEN_SIZE, GOLDEN_SIZE, 0,
                                  2 ** 31, "raise", {})
    assert [m["mode"] for m, _ in plan] == MODES
    for (m, _), (jm, _) in zip(plan, jplan, strict=True):
        for k in ("draw_index", "statics", "mode", "farthest", "K", "P"):
            assert m[k] == jm[k], (m["draw_index"], k)
        assert m["far_d"] == pytest.approx(jm["far_d"])
        assert m["K"] == 1
    assert [m["mode"] for m in metas] == list(golden["modes"]) == MODES
    np.testing.assert_array_equal([m["K"] for m in metas], golden["K"])
    np.testing.assert_array_equal([m["P"] for m in metas], golden["P"])
    # c2 and c4: front and back face; c3: all 16 triangles, so no probe
    assert list(golden["K"]) == [1, 1, 2, 16, 2, 1, 1]
    assert [m["draw_index"] for m in frame.probed_draws(metas)] == [2, 4]


def test_golden_is_current_and_port_matches_jax(golden, port_frame):
    """The file equals what JAX renders now (seeded with the file's K: one
    round, no overflow), and the port's frame agrees with it."""
    assert int(golden["size"]) == GOLDEN_SIZE
    kslot = {di: k for di, (k, mode) in enumerate(
        zip(golden["K"], golden["modes"])) if mode == "kslot"}
    new = jax_golden(kslot)
    np.testing.assert_array_equal(new["modes"], golden["modes"])
    np.testing.assert_array_equal(new["K"], golden["K"])
    np.testing.assert_array_equal(new["P"], golden["P"])
    np.testing.assert_allclose(new["color"], golden["color"], atol=1e-5)
    finite = np.isfinite(golden["zbuf"])
    np.testing.assert_array_equal(np.isfinite(new["zbuf"]), finite)
    np.testing.assert_allclose(new["zbuf"][finite], golden["zbuf"][finite],
                               atol=1e-5)

    trace, color, zbuf, _ = port_frame
    assert color.min() >= 0.0 and color.max() <= 1.0
    frame_against_jax(trace, GOLDEN_SIZE, color, golden["color"])
    np.testing.assert_array_equal(np.isfinite(zbuf), finite)
    assert 0.05 < finite.mean() < 0.9
    np.testing.assert_allclose(zbuf[finite], golden["zbuf"][finite],
                               atol=2e-5)


def test_fused_frame_matches_scan_oracle():
    """The frame == the exact per-draw submission-order scan, at 64x64; and
    through render_trace_rt's own dispatch."""
    trace = _port_trace()
    a = frame.render_trace_rt_fused(trace, 64, 64, device="cpu")
    b = rb.render_trace_rt(trace, 64, 64, engine="brute",
                           camera="perspective", device="cpu")
    diff = np.abs(a - b).max(-1)
    print(f"max |frame - scan oracle| {diff.max():.3e}")
    assert diff.max() <= 1e-3
    c = rb.render_trace_rt(trace, 64, 64, engine="pallas_bvh",
                           camera="perspective", device="cpu")
    np.testing.assert_array_equal(a, c)
    assert np.isfinite(frame.fragment_margins(trace, 64, 64,
                                              device="cpu")).mean() > 0.9


def test_overflow_retry_converges():
    """Three stacked translucent layers: the probe fires, K doubles 1 -> 2 ->
    4 (clipped to P), and the image is the scan oracle's; the JAX package
    reaches the same K on the same trace."""
    trace = make_synth_trace.build_layered_trace(layers=3)
    tkey = frame._trace_key(trace)
    out = frame.render_trace_rt_fused(trace, 32, 32, device="cpu")
    ks = {di: k for (tk, di), k in frame._K_HINTS.items() if tk == tkey}
    assert ks == {0: 4}
    _, _, _, metas = frame.make_frame_fn(trace, 32, 32, device="cpu")
    assert (metas[0]["mode"], metas[0]["K"], metas[0]["P"]) == ("kslot", 4, 216)
    oracle = rb.render_trace_rt(trace, 32, 32, engine="brute",
                                camera="perspective", device="cpu")
    assert np.abs(out[..., :3] - oracle[..., :3]).max() <= 1e-3
    # one round short of the truth still overflows: the probe counts rays
    frame._K_HINTS[(tkey, 0)] = 2
    fn, arrays, rays, metas = frame.make_frame_fn(trace, 32, 32, device="cpu")
    ovf = fn(arrays, *rays)[2]
    assert ovf.shape == (1,) and int(ovf[0]) == 32 * 32
    frame._K_HINTS[(tkey, 0)] = 4

    jtrace = _jax_trace(trace)
    jout = jax_frame.render_trace_rt_fused(jtrace, 32, 32)
    jks = [k for (tk, _), k in jax_frame._K_HINTS.items()
           if tk == jax_frame._trace_key(jtrace)]
    assert jks == [4]
    frame_against_jax(trace, 32, out, jout)


def test_frame_cache_subsets_and_stencil():
    trace = _port_trace()
    first = frame.make_frame_fn(trace, 16, 16, device="cpu")
    assert frame.make_frame_fn(trace, 16, 16, device="cpu") is first
    assert frame.make_frame_fn(trace, 16, 16, end_draw=3,
                               device="cpu") is not first
    assert len(frame._FRAME_CACHE) <= frame._FRAME_CACHE_SIZE
    sub = frame.render_trace_rt_fused(trace, 16, 16, start_draw=1, end_draw=4,
                                      device="cpu")
    ref = rb.render_trace_rt(trace, 16, 16, engine="brute",
                             camera="perspective", start_draw=1, end_draw=4,
                             device="cpu")
    assert np.abs(sub - ref).max() <= 1e-3
    stencil = cgltrace.load_trace(cgltrace.trace_path("synth_draw3d"))
    with pytest.raises(NotImplementedError, match="stencil"):
        frame.make_frame_fn(stencil, 16, 16, device="cpu")
    with pytest.warns(UserWarning, match="stencil"):
        _, _, _, metas = frame.make_frame_fn(stencil, 16, 16,
                                             on_stencil="skip", device="cpu")
    assert [m["draw_index"] for m in metas] == [0, 1, 2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            frame.make_frame_fn(trace, 16, 16)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            frame.render_trace_rt_fused(trace, 16, 16)


@pytest.mark.parametrize("K", range(1, 17))
def test_sort_slots_by_prim(K):
    """Against numpy: by prim id, misses last, every field moved with its
    prim; for K past the JAX network's documented 8 too."""
    rng = np.random.default_rng(K)
    R = 200
    prim = np.stack([rng.permutation(40)[:K] for _ in range(R)]).astype(
        np.int32)
    prim[rng.random((R, K)) < 0.3] = -1
    t = rng.uniform(1, 2, size=(R, K)).astype(np.float32)
    u = rng.uniform(0, 1, size=(R, K)).astype(np.float32)
    v = rng.uniform(0, 1, size=(R, K)).astype(np.float32)
    slots = [tuple(torch.as_tensor(f[:, k].copy()) for f in (prim, t, u, v))
             for k in range(K)]
    got = frame._sort_slots_by_prim(slots)
    assert len(got) == K
    key = np.where(prim < 0, 2 ** 30, prim)
    order = np.argsort(key, axis=1, kind="stable")
    for k in range(K):
        for f, g in zip((prim, t, u, v), got[k]):
            np.testing.assert_array_equal(
                g.numpy(), np.take_along_axis(f, order, 1)[:, k])


def _write_golden():
    out = jax_golden(None)
    np.savez_compressed(GOLDEN, **out)
    print(GOLDEN, os.path.getsize(GOLDEN), "bytes; K", out["K"], "modes",
          out["modes"])


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_rt_frame.py "
                 "--write")
    import jax
    jax.config.update("jax_platforms", "cpu")
    _write_golden()
