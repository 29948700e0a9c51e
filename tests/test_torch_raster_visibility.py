"""Pass 1 (visibility): the port's plain version against the JAX package.

``ops.cuda_raster.visibility_tiles_reference`` is held, bit for bit, to the
JAX Pallas kernel run as the JAX package's own tests run it on the CPU
(``pallas_raster.visibility_tiles(..., interpret=True)``) and to its XLA
twin ``ops.deferred._visibility_tiles``, for every draw kind of the
synthetic trace, fused and K-slot, tile_logsize 3 to 6, at 64x64.  The
Pallas kernel needs ts*ts % 128 == 0, so at tile_logsize 3 only the XLA
twin is compared.  The spheres keep every 4th triangle so the 64x64
per-tile prim lists stay short for the CPU.  ds tiles are seeded with
random depth and stencil bytes so the depth and stencil paths decide.

The kernel's cull (a warp skips the prims that provably cover none of its
8x4 patch) has a plain twin, ``cuda_raster.patch_culled``: it is held patch
by patch to the per-pixel edge values of ``raster.edge.eval_edges`` on every
draw and on seeded random edges whose values wrap, at every tile size.

The CUDA kernel against the plain version runs only on a card (marker
``cuda``), on the draws and on inputs whose edge values wrap, under a
scissor that cuts patches:
python -m pytest --noconftest -m cuda tests/test_torch_raster_visibility.py
"""
import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch.core import fixed
from skybox_rt_tpu_torch.core.state import RenderState
from skybox_rt_tpu_torch.geom import cgltrace
from skybox_rt_tpu_torch.ops import cuda_raster, deferred
from skybox_rt_tpu_torch.raster import edge as edge_mod
from skybox_rt_tpu_torch.ref import driver

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

SIZE = 64
DRAWS = (0, 1, 2, 3)          # opaque, textured, blended, stencil
TILE_LOGSIZES = (3, 4, 5, 6)
K_SLOTS = 4


def _trace():
    trace = cgltrace.load_trace(cgltrace.trace_path("synth_draw3d"))
    for dc in trace.drawcalls[:2]:
        dc.indices = dc.indices[::4]
    return trace


def _seeded_ds(T, tls, seed):
    ts = 1 << tls
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(T, ts, ts), dtype=np.uint64)
    # keep half the pixels at the cleared depth so prims still pass
    words = np.where(rng.random((T, ts, ts)) < 0.5, words | 0xFFFFFF, words)
    return words.astype(np.uint32)


def _port_inputs(d, tls, device="cpu"):
    rs, _, b = driver.prepare_drawcalls(_trace(), SIZE, SIZE, tls,
                                        device=device)[d]
    arrs = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for a in (b.edges, b.attribs[:, 0], b.tile_pids, b.tile_xy)]
    fbd = _seeded_ds(b.tile_pids.shape[0], tls, seed=10 * d + tls)
    return rs, b, arrs, fbd


def _as_np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("kslot", [False, True], ids=["fused", "kslot"])
@pytest.mark.parametrize("tls", TILE_LOGSIZES)
@pytest.mark.parametrize("d", DRAWS)
def test_plain_matches_jax(d, tls, kslot):
    import jax.numpy as jnp

    from skybox_rt_tpu.ops import deferred as jax_deferred
    from skybox_rt_tpu.ops import pallas_raster
    from skybox_rt_tpu.ref import driver as jax_driver
    from skybox_rt_tpu_torch import interop

    rs, b, arrs, fbd = _port_inputs(d, tls)
    K = K_SLOTS if kslot else 0
    got = cuda_raster.visibility_tiles_reference(
        rs, *arrs, fixed.from_numpy_u32(fbd), tls, fused=not kslot,
        blend_slots=K)
    got = [fixed.to_numpy_u32(got[0])] + [_as_np(g) for g in got[1:]]

    # the JAX side resolves its own state from the same trace bytes
    with np.load(cgltrace.trace_path("synth_draw3d")) as z:
        from skybox_rt_tpu.geom import cgltrace as jax_cgltrace
        jt = jax_cgltrace._from_npz(z)
    for dc in jt.drawcalls[:2]:
        dc.indices = dc.indices[::4]
    jrs, _, jb = jax_driver.prepare_drawcalls(jt, SIZE, SIZE, tls)[d]
    assert interop.render_state_from_reference(jrs) == rs
    np.testing.assert_array_equal(np.asarray(jb.tile_pids), b.tile_pids)

    jargs = (jnp.asarray(jb.edges), jnp.asarray(jb.attribs[:, 0]),
             jnp.asarray(jb.tile_pids), jnp.asarray(jb.tile_xy),
             jnp.asarray(fbd))
    xla = jax_deferred._visibility_tiles(jrs, *jargs, tls, blend_slots=K)
    # the XLA twin has no fused outputs: compare dsw and winner / slots
    for g, r in zip(got, xla):
        np.testing.assert_array_equal(g, np.asarray(r))

    if pallas_raster.supported(jrs, tls):
        pal = pallas_raster.visibility_tiles(
            jrs, *jargs, tls, interpret=True, fused=not kslot,
            blend_slots=K)
        assert len(pal) == len(got)
        for g, r in zip(got, pal):
            np.testing.assert_array_equal(g, np.asarray(r))


def test_blended_draw_overflows_default_slots():
    """The blended draw stacks more passing fragments than the default K,
    so the K-slot outputs are exercised past their capacity."""
    rs, _, arrs, _ = _port_inputs(2, 5)
    T = arrs[2].shape[0]
    fbd = torch.full((T, 32, 32), -1, dtype=torch.int32)
    _, slots, cnt = cuda_raster.visibility_tiles_reference(
        rs, *arrs, fbd, 5, blend_slots=K_SLOTS)
    assert int(cnt.max()) > K_SLOTS
    assert bool((slots >= 0).all(dim=1)[cnt >= K_SLOTS].all())


def test_wrapper_rejects_other_devices():
    rs, _, arrs, fbd = _port_inputs(0, 5)
    meta = [a.to("meta") for a in arrs]
    with pytest.raises(ValueError):
        cuda_raster.visibility_tiles(rs, *meta, torch.empty(
            fbd.shape, dtype=torch.int32, device="meta"), 5)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Every draw, and inputs whose edge values wrap under a scissor that
    cuts patches, at every tile size, fused and K-slot: bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    dev = torch.device("cuda")
    launched = cuda_raster.launch_count
    for d in DRAWS:
        for tls in TILE_LOGSIZES:
            rs, _, arrs, fbd = _port_inputs(d, tls, device=dev)
            fbd = fixed.from_numpy_u32(fbd, device=dev)
            cases = [(rs, arrs + [fbd])]
            if d in (0, 3):     # the depth test; the stencil draw's OM
                wrap = cuda_raster.wrapping_case(tls, seed=tls, device=dev)
                cases.append((RenderState(
                    flags=rs.flags, om=rs.om, tex=rs.tex,
                    scissor=cuda_raster.WRAP_SCISSOR), list(wrap)))
            for state, args in cases:
                for K in (0, K_SLOTS):
                    got = cuda_raster.visibility_tiles(
                        state, *args, tls, fused=K == 0, blend_slots=K)
                    want = cuda_raster.visibility_tiles_reference(
                        state, *args, tls, fused=K == 0, blend_slots=K)
                    torch.cuda.synchronize()
                    launched += 1
                    for g, w in zip(got, want):
                        assert torch.equal(g, w), (d, tls, K)
    assert cuda_raster.launch_count == launched


def _full_range_edges(seed, prims):
    """Edge coefficients near +-2**31: half the prims uniform over all of
    int32, the other half with a, b under 2**8 in size and c within 2**11
    of +-2**31, so that their values wrap inside patches."""
    rng = np.random.default_rng(seed)
    e = rng.integers(-2**31, 2**31, size=(prims, 3, 3))
    half = prims // 2
    e[half:, :, :2] = rng.integers(-2**8, 2**8, size=(prims - half, 3, 2))
    e[half:, :, 2] = rng.choice([-1, 1], size=(prims - half, 3)) * (
        2**31 - rng.integers(1, 2**11, size=(prims - half, 3)))
    return torch.from_numpy(e.astype(np.int32))


def _cull_inputs(source, tls):
    """(edges, tile_pids, tile_xy) of a draw of the trace or of seeded
    random edges that wrap."""
    if source.startswith("draw"):
        _, _, (edges, _, tile_pids, tile_xy), _ = _port_inputs(
            int(source[4:]), tls)
        return edges, tile_pids, tile_xy
    edges, _, tile_pids, tile_xy, _ = cuda_raster.wrapping_case(tls,
                                                                seed=tls)
    if source == "full_range":
        edges = _full_range_edges(tls, edges.shape[0])
    return edges, tile_pids, tile_xy


@pytest.mark.parametrize("source", [f"draw{d}" for d in DRAWS]
                         + ["wrapping", "full_range"])
@pytest.mark.parametrize("tls", TILE_LOGSIZES)
def test_patch_cull_never_culls_a_covered_pixel(tls, source):
    """patch_culled against every pixel of every (patch, prim) of the
    tiles: a culled prim has an edge whose wrapped value is negative on
    every pixel of the patch, so it covers none of them."""
    edges, tile_pids, tile_xy = _cull_inputs(source, tls)
    org = cuda_raster.patch_origins(tile_xy, tls)          # (T, Q, 2)
    Q = org.shape[1]
    assert Q == (1 << 2 * tls) // 32
    lx = torch.arange(cuda_raster.PATCH_W)
    ly = torch.arange(cuda_raster.PATCH_H)
    xs = (org[..., 0, None, None] + lx).expand(-1, -1, len(ly), -1)
    ys = (org[..., 1, None, None] + ly[:, None]).expand(-1, -1, -1, len(lx))
    culled_n = covered_n = wrapped_n = 0
    for t in range(tile_pids.shape[0]):
        pids = tile_pids[t][tile_pids[t] >= 0].long()
        if not pids.numel():
            continue
        e = edges[pids]
        evals = edge_mod.eval_edges(e[:, None, None, None], xs[t], ys[t])
        negative = (evals < 0).flatten(3).all(-1)           # (3, n, Q)
        covered = (evals >= 0).all(0).flatten(2).any(-1)    # (n, Q)
        culled = cuda_raster.patch_culled(e[:, None], org[t, None, :, 0],
                                          org[t, None, :, 1])
        assert culled.shape == covered.shape
        assert not (culled & covered).any()
        assert not (culled & ~negative.any(0)).any()
        # culls that only the wrap explains: some edge's int64 values over
        # the patch are all >= 0, yet it wraps negative on every pixel
        e64 = e.long()[:, None]
        x64, y64 = org[t, None, :, 0, None], org[t, None, :, 1, None]
        x1 = x64 + cuda_raster.PATCH_W - 1
        y1 = y64 + cuda_raster.PATCH_H - 1
        lo = (e64[..., 2] + torch.minimum(e64[..., 0] * x64, e64[..., 0] * x1)
              + torch.minimum(e64[..., 1] * y64, e64[..., 1] * y1))
        wrapped_n += int((culled & (negative & (lo >= 0).permute(2, 0, 1))
                          .any(0)).sum())
        culled_n += int(culled.sum())
        covered_n += int(covered.sum())
    assert culled_n > 0 and covered_n > 0
    if not source.startswith("draw"):
        assert wrapped_n > 0


def test_patch_cull_keeps_few_steps_on_d1():
    """The textured sphere draw at 256x256 with 32x32 tiles: the patches
    keep at most 10 % of the pixel-prim steps (8.8 %)."""
    trace = cgltrace.load_trace(cgltrace.trace_path("synth_draw3d"))
    rs, _, b = driver.prepare_drawcalls(trace, 256, 256, 5, device="cpu")[1]
    edges, _, _, tile_pids, tile_xy = deferred.device_arrays(b, "cpu")
    steps, tests, all_steps = cuda_raster.cull_counts(
        edges, tile_pids, tile_xy, 5, rs.scissor)
    real = int((tile_pids >= 0).sum())
    assert all_steps == real * 32 * 32
    assert tests == real * 32            # every patch lies in the scissor
    assert 0 < steps <= 0.10 * all_steps
    assert steps % 32 == 0
    # a scissor that leaves the frame's left half out halves the tests
    _, half, _ = cuda_raster.cull_counts(edges, tile_pids, tile_xy, 5,
                                         (128, 0, 256, 256))
    assert half == int((tile_pids[tile_xy[:, 0] >= 4] >= 0).sum()) * 32
