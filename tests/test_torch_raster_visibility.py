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

The CUDA kernel against the plain version runs only on a card (marker
``cuda``):  python -m pytest --noconftest -m cuda tests/test_torch_raster_visibility.py
"""
import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch.core import fixed
from skybox_rt_tpu_torch.geom import cgltrace
from skybox_rt_tpu_torch.ops import cuda_raster
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
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    dev = torch.device("cuda")
    for d in DRAWS:
        for tls in TILE_LOGSIZES:
            rs, _, arrs, fbd = _port_inputs(d, tls, device=dev)
            fbd = fixed.from_numpy_u32(fbd, device=dev)
            for K in (0, K_SLOTS):
                got = cuda_raster.visibility_tiles(rs, *arrs, fbd, tls,
                                                   fused=K == 0,
                                                   blend_slots=K)
                want = cuda_raster.visibility_tiles_reference(
                    rs, *arrs, fbd, tls, fused=K == 0, blend_slots=K)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (d, tls, K)
