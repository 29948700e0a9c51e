"""The compute regression apps of the port against the JAX package and the
numpy oracles, on the CPU.

Each app takes the same numpy-seeded inputs through skybox_rt_tpu.apps.
compute and skybox_rt_tpu_torch.apps.compute.  Integer results are exact;
float results agree within the JAX tests' rtol 1e-5, atol 1e-5
(tests/test_compute_apps.py), since XLA's CPU code may contract
multiply-adds and eager torch does not.

``sgemm_pallas`` (kernel #12): on the CPU the port runs the kernel's plain
version, held to the JAX Pallas kernel in interpret mode (as its own test
runs it) at rtol 1e-5, atol 1e-3, and bit for bit to a float32 numpy loop
over ascending k.  The CUDA kernel against the plain version runs only on a
card (marker ``cuda``):
python -m pytest --noconftest -m cuda tests/test_torch_apps_compute.py
"""
import zlib

import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch.apps import compute, cuda_sgemm
from skybox_rt_tpu_torch.core import fixed

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _jax():
    from skybox_rt_tpu.apps import compute as jcompute
    return jcompute


def rng(seed):
    return np.random.default_rng(seed)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _both(name, *args, jargs=None):
    """(port result as numpy, JAX result as numpy) of compute.<name>."""
    got = getattr(compute, name)(*(t(a) for a in args)).numpy()
    want = np.asarray(getattr(_jax(), name)(*(jargs or args)))
    return got, want


def test_vecadd():
    r = rng(1)
    a = r.standard_normal(4096).astype(np.float32)
    b = r.standard_normal(4096).astype(np.float32)
    got, want = _both("vecadd", a, b)
    np.testing.assert_array_equal(got, a + b)
    np.testing.assert_array_equal(got, want)


def test_sgemm():
    r = rng(2)
    a = r.standard_normal((128, 96)).astype(np.float32)
    b = r.standard_normal((96, 64)).astype(np.float32)
    got, want = _both("sgemm", a, b)
    np.testing.assert_allclose(got, a @ b, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_conv3x():
    r = rng(4)
    h, w = 33, 47
    padded = np.zeros((h + 2, w + 2), np.float32)
    padded[1:-1, 1:-1] = r.standard_normal((h, w)).astype(np.float32)
    wts = r.standard_normal((3, 3)).astype(np.float32)
    ref = np.zeros((h, w), np.float32)
    for y in range(h):
        for x in range(w):
            ref[y, x] = np.sum(padded[y:y + 3, x:x + 3] * wts,
                               dtype=np.float32)
    got, want = _both("conv3x", padded, wts)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_stencil3d():
    r = rng(5)
    s = 9
    vol = r.standard_normal((s, s, s)).astype(np.float32)
    p = np.pad(vol, 1, mode="edge")
    ref = sum(p[dz:dz + s, dy:dy + s, dx:dx + s]
              for dz in range(3) for dy in range(3) for dx in range(3)) / 27.0
    got, want = _both("stencil3d", vol)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_rank_sort_stable_with_duplicates():
    r = rng(6)
    x = r.integers(0, 50, size=257).astype(np.int32)   # duplicates certain
    got, want = _both("rank_sort", x)
    np.testing.assert_array_equal(got, np.sort(x, kind="stable"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(-20, 20), (-2**20, 2**20)])
def test_diverge(lo, hi):
    """Exact, and int32 wraparound as JAX's at large values."""
    r = rng(7)
    src = r.integers(lo, hi, size=64).astype(np.int32)
    got, want = _both("diverge", src)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if hi <= 20:
        np.testing.assert_array_equal(got, compute.diverge_oracle(src))


def test_diverge_oracle_is_the_jax_one():
    src = rng(8).integers(-20, 20, size=40).astype(np.int32)
    np.testing.assert_array_equal(compute.diverge_oracle(src),
                                  _jax().diverge_oracle(src))


def test_dogfood_cases_are_the_jax_ones():
    assert sorted(compute.DOGFOOD_CASES) == sorted(_jax().DOGFOOD_CASES)
    assert len(compute.DOGFOOD_CASES) == 22


@pytest.mark.parametrize("name", sorted(compute.DOGFOOD_CASES))
def test_dogfood(name):
    import jax.numpy as jnp
    r = rng(zlib.crc32(name.encode()))
    fn, oracle = compute.DOGFOOD_CASES[name]
    jfn, joracle = _jax().DOGFOOD_CASES[name]
    n = 256
    if name.startswith("i"):
        a = r.integers(-1000, 1000, size=n).astype(np.int32)
        b = r.integers(1, 1000, size=n).astype(np.int32)  # no div-by-zero
    else:
        a = (r.standard_normal(n) * 4 + 0.5).astype(np.float32)
        b = (np.abs(r.standard_normal(n)) + 0.5).astype(np.float32)
    out = fn(t(a), t(b))
    ref = oracle(a, b)
    np.testing.assert_array_equal(ref, joracle(a, b))
    want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
    got = (fixed.to_numpy_u32(out) if ref.dtype == np.uint32
           else out.numpy())
    assert got.dtype == ref.dtype
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, want)


def test_utof_reads_u32_words():
    """utof on int32 patterns takes them as unsigned (0xFFFFFFFF -> 2^32)."""
    a = torch.tensor([-1, 5, -2 ** 31], dtype=torch.int32)
    b = torch.zeros(3, dtype=torch.int32)
    want = np.array([0xFFFFFFFF, 5, 2 ** 31], np.uint32).astype(np.float32)
    np.testing.assert_array_equal(compute.DOGFOOD_CASES["utof"][0](a, b),
                                  want)


def _sgemm_inputs(m, k, n, seed=3):
    r = rng(seed)
    return (r.standard_normal((m, k)).astype(np.float32),
            r.standard_normal((k, n)).astype(np.float32))


def test_sgemm_pallas_matches_jax():
    import jax.numpy as jnp
    a, b = _sgemm_inputs(256, 384, 128)
    got = compute.sgemm_pallas(t(a), t(b), block=(128, 128, 128)).numpy()
    want = np.asarray(_jax().sgemm_pallas(jnp.asarray(a), jnp.asarray(b),
                                          block=(128, 128, 128),
                                          interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got, a @ b, rtol=1e-5, atol=1e-3)


def _ascending_k(a, b):
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for kk in range(a.shape[1]):
        acc = acc + a[:, kk:kk + 1] * b[kk:kk + 1, :]
    return acc


@pytest.mark.parametrize("m,k,n,block", [(256, 384, 128, (128, 128, 128)),
                                         (200, 72, 136, (8, 8, 8))])
def test_sgemm_twin_is_the_ascending_k_loop(m, k, n, block):
    """The plain version is bit-equal to float32 numpy over ascending k,
    whatever the block (a ragged shape: 200 x 72 x 136, block 8)."""
    a, b = _sgemm_inputs(m, k, n, seed=m + k)
    got = compute.sgemm_pallas(t(a), t(b), block=block).numpy()
    np.testing.assert_array_equal(got, _ascending_k(a, b))
    np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("block", [(128, 128, 128), (8, 8, 7), (3, 8, 8)])
def test_sgemm_pallas_block_must_divide(block):
    a, b = _sgemm_inputs(200, 72, 136)
    with pytest.raises(ValueError):
        compute.sgemm_pallas(t(a), t(b), block=block)


def test_sgemm_wrapper_rejects():
    a, b = _sgemm_inputs(16, 8, 4)
    with pytest.raises(ValueError):
        cuda_sgemm.sgemm(t(a), t(a))                   # shapes do not chain
    with pytest.raises(TypeError):
        cuda_sgemm.sgemm(t(a).double(), t(b).double())
    with pytest.raises(ValueError):
        cuda_sgemm.sgemm(t(a).to("meta"), t(b).to("meta"))


@pytest.mark.cuda
def test_sgemm_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    for (m, k, n), block in (((256, 384, 128), (128, 128, 128)),
                             ((200, 72, 136), (8, 8, 8)),
                             ((1, 1, 1), (1, 1, 1)),
                             ((130, 257, 129), (1, 1, 1))):
        a, b = (x.cuda() for x in map(t, _sgemm_inputs(m, k, n)))
        cuda_sgemm.reset_launch_count()
        got = compute.sgemm_pallas(a, b, block=block)
        assert cuda_sgemm.launch_count == 1
        want = cuda_sgemm.sgemm_reference(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (m, k, n)
