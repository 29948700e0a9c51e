"""The compute regression apps of the port against the JAX package and the
numpy oracles, on the CPU.

Each app takes the same numpy-seeded inputs through skybox_rt_tpu.apps.
compute and skybox_rt_tpu_torch.apps.compute.  Integer results are exact;
float results agree within the JAX tests' rtol 1e-5, atol 1e-5
(tests/test_compute_apps.py), since XLA's CPU code may contract
multiply-adds and eager torch does not.

``sgemm_pallas`` (kernel #12): on the CPU the port runs the kernel's plain
version, held to the JAX Pallas kernel in interpret mode (as its own test
runs it) at rtol 1e-5, atol 1e-3, and bit for bit to a numpy loop of fused
multiply-adds over ascending k.  The plain version's fmaf emulation is held
bit for bit to the exactly rounded ``a * b + c`` (``fractions.Fraction``,
rounded to float32 by hand) on random triples, ties, cancellations and
subnormal results.  The CUDA kernel against the plain version runs only on a
card (marker ``cuda``):
python -m pytest --noconftest -m cuda tests/test_torch_apps_compute.py
"""
import math
import zlib
from fractions import Fraction

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


def _fma_np(a, b, c):
    """float32 fmaf in numpy, built as the plain version is: the float64
    product is exact, TwoSum gives the error of the float64 sum, and a sum
    exactly halfway between two float32 values goes to the neighbour on the
    error's side."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.float32(np.inf),
                                     np.float32(-np.inf)))
    tie = (r != s) & (r.astype(np.float64) + other == 2 * s) & (e != 0)
    return np.where(tie & ((e > 0) == (other > s)), other, r)


def _ascending_k(a, b):
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for kk in range(a.shape[1]):
        acc = _fma_np(a[:, kk:kk + 1], b[kk:kk + 1, :], acc)
    return acc


def _round_f32(v: Fraction, zero_sign: float) -> np.float32:
    """The float32 nearest to v, ties to even (finite range); an exact zero
    takes zero_sign's sign."""
    if v == 0:
        return np.float32(math.copysign(0.0, zero_sign))
    mag = abs(v)
    e = mag.numerator.bit_length() - mag.denominator.bit_length()
    if Fraction(2) ** e > mag:
        e -= 1
    elif Fraction(2) ** (e + 1) <= mag:
        e += 1
    q = Fraction(2) ** max(e - 23, -149)         # the spacing at |v|
    units = mag / q
    whole = units.numerator // units.denominator
    rest = units - whole
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and whole % 2):
        whole += 1
    out = np.float32(float(whole * q))
    return -out if v < 0 else out


def _fma_exact(a, b, c):
    """fmaf by exact rational arithmetic: a * b + c rounded once."""
    out = np.empty(a.shape, np.float32)
    for i, (x, y, z) in enumerate(zip(a.tolist(), b.tolist(), c.tolist())):
        prod = Fraction(x) * Fraction(y)
        # an exact zero is -0 only when the product and c are both -0
        neg_zero = prod == 0 and math.copysign(1.0, x * y) < 0 \
            and z == 0 and math.copysign(1.0, z) < 0
        out[i] = _round_f32(prod + Fraction(z), -1.0 if neg_zero else 1.0)
    return out


def _fma_triples(kind, count=1500, seed=0):
    """float32 (a, b, c): random, or built so that a * b lies exactly
    halfway between two float32 values with a tiny c of either sign, or so
    that c cancels a * b, or with subnormal results."""
    r = rng(seed + len(kind))
    if kind == "random":
        a, b, c = (r.standard_normal(count).astype(np.float32)
                   * np.float32(2.0) ** r.integers(-20, 20, count)
                   for _ in range(3))
        return a.astype(np.float32), b.astype(np.float32), \
            c.astype(np.float32)
    # odd 13-bit significands whose product has 25 significant bits: the
    # product's last bit is half a float32 unit, a midpoint
    p = r.integers(2 ** 12, 2 ** 13, 8 * count) | 1
    q = r.integers(2 ** 12, 2 ** 13, 8 * count) | 1
    keep = (p * q < 2 ** 25)
    p, q = p[keep][:count], q[keep][:count]
    sign = np.where(r.random(count) < 0.5, -1.0, 1.0)
    if kind == "subnormal":
        ea, eb = -75 - r.integers(0, 10, count), -75 - r.integers(0, 10, count)
    else:
        ea, eb = r.integers(-30, 10, count) - 12, r.integers(-30, 10, count) - 12
    a = (sign * p * np.float64(2.0) ** ea).astype(np.float32)
    b = (q * np.float64(2.0) ** eb).astype(np.float32)
    prod = a.astype(np.float64) * b.astype(np.float64)
    if kind in ("tie_up", "tie_down"):
        # below half a float64 unit of the product: a float64 sum rounds
        # back onto the midpoint; tie_up pushes |a * b + c| above it
        tiny = prod * np.float64(2.0) ** -60
        c = tiny if kind == "tie_up" else -tiny
    elif kind == "cancel":
        c = -prod * (1 + np.float64(2.0) ** -30 * r.integers(-3, 4, count))
    else:                                       # subnormal
        c = np.where(r.random(count) < 0.5, 0.0,
                     r.standard_normal(count) * np.float64(2.0) ** -149 * 8)
    return a, b, c.astype(np.float32)


FMA_KINDS = ["random", "tie_up", "tie_down", "cancel", "subnormal"]


@pytest.mark.parametrize("impl", ["torch", "numpy"])
@pytest.mark.parametrize("kind", FMA_KINDS)
def test_fma_emulation_is_exactly_rounded(kind, impl):
    """The plain version's fmaf (and the tests' numpy twin) equal a * b + c
    rounded once, exactly, bit for bit; on the ties a float64 a * b + c
    rounded to float32 does not."""
    a, b, c = _fma_triples(kind)
    want = _fma_exact(a, b, c)
    if impl == "torch":
        got = cuda_sgemm.fma_reference(t(a), t(b), t(c)).numpy()
    else:
        got = _fma_np(a, b, c)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    if kind.startswith("tie"):
        assert (naive.view(np.int32) != want.view(np.int32)).sum() > 0
    if kind == "subnormal":
        assert ((want != 0) & (np.abs(want) < np.finfo(np.float32).tiny)).any()


@pytest.mark.parametrize("m,k,n,block", [(256, 384, 128, (128, 128, 128)),
                                         (200, 72, 136, (8, 8, 8))])
def test_sgemm_twin_is_the_ascending_k_loop(m, k, n, block):
    """The plain version is bit-equal to a numpy loop of float32 fused
    multiply-adds over ascending k, whatever the block (a ragged shape:
    200 x 72 x 136, block 8)."""
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
