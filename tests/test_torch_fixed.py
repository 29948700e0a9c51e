"""core.fixed of the port against skybox_rt_tpu.core.fixed, exactly.

Random int32 operands come from a numpy seed (and from hypothesis), the
float casts include NaN, +-inf, +-2^31 and the values around them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from skybox_rt_tpu.core import fixed as jfixed
from skybox_rt_tpu_torch.core import fixed

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

I32 = st.integers(min_value=-(2 ** 31), max_value=2 ** 31 - 1)


def _rand_i32(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-(2 ** 31), 2 ** 31, size=n, dtype=np.int64).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


SPECIAL_F32 = np.array(
    [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 127.99999, 128.0,
     -128.0, -128.00002, 2.0 ** 31, -(2.0 ** 31), 2.0 ** 31 / 2 ** 24,
     -(2.0 ** 31) / 2 ** 24, np.nextafter(np.float32(128.0), np.float32(0)),
     1e-30, -1e-30, 3.4e38, -3.4e38], np.float32)


@pytest.mark.parametrize("frac", [16, 24])
def test_to_fixed_x86_special_and_random(frac):
    rng = np.random.default_rng(frac)
    x = np.concatenate([
        SPECIAL_F32,
        rng.standard_normal(4096).astype(np.float32) * np.float32(300),
        rng.uniform(-2.0 ** 8, 2.0 ** 8, 4096).astype(np.float32)])
    want = np.asarray(jfixed.to_fixed_x86(jnp.asarray(x), frac))
    got = fixed.to_fixed_x86(_t(x), frac).numpy()
    np.testing.assert_array_equal(got, want)
    # NaN and out of range give INT_MIN explicitly
    assert got[0] == got[1] == got[2] == np.iinfo(np.int32).min


@pytest.mark.parametrize("frac", [16, 24])
def test_fixed_to_float(frac):
    x = np.concatenate([_rand_i32(4096, frac), np.array(
        [0, 1, -1, 2 ** 24 + 1, -(2 ** 31), 2 ** 31 - 1], np.int32)])
    want = np.asarray(jfixed.fixed_to_float(jnp.asarray(x), frac))
    got = fixed.fixed_to_float(_t(x), frac).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shift", [1, 8, 16, 24, 31])
def test_mul_shift(shift):
    a, b = _rand_i32(8192, shift), _rand_i32(8192, shift + 100)
    want = np.asarray(jfixed.mul_shift(jnp.asarray(a), jnp.asarray(b), shift))
    np.testing.assert_array_equal(
        fixed.mul_shift(_t(a), _t(b), shift).numpy(), want)


def test_mul_shift_rejects_bad_shift():
    with pytest.raises(ValueError):
        fixed.mul_shift(_t(np.int32([1])), _t(np.int32([1])), 32)


def test_imadd24_random():
    a, b, c = _rand_i32(8192, 1), _rand_i32(8192, 2), _rand_i32(8192, 3)
    want = np.asarray(jfixed.imadd24(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(c)))
    np.testing.assert_array_equal(fixed.imadd24(_t(a), _t(b), _t(c)).numpy(),
                                  want)


@settings(max_examples=200, deadline=None)
@given(a=I32, b=I32, c=I32)
def test_imadd24_property(a, b, c):
    """imadd24 is the low 32 bits of ((int64)a*b >> 24) + c."""
    want = (((a * b) >> 24) + c) & 0xFFFFFFFF
    want = want - 2 ** 32 if want >= 2 ** 31 else want
    got = fixed.imadd24(torch.tensor([a], dtype=torch.int32),
                        torch.tensor([b], dtype=torch.int32),
                        torch.tensor([c], dtype=torch.int32))
    assert int(got[0]) == want


def test_interpolate24():
    ax, ay, az = _rand_i32(4096, 7), _rand_i32(4096, 8), _rand_i32(4096, 9)
    dx, dy = _rand_i32(4096, 10) >> 6, _rand_i32(4096, 11) >> 6
    want = np.asarray(jfixed.interpolate24(*(jnp.asarray(v) for v in
                                             (ax, ay, az, dx, dy))))
    got = fixed.interpolate24(*(_t(v) for v in (ax, ay, az, dx, dy)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_to_fixed_np_is_the_same_host_code():
    x = np.random.default_rng(3).uniform(-100, 100, 4096).astype(np.float32)
    for frac in (16, 24):
        np.testing.assert_array_equal(fixed.to_fixed_np(x, frac),
                                      jfixed.to_fixed_np(x, frac))


@settings(max_examples=200, deadline=None)
@given(v=st.integers(min_value=0, max_value=2 ** 32 - 1))
def test_u32_round_trip(v):
    """int32 patterns <-> u32 values <-> numpy uint32, for every word."""
    t = fixed.from_numpy_u32(np.array([v], np.uint64))
    assert t.dtype == torch.int32
    assert int(fixed.u32(t)[0]) == v
    assert int(fixed.to_numpy_u32(t)[0]) == v
    assert fixed.s32(v) == int(t[0])
    assert int(fixed.i32(torch.tensor([v + 2 ** 32 * 3]))[0]) == int(t[0])
