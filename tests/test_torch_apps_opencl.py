"""The OpenCL-suite apps of the port against the JAX package and the numpy
oracles, on the CPU.

Each app takes the same numpy-seeded inputs through skybox_rt_tpu.apps.
opencl and skybox_rt_tpu_torch.apps.opencl.  Integer results (bfs costs,
kmeans ids, nearn's argmin, transpose) are exact; float results agree with
the oracle within the JAX tests' tolerances (tests/test_opencl_apps.py) and
with the JAX function within the same ones, since XLA's CPU code may
contract multiply-adds and sum in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skybox_rt_tpu.apps import opencl as jopencl
from skybox_rt_tpu_torch.apps import opencl

torch.set_num_threads(1)


def rng(seed=0):
    return np.random.default_rng(seed)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_saxpy_dot_psum_transpose():
    r = rng(1)
    x = r.standard_normal(2048).astype(np.float32)
    y = r.standard_normal(2048).astype(np.float32)
    got = opencl.saxpy(2.5, t(x), t(y)).numpy()
    np.testing.assert_allclose(got, 2.5 * x + y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jopencl.saxpy(2.5, x, y)),
                               rtol=1e-5, atol=1e-6)
    for got, want, ref in (
            (opencl.dotproduct(t(x), t(y)), jopencl.dotproduct(x, y),
             np.dot(x, y)),
            (opencl.psum_reduce(t(x)), jopencl.psum_reduce(x), x.sum())):
        np.testing.assert_allclose(float(got), ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                                   atol=1e-4)
    a = r.standard_normal((37, 53)).astype(np.float32)
    got = opencl.transpose(t(a)).numpy()
    np.testing.assert_array_equal(got, a.T)
    np.testing.assert_array_equal(got, np.asarray(jopencl.transpose(a)))


def test_blackscholes():
    r = rng(2)
    n = 4096
    S = r.uniform(5.0, 30.0, n).astype(np.float32)
    X = r.uniform(1.0, 100.0, n).astype(np.float32)
    T = r.uniform(0.25, 10.0, n).astype(np.float32)
    call, put = opencl.blackscholes(t(S), t(X), t(T), 0.02, 0.30)
    c_ref, p_ref = opencl.blackscholes_oracle(S, X, T, 0.02, 0.30)
    jc_ref, jp_ref = jopencl.blackscholes_oracle(S, X, T, 0.02, 0.30)
    np.testing.assert_array_equal(c_ref, jc_ref)
    np.testing.assert_array_equal(p_ref, jp_ref)
    jcall, jput = jopencl.blackscholes(S, X, T, 0.02, 0.30)
    for got, ref, want in ((call, c_ref, jcall), (put, p_ref, jput)):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_nearn():
    r = rng(3)
    pts = r.standard_normal((1000, 2)).astype(np.float32)
    q = np.array([0.3, -0.2], np.float32)
    dist, idx = opencl.nearn(t(pts), t(q))
    jdist, jidx = jopencl.nearn(pts, q)
    ref = np.sqrt(((pts - q) ** 2).sum(1))
    np.testing.assert_allclose(dist.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-5,
                               atol=1e-6)
    assert int(idx) == int(np.argmin(ref)) == int(jidx)


def test_kmeans_step():
    r = rng(4)
    pts = r.standard_normal((500, 3)).astype(np.float32)
    cen = r.standard_normal((7, 3)).astype(np.float32)
    assign = opencl.kmeans_assign(t(pts), t(cen)).numpy()
    ref_assign = np.argmin(((pts[:, None] - cen[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(assign, ref_assign)
    np.testing.assert_array_equal(
        assign, np.asarray(jopencl.kmeans_assign(pts, cen)))
    upd = opencl.kmeans_update(t(pts), t(assign), 7).numpy()
    jupd = np.asarray(jopencl.kmeans_update(pts, assign.astype(np.int32), 7))
    for k in range(7):
        members = pts[assign == k]
        ref = members.mean(0) if len(members) else np.zeros(3, np.float32)
        np.testing.assert_allclose(upd[k], ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(upd, jupd, rtol=1e-4, atol=1e-5)


def test_kmeans_empty_cluster_keeps_zero():
    pts = np.ones((4, 2), np.float32)
    upd = opencl.kmeans_update(t(pts), torch.zeros(4, dtype=torch.int64), 3)
    np.testing.assert_array_equal(upd.numpy()[1:], 0.0)


def test_spmv_csr():
    r = rng(5)
    R, C = 40, 60
    dense = r.standard_normal((R, C)).astype(np.float32)
    dense[r.random((R, C)) > 0.15] = 0.0            # ~85% sparse
    x = r.standard_normal(C).astype(np.float32)
    rows, cols = np.nonzero(dense)
    values = dense[rows, cols].astype(np.float32)
    row_ptr = np.zeros(R + 1, np.int32)
    np.add.at(row_ptr, rows + 1, 1)
    row_ptr = np.cumsum(row_ptr).astype(np.int32)
    row_id = opencl.expand_row_ptr(row_ptr)
    np.testing.assert_array_equal(row_id, rows)
    np.testing.assert_array_equal(row_id, jopencl.expand_row_ptr(row_ptr))
    y = opencl.spmv_csr(t(values), t(cols.astype(np.int32)), t(row_id), t(x),
                        R).numpy()
    jy = np.asarray(jopencl.spmv_csr(values, cols.astype(np.int32), row_id,
                                     x, R))
    np.testing.assert_allclose(y, dense @ x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y, jy, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed,n,m", [(6, 200, 600), (7, 200, 600),
                                      (8, 300, 280), (9, 64, 2000)])
def test_bfs(seed, n, m):
    r = rng(seed)
    src = r.integers(0, n, m).astype(np.int32)
    dst = r.integers(0, n, m).astype(np.int32)
    cost = opencl.bfs(t(src), t(dst), n).numpy()
    ref = opencl.bfs_oracle(src, dst, n)
    assert cost.dtype == np.int32
    np.testing.assert_array_equal(cost, ref)
    np.testing.assert_array_equal(ref, jopencl.bfs_oracle(src, dst, n))
    np.testing.assert_array_equal(
        cost, np.asarray(jopencl.bfs(jnp.asarray(src), jnp.asarray(dst), n)))


def test_gaussian_elimination():
    r = rng(8)
    n = 24
    A = r.standard_normal((n, n)).astype(np.float32)
    A += np.eye(n, dtype=np.float32) * (np.abs(A).sum(1).max() + 1.0)
    b = r.standard_normal(n).astype(np.float32)
    U, c = opencl.gaussian_eliminate(t(A), t(b))
    U, c = U.numpy(), c.numpy()
    jU, jc = jopencl.gaussian_eliminate(A, b)
    assert np.abs(np.tril(U, -1)).max() < 1e-3
    np.testing.assert_allclose(U, np.asarray(jU), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(c, np.asarray(jc), rtol=1e-4, atol=1e-4)
    x = opencl.back_substitute(U, c)
    np.testing.assert_array_equal(x, jopencl.back_substitute(U, c))
    np.testing.assert_allclose(A @ x, b, atol=5e-2)


def test_sfilter():
    """Borders stay zero; the interior within rtol 1e-5, atol 1e-4 of the
    host's reference loop (the JAX test's tolerance)."""
    r = np.random.default_rng(11)
    n = 16
    src = (r.random((n, n), np.float32) * 100.0).astype(np.float32)
    m = r.standard_normal(9).astype(np.float32)
    got = opencl.sfilter(t(src), t(m)).numpy()
    ref = np.zeros((n, n), np.float32)
    for y in range(1, n - 1):
        for x in range(1, n - 1):
            acc = np.float32(0)
            for k, (dy, dx) in enumerate(opencl._TAPS):
                acc = np.float32(acc + np.float32(src[y + dy, x + dx] * m[k]))
            ref[y, x] = acc
    # eager torch rounds every product and add as the loop does
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, np.asarray(jopencl.sfilter(src, m)),
                               rtol=1e-5, atol=1e-4)
    assert got[0].sum() == 0 and got[-1].sum() == 0
    assert got[:, 0].sum() == 0 and got[:, -1].sum() == 0


def test_sgemm3():
    r = np.random.default_rng(12)
    n = 32
    A = r.standard_normal((n, n)).astype(np.float32)
    B = r.standard_normal((n, n)).astype(np.float32)
    got = opencl.sgemm3(t(A), t(B)).numpy()
    ref = A.astype(np.float64) @ B.astype(np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jopencl.sgemm3(A, B)),
                               rtol=1e-5, atol=1e-5)
