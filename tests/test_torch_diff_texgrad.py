"""The texture-gradient path: row accumulation and the hand-written backward
passes around it, the port against the JAX package.

``diff.cuda_texgrad.accumulate_rows_reference`` (the plain version of the CUDA
kernel ``csrc/diff_accumulate.cu``, which ``accumulate_rows`` runs for CPU
tensors) against the JAX package's Pallas kernel in interpret mode
(``pallas_texgrad.accumulate_rows(interpret=True)``) on the same numpy-seeded
inputs: rtol 1e-5 / atol 1e-5 (the two sum in different orders).  The port's
order is pinned: two calls are bit-identical and equal a per-row float32 loop
in the documented order (segments of ascending n, then the segments in
order).  The quad sampler's and ``gather_tile_rows``' hand-written backward
passes against autograd of the same math: rtol 1e-5 / atol 1e-6.

The kernel's scratch, which the wrapper sizes in Python
(``cuda_texgrad.scratch_sizes``), is checked against what the data needs at
N = 0, one table row, all values dropped, all values in one row and N past
SEGMENTS_MAX * SEGMENT_MIN.  The CUDA kernel against the plain version runs
only on a card (marker ``cuda``), with a skewed and a long case besides:  python -m pytest --noconftest -m cuda tests/test_torch_diff_texgrad.py
"""
import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch.diff import cuda_texgrad, pipeline

torch.set_num_threads(1)

SHAPES = {
    "texel": (3000, 256, 16),
    "record": (1500, 320, 27),
    "vertex": (900, 161, 4),
    "uv": (900, 161, 2),
    "segments": (2 * cuda_texgrad.SEGMENT_MIN + 77, 64, 3),
    "one_row": (500, 1, 5),
}


def _inputs(name, spread=False):
    N, R, C = SHAPES[name]
    rng = np.random.default_rng(sorted(SHAPES).index(name))
    lo, hi = (-R // 8, R + R // 8 + 1) if spread else (0, R)
    idx = rng.integers(lo, hi, N).astype(np.int32)
    val = rng.normal(size=(N, C)).astype(np.float32)
    return idx, val, R


def _documented_order(idx, val, R):
    """out[r] = 0 + partial[0, r] + ..., partial[s, r] = 0 + the segment's
    val[n] with idx[n] == r in ascending n, every add in float32."""
    N, C = val.shape
    S, L = cuda_texgrad.segments(N)
    out = np.zeros((R, C), np.float32)
    for s in range(S):
        partial = np.zeros((R, C), np.float32)
        for n in range(s * L, min(N, (s + 1) * L)):
            if 0 <= idx[n] < R:
                partial[idx[n]] = partial[idx[n]] + val[n]
        out = out + partial
    return out


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_matches_jax_kernel(name):
    import jax.numpy as jnp

    from skybox_rt_tpu.diff import pallas_texgrad
    idx, val, R = _inputs(name)
    got = cuda_texgrad.accumulate_rows(torch.from_numpy(idx),
                                       torch.from_numpy(val), R)
    assert got.dtype == torch.float32 and tuple(got.shape) == (R, val.shape[1])
    want = pallas_texgrad.accumulate_rows(jnp.asarray(idx), jnp.asarray(val),
                                          R, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_order_is_pinned(name):
    idx, val, R = _inputs(name, spread=True)
    assert (idx < 0).any() or R == 1
    args = (torch.from_numpy(idx), torch.from_numpy(val), R)
    first = cuda_texgrad.accumulate_rows_reference(*args)
    again = cuda_texgrad.accumulate_rows_reference(*args)
    assert torch.equal(first, again)
    np.testing.assert_array_equal(first.numpy(),
                                  _documented_order(idx, val, R))
    # int64 idx, as torch.gather's callers hold it, is the same function
    assert torch.equal(first, cuda_texgrad.accumulate_rows(
        args[0].long(), args[1], R))


def test_segments_depend_on_n_alone():
    assert cuda_texgrad.segments(0) == (1, 1)
    assert cuda_texgrad.segments(1) == (1, 1)
    assert cuda_texgrad.segments(cuda_texgrad.SEGMENT_MIN) == (
        1, cuda_texgrad.SEGMENT_MIN)
    S, L = cuda_texgrad.segments(cuda_texgrad.SEGMENT_MIN + 1)
    assert S == 2 and S * L >= cuda_texgrad.SEGMENT_MIN + 1
    S, L = cuda_texgrad.segments(10 ** 7)
    assert S == cuda_texgrad.SEGMENTS_MAX and S * L >= 10 ** 7


def test_out_of_range_rows_are_dropped():
    import jax.numpy as jnp

    from skybox_rt_tpu.diff import pallas_texgrad
    idx = np.array([0, 5, 300, 5, -1, 256], np.int32)   # R = 256
    val = np.ones((6, 2), np.float32)
    got = cuda_texgrad.accumulate_rows(torch.from_numpy(idx),
                                       torch.from_numpy(val), 256).numpy()
    assert got[0, 0] == 1.0 and got[5, 0] == 2.0 and got.sum() == 6.0
    want = pallas_texgrad.accumulate_rows(jnp.asarray(idx), jnp.asarray(val),
                                          256, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    empty = cuda_texgrad.accumulate_rows(
        torch.zeros(0, dtype=torch.int32), torch.zeros((0, 3)), 4)
    assert tuple(empty.shape) == (4, 3) and float(empty.abs().sum()) == 0.0


def test_wrapper_rejects_other_devices_and_types():
    idx, val, R = _inputs("uv")
    with pytest.raises(ValueError):
        cuda_texgrad.accumulate_rows(torch.from_numpy(idx).to("meta"),
                                     torch.from_numpy(val).to("meta"), R)


def _sampler_inputs():
    rng = np.random.default_rng(1)
    tex = rng.uniform(0, 1, (8, 8, 4)).astype(np.float32)
    u = rng.uniform(-0.2, 1.2, (3, 7, 7)).astype(np.float32)
    v = rng.uniform(-0.2, 1.2, (3, 7, 7)).astype(np.float32)
    g = rng.normal(size=(3, 7, 7, 4)).astype(np.float32)
    return tex, u, v, g


def test_quad_sampler_backward_matches_autograd_and_jax():
    tex, u, v, g = _sampler_inputs()
    g_t = torch.from_numpy(g)
    grads = []
    for custom in (True, False):
        tq = pipeline._quad_texture(torch.from_numpy(tex)).requires_grad_(True)
        ut = torch.from_numpy(u).requires_grad_(True)
        vt = torch.from_numpy(v).requires_grad_(True)
        if custom:
            out = pipeline.sample_texture_bilinear_quad(tq, ut, vt)
        else:                       # the same math under autograd
            q, _, fx, fy = pipeline._quad_sample_prep(tq, ut, vt)
            out = pipeline._quad_lerp(q, fx, fy)
        (out * g_t).sum().backward()
        grads.append((out.detach(), tq.grad, ut.grad, vt.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)

    import jax
    import jax.numpy as jnp

    from skybox_rt_tpu.diff import pipeline as jpipe
    jq = jpipe._quad_texture(jnp.asarray(tex))
    jg = jax.grad(lambda q, a, b: jnp.sum(
        jpipe.sample_texture_bilinear_quad(q, a, b) * g), argnums=(0, 1, 2))(
            jq, jnp.asarray(u), jnp.asarray(v))
    for a, b in zip(grads[0][1:], jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_quad_sampler_equals_plain_sampler():
    tex, u, v, _ = _sampler_inputs()
    tex, u, v = (torch.from_numpy(a) for a in (tex, u, v))
    assert torch.equal(
        pipeline.sample_texture_bilinear_quad(pipeline._quad_texture(tex),
                                              u, v),
        pipeline.sample_texture_bilinear(tex, u, v))


def _tile_rows_inputs():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(5, 12, 7)).astype(np.float32)
    idx = rng.integers(0, 12, (5, 4, 4)).astype(np.int32)
    g = rng.normal(size=(5, 4, 4, 7)).astype(np.float32)
    return table, idx, g


@pytest.mark.parametrize("group_elems", [1, pipeline.ONEHOT_ELEMS])
def test_gather_tile_rows_backward_matches_autograd(group_elems, monkeypatch):
    """One tile a pass and all tiles in one pass give what autograd's
    gather backward gives."""
    monkeypatch.setattr(pipeline, "ONEHOT_ELEMS", group_elems)
    table, idx, g = _tile_rows_inputs()
    g_t, idx_t = torch.from_numpy(g), torch.from_numpy(idx)
    a = torch.from_numpy(table).requires_grad_(True)
    out = pipeline.gather_tile_rows(a, idx_t)
    (out * g_t).sum().backward()
    b = torch.from_numpy(table).requires_grad_(True)
    flat = idx_t.reshape(5, -1, 1).long().expand(-1, -1, 7)
    want = torch.gather(b, 1, flat).reshape(5, 4, 4, 7)
    (want * g_t).sum().backward()
    assert torch.equal(out, want)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_gather_rows_backward_matches_autograd_and_drops_padding():
    rng = np.random.default_rng(5)
    table = rng.normal(size=(9, 3)).astype(np.float32)
    idx = rng.integers(-1, 9, (6, 5)).astype(np.int32)
    assert (idx < 0).any()
    g = torch.from_numpy(rng.normal(size=(6, 5, 3)).astype(np.float32))
    a = torch.from_numpy(table).requires_grad_(True)
    out = pipeline.gather_rows(a, torch.from_numpy(idx))
    (out * g).sum().backward()
    b = torch.from_numpy(table).requires_grad_(True)
    live = torch.from_numpy(idx >= 0)[..., None]
    want = b[torch.from_numpy(idx).clamp(min=0).long()]
    assert torch.equal(out, want)               # padding reads row 0
    (want * g * live).sum().backward()          # ... and has no gradient
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


def _scratch_case(name):
    """(idx, R, C) of the scratch-sizing cases."""
    r = np.random.default_rng(11)
    long_n = cuda_texgrad.SEGMENTS_MAX * cuda_texgrad.SEGMENT_MIN + 4321
    return {
        "empty": (np.zeros(0, np.int32), 4, 3),
        "one_table_row": (r.integers(0, 1, 700), 1, 5),
        "all_dropped": (r.integers(-9, 0, 3000), 64, 3),
        "one_row": (np.full(5000, 7), 64, 2),
        "long": (r.integers(-5, 4096, long_n), 4096, 16),
    }[name]


@pytest.mark.parametrize("name", ["empty", "one_table_row", "all_dropped",
                                  "one_row", "long"])
def test_scratch_sizes_cover_the_data(name):
    idx, R, C = _scratch_case(name)
    idx = idx.astype(np.int64)
    N = idx.size
    S, L = cuda_texgrad.segments(N)
    plan = cuda_texgrad.scratch_sizes(N, R, C)
    parts = plan["parts"]
    assert list(parts) == ["status", "counts", "ticket", "nlong", "rowslot",
                           "longrows", "perm", "partials"]
    # a scan chunk is whole rows, at most SCAN_KEYS keys; two words a chunk
    rows = plan["rows"]
    assert rows * S <= cuda_texgrad.SCAN_KEYS or rows == 1
    assert parts["status"] == 2 * -(-R // rows)
    assert parts["counts"] == S * R and parts["ticket"] == parts["nlong"] == 1
    assert parts["rowslot"] == R and parts["perm"] == N
    assert parts["longrows"] == plan["max_long"]
    assert parts["partials"] == plan["max_long"] * S * C
    assert plan["words"] == sum(parts.values())
    keep = (idx >= 0) & (idx < R)
    n = np.arange(N)
    # every kept value's (row, segment) group has a count, its n a slot
    if keep.any():
        assert int((idx[keep] * S + n[keep] // L).max()) < parts["counts"]
    assert int(keep.sum()) <= parts["perm"]
    # the rows the kernel sums group by group fit the slots
    rows = np.bincount(idx[keep], minlength=R)
    long_rows = int((rows > cuda_texgrad.LONG_ROW).sum())
    assert long_rows <= plan["max_long"] <= R
    expect = {"empty": (0, 0), "one_table_row": (0, 0),
              "all_dropped": (0, 2), "one_row": (1, 4), "long": (0, 259)}
    assert (long_rows, plan["max_long"]) == expect[name]
    if name == "long":
        assert S == cuda_texgrad.SEGMENTS_MAX and S * L >= N > S * 1024


def _card_cases():
    """(name, idx, val, R) on the card: the shapes above, then 90 % of the
    values in one row (the case that took 4.23 ms in the kernel's first
    design), and N = 2,000,000 into 4,096 rows."""
    for name in sorted(SHAPES):
        idx, val, R = _inputs(name, spread=True)
        yield name, idx, val, R, True
    r = np.random.default_rng(9)
    n = 40000
    idx = np.where(r.random(n) < 0.9, 3, r.integers(-4, 256, n))
    yield "skewed", idx.astype(np.int32), \
        r.normal(size=(n, 16)).astype(np.float32), 256, True
    n = 2_000_000
    yield "long", r.integers(-4, 4096, n).astype(np.int32), \
        r.normal(size=(n, 16)).astype(np.float32), 4096, False


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    for name, idx, val, R, loop in _card_cases():
        idx, val = torch.from_numpy(idx).cuda(), torch.from_numpy(val).cuda()
        cuda_texgrad.reset_launch_count()
        got = cuda_texgrad.accumulate_rows(idx, val, R)
        again = cuda_texgrad.accumulate_rows(idx, val, R)
        assert cuda_texgrad.launch_count == 2
        want = cuda_texgrad.accumulate_rows_reference(idx, val, R)
        torch.cuda.synchronize()
        assert torch.equal(got, again), name
        assert torch.equal(got, want), name
        if loop:        # the per-value loop takes minutes at N = 2,000,000
            np.testing.assert_array_equal(
                got.cpu().numpy(), _documented_order(
                    idx.cpu().numpy(), val.cpu().numpy(), R))
