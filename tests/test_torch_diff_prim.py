"""The triangle set-up: ``diff.cuda_prim`` (csrc/diff_prim.cu on the card,
through ``pipeline._PrimSetup``) and its plain versions.

On the CPU: the backward's plain twin (``cuda_prim.prim_backward_reference``,
the closed-form chain) summed by the row accumulation equals autograd's
gradients of the plain set-up ``pipeline._prim_setup`` exactly on
integer-valued inputs and to float rounding on random ones, textured and
not, at P = 1, off a block multiple, with zero-area triangles, negative and
zero w and a negative index; ``pipeline._PrimSetup`` with stand-ins in the
kernels' place gives the plain record and z, edges / color / uv as views of
the record, z without a gradient and the plain gradients; CPU tensors never
touch the kernel library; the wrapper rejects a wrong dtype, shape, layout,
alignment or device.

On the card (marker ``cuda``; no JAX in this file): the forward's record and
z bit for bit the plain set-up's on the card, the backward bit for bit its
twin and twice alike, the Function's gradients within 1e-5 of each one's
largest magnitude of autograd's through the plain set-up, and the hard,
K-slot, alpha and soft renders' images and gradients against the same with
the plain set-up in the kernels' place:
  python -m pytest --noconftest -m cuda tests/test_torch_diff_prim.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch import _build
from skybox_rt_tpu_torch.diff import check, cuda_prim, cuda_texgrad, pipeline
from skybox_rt_tpu_torch.utils import tracing

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

#: (triangles, vertices); 70 and 300 are off the kernels' block of 64
SIZES = {"p1": (1, 3), "p70": (70, 40), "p300": (300, 200)}
GRAD_RTOL = 1e-5    # largest difference over each gradient's largest magnitude


def _cfg(textured, width=64, height=48, near=0.0, far=1.0):
    return pipeline.DiffRenderConfig(width=width, height=height, near=near,
                                     far=far, textured=textured)


def _inputs(size, textured, integer, seed, device="cpu"):
    """params (pos, color, uv), indices (P, 3) int32 and an upstream record
    gradient G (P, C).  Vertices are shared between triangles; the first
    triangles are special: a zero-area one (one vertex thrice), a collinear
    one, one with negative w, one with w = 0 at a corner, one with a
    negative index.  ``integer``: every value a small integer (G's too), so
    every product and sum is exact in float32."""
    P, V = SIZES[size]
    rng = np.random.default_rng(seed)
    if integer:
        pos = rng.integers(-8, 9, (V, 4)).astype(np.float32)
        pos[:, 3] = rng.integers(1, 5, V)
        color = rng.integers(-4, 5, (V, 4)).astype(np.float32)
        uv = rng.integers(-4, 5, (V, 2)).astype(np.float32)
    else:
        pos = rng.uniform(-1.0, 1.0, (V, 4)).astype(np.float32)
        pos[:, 3] = rng.uniform(0.5, 2.0, V)
        color = rng.uniform(0.0, 1.0, (V, 4)).astype(np.float32)
        uv = rng.uniform(0.0, 1.0, (V, 2)).astype(np.float32)
    indices = rng.integers(0, V, (P, 3)).astype(np.int32)
    if P > 5:
        indices[0] = indices[0, 0]                   # zero area: det = 0
        pos[V - 1] = pos[V - 2] + (pos[V - 2] - pos[V - 3])
        indices[1] = (V - 3, V - 2, V - 1)           # collinear when w = 1
        pos[indices[2, 0], 3] = -pos[indices[2, 0], 3]   # negative w
        pos[indices[3, 1], 3] = 0.0                  # w = 0
        indices[4, 2] = -1                           # reads row 0
    C = _width(textured)
    if integer:
        grad = rng.integers(-8, 9, (P, C)).astype(np.float32)
    else:
        grad = rng.normal(size=(P, C)).astype(np.float32)
    params = {"pos": pos, "color": color}
    if textured:
        params["uv"] = uv
    params = {k: torch.from_numpy(v).to(device).requires_grad_(True)
              for k, v in params.items()}
    if textured:        # read by no set-up arithmetic: no gradient
        params["tex"] = torch.zeros((4, 4, 4), device=device)
    return (params, torch.from_numpy(indices).to(device),
            torch.from_numpy(grad).to(device))


def _width(textured):
    return cuda_prim.REC_WIDTH_TEXTURED if textured else cuda_prim.REC_WIDTH


def _autograd(params, indices, grad, cfg):
    """The plain set-up's record and z, and autograd's gradients of
    sum(record * grad) to the parameters."""
    for p in params.values():
        p.grad = None
    setup = pipeline._prim_setup(params, indices, cfg)
    rec = pipeline._record(setup)
    rec.backward(grad)
    return rec.detach(), setup["z"].detach(), {
        k: p.grad.clone() for k, p in params.items() if p.requires_grad}


def _twin(params, indices, grad, cfg):
    """The backward twin's rows, summed as the Function sums them."""
    corner = torch.cat([indices[:, 0], indices[:, 1], indices[:, 2]])
    rows = cuda_prim.prim_backward_reference(params["pos"], indices, grad,
                                             cfg.width, cfg.height)
    V = params["pos"].shape[0]
    return {k: cuda_texgrad.accumulate_rows_reference(corner, d, V)
            for k, d in zip(("pos", "color", "uv"), rows) if d is not None}


def _same_bits(got, want):
    return got.dtype == want.dtype and got.shape == want.shape and \
        torch.equal(got.view(torch.int32), want.view(torch.int32))


def _grad_close(got, want, rtol=GRAD_RTOL):
    scale = float(want.abs().max())
    return float((got - want).abs().max()) <= rtol * max(scale, 1e-30)


# ------------------------------------------------ the twin on the CPU ----

@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_twin_equals_autograd_on_integers(size, textured):
    cfg = _cfg(textured)
    params, indices, grad = _inputs(size, textured, True, seed=len(size))
    _, _, want = _autograd(params, indices, grad, cfg)
    got = _twin(params, indices, grad, cfg)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not bool(got["pos"][:, 2].any())          # z takes no gradient


@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_twin_matches_autograd_on_random_inputs(size, textured):
    cfg = _cfg(textured, width=1024, height=768, near=0.25, far=3.0)
    params, indices, grad = _inputs(size, textured, False, seed=7)
    _, _, want = _autograd(params, indices, grad, cfg)
    got = _twin(params, indices, grad, cfg)
    for k in want:
        assert _grad_close(got[k], want[k]), k


def test_twin_rows_are_corner_major():
    """Row k P + p is corner k of triangle p: its colour and uv rows are
    the gradient's columns of that corner, its pos row's z 0."""
    params, indices, grad = _inputs("p70", True, False, seed=2)
    dpos, dcol, duv = cuda_prim.prim_backward_reference(
        params["pos"], indices, grad, 64, 48)
    P = indices.shape[0]
    assert dpos.shape == dcol.shape == (3 * P, 4) and duv.shape == (3 * P, 2)
    for k in range(3):
        assert torch.equal(dcol[k * P:(k + 1) * P],
                           grad[:, 9 + 4 * k:13 + 4 * k])
        assert torch.equal(duv[k * P:(k + 1) * P],
                           grad[:, 21 + 2 * k:23 + 2 * k])
    assert not bool(dpos[:, 2].any())
    untextured = cuda_prim.prim_backward_reference(
        params["pos"], indices, grad[:, :21].contiguous(), 64, 48)
    assert untextured[2] is None and torch.equal(untextured[0], dpos)


# ------------------------------------ the Function's plumbing on the CPU --

def _forward_standin(pos, color, uv, indices, width, height, near, far):
    """The plain set-up in the forward kernel's place."""
    cfg = _cfg(uv is not None, width, height, near, far)
    params = {"pos": pos, "color": color}
    if uv is not None:
        params.update(uv=uv, tex=torch.zeros((4, 4, 4)))
    with torch.no_grad():
        setup = pipeline._prim_setup(params, indices, cfg)
    corner = torch.cat([indices[:, 0], indices[:, 1], indices[:, 2]])
    return pipeline._record(setup), setup["z"], corner


@pytest.mark.parametrize("textured", [False, True])
def test_function_with_twins_in_the_kernels_place(textured, monkeypatch):
    """pipeline._PrimSetup on the CPU, the plain versions standing in for
    the kernels: the record, its views and z as the plain set-up gives
    them, z without a gradient, and autograd's gradients exactly (integer
    inputs); the gradients reach every parameter through the views too."""
    monkeypatch.setattr(cuda_prim, "prim_forward", _forward_standin)
    monkeypatch.setattr(cuda_prim, "prim_backward",
                        cuda_prim.prim_backward_reference)
    cfg = _cfg(textured)
    params, indices, grad = _inputs("p70", textured, True, seed=5)
    want_rec, want_z, want = _autograd(params, indices, grad, cfg)
    plain = pipeline._prim_setup(params, indices, cfg)
    for p in params.values():
        p.grad = None
    setup = pipeline._prim_setup_kernel(params, indices, cfg)
    assert set(setup) == set(plain) | {"rec"}
    rec = setup["rec"]
    assert _same_bits(rec.detach(), want_rec)
    assert _same_bits(setup["z"], want_z)
    assert not setup["z"].requires_grad
    for k in ("edges", "color", "uv"):
        if k in plain:
            assert setup[k]._base is rec
            assert _same_bits(setup[k].detach(), plain[k].detach()), k
    rec.backward(grad)
    for k in want:
        assert torch.equal(params[k].grad, want[k]), k
    for p in params.values():
        p.grad = None
    setup = pipeline._prim_setup_kernel(params, indices, cfg)
    (setup["edges"].sum() + setup["color"].sum()).backward()
    assert params["pos"].grad is not None
    assert bool(params["color"].grad.any())


@pytest.mark.parametrize("mode,slots", [("hard", 1), ("hard", 2),
                                        ("alpha", 2), ("soft", 2)])
def test_cpu_never_touches_the_library(mode, slots, monkeypatch):
    """render_deferred and its backward on CPU tensors: the plain set-up,
    no launch, no library load, no ``diff.prim_kernel`` count."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load_library", refuse)
    params, static, cfg = check.train_scene(32, mode, subdiv=1,
                                            tile_logsize=4, tex_size=8,
                                            tex_tiles=2)
    params, static = check.to_device(params, static, "cpu")
    cuda_prim.reset_launch_count()
    tracing.reset_stages()
    loss, _, _ = check.step(params, static, cfg, slots=slots)
    assert bool(torch.isfinite(loss))
    assert cuda_prim.launch_count == 0
    assert "diff.prim_kernel" not in tracing.counter_report()
    assert all(bool(torch.isfinite(p.grad).all()) for p in params.values())


# ------------------------------------------------------- the wrapper ----

def _wrapper_inputs():
    V, P = 6, 4
    return {"pos": torch.zeros((V, 4)), "color": torch.zeros((V, 4)),
            "uv": torch.zeros((V, 2)),
            "indices": torch.zeros((P, 3), dtype=torch.int32),
            "grec": torch.zeros((P, 27))}


def _misaligned(a):
    flat = torch.zeros(a.numel() + 1)
    return flat[1:].view(a.shape)


BAD = {
    "pos_float64": ("pos", lambda a: a.double(), TypeError),
    "pos_width": ("pos", lambda a: a[:, :3].contiguous(), ValueError),
    "pos_1d": ("pos", lambda a: a.reshape(-1), ValueError),
    "pos_strided": ("pos", lambda a: a.t().contiguous().t(), ValueError),
    "pos_misaligned": ("pos", _misaligned, ValueError),
    "color_rows": ("color", lambda a: a[:5].contiguous(), ValueError),
    "color_float16": ("color", lambda a: a.half(), TypeError),
    "uv_width": ("uv", lambda a: torch.zeros((6, 3)), ValueError),
    "indices_int64": ("indices", lambda a: a.long(), TypeError),
    "indices_width": ("indices", lambda a: torch.zeros(
        (4, 4), dtype=torch.int32), ValueError),
    "indices_1d": ("indices", lambda a: a.reshape(-1), ValueError),
    "no_vertices": ("pos", lambda a: a[:0], ValueError),
    "grec_width": ("grec", lambda a: a[:, :20].contiguous(), ValueError),
    "grec_rows": ("grec", lambda a: a[:3].contiguous(), ValueError),
    "grec_float64": ("grec", lambda a: a.double(), TypeError),
    "grec_strided": ("grec", lambda a: a.t().contiguous().t(), ValueError),
    "device": (None, None, ValueError),
}
_FORWARD_ONLY = ("color", "uv")


@pytest.mark.parametrize("bad,which", [
    (bad, which) for bad in sorted(BAD) for which in ("forward", "backward")
    if not (which == "forward" and BAD[bad][0] == "grec")
    and not (which == "backward" and BAD[bad][0] in _FORWARD_ONLY)])
def test_wrapper_rejects(bad, which, monkeypatch):
    """A wrong dtype, shape, layout or alignment raises before any device
    check; CPU tensors of the right kind raise too (the kernels take CUDA
    tensors); the library is never loaded."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load_library", refuse)
    name, change, error = BAD[bad]
    a = _wrapper_inputs()
    if name == "pos" and bad == "no_vertices":
        a = {k: v[:0] if k in ("pos", "color", "uv") else v
             for k, v in a.items()}
    elif name is not None:
        a[name] = change(a[name])
    cuda_prim.reset_launch_count()
    with pytest.raises(error):
        if which == "forward":
            cuda_prim.prim_forward(a["pos"], a["color"], a["uv"],
                                   a["indices"], 64, 64, 0.0, 1.0)
        else:
            cuda_prim.prim_backward(a["pos"], a["indices"], a["grec"], 64, 64)
    assert cuda_prim.launch_count == 0


# --------------------------------------------------------------- card ----

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_kernels_on_card(size, textured, integer):
    """The forward's record, z and corner list bit for bit the plain
    set-up's on the card; the backward bit for bit its twin and twice
    alike; two launches a forward and backward; the Function's gradients
    against autograd's through the plain set-up."""
    dev = _need_card()
    cfg = _cfg(textured, width=1024, height=768, near=0.25, far=3.0)
    params, indices, grad = _inputs(size, textured, integer, seed=11,
                                    device=dev)
    want_rec, want_z, want = _autograd(params, indices, grad, cfg)
    pos, color = params["pos"].detach(), params["color"].detach()
    uv = params["uv"].detach() if textured else None
    cuda_prim.reset_launch_count()
    rec, z, corner = cuda_prim.prim_forward(pos, color, uv, indices,
                                            cfg.width, cfg.height, cfg.near,
                                            cfg.far)
    rows = cuda_prim.prim_backward(pos, indices, grad, cfg.width, cfg.height)
    again = cuda_prim.prim_backward(pos, indices, grad, cfg.width,
                                    cfg.height)
    torch.cuda.synchronize()
    assert cuda_prim.launch_count == 3
    assert _same_bits(rec, want_rec)
    assert _same_bits(z, want_z)
    assert torch.equal(corner, torch.cat([indices[:, 0], indices[:, 1],
                                          indices[:, 2]]))
    twin = cuda_prim.prim_backward_reference(pos, indices, grad, cfg.width,
                                             cfg.height)
    for a, b, w in zip(rows, again, twin, strict=True):
        if w is None:
            assert a is None and b is None
            continue
        assert _same_bits(a, b)
        assert _same_bits(a, w)
    for p in params.values():
        p.grad = None
    setup = pipeline.prim_setup(params, indices, cfg)
    setup["rec"].backward(grad)
    for k in want:
        if integer:
            assert torch.equal(params[k].grad, want[k]), k
        assert _grad_close(params[k].grad, want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("mode,slots", [("hard", 1), ("hard", 2),
                                        ("alpha", 2), ("soft", 2)])
@pytest.mark.parametrize("scene", ["icosphere", "degenerate"])
def test_modes_on_card(scene, mode, slots, monkeypatch):
    """render_deferred and its backward through the kernels against the
    same with the plain set-up in their place: the image bit for bit, the
    gradients within GRAD_RTOL of their largest magnitude, two kernel
    backward passes alike, two launches a step."""
    dev = _need_card()
    if scene == "icosphere":
        params, static, cfg = check.train_scene(64, mode, subdiv=2,
                                                tile_logsize=4, tex_size=16,
                                                tex_tiles=4)
    else:
        params, static, cfg = check.random_triangles(n=30, seed=11,
                                                     degenerate=True)
        cfg = dataclasses.replace(
            cfg, alpha_blend=mode == "alpha",
            soft_edge_temp=0.7 if mode == "soft" else 0.0)
    params, static = check.to_device(params, static, dev)

    def run():
        for p in params.values():
            p.grad = None
        img, _ = pipeline.render_deferred(params, static, cfg, slots=slots)
        check.loss_of(img, cfg).backward()
        return img.detach(), {k: p.grad.clone() for k, p in params.items()
                              if p.grad is not None}

    cuda_prim.reset_launch_count()
    img, grads = run()
    img2, grads2 = run()
    torch.cuda.synchronize()
    assert cuda_prim.launch_count == 4
    assert _same_bits(img, img2)
    for k in grads:
        assert _same_bits(grads[k], grads2[k]), k
    monkeypatch.setattr(pipeline, "_prim_setup_kernel", pipeline._prim_setup)
    cuda_prim.reset_launch_count()
    plain_img, plain_grads = run()
    torch.cuda.synchronize()
    assert cuda_prim.launch_count == 0
    assert _same_bits(img, plain_img)
    assert set(grads) == set(plain_grads)
    for k in grads:
        assert _grad_close(grads[k], plain_grads[k]), k
