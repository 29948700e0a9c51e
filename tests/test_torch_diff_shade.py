"""The hard-mode one-slot shade: ``diff.cuda_shade`` (csrc/diff_shade.cu on
the card, through ``pipeline._ShadeHard``) and its plain versions.

On the CPU: the pinned-order per-tile slot reduction
(``cuda_shade.tile_rows_reference``) equals ``pipeline.gather_tile_rows``'
one-hot backward exactly on integer-valued rows and to float rounding on
random ones, and adds in ascending pixel order; the kernels' twins
(``shade_forward_reference``, ``shade_backward_reference``) equal the plain
loop ``pipeline.shade_loop`` bit for bit forward and autograd's gradients
of it to float rounding (rtol 1e-5 of each gradient's largest magnitude),
at every tile size, untextured, textured and modulated, with M = 4, M >= 200,
an empty tile and degenerate triangles; CPU tensors and every mode but the
hard one-slot one never touch the kernel library; the wrapper rejects a
wrong dtype, shape, width, tile size or device.

On the card (marker ``cuda``; no JAX in this file): both kernels against
their twins bit for bit and twice alike, and the kernel path against the
plain loop on the card: the image bit for bit, the four parameter gradients
within 1e-4 of each one's largest magnitude, two backward passes alike:
  python -m pytest --noconftest -m cuda tests/test_torch_diff_shade.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from skybox_rt_tpu_torch import _build
from skybox_rt_tpu_torch.diff import check, cuda_shade, pipeline
from skybox_rt_tpu_torch.utils import tracing

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

#: (textured, modulate); modulate does nothing untextured
FORMS = {"plain": (False, False), "plain_modulate": (False, True),
         "textured": (True, False), "modulated": (True, True)}
#: (scene, tile_logsize, image size): the icosphere at every tile size, a
#: handful of triangles (M = 4), a few hundred over one tile (M >= 200),
#: degenerate triangles
CASES = {
    "icosphere_3": ("icosphere", 3, 64),
    "icosphere_4": ("icosphere", 4, 64),
    "icosphere_5": ("icosphere", 5, 64),
    "icosphere_6": ("icosphere", 6, 64),
    "m4": ("few", 4, 64),
    "m200": ("many", 5, 32),
    "degenerate": ("degenerate", 4, 64),
}
GRAD_RTOL = 1e-5         # the twins against autograd, on the CPU
CARD_GRAD_RTOL = 1e-4    # the kernel path against the plain loop


def _scene(case, form, device="cpu", empty_tile=True):
    """(params, static, cfg) on ``device``; ``empty_tile`` appends a tile of
    padding alone to the bins, at the first tile's place (for the shade
    alone: the assembly of a whole image takes each place once)."""
    kind, tls, size = CASES[case]
    textured, modulate = FORMS[form]
    if kind == "icosphere":
        params, static, cfg = check.train_scene(size, subdiv=2,
                                                tile_logsize=tls, tex_size=16,
                                                tex_tiles=4)
    else:
        n, seed = {"few": (4, 1), "many": (240, 5), "degenerate": (30, 11)}[
            kind]
        params, static, cfg = check.random_triangles(
            n=n, seed=seed, size=size, tile_logsize=tls,
            degenerate=kind == "degenerate")
        rng = np.random.default_rng(seed)
        params["tex"] = rng.uniform(0.0, 1.0, (16, 8, 4)).astype(np.float32)
    cfg = dataclasses.replace(cfg, textured=textured, modulate=modulate,
                              background=(0.25, 0.5, 0.75, 1.0))
    if not textured:        # no gradient reaches uv or tex
        params = {k: v for k, v in params.items() if k in ("pos", "color")}
    if empty_tile:
        M = static["tile_pids"].shape[1]
        static = dict(static)
        static["tile_pids"] = np.concatenate(
            [static["tile_pids"], np.full((1, M), -1, np.int32)])
        static["tile_xy"] = np.concatenate(
            [static["tile_xy"], static["tile_xy"][:1]])
    params, static = check.to_device(params, static, device)
    return params, static, cfg


def _tiles(params, static, cfg):
    """The shade's inputs: the packed records rec (P, C), the tiles' copy of
    them rec_tile (T, M, C) and the quad table, each a leaf that requires
    grad; the tile lists, the one-slot steps (T, ts, ts) and the origins."""
    setup = pipeline.prim_setup(params, static["indices"], cfg)
    origins = pipeline._origins(static, cfg).to(torch.int32)
    steps, _ = pipeline.visibility_slots(setup, static["tile_pids"], origins,
                                         cfg)
    P = setup["edges"].shape[0]
    parts = [setup["edges"].reshape(P, 9), setup["color"].reshape(P, 12)]
    tex_quad = None
    if cfg.textured:
        parts.append(setup["uv"].reshape(P, 6))
        tex_quad = pipeline._quad_texture(params["tex"]).detach() \
            .requires_grad_(True)
    rec = torch.cat(parts, 1).detach().requires_grad_(True)
    pids = static["tile_pids"]
    rec_tile = rec.detach()[pids.clamp(min=0).long()].requires_grad_(True)
    return (rec, rec_tile, tex_quad, pids, steps[..., 0].contiguous(),
            origins)


def _same_bits(got, want):
    return got.dtype == want.dtype and got.shape == want.shape and \
        torch.equal(got.view(torch.int32), want.view(torch.int32))


def _grad_close(got, want, rtol):
    scale = float(want.abs().max())
    return float((got - want).abs().max()) <= rtol * max(scale, 1e-30)


# ------------------------------------------------------- the reduction ----

def _onehot_backward(rows, steps, M):
    """gather_tile_rows' backward (the one-hot product) for upstream rows."""
    T, C = rows.shape[0], rows.shape[-1]
    table = torch.zeros((T, M, C), requires_grad=True)
    out = pipeline.gather_tile_rows(table, steps.clamp(min=0))
    live = (steps >= 0)[..., None]
    (out * torch.where(live, rows, 0.0)).sum().backward()
    return table.grad


@pytest.mark.parametrize("T,n,M,C", [(3, 64, 4, 21), (5, 256, 57, 27),
                                     (2, 1024, 230, 27), (4, 4096, 9, 21)])
def test_tile_rows_twin_equals_onehot_on_integers(T, n, M, C):
    rng = np.random.default_rng(n + M)
    steps = torch.from_numpy(rng.integers(-1, M, (T, n)).astype(np.int32))
    steps[0, :] = -1                                  # an empty tile
    rows = torch.from_numpy(rng.integers(-64, 65, (T, n, C)).astype(
        np.float32))
    got = cuda_shade.tile_rows_reference(steps, rows, M)
    assert got.shape == (T, M, C) and got.dtype == torch.float32
    assert torch.equal(got, _onehot_backward(rows, steps, M))
    assert not bool(got[0].any())


@pytest.mark.parametrize("T,n,M", [(3, 64, 4), (2, 1024, 230)])
def test_tile_rows_twin_matches_onehot_on_random_rows(T, n, M):
    rng = np.random.default_rng(T * n)
    steps = torch.from_numpy(rng.integers(-1, M, (T, n)).astype(np.int32))
    rows = torch.from_numpy(rng.normal(size=(T, n, 27)).astype(np.float32))
    got = cuda_shade.tile_rows_reference(steps, rows, M)
    want = _onehot_backward(rows, steps, M)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    exact = torch.zeros((T * M, 27), dtype=torch.float64)
    keep = (steps >= 0).reshape(-1)
    key = (torch.arange(T)[:, None] * M + steps).reshape(-1)[keep]
    exact.index_add_(0, key, rows.reshape(-1, 27)[keep].double())
    torch.testing.assert_close(got.double(), exact.reshape(T, M, 27),
                               rtol=1e-5, atol=1e-5)


def test_tile_rows_twin_adds_in_ascending_pixel_order():
    """In float32, 1e8 + 1 is 1e8: the sum of 1e8, -1e8 and 1 is 1 when 1
    comes last and 0 when it meets 1e8 first.  The slot's values lie at
    pixels 0, 2 and 4 among other slots' and a dropped step's."""
    steps = torch.tensor([[2, 0, 2, 5, 2, -1, 1]], dtype=torch.int32)

    def slot2(a, b, c):
        rows = torch.tensor([a, 7.0, b, 3.0, c, 9.0, 5.0])[None, :, None]
        got = cuda_shade.tile_rows_reference(steps, rows, 4)
        assert got[0, :, 0].tolist()[:2] == [7.0, 5.0]
        assert float(got[0, 3, 0]) == 0.0
        return float(got[0, 2, 0])

    assert slot2(1e8, -1e8, 1.0) == 1.0
    assert slot2(1e8, 1.0, -1e8) == 0.0
    assert slot2(1.0, 1e8, -1e8) == 0.0


# ------------------------------------------------ the twins on the CPU ----

@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_twins_match_plain_loop(case, form):
    params, static, cfg = _scene(case, form)
    rec, rec_tile, tex_quad, pids, steps, origins = _tiles(params, static,
                                                          cfg)
    T, M, _ = rec_tile.shape
    if case == "m4":
        assert M == 4
    if case == "m200":
        assert M >= 200
    assert not bool((steps[-1] >= 0).any())           # the empty tile
    img = pipeline.shade_loop(rec_tile, tex_quad, steps[..., None], origins,
                              cfg)
    g = torch.from_numpy(np.random.default_rng(T).normal(
        size=tuple(img.shape)).astype(np.float32))
    img.backward(g)
    tq = None if tex_quad is None else tex_quad.detach()
    fwd = cuda_shade.shade_forward_reference(
        rec.detach(), tq, pids, steps, origins, cfg.tile_logsize,
        cfg.modulate, cfg.background)
    assert _same_bits(fwd, img.detach())
    grec, rows, anchor = cuda_shade.shade_backward_reference(
        rec.detach(), tq, pids, steps, origins, g, cfg.tile_logsize,
        cfg.modulate)
    assert grec.shape == rec_tile.shape
    assert _grad_close(grec, rec_tile.grad, GRAD_RTOL)
    assert not bool(grec[-1].any())                   # the empty tile
    if tex_quad is None:
        assert rows is None and anchor is None
        return
    th, tw = tex_quad.shape[:2]
    assert rows.shape == (steps.numel(), 16) and anchor.dtype == torch.int32
    dead = (steps < 0).reshape(-1)
    assert bool((anchor[dead] == -1).all()) and not bool(rows[dead].any())
    assert bool(((anchor[~dead] >= 0) & (anchor[~dead] < th * tw)).all())
    dtq = pipeline._accumulate_rows(anchor, rows, th * tw).reshape(
        tex_quad.shape)
    assert _grad_close(dtq, tex_quad.grad, GRAD_RTOL)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_shade_function_with_twins_in_the_kernels_place(form, monkeypatch):
    """pipeline._ShadeHard's plumbing on the CPU, the twins standing in for
    the kernels: the loop's image, and its gradients to rec and to the
    quad table (through _accumulate_rows) to float rounding."""
    monkeypatch.setattr(cuda_shade, "shade_forward",
                        cuda_shade.shade_forward_reference)
    monkeypatch.setattr(cuda_shade, "shade_backward",
                        cuda_shade.shade_backward_reference)
    params, static, cfg = _scene("icosphere_4", form)
    rec, _, tex_quad, pids, steps, origins = _tiles(params, static, cfg)
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(*steps.shape, 4)).astype(np.float32))
    img = pipeline._ShadeHard.apply(rec, tex_quad, pids, steps, origins, cfg)
    img.backward(g)
    got = [rec.grad] + ([] if tex_quad is None else [tex_quad.grad])
    rec.grad = None
    if tex_quad is not None:
        tex_quad.grad = None
    want_img = pipeline.shade_loop(pipeline.gather_rows(rec, pids), tex_quad,
                                   steps[..., None], origins, cfg)
    want_img.backward(g)
    want = [rec.grad] + ([] if tex_quad is None else [tex_quad.grad])
    assert _same_bits(img.detach(), want_img.detach())
    for a, b in zip(got, want, strict=True):
        assert _grad_close(a, b, GRAD_RTOL)


@pytest.mark.parametrize("mode,slots", [("hard", 1), ("hard", 2),
                                        ("alpha", 2), ("soft", 2)])
def test_cpu_and_other_modes_never_touch_the_library(mode, slots,
                                                     monkeypatch):
    """render_deferred and its backward on CPU tensors: the plain loop, no
    launch, no library load, no ``diff.shade_kernel`` count."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load_library", refuse)
    params, static, cfg = check.train_scene(32, mode, subdiv=1,
                                            tile_logsize=4, tex_size=8,
                                            tex_tiles=2)
    params, static = check.to_device(params, static, "cpu")
    cuda_shade.reset_launch_count()
    tracing.reset_stages()
    loss, _, _ = check.step(params, static, cfg, slots=slots)
    assert bool(torch.isfinite(loss))
    assert cuda_shade.launch_count == 0
    assert "diff.shade_kernel" not in tracing.counter_report()
    assert all(bool(torch.isfinite(p.grad).all()) for p in params.values())


def _wrapper_inputs():
    T, M, ts = 3, 8, 8
    return {"rec": torch.zeros((10, 27)),
            "tex_quad": torch.zeros((4, 4, 4, 4)),
            "tile_pids": torch.zeros((T, M), dtype=torch.int32),
            "steps": torch.zeros((T, ts, ts), dtype=torch.int32),
            "origins": torch.zeros((T, 2), dtype=torch.int32),
            "grad": torch.zeros((T, ts, ts, 4))}


BAD = {
    "rec_float64": ("rec", lambda a: a.double(), TypeError),
    "rec_width": ("rec", lambda a: a[..., :21].contiguous(), ValueError),
    "rec_3d": ("rec", lambda a: a[None], ValueError),
    "rec_strided": ("rec", lambda a: a.t().contiguous().t(), ValueError),
    "tile_pids_int64": ("tile_pids", lambda a: a.long(), TypeError),
    "tile_pids_1d": ("tile_pids", lambda a: a.reshape(-1), ValueError),
    "tile_pids_tiles": ("tile_pids", lambda a: a[:2].contiguous(),
                        ValueError),
    "tex_quad_shape": ("tex_quad", lambda a: a[..., :3].contiguous(),
                       ValueError),
    "steps_int64": ("steps", lambda a: a.long(), TypeError),
    "steps_shape": ("steps", lambda a: a[:, :4].contiguous(), ValueError),
    "origins_shape": ("origins", lambda a: a[:2].contiguous(), ValueError),
    "grad_shape": ("grad", lambda a: a[..., :3].contiguous(), ValueError),
    "grad_float16": ("grad", lambda a: a.half(), TypeError),
    "device": (None, None, ValueError),
    "tile_logsize": ("tile_logsize", None, ValueError),
}


@pytest.mark.parametrize("bad,which", [
    (bad, which) for bad in sorted(BAD) for which in ("forward", "backward")
    if not (which == "forward" and BAD[bad][0] == "grad")])
def test_wrapper_rejects(bad, which, monkeypatch):
    """A wrong dtype, shape or layout raises before any device check; CPU
    tensors of the right kind raise too (the kernels take CUDA tensors);
    the library is never loaded."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load_library", refuse)
    name, change, error = BAD[bad]
    a = _wrapper_inputs()
    tls = 3
    if name == "tile_logsize":
        tls = 2
    elif name is not None:
        a[name] = change(a[name])
    args = (a["rec"], a["tex_quad"], a["tile_pids"], a["steps"],
            a["origins"])
    cuda_shade.reset_launch_count()
    with pytest.raises(error):
        if which == "forward":
            cuda_shade.shade_forward(*args, tls, True, (0, 0, 0, 1))
        else:
            cuda_shade.shade_backward(*args, a["grad"], tls, True)
    assert cuda_shade.launch_count == 0


def test_wrapper_rejects_a_missing_texture_for_a_textured_record(
        monkeypatch):
    monkeypatch.setattr(_build, "load_library", lambda: None)
    a = _wrapper_inputs()
    with pytest.raises(ValueError):
        cuda_shade.shade_forward(a["rec"], None, a["tile_pids"], a["steps"],
                                 a["origins"], 3, True, (0, 0, 0, 1))


# --------------------------------------------------------------- card ----

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_twins_on_card(case, form):
    """Forward and backward against their twins bit for bit; two launches
    of each alike; two launches a forward and backward."""
    dev = _need_card()
    params, static, cfg = _scene(case, form, dev)
    rec, _, tex_quad, pids, steps, origins = _tiles(params, static, cfg)
    tq = None if tex_quad is None else tex_quad.detach()
    args = (rec.detach(), tq, pids, steps, origins)
    g = torch.randn((*steps.shape, 4), device=dev,
                    generator=torch.Generator(dev).manual_seed(3))
    cuda_shade.reset_launch_count()
    img = cuda_shade.shade_forward(*args, cfg.tile_logsize, cfg.modulate,
                                   cfg.background)
    got = cuda_shade.shade_backward(*args, g, cfg.tile_logsize, cfg.modulate)
    again = cuda_shade.shade_backward(*args, g, cfg.tile_logsize,
                                      cfg.modulate)
    torch.cuda.synchronize()
    assert cuda_shade.launch_count == 3
    assert _same_bits(img, cuda_shade.shade_forward_reference(
        *args, cfg.tile_logsize, cfg.modulate, cfg.background))
    want = cuda_shade.shade_backward_reference(*args, g, cfg.tile_logsize,
                                               cfg.modulate)
    for a, b, w in zip(got, again, want):
        if w is None:
            assert a is None and b is None
            continue
        assert _same_bits(a, b)
        assert _same_bits(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("case", ["icosphere_3", "icosphere_5", "icosphere_6",
                                  "m4", "m200", "degenerate"])
def test_kernel_path_matches_plain_loop_on_card(case, form, monkeypatch):
    """render_deferred and its backward on the card through the kernels
    against the same with the plain loop in the kernels' place: the image
    bit for bit, the four gradients within CARD_GRAD_RTOL of their largest
    magnitude, two kernel backward passes alike."""
    dev = _need_card()
    params, static, cfg = _scene(case, form, dev, empty_tile=False)

    def run():
        for p in params.values():
            p.grad = None
        img, _ = pipeline.render_deferred(params, static, cfg, slots=2)
        check.loss_of(img, cfg).backward()
        return img.detach(), {k: p.grad.clone() for k, p in params.items()}

    cuda_shade.reset_launch_count()
    img, grads = run()
    img2, grads2 = run()
    torch.cuda.synchronize()
    assert cuda_shade.launch_count == 4
    assert _same_bits(img, img2)
    for k in grads:
        assert _same_bits(grads[k], grads2[k]), k
    monkeypatch.setattr(
        pipeline._ShadeHard, "apply",
        lambda rec, tq, pids, s, o, c: pipeline.shade_loop(
            pipeline.gather_rows(rec, pids), tq, s[..., None], o, c))
    cuda_shade.reset_launch_count()
    plain_img, plain_grads = run()
    torch.cuda.synchronize()
    assert cuda_shade.launch_count == 0
    assert _same_bits(img, plain_img)
    for k in grads:
        assert _grad_close(grads[k], plain_grads[k], CARD_GRAD_RTOL), k
