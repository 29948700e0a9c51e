"""Plain differentiable rasterizer: the reference that the training cell's
image, loss and gradients are held to.

It renders the hard mode of a depth-tested, textured and modulated
triangle mesh from the benchmark's own inputs (clip-space vertex positions
``pos`` (V, 4), vertex colours (V, 4), texture coordinates (V, 2), a texture
(TH, TW, 4) and the faces), with these semantics:

  * a vertex lands at screen (X / W, Y / W) with X = (x + w) * width / 2,
    Y = (y + w) * height / 2, W = w (row 0 at the bottom), and its depth is
    z / w * (far - near) / 2 + (near + far) / 2;
  * a triangle's three edge functions are the cross products of its
    vertices' (X, Y, W), the one opposite vertex i from the other two,
    signed so that their sum at the triangle's own vertices is positive;
    a pixel is covered where all three are >= 0 at its centre;
  * barycentrics are the edge functions over their sum (the sum's size
    kept at least 1e-20), the depth, colour and texture coordinates their
    weighted sums;
  * of the triangles that cover a pixel with a depth below +inf, the one of
    least depth writes it, the lowest triangle index among equal depths
    (the order triangles are submitted in); a pixel no triangle writes is
    the background;
  * the texel is a bilinear sample with repeat wrapping (texel centres at
    half-integers), multiplied into the vertex colour.

The loss is the mean square difference of the image against the target
image over every pixel and channel; the gradients of the loss with respect
to the four parameters come from autograd.  As in the program, no gradient
flows through the choice of the winner (coverage is hard), only through the
winner's barycentrics, colours, coordinates and texels.

It imports nothing of the program and takes nothing the program made but
the parameters and the target, which are data.  Each pixel's winner is
found among every triangle: a triangle is tested at the pixels of its own
screen bounding box (one pixel wider on each side), and a triangle with a
vertex at w <= 0 at every pixel.  The winner search runs under no_grad and
the shading of the winners differentiably, both in ``dtype``: float64 for
the reference, bfloat16 for the control.

Departures from the program's expressions, not from its semantics: the
program samples an edge function at integer pixels with the half-pixel
offset folded into its constant, and lerps texels as a + f * (b - a); here
the pixel centre is x + 0.5 and the lerp a * (1 - f) + b * f.
"""
from __future__ import annotations

import torch

F64 = torch.float64
#: smallest size of the barycentrics' denominator
DENOM_MIN = 1e-20
#: (triangle, pixel) pairs a block of the winner search holds at most
PAIR_BLOCK = 1 << 22


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def screen_vertices(pos, width: int, height: int):
    """(V, 3) homogeneous screen coordinates (X, Y, W) of clip positions."""
    x = (pos[:, 0] + pos[:, 3]) * (width / 2)
    y = (pos[:, 1] + pos[:, 3]) * (height / 2)
    return torch.stack([x, y, pos[:, 3]], -1)


def edge_functions(hv, faces):
    """(F, 3, 3) edge functions [edge i][a, b, c] with value a X + b Y + c:
    edge i is the cross product of the other two vertices, signed by the
    triangle's determinant."""
    p = [hv[faces[:, k]] for k in range(3)]
    e = torch.stack([torch.linalg.cross(p[1], p[2]),
                     torch.linalg.cross(p[2], p[0]),
                     torch.linalg.cross(p[0], p[1])], 1)
    det = (e[:, 0] * p[0]).sum(-1)
    sign = torch.where(det < 0, -1.0, 1.0).to(e.dtype)
    return e * sign[:, None, None]


def _eval(e, x, y):
    """Edge values (..., 3) of e (..., 3, 3) at the points (x, y)."""
    return e[..., 0] * x[..., None] + e[..., 1] * y[..., None] + e[..., 2]


def _barycentrics(ev):
    s = ev.sum(-1, keepdim=True)
    s = torch.where(s.abs() > DENOM_MIN, s, DENOM_MIN)
    return ev / s


def _boxes(hv, faces, width, height):
    """Per triangle the inclusive pixel box [x0, x1] x [y0, y1] (int64,
    host) of the pixels whose centres its projection may cover."""
    v = hv.detach().to(F64)
    w = v[:, 2]
    sx, sy = v[:, 0] / w, v[:, 1] / w
    tri = faces.to(v.device)
    xs, ys = sx[tri], sy[tri]
    bad = ~(w[tri] > 0).all(1) | ~torch.isfinite(xs).all(1) \
        | ~torch.isfinite(ys).all(1)
    x0 = torch.floor(xs.amin(1) - 0.5) - 1
    x1 = torch.ceil(xs.amax(1) - 0.5) + 1
    y0 = torch.floor(ys.amin(1) - 0.5) - 1
    y1 = torch.ceil(ys.amax(1) - 0.5) + 1
    big = float(max(width, height))
    x0 = torch.where(bad, 0.0, x0.clamp(-1, big))
    y0 = torch.where(bad, 0.0, y0.clamp(-1, big))
    x1 = torch.where(bad, width - 1.0, x1.clamp(-1, big))
    y1 = torch.where(bad, height - 1.0, y1.clamp(-1, big))
    box = torch.stack([x0.clamp(min=0), x1.clamp(max=width - 1),
                       y0.clamp(min=0), y1.clamp(max=height - 1)], 1)
    return box.to(torch.int64).cpu()


def winners(edges, zv, faces, hv, width: int, height: int, offset=(0.0, 0.0)):
    """(H * W,) int64: each pixel's winning triangle, -1 for none.  ``edges``
    (F, 3, 3) and ``zv`` (V,) the vertex depths, both detached; a pixel is
    sampled at its centre moved by ``offset`` (pixels, at most one)."""
    dev = edges.device
    box = _boxes(hv, faces, width, height)
    bw = (box[:, 1] - box[:, 0] + 1).clamp(min=0)
    bh = (box[:, 3] - box[:, 2] + 1).clamp(min=0)
    order = torch.argsort(bw * bh, stable=True).tolist()
    bw, bh = bw.tolist(), bh.tolist()
    inf = float("inf")
    cands = []
    i = 0
    while i < len(order):
        # a block of triangles of like box size, padded to its largest box
        j, mw, mh = i, 0, 0
        while j < len(order):
            t = order[j]
            nw, nh = max(mw, bw[t]), max(mh, bh[t])
            if j > i and (j - i + 1) * nw * nh > PAIR_BLOCK:
                break
            mw, mh, j = nw, nh, j + 1
        tri = torch.tensor(order[i:j], dtype=torch.int64)
        i = j
        if mw == 0 or mh == 0:
            continue
        b = box[tri].to(dev)
        tri = tri.to(dev)
        dx = torch.arange(mw, device=dev)
        dy = torch.arange(mh, device=dev)
        px = (b[:, 0, None, None] + dx[None, None, :]).expand(-1, mh, -1)
        py = (b[:, 2, None, None] + dy[None, :, None]).expand(-1, -1, mw)
        valid = (px <= b[:, 1, None, None]) & (py <= b[:, 3, None, None])
        e = edges[tri][:, None, None]                   # (n, 1, 1, 3, 3)
        ev = _eval(e, px.to(edges.dtype) + (0.5 + offset[0]),
                   py.to(edges.dtype) + (0.5 + offset[1]))
        inside = valid & (ev >= 0).all(-1)
        bary = _barycentrics(ev)
        z = (bary * zv[faces[tri]][:, None, None, :]).sum(-1)
        # NaN and +inf never win
        ok = inside & (z < inf)
        pix = (py * width + px)[ok]
        zk = z[ok]
        tk = tri[:, None, None].expand(-1, mh, mw)[ok]
        cands.append((pix, zk, tk))
    pix = torch.cat([c[0] for c in cands]) if cands else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    zk = torch.cat([c[1] for c in cands]) if cands else \
        torch.zeros(0, dtype=edges.dtype, device=dev)
    tk = torch.cat([c[2] for c in cands]) if cands else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    # a bfloat16 depth is compared in float32, which holds it exactly
    key = zk if zk.dtype in (torch.float32, F64) else zk.float()
    best = torch.full((height * width,), inf, dtype=key.dtype, device=dev)
    best = best.scatter_reduce(0, pix, key, "amin")
    at_min = key == best[pix]
    big = torch.iinfo(torch.int64).max
    win = torch.full((height * width,), big, dtype=torch.int64, device=dev)
    win = win.scatter_reduce(0, pix[at_min], tk[at_min], "amin")
    return torch.where(win == big, -1, win)


def bilinear(tex, u, v):
    """Bilinear texel of (TH, TW, C) ``tex`` at (u, v), repeat wrapping."""
    th, tw = tex.shape[0], tex.shape[1]
    uu = torch.remainder(u, 1.0) * tw - 0.5
    vv = torch.remainder(v, 1.0) * th - 0.5
    x0, y0 = torch.floor(uu), torch.floor(vv)
    fx, fy = (uu - x0)[..., None], (vv - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), tw)
    y0i = torch.remainder(y0.to(torch.int64), th)
    x1i, y1i = torch.remainder(x0i + 1, tw), torch.remainder(y0i + 1, th)
    top = tex[y0i, x0i] * (1 - fx) + tex[y0i, x1i] * fx
    bottom = tex[y1i, x0i] * (1 - fx) + tex[y1i, x1i] * fx
    return top * (1 - fy) + bottom * fy


def render(params, faces, width: int, height: int, near=0.0, far=1.0,
           background=(0.0, 0.0, 0.0, 1.0), offset=(0.0, 0.0)):
    """(H, W, 4) image of ``params`` (tensors of one dtype that may require
    grad; ``faces`` (F, 3) int64): the hard mode's winners shaded
    differentiably.  ``offset`` moves every pixel's sample point from its
    centre (pixels, at most one)."""
    pos, color, uv, tex = (params[k] for k in ("pos", "color", "uv", "tex"))
    dt, dev = pos.dtype, pos.device
    hv = screen_vertices(pos, width, height)
    edges = edge_functions(hv, faces)
    zv = pos[:, 2] / pos[:, 3] * ((far - near) / 2) + (near + far) / 2
    with torch.no_grad():
        win = winners(edges.detach(), zv.detach(), faces, hv.detach(), width,
                      height, offset)
    live = torch.nonzero(win >= 0).squeeze(1)
    tri = win[live]
    px = (live % width).to(dt) + (0.5 + offset[0])
    py = torch.div(live, width, rounding_mode="floor").to(dt) \
        + (0.5 + offset[1])
    bary = _barycentrics(_eval(edges[tri], px, py))[..., None]  # (N, 3, 1)
    f = faces[tri]
    col = (color[f] * bary).sum(1)
    st = (uv[f] * bary).sum(1)
    col = col * bilinear(tex, st[:, 0], st[:, 1])
    img = torch.tensor(background, dtype=dt, device=dev).expand(
        height * width, 4)
    img = img.index_put((live,), col)
    return img.reshape(height, width, 4)


def fit_step(params, faces, target, width: int, height: int,
             dtype=F64, **render_kw):
    """The reference of one fit step from the parameters it started from:
    a dict of ``image`` (H, W, 4), ``loss`` (0-d) and ``grad_<name>`` for
    pos, color, uv and tex, all detached, in ``dtype``.  ``render_kw`` go to
    :func:`render`."""
    _no_tf32()
    leaves = {k: torch.as_tensor(v).detach().to(dtype).requires_grad_(True)
              for k, v in params.items()}
    faces = torch.as_tensor(faces, device=leaves["pos"].device).to(
        torch.int64)
    img = render(leaves, faces, width, height, **render_kw)
    tgt = torch.as_tensor(target, device=img.device).to(dtype)
    loss = torch.mean((img - tgt) ** 2)
    loss.backward()
    out = {"image": img.detach(), "loss": loss.detach()}
    out.update({"grad_" + k: v.grad for k, v in leaves.items()})
    return out
