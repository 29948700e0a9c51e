"""Plain exact-integer rasterizer: the reference that the draw3d frame of the
raster cell is held to, word for word.

It replays a captured trace (the ``.npz`` layout of a CGLTrace: per draw
the 22 render states, clip-space positions, vertex colours, texture
coordinates, triangles and the viewport's near and far; per texture its
format, size and bytes) in **immediate mode**: draw after draw, every
covered fragment of every triangle is shaded and merged into the colour
and depth-stencil buffers in submission order.  It is written from the
reference's semantics, which the Skybox sources define (the draw3d host,
``tests/regression/draw3d/main.cpp``; binning, ``sim/common/gfxutil.cpp``;
the rasterizer, sampler, depth-stencil test and blender,
``sim/common/graphics.cpp``; the output merger, ``sim/simx/om_unit.cpp``;
the pixel shader, ``tests/regression/draw3d/kernel.cpp``):

  * set-up, in float32 on the host (gfxutil.cpp:35-276): the viewport
    transform without the divide, three edge functions as cross products
    of the vertices' (x, y, w), all negated when their determinant is
    negative, none for a zero determinant; the half-pixel offset
    c += a/2 + b/2; the edges normalised by their largest |a| or |b| and
    cut to 16 fraction bits toward zero; each attribute (screen z, r, g,
    b, a, u, v) as (v0 - v2, v1 - v2, v2) cut to 24 fraction bits; the
    screen bounding box, floored and ceiled, clipped to the frame; a
    triangle with an empty box draws nothing;
  * coverage at integer pixel (x, y): every a x + b y + c, in wrapping
    32-bit arithmetic, >= 0, inside the scissor (the frame);
  * the shader (kernel.cpp:16-229): the edge values read as 24-bit fixed
    point, in float32 ``r = 1 / ((f0 + f1) + f2)``, ``dx = r f0``,
    ``dy = r f1`` cut to 24 fraction bits (x86: NaN or out of range gives
    -2**31); an attribute is ``((ax dx) >> 24 + az) + ((ay dy) >> 24)``
    in 32-bit words, each product exact in 64 bits; depth the
    interpolated z where the draw tests depth, else 0; colour the
    interpolated rgba, else 1.0; the texel at (u >> 1, v >> 1) (23
    fraction bits), modulated into the colour, or in its place; a
    channel is ``((c * k) >> 24) & 255`` with k = 255 or the texel's;
  * the sampler (graphics.cpp:36-314) at level 0: half a texel back and
    forth, wrapped (repeat: the low 23 bits; clamp), 8-bit weights,
    four texels, the two-channel lerp with its +0x00800080 rounding;
  * the output merger (graphics.cpp:320-636, om_unit.cpp:24-154): the
    stencil and depth compares on the 24-bit depth and 8-bit stencil of
    the word, the stencil ops, the masked depth-stencil write where the
    mask is not 0; the blender (mode ADD, the draw's factors, /255 with
    the +0x80 bias) where blending is on and the test passed; the masked
    colour write where the fragment passed;
  * the host's programming (main.cpp:171-390), quirks included: the
    stencil's zpass register gets the trace's zfail op and zfail stays
    KEEP; the filter follows the magnification filter; the v wrap follows
    addressU; depth and stencil are enabled unless their function is
    ALWAYS with nothing to write; texture-and-colour draws that do not
    modulate drop the colour.

Departures from the reference C++, none of which changes a word of this
frame: the rasterizer walks a triangle's bounding box, where the C++
walks its binned tiles whole (a pixel outside the box is never covered
while no edge value wraps, as none does at these sizes); each draw's
triangles are shaded at once and the output merger then folds each
pixel's fragments in submission order, one rank of fragments a step;
only the ARGB8888 texel format is decoded, the format this trace binds;
the face is always front, as the draw3d shader passes it.

``control=True`` computes the interpolation, the texel weights and the
blend in float32 instead of fixed point: the control that must fail the
cell's exact check.

It imports nothing of the program, reads the trace file itself, and runs
in int64 torch on any device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

F32 = np.float32
EDGE_ONE = 1 << 16               # TFixed<16>
ATTR_ONE = 1 << 24               # TFixed<24>
TEX_FRAC = 23                    # VX_TEX_FXD_FRAC
TEX_MASK = (1 << TEX_FRAC) - 1
DEPTH_MASK = (1 << 24) - 1
U32 = 0xFFFFFFFF
INT_MIN = -(1 << 31)
CLEAR_COLOR = 0xFF000000         # main.cpp:47
CLEAR_DEPTH = 0xFFFFFFFF         # main.cpp:48
#: the 22 render states of a draw, in the trace file's order
STATE_FIELDS = (
    "color_enabled", "color_writemask", "depth_test", "depth_writemask",
    "depth_func", "stencil_test", "stencil_func", "stencil_zpass",
    "stencil_zfail", "stencil_fail", "stencil_ref", "stencil_mask",
    "stencil_writemask", "texture_enabled", "texture_envmode",
    "texture_minfilter", "texture_magfilter", "texture_addressU",
    "texture_addressV", "blend_enabled", "blend_src", "blend_dst")
# the trace's enums (cocogfx CGLTrace)
COMPARE = ("never", "less", "equal", "lequal", "greater", "notequal",
           "gequal", "always")
STENCIL_OP = ("keep", "replace", "incr", "decr", "zero", "invert")
BLEND_FACTOR = ("zero", "one", "src_color", "one_minus_src_color",
                "src_alpha", "one_minus_src_alpha", "dst_alpha",
                "one_minus_dst_alpha", "dst_color", "one_minus_dst_color",
                "alpha_saturate")
ENVMODE_MODULATE = 3
FILTER_NEAREST = 1
ADDRESS_WRAP = 0
FORMAT_ARGB8888 = 5


@dataclasses.dataclass
class Draw:
    states: dict
    texture_id: int
    pos: np.ndarray         # (V, 4) float32 clip space
    color: np.ndarray       # (V, 4) float32
    texcoord: np.ndarray    # (V, 2) float32
    indices: np.ndarray     # (P, 3)
    near: float
    far: float


@dataclasses.dataclass
class Texture:
    format: int
    width: int
    height: int
    pixels: np.ndarray      # uint8 bytes of level 0


def load(path: str):
    """(draws, textures by id) of a trace file in the ``.npz`` layout."""
    with np.load(path, allow_pickle=False) as z:
        draws = []
        for i in range(int(z["num_drawcalls"])):
            p = f"dc{i}_"
            near, far = (float(v) for v in z[p + "nearfar"])
            draws.append(Draw(
                states=dict(zip(STATE_FIELDS,
                                (int(v) for v in z[p + "states"]))),
                texture_id=int(z[p + "meta"][0]),
                pos=z[p + "pos"].astype(F32), color=z[p + "color"].astype(F32),
                texcoord=z[p + "texcoord"].astype(F32),
                indices=z[p + "indices"].astype(np.int64), near=near,
                far=far))
        textures = {}
        for tid in z["texture_ids"]:
            fmt, w, h = (int(v) for v in z[f"tex{int(tid)}_meta"])
            textures[int(tid)] = Texture(fmt, w, h,
                                         z[f"tex{int(tid)}_pixels"].copy())
    return draws, textures


# ---------------------------------------------------------------- set-up


def _fixed(x, one):
    """float32 -> fixed point, cut toward zero, the low 32 bits kept."""
    v = np.trunc(np.asarray(x, F32) * F32(one)).astype(np.int64)
    return ((v + (1 << 31)) & U32) - (1 << 31)


def setup(draw: Draw, width: int, height: int) -> dict | None:
    """The triangles of ``draw`` that can cover a pixel: int64 ``edges``
    (P, 3, 3) [edge][a, b, c] with 16 fraction bits, ``attribs`` (P, 7, 3)
    [z r g b a u v][x, y, c] with 24, and the bounding boxes ``box`` (P, 4)
    (left, top, right, bottom), in submission order; None for none."""
    pos = draw.pos
    idx = draw.indices
    hw, hh = F32(0.5) * F32(width), F32(0.5) * F32(height)
    hd = F32(0.5) * (F32(draw.far) - F32(draw.near))
    near = F32(draw.near)
    v = [pos[idx[:, k]] for k in range(3)]
    # 2D homogeneous device coordinates: the viewport without the divide
    h = [(p[:, 0] * hw + p[:, 3] * hw, p[:, 1] * hh + p[:, 3] * hh, p[:, 3])
         for p in v]
    (x0, y0, w0), (x1, y1, w1), (x2, y2, w2) = h
    a = [y1 * w2 - y2 * w1, y2 * w0 - y0 * w2, y0 * w1 - y1 * w0]
    b = [x2 * w1 - x1 * w2, x0 * w2 - x2 * w0, x1 * w0 - x0 * w1]
    c = [x1 * y2 - x2 * y1, x2 * y0 - x0 * y2, x0 * y1 - x1 * y0]
    det = (c[0] * w0 + c[1] * w1) + c[2] * w2
    sign = np.where(det < 0, F32(-1.0), F32(1.0))
    a, b, c = ([e * sign for e in row] for row in (a, b, c))
    # the screen: the divide applied
    scr = []
    for p in v:
        rhw = F32(1.0) / p[:, 3]
        scr.append((p[:, 0] * rhw * hw + hw, p[:, 1] * rhw * hh + hh,
                    p[:, 2] * rhw * hd + (near + hd)))
    xs = np.stack([s[0] for s in scr], -1)
    ys = np.stack([s[1] for s in scr], -1)
    left = np.maximum(np.floor(xs.min(-1)).astype(np.int64), 0)
    right = np.minimum(np.ceil(xs.max(-1)).astype(np.int64), width)
    top = np.maximum(np.floor(ys.min(-1)).astype(np.int64), 0)
    bottom = np.minimum(np.ceil(ys.max(-1)).astype(np.int64), height)
    keep = (det != 0) & (right > left) & (bottom > top)
    if not keep.any():
        return None
    c = [ck + (ak * F32(0.5) + bk * F32(0.5)) for ak, bk, ck in zip(a, b, c)]
    e = np.stack([np.stack([a[k], b[k], c[k]], -1) for k in range(3)], 1)
    e = e[keep]
    scale = F32(1.0) / np.abs(e[:, :, :2]).reshape(len(e), -1).max(1)
    edges = _fixed(e * scale[:, None, None], EDGE_ONE)

    col = [draw.color[idx[keep, k]] for k in range(3)]
    tex = [draw.texcoord[idx[keep, k]] for k in range(3)]
    planes = [[s[2][keep] for s in scr]]
    planes += [[cv[:, ch] for cv in col] for ch in range(4)]
    planes += [[tv[:, ch] for tv in tex] for ch in range(2)]
    attribs = np.stack([_fixed(np.stack([p0 - p2, p1 - p2, p2], -1),
                               ATTR_ONE) for p0, p1, p2 in planes], 1)
    box = np.stack([left, top, right, bottom], -1)[keep]
    return {"edges": edges, "attribs": attribs, "box": box}


# ---------------------------------------------------------------- state


def draw_state(draw: Draw, textures: dict) -> dict:
    """The draw's state as the draw3d host programs it."""
    s = draw.states
    depth_func = COMPARE[s["depth_func"]] if s["depth_test"] else "always"
    depth_write = bool(s["depth_test"] and s["depth_writemask"] & 1)
    if s["stencil_test"]:
        stencil = {"func": COMPARE[s["stencil_func"]],
                   # main.cpp writes the zfail op into the zpass register
                   # twice and never writes zfail
                   "zpass": STENCIL_OP[s["stencil_zfail"]], "zfail": "keep",
                   "fail": STENCIL_OP[s["stencil_fail"]],
                   "ref": s["stencil_ref"] & 0xFFFF,
                   "mask": s["stencil_mask"] & 0xFFFF,
                   "writemask": s["stencil_writemask"] & 0xFFFF}
    else:
        stencil = {"func": "always", "zpass": "keep", "zfail": "keep",
                   "fail": "keep", "ref": 0, "mask": 0xFF, "writemask": 0}
    stencil_on = not (stencil["func"] == "always" and stencil["zpass"] ==
                      "keep" and stencil["zfail"] == "keep")
    tex_on = bool(s["texture_enabled"])
    modulate = tex_on and s["texture_envmode"] == ENVMODE_MODULATE
    color_on = bool(s["color_enabled"])
    if modulate and not color_on:
        modulate = False
    if tex_on and color_on and not modulate:
        color_on = False
    wmask = s["color_writemask"] & 0xF
    out = {
        "shade_depth": bool(s["depth_test"]), "color_on": color_on,
        "tex_on": tex_on, "modulate": modulate,
        "depth_func": depth_func, "depth_write": depth_write,
        "depth_on": not (depth_func == "always" and not depth_write),
        "stencil": stencil, "stencil_on": stencil_on,
        "blend": ((BLEND_FACTOR[s["blend_src"]], BLEND_FACTOR[s["blend_dst"]])
                  if s["blend_enabled"] else None),
        "color_mask": sum(0xFF << (8 * i) for i in range(4)
                          if wmask >> i & 1),
    }
    if tex_on:
        t = textures[draw.texture_id]
        if t.format != FORMAT_ARGB8888:
            raise ValueError(f"texture format {t.format}: the reference "
                             "decodes ARGB8888 alone")
        out["texture"] = {
            "texels": t.pixels[:t.width * t.height * 4].view("<u4"),
            "log_w": max(int(np.ceil(np.log2(t.width))), 0),
            "log_h": max(int(np.ceil(np.log2(t.height))), 0),
            "bilinear": s["texture_magfilter"] != FILTER_NEAREST,
            # the v wrap follows addressU (main.cpp:308)
            "repeat": s["texture_addressU"] == ADDRESS_WRAP}
    return out


# ---------------------------------------------------------------- shader


def _w32(x):
    """int64 -> the signed 32-bit value of its low 32 bits, as int64."""
    return ((x + (1 << 31)) & U32) - (1 << 31)


def _gradients(ev):
    """(dx, dy) in 24-bit fixed point from the three int64 edge values."""
    f = [e.to(torch.float32) * (2.0 ** -24) for e in ev]
    r = torch.ones_like(f[0]) / ((f[0] + f[1]) + f[2])
    out = []
    for fk in (f[0], f[1]):
        t = torch.trunc((r * fk) * float(ATTR_ONE))
        bad = torch.isnan(t) | (t >= 2.0 ** 31) | (t < -(2.0 ** 31))
        out.append(torch.where(bad, float(INT_MIN), t).to(torch.int64))
    return out


def _interpolate(plane, dx, dy, control):
    ax, ay, az = plane[:, 0], plane[:, 1], plane[:, 2]
    if control:
        one = float(ATTR_ONE)
        v = (ax.to(torch.float32) * dx.to(torch.float32) / one
             + az.to(torch.float32)) \
            + ay.to(torch.float32) * dy.to(torch.float32) / one
        return _w32(torch.trunc(v).to(torch.int64))
    return _w32(_w32(_w32((ax * dx) >> 24) + az) + _w32((ay * dy) >> 24))


def _chan(c, k):
    return (_w32(c * k) >> 24) & 0xFF


def _wrap(t, repeat):
    return (t if repeat else t.clamp(0, TEX_MASK)) & TEX_MASK


def _sample(tex, texels, u, v, control):
    """ARGB texel words (int64) at fixed-point (u, v), level 0."""
    lw, lh = tex["log_w"], tex["log_h"]
    if not tex["bilinear"]:
        x = _wrap(u, tex["repeat"]) >> (TEX_FRAC - lw)
        y = _wrap(v, tex["repeat"]) >> (TEX_FRAC - lh)
        return texels[x + (y << lw)]
    du, dv = (1 << (TEX_FRAC - 1)) >> lw, (1 << (TEX_FRAC - 1)) >> lh
    u0, u1 = (_wrap(_w32(u + d), tex["repeat"]) for d in (-du, du))
    v0, v1 = (_wrap(_w32(v + d), tex["repeat"]) for d in (-dv, dv))
    xs, ys = (u0 << 8) >> (TEX_FRAC - lw), (v0 << 8) >> (TEX_FRAC - lh)
    x0, y0 = xs >> 8, ys >> 8
    x1, y1 = u1 >> (TEX_FRAC - lw), v1 >> (TEX_FRAC - lh)
    fa, fb = xs & 0xFF, ys & 0xFF
    t00, t01 = texels[x0 + (y0 << lw)], texels[x1 + (y0 << lw)]
    t10, t11 = texels[x0 + (y1 << lw)], texels[x1 + (y1 << lw)]
    if control:
        out = 0
        for sh in (0, 8, 16, 24):
            c = [((t >> sh) & 0xFF).to(torch.float32)
                 for t in (t00, t01, t10, t11)]
            wa, wb = fa.to(torch.float32) / 255, fb.to(torch.float32) / 255
            top = c[0] + (c[1] - c[0]) * wa
            bot = c[2] + (c[3] - c[2]) * wa
            val = torch.round(top + (bot - top) * wb).to(torch.int64)
            out = out | (val.clamp(0, 255) << sh)
        return out

    def split(t):                # (r << 16) | b and (a << 16) | g
        return t & 0x00FF00FF, (t >> 8) & 0x00FF00FF

    def lerp(p, q, f):
        s = (p * (0xFF - f) + q * f + 0x00800080) & U32
        return ((s + ((s >> 8) & 0x00FF00FF)) & U32) >> 8 & 0x00FF00FF

    (l00, h00), (l01, h01) = split(t00), split(t01)
    (l10, h10), (l11, h11) = split(t10), split(t11)
    lo = lerp(lerp(l00, l01, fa), lerp(l10, l11, fa), fb)
    hi = lerp(lerp(h00, h01, fa), lerp(h10, h11, fa), fb)
    return (hi << 8) | lo


def shade(st, fr_pid, ev, setup_, texels, control):
    """(colour words, depth values) of the fragments."""
    dx, dy = _gradients(ev)
    at = setup_["attribs"][fr_pid]                     # (N, 7, 3)
    interp = [_interpolate(at[:, k], dx, dy, control) for k in range(7)]
    z = interp[0] if st["shade_depth"] else torch.zeros_like(dx)
    rgba = interp[1:5] if st["color_on"] else [torch.full_like(dx, ATTR_ONE)
                                               ] * 4
    r, g, b, a = rgba
    if st["tex_on"]:
        t = _sample(st["texture"], texels, interp[5] >> 1, interp[6] >> 1,
                    control)
        if not st["modulate"]:
            return t, z
        k = [(t >> sh) & 0xFF for sh in (24, 16, 8, 0)]
    else:
        k = [255] * 4
    return ((_chan(a, k[0]) << 24) | (_chan(r, k[1]) << 16)
            | (_chan(g, k[2]) << 8) | _chan(b, k[3])), z


# ---------------------------------------------------------------- merger


def _compare(func, a, b):
    return {"never": lambda: torch.zeros_like(a, dtype=torch.bool),
            "less": lambda: a < b, "equal": lambda: a == b,
            "lequal": lambda: a <= b, "greater": lambda: a > b,
            "notequal": lambda: a != b, "gequal": lambda: a >= b,
            "always": lambda: torch.ones_like(a, dtype=torch.bool)}[func]()


def _stencil_op(op, ref, val):
    return {"keep": lambda: val, "zero": lambda: torch.zeros_like(val),
            "replace": lambda: torch.full_like(val, ref),
            "incr": lambda: torch.where(val < 0xFF, val + 1, val),
            "decr": lambda: torch.where(val > 0, val - 1, val),
            "invert": lambda: val ^ U32}[op]()


def _factor(name, src, dst):
    """One blend factor's (a, r, g, b) channels (graphics.cpp:405-475)."""
    sa, da = src[0], dst[0]
    full = torch.full_like(sa, 0xFF)
    if name == "zero":
        return [full * 0] * 4
    if name == "one":
        return [full] * 4
    if name == "src_color":
        return list(src)
    if name == "one_minus_src_color":
        return [0xFF - s for s in src]
    if name == "src_alpha":
        return [sa] * 4
    if name == "one_minus_src_alpha":
        return [0xFF - sa] * 4
    if name == "dst_alpha":
        return [da] * 4
    if name == "one_minus_dst_alpha":
        return [0xFF - da] * 4
    if name == "dst_color":
        return list(dst)
    if name == "one_minus_dst_color":
        return [0xFF - d for d in dst]
    f = torch.minimum(sa, 0xFF - da)            # alpha_saturate
    return [full, f, f, f]


def _blend(factors, src, dst, control):
    sc = [(src >> sh) & 0xFF for sh in (24, 16, 8, 0)]
    dc = [(dst >> sh) & 0xFF for sh in (24, 16, 8, 0)]
    fs, fd = _factor(factors[0], sc, dc), _factor(factors[1], sc, dc)
    out = 0
    for i, sh in enumerate((24, 16, 8, 0)):
        if control:
            v = (sc[i].to(torch.float32) * fs[i].to(torch.float32)
                 + dc[i].to(torch.float32) * fd[i].to(torch.float32)) / 255
            ch = torch.round(v).clamp(0, 255).to(torch.int64)
        else:
            v = torch.clamp(sc[i] * fs[i] + dc[i] * fd[i] + 0x80, max=0xFF00)
            ch = (v + (v >> 8)) >> 8
        out = out | (ch << sh)
    return out


def merge(st, color, z, dst_c, dst_d, control):
    """One fragment a pixel through the output merger: (colour, ds)."""
    passed = torch.ones_like(dst_d, dtype=torch.bool)
    ds_mask = torch.zeros_like(dst_d)
    result = dst_d
    if st["depth_on"] or st["stencil_on"]:
        s = st["stencil"]
        depth_ref = z & DEPTH_MASK
        stencil_val = dst_d >> 24
        s_pass = _compare(s["func"], torch.full_like(stencil_val,
                                                     s["ref"] & s["mask"]),
                          stencil_val & s["mask"])
        d_pass = _compare(st["depth_func"], depth_ref, dst_d & DEPTH_MASK)
        passed = s_pass & d_pass
        s_res = torch.where(s_pass, torch.where(
            d_pass, _stencil_op(s["zpass"], s["ref"], stencil_val),
            _stencil_op(s["zfail"], s["ref"], stencil_val)),
            _stencil_op(s["fail"], s["ref"], stencil_val))
        result = ((s_res << 24) | depth_ref) & U32
        if st["depth_on"] and st["depth_write"]:
            ds_mask = torch.where(passed, DEPTH_MASK, 0)
        if st["stencil_on"]:
            ds_mask = ds_mask | ((s["writemask"] & 0xFF) << 24)
    new_d = (dst_d & ~ds_mask & U32) | (result & ds_mask)
    if st["blend"] is not None:
        color = torch.where(passed, _blend(st["blend"], color, dst_c,
                                           control), color)
    m = st["color_mask"]
    new_c = torch.where(passed, (dst_c & ~m & U32) | (color & m), dst_c) \
        if m else dst_c
    return new_c, new_d


# ---------------------------------------------------------------- frame


def _fragments(box, device):
    """(triangle, x, y) of every pixel of every box, in triangle order, then
    row-major."""
    b = torch.as_tensor(box, device=device)
    w = b[:, 2] - b[:, 0]
    n = w * (b[:, 3] - b[:, 1])
    tri = torch.repeat_interleave(torch.arange(len(b), device=device), n)
    k = torch.arange(int(n.sum()), device=device) - (torch.cumsum(n, 0)
                                                     - n)[tri]
    return tri, b[tri, 0] + k % w[tri], b[tri, 1] + k // w[tri]


def render_draw(st, setup_, width, color, ds, texels, control=False):
    """Every fragment of one draw, merged in submission order into the
    (H * W,) int64 buffers ``color`` and ``ds``; returns them."""
    device = color.device
    edges = torch.as_tensor(setup_["edges"], device=device)
    s = dict(setup_, attribs=torch.as_tensor(setup_["attribs"],
                                             device=device))
    tri, x, y = _fragments(setup_["box"], device)
    e = edges[tri]
    ev = [_w32(e[:, k, 0] * x + e[:, k, 1] * y + e[:, k, 2])
          for k in range(3)]
    cov = (ev[0] >= 0) & (ev[1] >= 0) & (ev[2] >= 0)
    tri, px = tri[cov], (y * width + x)[cov]
    ev = [v[cov] for v in ev]
    frag_c, frag_z = shade(st, tri, ev, s, texels, control)
    # each pixel's fragments in submission order: rank r is the r-th
    # fragment that covers its pixel
    px_sorted, order = torch.sort(px, stable=True)
    n = px_sorted.numel()
    if not n:
        return color, ds
    new = torch.ones(n, dtype=torch.bool, device=device)
    new[1:] = px_sorted[1:] != px_sorted[:-1]
    pos = torch.arange(n, device=device)
    first_of = torch.cummax(torch.where(new, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - first_of
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        p = px[sel]
        color[p], ds[p] = merge(st, frag_c[sel], frag_z[sel], color[p],
                                ds[p], control)
    return color, ds


def render(draws, textures, width: int, height: int, device="cpu",
           control: bool = False) -> torch.Tensor:
    """The (height, width) frame as int32 ARGB words (row 0 at the top of
    the buffer, as the program's), every draw in order from the cleared
    buffers (colour 0xFF000000, depth-stencil 0xFFFFFFFF)."""
    device = torch.device(device)
    color = torch.full((height * width,), CLEAR_COLOR, dtype=torch.int64,
                       device=device)
    ds = torch.full_like(color, CLEAR_DEPTH)
    for draw in draws:
        st = draw_state(draw, textures)
        s = setup(draw, width, height)
        if s is None:
            continue
        texels = (torch.as_tensor(st["texture"]["texels"].astype(np.int64),
                                  device=device) if st["tex_on"] else None)
        color, ds = render_draw(st, s, width, color, ds, texels, control)
    return _w32(color).to(torch.int32).reshape(height, width)
