"""CGLTrace scene loader.

Counterpart of skybox_rt_tpu.geom.cgltrace: the same dataclasses, XML
parser and npz layout, so both packages read the same trace bytes.

The reference's scenes are Boost XML serialization archives produced by
cocogfx's ``CGLTrace`` (consumed at draw3d/main.cpp:428-455).  The cocogfx
submodule is absent from the snapshot, so this loader was re-derived from the
archive layout of the checked-in ``tests/regression/draw3d/*.cgltrace`` files:

    <cgltrace>
      <drawcalls><count>N</count><item>...</item>*N</drawcalls>
      <textures><count>M</count><item><first>id</first><second>
          <format/><width/><height/><size/><pixels>base64</pixels>
      </second></item>*M</textures>
    </cgltrace>

Each drawcall item carries render states, a texture id, an unordered_map of
vertices (key ``first`` -> {pos.xyzw, color.rgba, texcoord.uv}), a primitive
index list (i0,i1,i2 referencing vertex keys), and a viewport (near/far).

A trace also round-trips through the JAX package's ``.npz`` layout
(:func:`save_npz` / :func:`load_npz`); the port's committed synthetic trace
(``data/synth_draw3d.npz``) is stored that way, and :func:`load_cached`
keeps parsed XML archives in it.
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib
import os
import xml.etree.ElementTree as ET
import zipfile

import numpy as np


@dataclasses.dataclass
class RenderStates:
    """Per-drawcall fixed-function state (cocogfx CGLTrace::states_t)."""
    color_enabled: bool
    color_writemask: int
    depth_test: bool
    depth_writemask: int
    depth_func: int
    stencil_test: bool
    stencil_func: int
    stencil_zpass: int
    stencil_zfail: int
    stencil_fail: int
    stencil_ref: int
    stencil_mask: int
    stencil_writemask: int
    texture_enabled: bool
    texture_envmode: int
    texture_minfilter: int
    texture_magfilter: int
    texture_addressU: int
    texture_addressV: int
    blend_enabled: bool
    blend_src: int
    blend_dst: int


@dataclasses.dataclass
class DrawCall:
    states: RenderStates
    texture_id: int
    # vertex arrays indexed 0..V-1 after key remapping
    pos: np.ndarray        # (V, 4) float32 clip-space x,y,z,w
    color: np.ndarray      # (V, 4) float32 r,g,b,a
    texcoord: np.ndarray   # (V, 2) float32 u,v
    indices: np.ndarray    # (P, 3) int32 into pos/color/texcoord
    near: float
    far: float


@dataclasses.dataclass
class Texture:
    format: int            # cocogfx ePixelFormat id
    width: int
    height: int
    pixels: np.ndarray     # raw bytes, uint8 (width*height*bpp)


@dataclasses.dataclass
class CGLTrace:
    drawcalls: list[DrawCall]
    textures: dict[int, Texture]


def _text(elem, tag, default=None):
    e = elem.find(tag)
    if e is None:
        if default is not None:
            return default
        raise KeyError(f"missing <{tag}>")
    return e.text or ""


def _parse_states(e) -> RenderStates:
    g = lambda t: int(_text(e, t))
    return RenderStates(
        color_enabled=bool(g("color_enabled")),
        color_writemask=g("color_writemask"),
        depth_test=bool(g("depth_test")),
        depth_writemask=g("depth_writemask"),
        depth_func=g("depth_func"),
        stencil_test=bool(g("stencil_test")),
        stencil_func=g("stencil_func"),
        stencil_zpass=g("stencil_zpass"),
        stencil_zfail=g("stencil_zfail"),
        stencil_fail=g("stencil_fail"),
        stencil_ref=g("stencil_ref"),
        stencil_mask=g("stencil_mask"),
        stencil_writemask=g("stencil_writemask"),
        texture_enabled=bool(g("texture_enabled")),
        texture_envmode=g("texture_envmode"),
        texture_minfilter=g("texture_minfilter"),
        texture_magfilter=g("texture_magfilter"),
        texture_addressU=g("texture_addressU"),
        texture_addressV=g("texture_addressV"),
        blend_enabled=bool(g("blend_enabled")),
        blend_src=g("blend_src"),
        blend_dst=g("blend_dst"),
    )


def _parse_drawcall(e) -> DrawCall:
    states = _parse_states(e.find("states"))
    texture_id = int(_text(e, "texture_id"))

    # vertices: unordered_map<uint32, vertex_t>
    verts = {}
    for item in e.find("vertices").findall("item"):
        key = int(_text(item, "first"))
        sec = item.find("second")
        pos = sec.find("pos")
        col = sec.find("color")
        tc = sec.find("texcoord")
        verts[key] = (
            [float(_text(pos, c)) for c in "xyzw"],
            [float(_text(col, c)) for c in "rgba"],
            [float(_text(tc, c)) for c in "uv"],
        )

    keys = sorted(verts)
    remap = {k: i for i, k in enumerate(keys)}
    pos = np.array([verts[k][0] for k in keys], np.float32).reshape(-1, 4)
    color = np.array([verts[k][1] for k in keys], np.float32).reshape(-1, 4)
    texcoord = np.array([verts[k][2] for k in keys], np.float32).reshape(-1, 2)

    prims = []
    for item in e.find("primitives").findall("item"):
        prims.append([remap[int(_text(item, t))] for t in ("i0", "i1", "i2")])
    indices = np.array(prims, np.int32).reshape(-1, 3)

    vp = e.find("viewport")
    return DrawCall(
        states=states,
        texture_id=texture_id,
        pos=pos,
        color=color,
        texcoord=texcoord,
        indices=indices,
        near=float(_text(vp, "near")),
        far=float(_text(vp, "far")),
    )


def _parse_texture(e) -> tuple[int, Texture]:
    tid = int(_text(e, "first"))
    sec = e.find("second")
    fmt = int(_text(sec, "format"))
    w = int(_text(sec, "width"))
    h = int(_text(sec, "height"))
    size = int(_text(sec, "size"))
    b64 = "".join(_text(sec, "pixels").split())
    raw = base64.b64decode(b64 + "=" * (-len(b64) % 4))
    pixels = np.frombuffer(raw[:size], np.uint8).copy()
    if pixels.size != size:
        raise ValueError(f"texture {tid}: {pixels.size} bytes, header says "
                         f"{size}")
    return tid, Texture(format=fmt, width=w, height=h, pixels=pixels)


def load(path: str) -> CGLTrace:
    root = ET.parse(path).getroot()  # <boost_serialization>
    if root.tag != "cgltrace":
        root = root.find("cgltrace")
    drawcalls = [_parse_drawcall(e) for e in root.find("drawcalls").findall("item")]
    textures = dict(
        _parse_texture(e) for e in root.find("textures").findall("item")
    )
    return CGLTrace(drawcalls=drawcalls, textures=textures)


_STATE_FIELDS = [f.name for f in dataclasses.fields(RenderStates)]


def _to_npz(trace: CGLTrace) -> dict:
    out = {"num_drawcalls": np.int32(len(trace.drawcalls)),
           "texture_ids": np.array(sorted(trace.textures), np.int32)}
    for i, dc in enumerate(trace.drawcalls):
        p = f"dc{i}_"
        out[p + "states"] = np.array(
            [int(getattr(dc.states, f)) for f in _STATE_FIELDS], np.int64
        )
        out[p + "pos"] = dc.pos
        out[p + "color"] = dc.color
        out[p + "texcoord"] = dc.texcoord
        out[p + "indices"] = dc.indices
        out[p + "meta"] = np.array([dc.texture_id], np.int32)
        out[p + "nearfar"] = np.array([dc.near, dc.far], np.float32)
    for tid, tex in trace.textures.items():
        p = f"tex{tid}_"
        out[p + "meta"] = np.array([tex.format, tex.width, tex.height], np.int32)
        out[p + "pixels"] = tex.pixels
    return out


def _from_npz(z) -> CGLTrace:
    drawcalls = []
    for i in range(int(z["num_drawcalls"])):
        p = f"dc{i}_"
        sv = z[p + "states"]
        states = RenderStates(**{f: (bool(v) if f.endswith(("enabled", "test")) or f in
                                     ("color_enabled", "depth_test", "stencil_test",
                                      "texture_enabled", "blend_enabled")
                                     else int(v))
                                 for f, v in zip(_STATE_FIELDS, sv)})
        drawcalls.append(DrawCall(
            states=states,
            texture_id=int(z[p + "meta"][0]),
            pos=z[p + "pos"],
            color=z[p + "color"],
            texcoord=z[p + "texcoord"],
            indices=z[p + "indices"],
            near=float(z[p + "nearfar"][0]),
            far=float(z[p + "nearfar"][1]),
        ))
    textures = {}
    for tid in z["texture_ids"]:
        p = f"tex{int(tid)}_"
        fmt, w, h = (int(v) for v in z[p + "meta"])
        textures[int(tid)] = Texture(format=fmt, width=w, height=h,
                                     pixels=z[p + "pixels"])
    return CGLTrace(drawcalls=drawcalls, textures=textures)


DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def save_npz(trace: CGLTrace, path: str) -> None:
    np.savez_compressed(path, **_to_npz(trace))


def load_npz(path: str) -> CGLTrace:
    with np.load(path, allow_pickle=False) as z:
        return _from_npz(z)


def trace_path(name: str) -> str:
    """Resolve a scene name (e.g. 'synth_draw3d') to a trace file: the name
    itself if it is a path, else ``data/<name>.cgltrace`` or ``.npz`` in
    this package."""
    if os.path.exists(name):
        return name
    for ext in (".cgltrace", ".npz"):
        p = os.path.join(DATA_DIR, name + ext)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(name)


def load_trace(path: str) -> CGLTrace:
    """Load a trace from its XML archive or its ``.npz`` form."""
    return load_npz(path) if path.endswith(".npz") else load(path)


def _cache_key(path: str) -> str:
    st = os.stat(path)
    key = f"{os.path.abspath(path)}:{st.st_size}:{st.st_mtime_ns}:v1"
    return hashlib.sha1(key.encode()).hexdigest()[:16]


def load_cached(path: str, cache_dir: str | None = None) -> CGLTrace:
    """Load a trace from either form :func:`load_trace` reads, keeping a
    parsed XML archive as ``.npz`` in ``cache_dir`` (default
    ``~/.cache/skybox_rt_tpu_torch``), keyed by the file's path, size and
    modification time: parsing a 2 MB archive is slow.  An ``.npz`` trace
    is already that form and is read as it is.  A cache file that cannot be
    read is parsed and written again."""
    if path.endswith(".npz"):
        return load_npz(path)
    cache_dir = cache_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "skybox_rt_tpu_torch")
    os.makedirs(cache_dir, exist_ok=True)
    cpath = os.path.join(cache_dir, _cache_key(path) + ".npz")
    if os.path.exists(cpath):
        try:
            return load_npz(cpath)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            pass
    trace = load(path)
    # written under a name of its own and moved into place: a reader in
    # another process never sees half a file
    tmp = f"{cpath}.{os.getpid()}.npz"
    save_npz(trace, tmp)
    os.replace(tmp, cpath)
    return trace
