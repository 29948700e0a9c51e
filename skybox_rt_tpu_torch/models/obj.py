"""Minimal Wavefront OBJ loader for RT scenes.

Counterpart of skybox_rt_tpu.models.obj (pure numpy, a copy).  Supports
v/vt/vn records and polygonal f records (triangulated as fans), with the
OBJ index conventions (1-based, negative = relative).  Produces the flat
arrays the RT path consumes (rt.tracer.RTScene): positions, faces, and
optional per-vertex uv/normals re-indexed to position order (last-wins
when a position is referenced with different vt/vn — exact welding is out
of scope for a demo loader).
"""
from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Returns dict(verts (V,3) f32, faces (F,3) i32,
    uvs (V,2) f32 | None, normals (V,3) f32 | None)."""
    verts: list = []
    uvs_raw: list = []
    normals_raw: list = []
    faces: list = []
    uv_of_vert: dict = {}
    n_of_vert: dict = {}

    def resolve(idx: str, n: int) -> int:
        i = int(idx)
        return (n + i) if i < 0 else (i - 1)

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs_raw.append([float(x) for x in parts[1:3]])
            elif tag == "vn":
                normals_raw.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                corners = []
                for vspec in parts[1:]:
                    comps = vspec.split("/")
                    vi = resolve(comps[0], len(verts))
                    corners.append(vi)
                    if len(comps) > 1 and comps[1]:
                        uv_of_vert[vi] = resolve(comps[1], len(uvs_raw))
                    if len(comps) > 2 and comps[2]:
                        n_of_vert[vi] = resolve(comps[2], len(normals_raw))
                for k in range(1, len(corners) - 1):     # fan-triangulate
                    faces.append([corners[0], corners[k], corners[k + 1]])

    V = len(verts)
    out = {
        "verts": np.asarray(verts, np.float32).reshape(V, 3),
        "faces": np.asarray(faces, np.int32).reshape(-1, 3),
        "uvs": None,
        "normals": None,
    }
    if uvs_raw and uv_of_vert:
        uv = np.zeros((V, 2), np.float32)
        for vi, ti in uv_of_vert.items():
            uv[vi] = uvs_raw[ti]
        out["uvs"] = uv
    if normals_raw and n_of_vert:
        nm = np.zeros((V, 3), np.float32)
        for vi, ni in n_of_vert.items():
            nm[vi] = normals_raw[ni]
        out["normals"] = nm
    return out


def save_obj(path: str, verts, faces) -> None:
    """Write a position-only OBJ (round-trip/testing helper)."""
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")
