"""Procedural scene builders for the synthetic trace generator.

Counterpart of the parts of skybox_rt_tpu.models.scenes that
models/make_synth_trace.py uses, copied as is.  Everything is float32 numpy
on the host.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32


def checkerboard_texture(size=64, tiles=8):
    """RGBA float checkerboard."""
    y, x = np.mgrid[0:size, 0:size]
    c = (((x * tiles // size) + (y * tiles // size)) % 2).astype(F32)
    tex = np.stack([c, 1 - c, c * 0.5 + 0.25, np.ones_like(c)], -1)
    return tex.astype(F32)


def icosphere(subdiv=2, radius=1.0):
    """Geodesic sphere mesh: (verts (V,3) f32, faces (F,3) i32)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = list(map(tuple, verts))
    cache = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key in cache:
            return cache[key]
        va, vb = np.array(verts[a]), np.array(verts[b])
        m = (va + vb) / 2
        m /= np.linalg.norm(m)
        verts.append(tuple(m))
        cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        nf = []
        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nf

    v = np.array(verts, F32) * F32(radius)
    f = np.array(faces, np.int32)
    return v, f


def mesh_grid_plane(n=8, y=-1.0, half=4.0):
    """Ground plane triangulated into a grid."""
    lin = np.linspace(-half, half, n + 1, dtype=F32)
    xx, zz = np.meshgrid(lin, lin)
    verts = np.stack([xx, np.full_like(xx, y), zz], -1).reshape(-1, 3)
    faces = []
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j
            b = a + 1
            c = a + (n + 1)
            d = c + 1
            faces += [(a, b, c), (b, d, c)]
    return verts.astype(F32), np.array(faces, np.int32)
