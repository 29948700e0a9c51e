"""The benchmark's scene generators: a frozen copy, so that no change to the
program can change the work a cell asks for.

``icosphere``, ``mesh_grid_plane``, ``sphere_field``, ``planar_uvs`` and
``checkerboard_texture`` copy ``skybox_rt_tpu_torch/models/scenes.py`` as it
stood when the benchmark was defined (``checkerboard_texture`` gains an
optional pair of colours); benchmark/tests checks that the copies still
produce what the program's generators do.  :func:`make_scene` builds a
configuration's scene from its file and the run's seed: the seed draws the
spheres' tints and the checkerboard's two colours, never the geometry or
the camera, so every seed asks for the same work.  Everything is float32
numpy on the host.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32


def checkerboard_texture(size=64, tiles=8, colours=None):
    """RGBA float checkerboard.  ``colours``: None for the program's own two
    colours, or a pair of RGB triples for the dark and the light tiles."""
    y, x = np.mgrid[0:size, 0:size]
    c = (((x * tiles // size) + (y * tiles // size)) % 2).astype(F32)
    if colours is None:
        tex = np.stack([c, 1 - c, c * 0.5 + 0.25, np.ones_like(c)], -1)
        return tex.astype(F32)
    dark, light = (np.asarray(k, F32) for k in colours)
    rgb = dark + c[..., None] * (light - dark)
    return np.concatenate([rgb, np.ones_like(c)[..., None]], -1).astype(F32)


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


def sphere_field(copies=9, subdiv=5, spacing=2.4, ground=True, seed=0):
    """A grid of icospheres over a ground plane; the seed draws the tints.
    Returns (verts (V,3) f32, faces (P,3) i32, colors (V,4) f32)."""
    rng = np.random.default_rng(seed)
    sv, sf = icosphere(subdiv=subdiv, radius=0.9)
    grid = int(np.ceil(np.sqrt(copies)))
    vs, fs, cs = [], [], []
    off = 0
    for i in range(copies):
        dx = (i % grid - (grid - 1) / 2) * spacing
        dz = (i // grid - (grid - 1) / 2) * spacing
        vs.append(sv + np.asarray([dx, 0.0, dz], F32))
        fs.append(sf + off)
        tint = rng.uniform(0.3, 1.0, size=3).astype(F32)
        cs.append(np.concatenate(
            [np.tile(tint, (sv.shape[0], 1)),
             np.ones((sv.shape[0], 1), F32)], 1))
        off += sv.shape[0]
    if ground:
        gv, gf = mesh_grid_plane(n=16, y=-1.0,
                                 half=spacing * (grid + 1) / 2)
        vs.append(gv)
        fs.append(gf + off)
        cs.append(np.tile(np.asarray([[0.7, 0.7, 0.75, 1.0]], F32),
                          (gv.shape[0], 1)))
    return (np.concatenate(vs).astype(F32),
            np.concatenate(fs).astype(np.int32),
            np.concatenate(cs).astype(F32))


def planar_uvs(verts, scale=0.125):
    """(V, 2) f32 texture coordinates from a mesh's x and z."""
    verts = np.asarray(verts, F32)
    return (verts[:, [0, 2]] * F32(scale) + F32(0.5)).astype(F32)


def make_scene(config: dict, seed: int) -> dict:
    """The inputs both the program and the reference get: verts, faces,
    colors, and with ``config["texture"]`` uvs and texture (None otherwise).
    The seed (any non-negative int) sets colours only."""
    field = config["sphere_field"]
    verts, faces, colors = sphere_field(seed=seed, **field)
    scene = dict(verts=verts, faces=faces, colors=colors, uvs=None,
                 texture=None)
    tex = config.get("texture")
    if tex is not None:
        rng = np.random.default_rng([seed, 1])
        colours = rng.uniform(0.15, 1.0, size=(2, 3))
        scene["uvs"] = planar_uvs(verts, scale=tex["uv_scale"])
        scene["texture"] = checkerboard_texture(tex["size"], tex["tiles"],
                                                colours)
    return scene
