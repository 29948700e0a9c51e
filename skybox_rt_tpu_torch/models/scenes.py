"""Procedural scene builders for the synthetic trace generator and the
ray-tracing path.

Counterpart of skybox_rt_tpu.models.scenes, copied as is; :func:`multi_sphere`
and :func:`aimed_rays` are the scene and ray makers of the ray-query kernels'
checks (the CPU tests and chip_smoke.py share them), :func:`planar_uvs` the
texture coordinates of the textured ray-traced frames.  Everything is float32
numpy on the host.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32


def triangle(z=0.2):
    """One triangle with red, green and blue corners: (dict of pos (3, 4),
    color (3, 4), uv (3, 2), indices (1, 3))."""
    pos = np.array([
        [-0.5, -0.5, z, 1.0],
        [0.5, -0.5, z, 1.0],
        [0.0, 0.5, z, 1.0],
    ], F32)
    color = np.array([
        [1, 0, 0, 1],
        [0, 1, 0, 1],
        [0, 0, 1, 1],
    ], F32)
    uv = np.array([[0, 0], [1, 0], [0.5, 1]], F32)
    indices = np.array([[0, 1, 2]], np.int32)
    return dict(pos=pos, color=color, uv=uv), indices


def quad(z=0.5, scale=0.8):
    """Two-triangle textured quad."""
    s = scale
    pos = np.array([
        [-s, -s, z, 1.0], [s, -s, z, 1.0], [s, s, z, 1.0], [-s, s, z, 1.0],
    ], F32)
    color = np.ones((4, 4), F32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], F32)
    indices = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return dict(pos=pos, color=color, uv=uv), indices


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
    """Ground plane triangulated into a grid (for RT shadows/bounces)."""
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
    """Multi-object RT scene: a grid of icospheres over a ground plane.
    copies=9 @ subdiv=5 -> 184,320 sphere tris + a 512-tri plane.

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


#: checkerboard_texture arguments of the textured ray-traced frames.  With
#: planar_uvs a world unit spans 4 texels: a bilinear lookup turns a hit
#: point's last-bit differences into colour differences in proportion to
#: that, and the frames are held to a float tolerance.
RT_CHECKER = dict(size=32, tiles=4)


def planar_uvs(verts, scale=0.125):
    """(V, 2) f32 texture coordinates from a mesh's x and z (a planar
    projection from above; the sampler's repeat wrap tiles it)."""
    verts = np.asarray(verts, F32)
    return (verts[:, [0, 2]] * F32(scale) + F32(0.5)).astype(F32)


def multi_sphere(n=4, subdiv=2, seed=5):
    """n icospheres of seeded radius and offset, centred on their mean:
    (verts (V,3) f32, faces (P,3) i64).  Cuts into many small BVH blocks."""
    rng = np.random.default_rng(seed)
    vs, fs = [], []
    off = 0
    for _ in range(n):
        v, f = icosphere(subdiv=subdiv, radius=0.4 + 0.2 * rng.random())
        v = v + rng.normal(size=(1, 3)) * 1.2
        vs.append(v.astype(F32))
        fs.append(f + off)
        off += v.shape[0]
    v = np.concatenate(vs)
    return ((v - v.mean(0, keepdims=True)).astype(F32),
            np.concatenate(fs).astype(np.int64))


def aimed_rays(R, seed=3, aimed=True):
    """R seeded unit rays from |o| ~ 3, aimed at the origin with jitter (or
    in random directions): (o, d) float32 (R, 3)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(F32) * 3.0
    d = (-o if aimed else 0.0) + rng.normal(size=(R, 3)).astype(F32) * 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


# The scenes the BVH-block ray queries are checked on, by the CPU tests
# against the JAX package and by chip_smoke.py on the card:
# name -> (multi_sphere arguments, tri_block, rays, ray seed)
BVH_CHECK_SCENES = {
    "multi4_tb32": (dict(n=4, subdiv=2), 32, 1500, 31),
    "multi6_tb16": (dict(n=6, subdiv=2, seed=11), 16, 1200, 37),
    "multi3_tb32_parked": (dict(n=3, subdiv=2, seed=13), 32, 600, 41),
    "multi4_tb32_anyhit": (dict(n=4, subdiv=2, seed=19), 32, 900, 47),
}


def parked(o, d, every):
    """Copies of o, d with every `every`-th ray parked (origin 3e7,
    direction 0.57735, the tracer's dead-ray convention), and the mask."""
    o, d = o.copy(), d.copy()
    park = np.arange(o.shape[0]) % every == 0
    o[park] = 3e7
    d[park] = 0.57735
    return o, d, park


def bvh_check_queries(name):
    """(verts, faces, tri_block, queries) of a check scene; queries is a
    list of (kind, o, d, t_max): kind "closest" with t_max None or (R,),
    kind "any" with t_max a number or (R,)."""
    kw, tri_block, R, seed = BVH_CHECK_SCENES[name]
    verts, faces = multi_sphere(**kw)
    o, d = aimed_rays(R, seed=seed)
    if name == "multi3_tb32_parked":
        op, dp, _ = parked(o, d, 3)
        queries = [("closest", op, dp, np.full((R,), 2.5, F32))]
    elif name == "multi4_tb32_anyhit":
        op, dp, _ = parked(o, d, 4)
        queries = [("any", o, d, 2.0),
                   ("any", op, dp, (np.arange(R) % 3 + 1).astype(F32))]
    else:
        queries = [("closest", o, d, None)]
    return verts, faces, tri_block, queries


# The scenes the clustered and flat ray queries are checked on, by the CPU
# tests against the JAX package and by chip_smoke.py on the card:
# name -> (mesh maker, its arguments, max_tris of a cluster, rays, ray seed)
CLUSTER_CHECK_SCENES = {
    "ico3_c64": (icosphere, dict(subdiv=3), 64, 2000, 5),
    "ico2_c64_anyhit": (icosphere, dict(subdiv=2), 64, 1500, 11),
    "ico1_c32_anyhit": (icosphere, dict(subdiv=1), 32, 700, 13),
    "multi4_c32": (multi_sphere, dict(n=4, subdiv=2), 32, 1000, 31),
}


def axis_parallel(d):
    """A copy of unit directions d with one component zeroed in two rays of
    three (renormalised) and every 97th direction all zero."""
    d = d.copy()
    d[0::3, 0] = 0.0
    d[1::3, 1] = 0.0
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), F32(1e-20))
    d[5::97] = 0.0
    return d.astype(F32)


def cluster_check_queries(name):
    """(verts, faces, max_tris, queries) of a check scene; queries is a
    list of (label, kind, o, d, t_max) as in :func:`bvh_check_queries`."""
    maker, kw, max_tris, R, seed = CLUSTER_CHECK_SCENES[name]
    verts, faces = maker(**kw)
    o, d = aimed_rays(R, seed=seed)
    rng = np.random.default_rng(17)
    if name == "ico3_c64":
        op, dp, _ = parked(o, d, 3)
        queries = [
            ("unbounded", "closest", o, d, None),
            ("per_ray_tmax", "closest", o, d,
             rng.uniform(1.5, 3.5, size=R).astype(F32)),
            ("parked", "closest", op, dp, None),
            ("axis_parallel", "closest", o, axis_parallel(d), None)]
    elif name == "ico2_c64_anyhit":
        queries = [(f"tmax_{tm:g}", "any", o, d, tm)
                   for tm in (0.5, 2.0, 1e8)]
    elif name == "ico1_c32_anyhit":
        queries = [("per_ray_tmax", "any", o, d,
                    rng.uniform(0.1, 5.0, size=R).astype(F32))]
    else:
        op, dp, _ = parked(o, d, 4)
        queries = [("unbounded", "closest", o, d, None),
                   ("parked_tmax_2", "any", op, dp, 2.0)]
    return verts, np.asarray(faces, np.int64), max_tris, queries


def check_clustered_equals_flat(got, got_flat):
    """Hold a clustered closest-hit result (prim, t, u, v as numpy arrays) to
    the flat query's on the same rays.  The two run the same arithmetic on
    each triangle, so the miss masks are equal and wherever the prims agree
    every output is equal bit for bit; where the prims differ the hit is a
    tie between triangles (lowest slot against lowest prim id): the two t
    agree to rtol 1e-5, on at most 1 % of the hits.  Raises AssertionError
    otherwise; returns the number of such ties."""
    p, pf = got[0], got_flat[0]
    if not np.array_equal(p < 0, pf < 0):
        raise AssertionError("clustered and flat miss masks differ")
    same = p == pf
    for name, g, w in zip("tuv", got[1:], got_flat[1:]):
        if not np.array_equal(g[same], w[same]):
            raise AssertionError(f"clustered {name} != flat {name} where the "
                                 f"prims agree")
    ties, hits = int((~same).sum()), int((p >= 0).sum())
    t, tf = got[1][~same], got_flat[1][~same]
    if ties > 0.01 * hits or (np.abs(t - tf) > 1e-5 * np.abs(tf)).any():
        raise AssertionError(f"clustered != flat beyond ties: {ties} of "
                             f"{hits} hits")
    return ties


# The triangle soups the next-hit-after query is checked on, by the CPU tests
# against the JAX package and by chip_smoke.py on the card.  Both hold hits of
# exactly equal t, which an enumeration that steps t by an epsilon would lose.
AFTER_CHECK_SOUPS = ("duplicate_soup", "coplanar_grid")


def after_check_queries(name):
    """(v0, e1, e2, tri_block, o, d, t_max, walks) of a check soup: float32
    (P, 3) triangle arrays, rays (R, 3), t_max None or (R,), and the number
    of walks that enumerates every ray's hits."""
    if name == "duplicate_soup":
        # random triangles, one an exact duplicate of another: every hit of
        # the pair is a tie; every fifth ray is parked
        rng = np.random.default_rng(0)
        P, R = 37, 300
        v0, e1, e2 = (rng.uniform(-1, 1, (P, 3)).astype(F32)
                      for _ in range(3))
        v0[20], e1[20], e2[20] = v0[5], e1[5], e2[5]
        o = rng.uniform(-3, -2, (R, 3)).astype(F32)
        d = (rng.uniform(-1, 1, (R, 3)) + 1.5).astype(F32)
        o, d, _ = parked(o, d, 5)
        return v0, e1, e2, 64, o, d, None, 8
    if name == "coplanar_grid":
        # two coplanar layers of an n x n quad grid in the plane z = 1, the
        # second shifted by half a cell; parallel rays that reach grid
        # vertices, edge midpoints and cell centres at exactly t = 1 meet up
        # to 6 + 2 triangles there.  Blocks of 8: the tied triangles lie in
        # several.  Every coordinate is a multiple of 1/16, so each product
        # and sum of the test is exact in float32 however it is contracted:
        # an edge hit is u = 0 or u + v = 1 exactly, in every implementation.
        # The rays are inclined: an axis-parallel ray that lies exactly in a
        # box's upper face fails the slab test (0 * 1e30 = 0 < t).
        n = 8
        lin = np.linspace(-1.0, 1.0, n + 1, dtype=F32)
        tris = []
        for shift in (F32(0.0), F32(1.0 / n)):
            for i in range(n):
                for j in range(n):
                    a = [lin[j] + shift, lin[i] + shift, 1.0]
                    b = [lin[j + 1] + shift, lin[i] + shift, 1.0]
                    c = [lin[j + 1] + shift, lin[i + 1] + shift, 1.0]
                    e = [lin[j] + shift, lin[i + 1] + shift, 1.0]
                    tris += [[a, b, c], [a, c, e]]
        tri = np.asarray(tris, F32)
        half = np.linspace(-1.0, 1.0, 2 * n + 1, dtype=F32)
        xx, yy = np.meshgrid(half, half)
        d = np.tile(np.asarray([[0.125, 0.0625, 1.0]], F32), (xx.size, 1))
        o = np.stack([xx.ravel(), yy.ravel(), np.ones(xx.size, F32)], -1) - d
        # a third of the rays stop before the plane, a third just behind it
        t_max = np.asarray([0.5, 1.5, np.inf], F32)[np.arange(o.shape[0]) % 3]
        return (tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], 8,
                o.astype(F32), d, t_max, 10)
    raise KeyError(name)


def soup_mesh(v0, e1, e2):
    """(verts (3P, 3), faces (P, 3)) of a triangle soup given as arrays."""
    verts = np.stack([v0, v0 + e1, v0 + e2], 1).reshape(-1, 3)
    return verts, np.arange(verts.shape[0], dtype=np.int64).reshape(-1, 3)


def layered_trace(layers=3, grid=6):
    """One drawcall of `layers` stacked viewport-covering triangle sheets
    (grid x grid quads each), blending on, depth test off: every pixel gets
    `layers` fragments in submission order, and the draw has more triangles
    than the frame's scan cutoff, so it runs the K-slot walks.  Returns
    (pos (V, 4), indices (P, 3), color (V, 4), uv (V, 2))."""
    verts, idx, cols, uvs = [], [], [], []
    for li in range(layers):
        base = len(verts)
        for gy in range(grid + 1):
            for gx in range(grid + 1):
                # deterministic jitter: no pixel ray grazes a shared edge
                j = 0.013 * np.sin(12.9898 * gx + 78.233 * gy + li)
                x = (2.0 * gx / grid - 1.0) + j
                y = (2.0 * gy / grid - 1.0) - j
                verts.append([x, y, 0.2 + 0.2 * li, 1.0])
                cols.append([0.9 - 0.2 * li, 0.3 + 0.2 * li, 0.5, 0.5])
                uvs.append([gx / grid, gy / grid])
        for gy in range(grid):
            for gx in range(grid):
                v00 = base + gy * (grid + 1) + gx
                v10 = v00 + 1
                v01 = v00 + (grid + 1)
                v11 = v01 + 1
                idx.append([v00, v10, v11])
                idx.append([v00, v11, v01])
    return (np.asarray(verts, F32), np.asarray(idx, np.int32),
            np.asarray(cols, F32), np.asarray(uvs, F32))
