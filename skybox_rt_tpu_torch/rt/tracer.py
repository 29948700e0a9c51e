"""Ray tracer: camera, shading loop, multi-bounce mirror reflections.

Counterpart of skybox_rt_tpu.rt.tracer.  The shading stages reuse the float
material model of the differentiable pipeline (barycentric attribute
interpolation, bilinear texture lookup), so the RT and raster paths share
behaviour.

Rays are a flat (R, ...) batch on one explicit device.  Bounces iterate over a
fixed depth with active-ray masks; surviving rays are re-compacted to the
front before each bounce, and the bounce's launch width is chosen on the host
from the live count (one ``.item()`` a bounce).  Nothing here records
gradients: the path runs under ``torch.no_grad()``.

Entry points (:func:`make_frame_fn`, :func:`render`) run on the CUDA card
unless ``device`` says otherwise (core.device).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.device import resolve_device
from ..diff.pipeline import sample_texture_bilinear
from . import bvh as bvh_mod
from . import intersect
from . import wavefront

F32 = torch.float32
I32 = torch.int32

#: above this many triangles engine "pallas" takes the BVH-block kernels
#: ("pallas_bvh"), at or below it the clustered kernels; the same switch as
#: the JAX package, so both take the same engine for the same scene
PALLAS_MAX_TRIS = 15000
#: treelet block size of the pallas_bvh engine (rt.bvh.build_block_set).
#: Kept at the JAX package's value only because it defines the same
#: ``blocks`` in both packages; it has not been tuned for this card.
BVH_TRI_BLOCK = 256

ENGINES = ("pallas", "pallas_bvh", "pallas_streamed", "pallas_worklist",
           "bvh", "brute")
COMPACT_METHODS = ("argsort", "argsort_om", "octant", "partition")

PARK_O = (3e7, 3e7, 3e7)
PARK_D = (0.57735, 0.57735, 0.57735)


def _norm3(a):
    """sqrt(x*x + y*y + z*z) over the last axis, keepdim."""
    return torch.sqrt(a[..., 0:1] * a[..., 0:1] + a[..., 1:2] * a[..., 1:2]
                      + a[..., 2:3] * a[..., 2:3])


def _dot3(a, b):
    """a.b over the last axis, keepdim, summed left to right."""
    return (a[..., 0:1] * b[..., 0:1] + a[..., 1:2] * b[..., 1:2]
            + a[..., 2:3] * b[..., 2:3])


def _vec(values, device):
    return torch.tensor(values, dtype=F32, device=device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera."""
    eye: tuple
    look_at: tuple
    up: tuple = (0.0, 1.0, 0.0)
    fov_y_deg: float = 45.0

    def basis(self, device="cpu"):
        eye = _vec(self.eye, device)
        fwd = _vec(self.look_at, device) - eye
        fwd = fwd / _norm3(fwd)
        right = torch.linalg.cross(fwd, _vec(self.up, device))
        right = right / _norm3(right)
        up = torch.linalg.cross(right, fwd)
        return eye, fwd, right, up


@dataclasses.dataclass(frozen=True)
class RTConfig:
    width: int
    height: int
    bounces: int = 0              # extra reflection bounces after primary
    shadows: bool = False
    textured: bool = False
    use_bvh: bool = True          # legacy toggle: False forces engine=brute
    # engine: 'pallas' (the default, as in the JAX package: the clustered
    # CUDA kernels of ops.cuda_rt at or below PALLAS_MAX_TRIS triangles,
    # 'pallas_bvh' above), 'pallas_bvh' (BVH-treelet blocks: the BVH-block
    # CUDA kernels of ops.cuda_rt), 'bvh' (stackless lockstep traversal,
    # plain torch), 'brute' (all-pairs oracle).  'pallas_streamed' (dense
    # sweep over AABB-gated triangle blocks) and 'pallas_worklist' (per-tile
    # lists of active blocks from a prepass) are kept for comparison, as in
    # the JAX package: closest-hit kernels of ops.cuda_rt over the clusters'
    # treelet order, occlusion the same query with prim >= 0.
    engine: str = "pallas"
    # re-compact surviving rays to the front before each bounce.  Dead rays
    # are parked at a far origin and grouped at the tail, so whole warps of
    # them leave the hierarchy at its top level.
    compact_bounces: bool = True
    # compaction permutation: 'argsort' (octant+Morton full sort),
    # 'argsort_om' (origin-major key, see _compact_key), 'octant' (counting
    # sort, no Morton), or 'partition' (active-first only)
    compact_method: str = "argsort"
    # stay in compacted order across bounces (one packed row gather per
    # bounce + one final scatter) instead of unsorting every bounce's
    # outputs.  Pure scheduling change: identical image.
    compact_stay: bool = True
    # number of width halvings for the bounce shape ladder: each bounce's
    # closest+shade runs at width R, R/2, ... R>>n, the smallest that holds
    # the live rays (a host decision on the live count).  Compacted live
    # rays are a prefix and every per-ray result is independent of launch
    # width, so this is exact; rows past the chosen width are dead (weight
    # 0) and get parked outputs.  Requires compact_stay.  0 = off.
    bounce_width_ladder: int = 2
    background: tuple = (0.0, 0.0, 0.0, 1.0)
    ambient: float = 0.1
    light_dir: tuple = (0.4, 0.8, 0.45)   # directional light (to light)
    light_color: tuple = (1.0, 1.0, 1.0)


@dataclasses.dataclass
class RTScene:
    """Host-side scene: geometry + per-vertex attributes + materials."""
    verts: np.ndarray          # (V, 3)
    faces: np.ndarray          # (P, 3)
    colors: np.ndarray         # (V, 4) vertex albedo
    normals: np.ndarray = None # (V, 3) vertex normals (computed if None)
    uvs: np.ndarray = None     # (V, 2)
    texture: np.ndarray = None # (TH, TW, 4) float
    reflectivity: float = 0.0  # uniform mirror weight for bounce demo
    bvh: bvh_mod.BVH = None
    # BVH build method: 'sah' (binned surface-area heuristic, best traversal),
    # 'median', or 'lbvh' (near-linear Morton build for animated geometry)
    bvh_method: str = "sah"

    def finalize(self):
        if self.normals is None:
            self.normals = vertex_normals(self.verts, self.faces)
        if self.bvh is None:
            self.bvh = bvh_mod.build(self.verts, self.faces,
                                     method=self.bvh_method)
        return self


def vertex_normals(verts, faces):
    """Area-weighted smooth vertex normals (host)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(norm, 1e-20)).astype(np.float32)


def camera_rays(cam: Camera, width: int, height: int, device=None):
    """Primary rays through pixel centers, in scanline order; row 0 = bottom
    (GL convention, matching the raster framebuffer orientation)."""
    device = resolve_device(device)
    eye, fwd, right, up = cam.basis(device)
    aspect = width / height
    tan_h = torch.tan(torch.deg2rad(_vec(cam.fov_y_deg, device)) * 0.5)
    ys = (torch.arange(height, dtype=F32, device=device) + 0.5) \
        / height * 2.0 - 1.0
    xs = (torch.arange(width, dtype=F32, device=device) + 0.5) \
        / width * 2.0 - 1.0
    px = xs[None, :] * tan_h * aspect
    py = ys[:, None] * tan_h
    d = (fwd[None, None]
         + right[None, None] * px[..., None]
         + up[None, None] * py[..., None])
    d = d / _norm3(d)
    o = torch.broadcast_to(eye, d.shape)
    return o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()


def _part1by2_i32(x):
    """Spread 9 bits of x to every 3rd bit (int32 Morton helper)."""
    x = x & 0x1FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _octant(d):
    pos = (d > 0).to(I32)
    return pos[:, 0] | (pos[:, 1] << 1) | (pos[:, 2] << 2)


def _compact_key(active, o, d, origin_major: bool = False):
    """Bounce re-compaction sort key (int32, bits 0..29; inactive = 1<<30):
    inactive rays last; active rays grouped by direction OCTANT and ordered
    by a 27-bit Morton code of the origin within the active bbox, so that
    consecutive sorted rays start close together and head the same way.

    origin_major puts the top 6 Morton bits (two octree levels of the
    origin) ABOVE the octant bits: octant-major sweeps the scene once per
    octant, origin-major keeps neighbouring origins together and lets the
    octant split only within a coarse cell."""
    oct_ = _octant(d)
    big = torch.full((), 3e38, dtype=F32, device=o.device)
    lo = torch.where(active[:, None], o, big).amin(dim=0)
    hi = torch.where(active[:, None], o, -big).amax(dim=0)
    scale = 512.0 / (hi - lo).clamp(min=1e-20)
    q = ((o - lo) * scale).clamp(0.0, 511.0).to(I32)
    m = (_part1by2_i32(q[:, 0]) << 2) | (_part1by2_i32(q[:, 1]) << 1) \
        | _part1by2_i32(q[:, 2])
    if origin_major:
        key = ((m >> 21) << 24) | (oct_ << 21) | (m & 0x1FFFFF)
    else:
        key = (oct_ << 27) | m
    return torch.where(active, key, 1 << 30)


def _inverse_perm(perm):
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return inv


def _bucket_perm(key, num_buckets: int):
    """Stable counting-sort permutation for a SMALL integer key — no
    argsort: rank-within-bucket via a (R, B) cumsum of one-hots plus
    bucket offsets.  Returns (perm, inv) with out[i] = in[perm[i]]; the
    scatter's indices are unique, so it needs no atomics."""
    B = num_buckets
    key = key.long()
    onehot = (key[:, None] == torch.arange(B, device=key.device)[None]
              ).long()                               # (R, B)
    ranks = torch.cumsum(onehot, dim=0) - 1          # (R, B) in-bucket rank
    counts = ranks[-1] + 1
    offsets = torch.cumsum(counts, dim=0) - counts
    pos = offsets[key] + ranks.gather(1, key[:, None])[:, 0]
    return _inverse_perm(pos), pos


def _compact_perm(active, o, d, method: str, want_inv: bool = True):
    """Bounce-compaction permutation (perm, inv): surviving rays to the
    front, dead rays last.  method:
      'argsort'   — (octant, origin-Morton) full sort (_compact_key)
      'argsort_om'— the same with the origin-major key
      'octant'    — counting sort by direction octant only; within an
                    octant rays keep their previous (pixel-tile) order
      'partition' — active-first 2-bucket split only
    want_inv=False skips the inverse permutation (the stay-compacted
    bounce loop never unsorts).
    """
    if method in ("argsort", "argsort_om"):
        perm = torch.argsort(
            _compact_key(active, o, d, origin_major=method == "argsort_om"),
            stable=True)
        return perm, (_inverse_perm(perm) if want_inv else None)
    if method == "octant":
        return _bucket_perm(torch.where(active, _octant(d), 8), 9)
    if method == "partition":
        return _bucket_perm((~active).to(I32), 2)
    raise ValueError(f"unknown compact_method {method!r}")


def _interp3(rows3, u, v):
    """Barycentric interpolation of a (R, 3, C) per-corner slice."""
    w = (1.0 - u - v)[..., None]
    return rows3[:, 0] * w + rows3[:, 1] * u[..., None] \
        + rows3[:, 2] * v[..., None]


def resolve_engine(cfg: RTConfig, num_tris: int) -> str:
    """The engine make_intersectors takes for a scene of num_tris triangles
    ("pallas" stands for the clustered kernels: it is returned only at or
    below PALLAS_MAX_TRIS)."""
    engine = cfg.engine if cfg.use_bvh else "brute"
    if engine == "pallas" and num_tris > PALLAS_MAX_TRIS:
        engine = "pallas_bvh"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    return engine


def make_intersectors(scene: RTScene, cfg: RTConfig, device=None):
    """(closest, occluded) for the scene on ``device``:
    closest(o, d, t_max=inf) -> (prim, t, u, v); occluded(o, d, t_max) ->
    (R,) bool."""
    device = resolve_device(device)
    engine = resolve_engine(cfg, scene.faces.shape[0])
    tri = intersect.triangle_arrays(
        torch.as_tensor(np.asarray(scene.verts, np.float32), device=device),
        torch.as_tensor(np.asarray(scene.faces, np.int64), device=device))

    def per_ray(t_max, o):
        return torch.broadcast_to(
            torch.as_tensor(t_max, dtype=F32, device=o.device), o.shape[:1])

    if engine == "pallas":
        from ..ops import cuda_rt

        clusters = cuda_rt.prepare_clusters(
            *tri, bvh_mod.build_clusters(scene.bvh))

        def closest(o, d, t_max=math.inf):
            tm = None if t_max is math.inf else per_ray(t_max, o)
            return cuda_rt.closest_hit_clustered(o, d, clusters, t_max=tm)

        def occluded(o, d, t_max):
            return cuda_rt.any_hit_clustered(o, d, clusters,
                                             t_max=per_ray(t_max, o))
    elif engine == "pallas_bvh":
        from ..ops import cuda_rt

        block_set = bvh_mod.build_block_set(scene.bvh,
                                            tri_block=BVH_TRI_BLOCK)
        blocks = cuda_rt.prepare_bvh_blocks(*tri, block_set)

        def closest(o, d, t_max=math.inf):
            tm = None if t_max is math.inf else per_ray(t_max, o)
            return cuda_rt.closest_hit_bvh(o, d, blocks, t_max=tm)

        def occluded(o, d, t_max):
            return cuda_rt.any_hit_bvh(o, d, blocks, t_max=per_ray(t_max, o))
    elif engine in ("pallas_streamed", "pallas_worklist"):
        from ..ops import cuda_rt

        # treelet order makes consecutive records spatially tight, so the
        # blocks' boxes are small and their gates fire
        stream = cuda_rt.prepare_stream_blocks(
            *tri, order=bvh_mod.build_clusters(scene.bvh)["order"])
        query = (cuda_rt.closest_hit_streamed if engine == "pallas_streamed"
                 else cuda_rt.closest_hit_worklist)

        def closest(o, d, t_max=math.inf):
            tm = None if t_max is math.inf else per_ray(t_max, o)
            return query(o, d, stream, t_max=tm)

        def occluded(o, d, t_max):
            # no any-hit variant: the closest hit inside the bound
            return query(o, d, stream, t_max=per_ray(t_max, o))[0] >= 0
    elif engine == "bvh":
        bvh_arr = scene.bvh.as_stackless_arrays(device)
        ls = scene.bvh.leaf_size

        def closest(o, d, t_max=math.inf):
            return bvh_mod.closest_hit_stackless(bvh_arr, tri, o, d,
                                                 t_max=t_max, leaf_size=ls)

        def occluded(o, d, t_max):
            return bvh_mod.any_hit_stackless(bvh_arr, tri, o, d,
                                             t_max=t_max, leaf_size=ls)
    else:
        def closest(o, d, t_max=math.inf):
            return intersect.closest_hit_bruteforce(o, d, *tri, t_max=t_max)

        def occluded(o, d, t_max):
            return intersect.any_hit_bruteforce(o, d, *tri, t_max=t_max)
    return closest, occluded


def shade_hits(scene_arrays, cfg: RTConfig, occluded, o, d, prim, t, u, v):
    """Lambert + optional texture + optional shadow for a hit batch.

    Returns (rgb (R,3), hit_mask (R,), hit_point, normal)."""
    dev = o.device
    hit = prim >= 0
    pt = o + d * torch.where(hit, t, torch.zeros_like(t))[..., None]
    # ONE packed record row per hit instead of six per-corner vertex
    # gathers (normals + colors [+ uvs] x 3 corners)
    r = scene_arrays["rec"][prim.clamp(min=0).long()]      # (R, 21 | 27)
    R = r.shape[0]
    n = _interp3(r[:, 0:9].reshape(R, 3, 3), u, v)
    n = n / _norm3(n).clamp(min=1e-20)
    # two-sided shading: flip normal against the incoming ray
    n = torch.where(_dot3(n, d) > 0, -n, n)

    albedo = _interp3(r[:, 9:21].reshape(R, 3, 4), u, v)[..., :3]
    if cfg.textured:
        uv = _interp3(r[:, 21:27].reshape(R, 3, 2), u, v)
        texel = sample_texture_bilinear(scene_arrays["texture"],
                                        uv[..., 0], uv[..., 1])
        albedo = albedo * texel[..., :3]

    ldir = _vec(cfg.light_dir, dev)
    ldir = ldir / _norm3(ldir)
    ndotl = _dot3(n, ldir)[..., 0].clamp(min=0.0)

    if cfg.shadows:
        # park shadow rays of non-hit pixels AND of terminator points
        # (ndotl <= 0: occlusion cannot change their shading — the Lambert
        # clamp already zeroed them).  Parked rays leave the hierarchy at
        # its top level.
        need = hit & (ndotl > 0.0)
        sh_o = torch.where(need[..., None], pt + n * 1e-3, _vec(PARK_O, dev))
        sh_d = torch.broadcast_to(ldir, sh_o.shape).contiguous()
        blocked = occluded(sh_o, sh_d, 1e8)
        ndotl = torch.where(blocked, torch.zeros_like(ndotl), ndotl)

    lc = _vec(cfg.light_color, dev)
    rgb = albedo * (cfg.ambient + ndotl[..., None] * lc)
    return rgb, hit, pt, n


def scene_shade_arrays(scene: RTScene, cfg: RTConfig, device=None) -> dict:
    """The per-scene arrays shade_hits consumes, on ``device``: per-prim
    packed attribute records [n0 n1 n2 | c0 c1 c2 | (uv0 uv1 uv2)] so
    shading costs one row gather per ray."""
    device = resolve_device(device)
    faces = np.asarray(scene.faces, np.int64)
    P = faces.shape[0]
    normals = np.asarray(scene.normals, np.float32)
    colors = np.asarray(scene.colors, np.float32)
    parts = [normals[faces].reshape(P, 9), colors[faces].reshape(P, 12)]
    if cfg.textured:
        parts.append(np.asarray(scene.uvs, np.float32)[faces]
                     .reshape(P, 6))
    scene_arrays = {"rec": torch.as_tensor(np.concatenate(parts, axis=1),
                                           device=device)}
    if cfg.textured:
        scene_arrays["texture"] = torch.as_tensor(
            np.asarray(scene.texture, np.float32), device=device)
    return scene_arrays


def _ladder_width(R: int, live: int, ladder: int) -> int:
    """The smallest of R, R>>1, ... R>>ladder (never below 512) that holds
    `live` rays."""
    width = R
    for k in range(1, ladder + 1):
        w = R >> k
        if w < 512:       # not worth a rung below one small launch
            break
        if live <= w:
            width = w
    return width


@torch.no_grad()
def trace_rays(scene_arrays, cfg: RTConfig, closest, occluded,
               reflectivity: float, o, d):
    """Trace + shade one ray batch -> (R, 4) RGBA."""
    dev = o.device
    prim, t, u, v = closest(o, d)
    rgb, hit, pt, n = shade_hits(scene_arrays, cfg, occluded,
                                 o, d, prim, t, u, v)
    bg = _vec(cfg.background, dev)
    bg3 = bg[:3]

    def reflect(cur_o, cur_d, cur_n):
        rd = cur_d - 2.0 * _dot3(cur_d, cur_n) * cur_n
        return cur_o + cur_n * 1e-3, rd

    def accumulate(rgb, weight, rgb2, hit2):
        contrib = torch.where(hit2[..., None], rgb2, bg3)
        rgb = rgb * (1.0 - weight) + contrib * weight
        refl = torch.where(hit2, reflectivity, 0.0).to(F32)[..., None]
        return rgb, weight * refl

    # mirror bounces: active-mask iteration
    if cfg.bounces > 0 and reflectivity > 0:
        if cfg.compact_method not in COMPACT_METHODS:
            raise ValueError(f"unknown compact_method {cfg.compact_method!r}")
        weight = torch.where(hit, reflectivity, 0.0).to(F32)[..., None]
        cur_o, cur_d, cur_n = pt, d, n
        park_o, park_d = _vec(PARK_O, dev), _vec(PARK_D, dev)
        if cfg.compact_bounces and cfg.compact_stay:
            # Stay-compacted bounce loop: state lives in the compacted
            # order of the LATEST bounce; `orig` maps each slot back to
            # launch order and ONE final scatter restores it.  Per-ray
            # arithmetic is identical to the other loops: pure scheduling.
            R = rgb.shape[0]
            orig = torch.arange(R, device=dev)
            hitf = hit.to(F32)[:, None]
            sort_ladder = (cfg.bounce_width_ladder
                           if cfg.compact_method in ("argsort", "argsort_om")
                           else 0)
            prev_live = None
            for b in range(cfg.bounces):
                ro, rd = reflect(cur_o, cur_d, cur_n)
                active = weight[..., 0] > 0
                packed = torch.cat(
                    [torch.where(active[..., None], ro, park_o),
                     torch.where(active[..., None], rd, park_d),
                     rgb, weight, hitf], dim=1)       # (R, 11)
                live = int(active.sum().item())       # the bounce's one sync
                if b > 0 and sort_ladder:
                    # Compaction ladder: bounce b's live rays all sit in
                    # bounce b-1's live prefix, so the argsort + packed
                    # gather only need the first w rows — the stable sort
                    # gives the live rays the SAME order as a full-width
                    # sort (dead keys are all the max sentinel; only the
                    # dead tail's order differs, which nothing observes).
                    key = _compact_key(
                        active, ro, rd,
                        origin_major=cfg.compact_method == "argsort_om")
                    w = _ladder_width(R, prev_live, sort_ladder)
                    pw = torch.argsort(key[:w], stable=True)
                    pc = torch.cat([packed[:w][pw], packed[w:]])
                    orig = torch.cat([orig[:w][pw], orig[w:]])
                else:
                    perm, _ = _compact_perm(active, ro, rd,
                                            cfg.compact_method,
                                            want_inv=False)
                    pc = packed[perm]                 # ONE row gather
                    orig = orig[perm]
                prev_live = live
                ro_c, rd_c = pc[:, 0:3], pc[:, 3:6]
                rgb, weight, hitf = pc[:, 6:9], pc[:, 9:10], pc[:, 10:11]

                w = _ladder_width(R, live, cfg.bounce_width_ladder)
                ro_s = ro_c[:w].contiguous()
                rd_s = rd_c[:w].contiguous()
                p2, t2, u2, v2 = closest(ro_s, rd_s)
                rgb2, hit2, pt2, n2 = shade_hits(
                    scene_arrays, cfg, occluded, ro_s, rd_s, p2, t2, u2, v2)
                pad = R - w
                if pad:
                    z3 = torch.zeros((pad, 3), dtype=F32, device=dev)
                    rgb2 = torch.cat([rgb2, z3])
                    hit2 = torch.cat([hit2, torch.zeros(
                        (pad,), dtype=torch.bool, device=dev)])
                    pt2 = torch.cat([pt2, z3 + park_o])
                    n2 = torch.cat([n2, z3 + _vec((0.0, 0.0, 1.0), dev)])
                rgb, weight = accumulate(rgb, weight, rgb2, hit2)
                cur_o, cur_d, cur_n = pt2, rd_c, n2
            out = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
            rgba = torch.where(hitf > 0.5, out, bg)
            final = torch.empty_like(rgba)
            final[orig] = rgba        # unique indices: a plain scatter
            return final
        for _ in range(cfg.bounces):
            ro, rd = reflect(cur_o, cur_d, cur_n)
            if cfg.compact_bounces:
                # re-compaction between bounces: sort surviving rays to
                # the front and park dead rays at a far origin, heading
                # away.  Shading (incl. the shadow launch) runs in the
                # compacted order too; outputs unsort at the end.
                active = weight[..., 0] > 0
                perm, inv_perm = _compact_perm(active, ro, rd,
                                               cfg.compact_method)
                ro_c = torch.where(active[..., None], ro, park_o)[perm]
                rd_c = torch.where(active[..., None], rd, park_d)[perm]
                p2, t2, u2, v2 = closest(ro_c, rd_c)
                rgb2, hit2, pt2, n2 = shade_hits(
                    scene_arrays, cfg, occluded, ro_c, rd_c, p2, t2, u2, v2)
                rgb2, pt2, n2 = rgb2[inv_perm], pt2[inv_perm], n2[inv_perm]
                hit2 = hit2[inv_perm]
            else:
                p2, t2, u2, v2 = closest(ro, rd)
                rgb2, hit2, pt2, n2 = shade_hits(
                    scene_arrays, cfg, occluded, ro, rd, p2, t2, u2, v2)
            rgb, weight = accumulate(rgb, weight, rgb2, hit2)
            cur_o, cur_d, cur_n = pt2, rd, n2

    out = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    return torch.where(hit[..., None], out, bg)


def make_frame_fn(scene: RTScene, cam: Camera, cfg: RTConfig, device=None):
    """Prepare a whole frame once, for repeated rendering on ``device``
    (None: the CUDA card).

    Returns (frame, (o, d)): frame(o, d) -> (H, W, 4) float32 tensor on the
    device, row 0 = bottom.  The scene's arrays, BVH blocks and intersectors
    are built and uploaded here; ``frame`` only traces.  o, d may be tensors
    or numpy arrays.  For an engine whose name starts with ``pallas`` the
    rays come back, and are expected, in 32x32 pixel-tile order
    (rt.wavefront.tile_order_perm), which keeps the rays of a warp together;
    the image is unsorted at the end.  For 'bvh' and 'brute' they are in
    scanline order.
    """
    device = resolve_device(device)
    scene = scene.finalize()
    scene_arrays = scene_shade_arrays(scene, cfg, device)
    closest, occluded = make_intersectors(scene, cfg, device)
    o, d = camera_rays(cam, cfg.width, cfg.height, device)

    inv_t = None
    if (cfg.engine if cfg.use_bvh else "brute").startswith("pallas"):
        perm, inv = wavefront.tile_order_perm(cfg.width, cfg.height, 32)
        perm_t = torch.as_tensor(perm, device=device).long()
        o, d = o[perm_t], d[perm_t]
        inv_t = torch.as_tensor(inv, device=device).long()

    def on_device(a):
        if not torch.is_tensor(a):
            a = torch.from_numpy(np.array(a, np.float32))
        return a.to(device=device, dtype=F32)

    def frame(o, d):
        o, d = on_device(o), on_device(d)
        img = trace_rays(scene_arrays, cfg, closest, occluded,
                         scene.reflectivity, o, d)
        if inv_t is not None:
            img = img[inv_t]
        return img.reshape(cfg.height, cfg.width, 4)

    return frame, (o, d)


def render(scene: RTScene, cam: Camera, cfg: RTConfig, device=None):
    """Full RT render -> (H, W, 4) float32 image tensor (row 0 = bottom)."""
    frame, (o, d) = make_frame_fn(scene, cam, cfg, device)
    return frame(o, d)
