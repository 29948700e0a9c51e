"""lbm — Parboil D3Q19 lattice-Boltzmann (tests/opencl/lbm of the reference).

Counterpart of skybox_rt_tpu.apps.lbm: the reference's stream-collide kernel
(tests/opencl/lbm/kernel.cl: performStreamCollide_kernel) with the GATHER
(pull) layout its layout_config.h selects: each cell pulls distribution e
from its opposite-direction neighbor, applies BGK collision (OMEGA=1.95) or
obstacle bounce-back, and writes locally.

The C grid is a flat float array of 20-entry cells (19 distributions +
FLAGS stored as a bit pattern in float memory) with a 2-z-slice margin on
each end; out-of-domain neighbor reads wrap through the flat layout
(CALC_INDEX is plain linear arithmetic — layout_config.h:42-44).  The
source / destination flat indices are computed once on the host
(:func:`make_indices`, numpy, as in the JAX package) and moved to the device
once, in :func:`make_step`; a step is one gather, the collide, and one
scatter to unique indices.  :func:`run` loops the steps in Python on the
device and returns numpy.  The grid is float32 on every device; the flags
are read with ``.view(torch.int32)``, and margins and FLAGS pass through
untouched.

Cell entry order and constants mirror layout_config.h:60-70 and
lbm_macros.h:12-22; the LDC (lid-driven cavity) initial condition mirrors
lbm.c:98-193.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device

OMEGA = np.float32(1.95)
DFL1 = np.float32(1.0 / 3.0)
DFL2 = np.float32(1.0 / 18.0)
DFL3 = np.float32(1.0 / 36.0)

OBSTACLE = 1 << 0
ACCEL = 1 << 1

# entry order = CELL_ENTRIES enum (layout_config.h:60-64); FLAGS = 19
NAMES = ["C", "N", "S", "E", "W", "T", "B",
         "NE", "NW", "SE", "SW", "NT", "NB", "ST", "SB",
         "ET", "EB", "WT", "WB"]
FLAGS = len(NAMES)
N_CELL_ENTRIES = FLAGS + 1

# direction vectors (dx, dy, dz) per entry (lbm_macros.h:55-73)
DIRS = np.array([
    (0, 0, 0), (0, 1, 0), (0, -1, 0), (1, 0, 0), (-1, 0, 0),
    (0, 0, 1), (0, 0, -1),
    (1, 1, 0), (-1, 1, 0), (1, -1, 0), (-1, -1, 0),
    (0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1),
    (1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1),
], np.int64)

# index of the opposite direction (N<->S swizzles etc., kernel.cl:62-72)
OPPOSITE = np.array([NAMES.index(
    n.translate(str.maketrans("NSEWTB", "SNWEBT"))) for n in NAMES])

# equilibrium weight per entry: DFL1 for C, DFL2 for axis, DFL3 for diagonal
WEIGHTS = np.array([DFL1] + [DFL2] * 6 + [DFL3] * 12, np.float32)


@dataclasses.dataclass(frozen=True)
class LBMConfig:
    size_x: int = 32
    size_y: int = 32
    size_z: int = 8

    @property
    def padded(self):
        return self.size_x, self.size_y, self.size_z  # PADDING_* are 0

    @property
    def margin(self):
        px, py, _ = self.padded
        return N_CELL_ENTRIES * px * py * 2            # two z slices

    @property
    def total_floats(self):
        px, py, pz = self.padded
        return N_CELL_ENTRIES * px * py * pz + 2 * self.margin

    def calc_index(self, x, y, z, e):
        """CALC_INDEX (layout_config.h:42) + margin: plain linear
        arithmetic, so out-of-domain coords wrap through the flat array
        exactly as in the C code."""
        px, py, _ = self.padded
        return self.margin + e + N_CELL_ENTRIES * (x + y * px + z * px * py)


def make_indices(cfg: LBMConfig):
    """Host-side precompute: (src (19, NC), dst (19, NC), flags (NC,)).

    GATHER layout: SRC_e(x) = entry e at x - dir_e (lbm_macros.h:130-150),
    DST is local.
    """
    x, y, z = np.meshgrid(np.arange(cfg.size_x), np.arange(cfg.size_y),
                          np.arange(cfg.size_z), indexing="ij")
    x, y, z = x.ravel(), y.ravel(), z.ravel()
    src = np.stack([cfg.calc_index(x - dx, y - dy, z - dz, e)
                    for e, (dx, dy, dz) in enumerate(DIRS)])
    dst = np.stack([cfg.calc_index(x, y, z, e) for e in range(FLAGS)])
    flags = cfg.calc_index(x, y, z, FLAGS)
    return src.astype(np.int32), dst.astype(np.int32), flags.astype(np.int32)


def init_ldc(cfg: LBMConfig) -> np.ndarray:
    """Initial grid for the lid-driven-cavity test (lbm.c:98-193).

    The reference's init sweeps the domain writing equilibrium through the
    same SRC_* gather stencil (so margins that later feed boundary gathers
    hold equilibrium too) and flags the 6 domain faces OBSTACLE with an
    ACCEL plate just inside the z faces.
    """
    grid = np.zeros(cfg.total_floats, np.float32)
    x, y, z = np.meshgrid(np.arange(cfg.size_x), np.arange(cfg.size_y),
                          np.arange(cfg.size_z), indexing="ij")
    x, y, z = x.ravel(), y.ravel(), z.ravel()
    for e, (dx, dy, dz) in enumerate(DIRS):
        grid[cfg.calc_index(x - dx, y - dy, z - dz, e)] = WEIGHTS[e]

    flags = np.zeros(x.shape, np.uint32)
    boundary = ((x == 0) | (x == cfg.size_x - 1) | (y == 0)
                | (y == cfg.size_y - 1) | (z == 0) | (z == cfg.size_z - 1))
    accel = (~boundary & ((z == 1) | (z == cfg.size_z - 2))
             & (x > 1) & (x < cfg.size_x - 2) & (y > 1) & (y < cfg.size_y - 2))
    flags = np.where(boundary, flags | OBSTACLE, flags)
    flags = np.where(accel, flags | ACCEL, flags)
    grid[cfg.calc_index(x, y, z, FLAGS)] = flags.view(np.float32)
    return grid


def _collide(f, accel):
    """BGK collision on gathered distributions f (19, NC) float32 — the fluid
    branch of kernel.cl:75-146, with the reference's exact constants."""
    rho = torch.sum(f, dim=0)
    n = {name: f[i] for i, name in enumerate(NAMES)}
    ux = (n["E"] - n["W"] + n["NE"] - n["NW"] + n["SE"] - n["SW"]
          + n["ET"] + n["EB"] - n["WT"] - n["WB"]) / rho
    uy = (n["N"] - n["S"] + n["NE"] + n["NW"] - n["SE"] - n["SW"]
          + n["NT"] + n["NB"] - n["ST"] - n["SB"]) / rho
    uz = (n["T"] - n["B"] + n["NT"] - n["NB"] + n["ST"] - n["SB"]
          + n["ET"] - n["EB"] + n["WT"] - n["WB"]) / rho
    ux = torch.where(accel, _F(0.005), ux)
    uy = torch.where(accel, _F(0.002), uy)
    uz = torch.where(accel, _F(0.0), uz)
    u2 = _F(1.5) * (ux * ux + uy * uy + uz * uz) - _F(1.0)
    base = _F(OMEGA) * rho
    keep = _F(np.float32(1.0) - OMEGA)
    # projected velocity along each direction (C gets 0)
    dirs = torch.as_tensor(DIRS, dtype=torch.float32, device=f.device)
    w = torch.as_tensor(WEIGHTS, device=f.device)
    cu = (dirs[:, 0, None] * ux[None]
          + dirs[:, 1, None] * uy[None]
          + dirs[:, 2, None] * uz[None])
    eq = w[:, None] * base[None] \
        * (cu * (_F(4.5) * cu + _F(3.0)) - u2[None])
    return keep * f + eq


def _F(x) -> float:
    """A float32 constant as the Python float of the same value, which
    torch applies to a float32 tensor without rounding again."""
    return float(np.float32(x))


def make_step(cfg: LBMConfig, device=None):
    """Build the stream-collide step on ``device`` (None: the CUDA card):
    grid (total_floats,) float32 tensor -> next grid.  Margins and FLAGS pass
    through untouched (the kernel only writes the 19 domain distributions,
    kernel.cl:148-175)."""
    dev = resolve_device(device)
    src_idx, dst_idx, flags_idx = make_indices(cfg)
    src_t = torch.from_numpy(src_idx.astype(np.int64)).to(dev)
    dst_t = torch.from_numpy(dst_idx.astype(np.int64).ravel()).to(dev)
    flags_t = torch.from_numpy(flags_idx.astype(np.int64)).to(dev)
    opp = torch.from_numpy(OPPOSITE.astype(np.int64)).to(dev)

    def step(grid):
        f = grid[src_t]                                     # (19, NC) gather
        flags = grid[flags_t].view(torch.int32)
        obstacle = (flags & OBSTACLE) != 0
        accel = (flags & ACCEL) != 0
        bounced = f[opp]                                    # swizzle pairs
        collided = _collide(f, accel)
        out = torch.where(obstacle[None, :], bounced, collided)
        # dst holds every index once: the scatter has no order to pin
        return grid.index_put((dst_t,), out.reshape(-1))

    return step


def run(cfg: LBMConfig = LBMConfig(), steps: int = 10,
        grid: np.ndarray | None = None, device=None) -> np.ndarray:
    """Run `steps` stream-collide iterations on ``device`` (None: the CUDA
    card); returns the final grid as numpy float32."""
    step = make_step(cfg, device)
    g = torch.from_numpy(np.array(init_ldc(cfg) if grid is None else grid,
                                  np.float32)).to(resolve_device(device))
    for _ in range(steps):
        g = step(g)
    return g.cpu().numpy()


def velocity_field(cfg: LBMConfig, grid: np.ndarray):
    """(NC, 3) cell velocities — the analog of LBM_storeVelocityField
    (lbm.c:304), used by the hosts' verification output."""
    _, _, flags_idx = make_indices(cfg)
    # local (post-write) distributions live at the cell itself
    local = np.stack([grid[flags_idx - FLAGS + e] for e in range(FLAGS)])
    rho = local.sum(0)
    vel = (DIRS.astype(np.float32).T @ local) / rho
    return vel.T
