"""OpenCL/POCL benchmark-suite analogs (tests/opencl/ of the reference).

Counterpart of skybox_rt_tpu.apps.opencl: saxpy, dotproduct, psum,
transpose, blackscholes, nearn, kmeans, spmv, bfs, gaussian, sfilter,
sgemm3, each the kernel math of one app on tensors, running on their
device, with the numpy oracles of the hosts' verify loops.

Departures from the JAX module, all forward-only apps compared within a
tolerance:
  * ``kmeans_update`` and ``spmv_csr`` sum with ``index_add_``, which on a
    card adds in no fixed order; the port's rule that no backward pass uses
    ``index_add_`` is about gradients and does not reach these.
  * ``bfs`` checks on the host whether the frontier is empty, once a level,
    where JAX keeps the loop on the device (``lax.while_loop``).
  * ``gaussian_eliminate`` is a Python loop of n - 1 steps (``lax.scan``).
  * ``kmeans_assign`` returns int64 ids (torch's index type; JAX: int32).
"""
from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


# ---------------------------------------------------------------------------
# saxpy / dotproduct / psum / transpose — tests/opencl/{saxpy,dotproduct,
# psum,transpose}: the elementwise / reduction / layout primitives.
# ---------------------------------------------------------------------------

def saxpy(a, x, y):
    return a * x + y


def dotproduct(x, y):
    return torch.sum(x * y)


def psum_reduce(x):
    return torch.sum(x)


def transpose(a):
    return a.t().contiguous()


# ---------------------------------------------------------------------------
# blackscholes — tests/opencl/blackscholes/BlackScholes.cl: the NVIDIA
# sample.  Polynomial cumulative-normal approximation, call+put per option.
# ---------------------------------------------------------------------------

_CND_A = (0.31938153, -0.356563782, 1.781477937, -1.821255978, 1.330274429)
_RSQRT2PI = 0.39894228040143267794


def _cnd(d):
    a1, a2, a3, a4, a5 = _CND_A
    k = 1.0 / (1.0 + 0.2316419 * torch.abs(d))
    poly = k * (a1 + k * (a2 + k * (a3 + k * (a4 + k * a5))))
    cnd = _RSQRT2PI * torch.exp(-0.5 * d * d) * poly
    return torch.where(d > 0, 1.0 - cnd, cnd)


def blackscholes(S, X, T, R, V):
    """-> (call, put) per option; R and V are scalars or tensors."""
    sqrtT = torch.sqrt(T)
    d1 = (torch.log(S / X) + (R + 0.5 * V * V) * T) / (V * sqrtT)
    d2 = d1 - V * sqrtT
    cnd1 = _cnd(d1)
    cnd2 = _cnd(d2)
    expRT = torch.exp(-R * T)
    call = S * cnd1 - X * expRT * cnd2
    put = X * expRT * (1.0 - cnd2) - S * (1.0 - cnd1)
    return call, put


def blackscholes_oracle(S, X, T, R, V):
    def cnd(d):
        a1, a2, a3, a4, a5 = _CND_A
        k = 1.0 / (1.0 + 0.2316419 * np.abs(d))
        poly = k * (a1 + k * (a2 + k * (a3 + k * (a4 + k * a5))))
        c = _RSQRT2PI * np.exp(-0.5 * d * d) * poly
        return np.where(d > 0, 1.0 - c, c)
    sqrtT = np.sqrt(T)
    d1 = (np.log(S / X) + (R + 0.5 * V * V) * T) / (V * sqrtT)
    d2 = d1 - V * sqrtT
    expRT = np.exp(-R * T)
    call = S * cnd(d1) - X * expRT * cnd(d2)
    put = X * expRT * (1.0 - cnd(d2)) - S * (1.0 - cnd(d1))
    return call, put


# ---------------------------------------------------------------------------
# nearn — tests/opencl/nearn: per-record euclidean distance to a query
# (lat/lng), host takes the min.
# ---------------------------------------------------------------------------

def nearn(points, query):
    """points (N, D), query (D,) -> (distances (N,), argmin)."""
    dist = torch.sqrt(torch.sum((points - query) ** 2, dim=1))
    return dist, torch.argmin(dist)


# ---------------------------------------------------------------------------
# kmeans — tests/opencl/kmeans/kernel.cl: assignment step = argmin distance
# over clusters (the quadratic expansion, one matrix product); the host then
# recomputes centroids (a segment sum).
# ---------------------------------------------------------------------------

def kmeans_assign(points, centroids):
    """points (N, D), centroids (K, D) -> (N,) int64 cluster ids."""
    d2 = (torch.sum(points ** 2, 1)[:, None]
          - 2.0 * (points @ centroids.T)
          + torch.sum(centroids ** 2, 1)[None, :])
    return torch.argmin(d2, dim=1)


def kmeans_update(points, assign, k: int):
    """Mean of each cluster's members (empty clusters keep 0)."""
    idx = assign.to(torch.int64)
    sums = torch.zeros((k, points.shape[1]), dtype=points.dtype,
                       device=points.device).index_add_(0, idx, points)
    counts = torch.zeros((k,), dtype=F32, device=points.device).index_add_(
        0, idx, torch.ones((points.shape[0],), dtype=F32,
                           device=points.device))
    return sums / torch.clamp(counts, min=1.0)[:, None]


# ---------------------------------------------------------------------------
# spmv — tests/opencl/spmv: CSR sparse matrix-vector product: gather x by
# column index, multiply by values, segment-sum by row.
# ---------------------------------------------------------------------------

def spmv_csr(values, col_idx, row_id, x, num_rows: int):
    """CSR with precomputed per-nonzero row ids (row_ptr expanded):
    y[r] = sum over nonzeros of row r of values * x[col]."""
    prod = values * x[col_idx.to(torch.int64)]
    return torch.zeros((num_rows,), dtype=prod.dtype,
                       device=prod.device).index_add_(
        0, row_id.to(torch.int64), prod)


def expand_row_ptr(row_ptr: np.ndarray) -> np.ndarray:
    """Host-side CSR row_ptr (R+1,) -> per-nonzero row ids (nnz,)."""
    counts = np.diff(row_ptr)
    return np.repeat(np.arange(len(counts), dtype=np.int32), counts)


# ---------------------------------------------------------------------------
# bfs — tests/opencl/bfs/kernel.cl (BFS_1/BFS_2): level-synchronous
# frontier expansion over the whole edge list: the new frontier is every
# unvisited node reached through an edge whose source is in the frontier.
# ---------------------------------------------------------------------------

def bfs(edge_src, edge_dst, num_nodes: int, source: int = 0):
    """Directed edge list -> (cost (N,) int32, -1 if unreachable)."""
    dev = edge_src.device
    src = edge_src.to(torch.int64)
    dst = edge_dst.to(torch.int64)
    frontier = torch.zeros((num_nodes,), dtype=torch.bool, device=dev)
    frontier[source] = True
    visited = frontier.clone()
    cost = torch.where(frontier, 0, -1).to(torch.int32)
    level = 0
    while bool(frontier.any()):
        # OR over every edge into a node: the largest of 0 / 1 flags
        reached = torch.zeros((num_nodes,), dtype=torch.int32,
                              device=dev).scatter_reduce_(
            0, dst, frontier[src].to(torch.int32), reduce="amax") > 0
        new = reached & ~visited
        cost = torch.where(new, level + 1, cost).to(torch.int32)
        frontier = new
        visited = visited | new
        level += 1
    return cost


def bfs_oracle(edge_src, edge_dst, num_nodes, source=0):
    from collections import deque
    adj = [[] for _ in range(num_nodes)]
    for s, t in zip(edge_src, edge_dst):
        adj[int(s)].append(int(t))
    cost = np.full(num_nodes, -1, np.int32)
    cost[source] = 0
    q = deque([source])
    while q:
        u = q.popleft()
        for w in adj[u]:
            if cost[w] < 0:
                cost[w] = cost[u] + 1
                q.append(w)
    return cost


# ---------------------------------------------------------------------------
# gaussian — tests/opencl/guassian (Rodinia Gaussian elimination, Fan1/Fan2
# kernels): forward elimination of [A|b] one pivot per step, each step one
# masked rank-1 row update (no pivoting, like the reference).
# ---------------------------------------------------------------------------

def gaussian_eliminate(A, b):
    """Forward elimination -> (U upper-triangular, b')."""
    n = A.shape[0]
    M = torch.cat([A, b[:, None]], dim=1)            # (n, n+1)
    rows = torch.arange(n, device=A.device)
    for p in range(n - 1):
        pivot_row = M[p]                             # (n+1,)
        m = M[:, p] / pivot_row[p]                   # Fan1: multipliers
        mask = (rows > p).to(M.dtype)
        M = M - (mask * m)[:, None] * pivot_row[None, :]   # Fan2
    return M[:, :-1], M[:, -1]


def back_substitute(U, c):
    """Host-side back substitution (the reference does this on the CPU)."""
    U = np.asarray(U)
    c = np.asarray(c)
    n = U.shape[0]
    x = np.zeros(n, U.dtype)
    for i in range(n - 1, -1, -1):
        x[i] = (c[i] - U[i, i + 1:] @ x[i + 1:]) / U[i, i]
    return x


# ---------------------------------------------------------------------------
# sfilter — tests/opencl/sfilter/kernel.cl:1-23: 3x3 convolution over the
# image interior (the host launches with global_offset (1,1) and work size
# (n-2, n-2), main.cc:223-225, so borders keep the zero-initialized dst),
# accumulated i0 + i1 + ... + i8 left to right.
# ---------------------------------------------------------------------------

_TAPS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1),
         (1, -1), (1, 0), (1, 1)]


def sfilter(src, m):
    """src (H, W) f32, m (9,) f32 taps (row-major 3x3) -> (H, W) f32."""
    h, w = src.shape
    acc = None
    for k, (dy, dx) in enumerate(_TAPS):
        term = src[1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx] * m[k]
        acc = term if acc is None else acc + term
    out = torch.zeros_like(src)
    out[1:-1, 1:-1] = acc
    return out


# ---------------------------------------------------------------------------
# sgemm3 — tests/opencl/sgemm3/kernel.cl:1-36: local-memory-tiled matmul.
# The tiling is the library's job, as the JAX package leaves it to XLA.
# ---------------------------------------------------------------------------

def sgemm3(A, B):
    """Full float32 on a card while torch.backends.cuda.matmul.allow_tf32
    is False, torch's default."""
    return torch.matmul(A.to(F32), B.to(F32))
