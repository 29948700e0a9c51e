// Closest hit over triangle blocks gated by block AABBs, for sm_90a: the dense
// sweep and the worklist walk.
//
// Replace the Pallas TPU kernels of skybox_rt_tpu/ops/pallas_rt.py
//   `_make_streamed_kernel` (entry `closest_hit_streamed`),
//   `_make_worklist_kernel` (entry `closest_hit_worklist`, with the prepass
//                            `_active_block_lists`).
// Those hold 4,096 rays as a tile a grid program and bring 512-triangle blocks
// to it, the first over a dense (ray tile x block) grid whose blocks arrive by
// the pipeline's own copies, the second over the tile's compacted list of
// active blocks with copies it double-buffers itself.  What tells the two
// apart on any chip is kept: how a ray tile comes to its blocks.
//
// The function (ops/cuda_rt.py holds the plain torch version of each): the
// records are P rows in the caller's order, cut into blocks of tri_block rows
// (the last one shorter), each with its AABB.  A ray tile is one thread block
// of RAY_TILE rays, a ray a thread.
//   streamed: the tile meets every block in ascending id.
//   worklist: the tile meets the blocks of its row of `lists` (G, NB), the
//            first `counts[g]` entries, in that order; the plain-torch prepass
//            made them (the blocks some ray of the tile enters against its
//            fixed t_max, near to far).
// In both a ray enters a block when its slab test passes with far = its
// running best t; over the triangles so entered, the Möller–Trumbore hit with
// the lexicographic minimum (t, slot), slot = the record's row; the prim
// returned is order[slot] (or slot without an order).  A block no ray of the
// tile enters is not staged.
//
// Exactness: the plain versions make the same per-ray decisions in the same
// per-ray order against the same running best (ops/cuda_rt.py), the arithmetic
// is rt_common.cuh's, so kernel and plain version agree bit for bit.
//
// Bound: operations.  A 1024x1024 launch reads 24 bytes and writes 16 a ray;
// a ray does one slab test of 25 flop a block it meets and 53 flop a triangle
// of a block it enters.  The records of a 12,032-triangle scene are 578 KB
// and stay in L2.  The design is the simple one: the block's records are
// staged once in shared memory for the tile (48 bytes a triangle, at most 12
// KB) and every thread that entered tests them from there, so a warp reads
// each record as a broadcast.

#include "rt_common.cuh"

#define RAY_TILE 128
#define MAX_TRI_BLOCK 256

// LISTED: walk `lists` row blockIdx.x (worklist); else every block (streamed).
template <bool LISTED>
__global__ void __launch_bounds__(RAY_TILE)
closest_hit_blocks_kernel(const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ tmax,     // (R,) or null
                          const float4* __restrict__ tri,     // (P, 3) float4
                          const float* __restrict__ aabb,     // (NB, 6)
                          const int* __restrict__ order,      // (P,) or null
                          const int* __restrict__ lists,      // (G, NB)
                          const int* __restrict__ counts,     // (G,)
                          int NB, int P, int tri_block, float t_min, int R,
                          int* __restrict__ out_prim,
                          float* __restrict__ out_t,
                          float* __restrict__ out_u,
                          float* __restrict__ out_v) {
    __shared__ float4 rec[3 * MAX_TRI_BLOCK];
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    bool active = r < R;
    // a thread past the end helps to stage and writes nothing
    Ray ray = load_ray(o, d, active ? r : R - 1);
    float tmax0 = (tmax && active) ? tmax[r] : CUDART_INF_F;
    float best_t = tmax0, best_u = 0.0f, best_v = 0.0f;
    int best_s = -1;
    int steps = LISTED ? counts[blockIdx.x] : NB;
    const int* row = LISTED ? lists + (size_t)blockIdx.x * NB : nullptr;
    for (int k = 0; k < steps; ++k) {
        int b = LISTED ? row[k] : k;
        bool enter = active && slab(aabb + 6 * (size_t)b, ray, best_t);
        // also the barrier after which the previous block's records are free
        if (!__syncthreads_or(enter)) continue;
        int base = b * tri_block;
        int n = min(tri_block, P - base);
        for (int i = threadIdx.x; i < 3 * n; i += blockDim.x)
            rec[i] = __ldg(tri + 3 * (size_t)base + i);
        __syncthreads();
        if (!enter) continue;
        for (int j = 0; j < n; ++j) {
            int slot = base + j;
            float t, u, v;
            bool hit = mt_record(rec[3 * j], rec[3 * j + 1], rec[3 * j + 2],
                                 ray, t_min, t, u, v) && t < tmax0;
            // lexicographic (t, slot) minimum: independent of the order in
            // which blocks are met
            if (hit && (t < best_t || (t == best_t && slot < best_s))) {
                best_t = t;
                best_s = slot;
                best_u = u;
                best_v = v;
            }
        }
    }
    if (!active) return;
    bool miss = best_s < 0;
    out_prim[r] = miss ? -1 : (order ? __ldg(order + best_s) : best_s);
    out_t[r] = miss ? CUDART_INF_F : best_t;
    out_u[r] = miss ? 0.0f : best_u;
    out_v[r] = miss ? 0.0f : best_v;
}

static int check_blocks(int NB, int P, int tri_block) {
    if (tri_block < 1 || tri_block > MAX_TRI_BLOCK || NB < 0 || P < 0
            || (long long)NB * tri_block < P
            || (NB > 0 && (long long)(NB - 1) * tri_block >= P))
        return cudaErrorInvalidValue;
    return cudaSuccess;
}

// Each returns the launch's cudaError_t (0 = launched); none synchronizes.
extern "C" int skybox_rt_closest_hit_streamed(
        const void* o, const void* d, const void* tmax, const void* tri,
        const void* aabb, const void* order, int NB, int P, int tri_block,
        float t_min, int R, void* out_prim, void* out_t, void* out_u,
        void* out_v, void* stream) {
    int rc = check_blocks(NB, P, tri_block);
    if (rc != cudaSuccess) return rc;
    if (R == 0) return cudaSuccess;
    int grid = (R + RAY_TILE - 1) / RAY_TILE;
    closest_hit_blocks_kernel<false><<<grid, RAY_TILE, 0,
                                       (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmax,
        (const float4*)tri, (const float*)aabb, (const int*)order, nullptr,
        nullptr, NB, P, tri_block, t_min, R, (int*)out_prim, (float*)out_t,
        (float*)out_u, (float*)out_v);
    return (int)cudaGetLastError();
}

extern "C" int skybox_rt_closest_hit_worklist(
        const void* o, const void* d, const void* tmax, const void* tri,
        const void* aabb, const void* order, const void* lists,
        const void* counts, int NB, int P, int tri_block, float t_min, int R,
        void* out_prim, void* out_t, void* out_u, void* out_v, void* stream) {
    int rc = check_blocks(NB, P, tri_block);
    if (rc != cudaSuccess) return rc;
    if (R == 0) return cudaSuccess;
    int grid = (R + RAY_TILE - 1) / RAY_TILE;
    closest_hit_blocks_kernel<true><<<grid, RAY_TILE, 0,
                                      (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tmax,
        (const float4*)tri, (const float*)aabb, (const int*)order,
        (const int*)lists, (const int*)counts, NB, P, tri_block, t_min, R,
        (int*)out_prim, (float*)out_t, (float*)out_u, (float*)out_v);
    return (int)cudaGetLastError();
}
